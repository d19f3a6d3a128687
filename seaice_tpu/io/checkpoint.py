"""Checkpoint / restart.

JAX replacement for the reference's Registry-defined `restart`
stream + restart_timestamp protocol (`mpas_seaice_core.F:341-354`,
Registry.xml:1910-2014): the full State pytree plus clock metadata is
written bitwise to an npz file; an atomically-updated
`restart_timestamp` text file records the latest valid restart. Bitwise
restartability is enforced by test (the reference's restartability.py
strategy).
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import jax

from ..model import State
from ..dynamics.evp import VelocitySolverState


def _flatten_state(state: State) -> Dict[str, np.ndarray]:
    out = {}
    v = state.velocity
    out["velocity.u_velocity"] = np.asarray(v.u_velocity)
    out["velocity.v_velocity"] = np.asarray(v.v_velocity)
    out["velocity.stress11"] = np.asarray(v.stress11)
    out["velocity.stress22"] = np.asarray(v.stress22)
    out["velocity.stress12"] = np.asarray(v.stress12)
    out["velocity.solve_velocity_prev"] = np.asarray(
        v.solve_velocity_prev)
    for k, arr in state.tracers.items():
        out[f"tracers.{k}"] = np.asarray(arr)
    out["time"] = np.asarray(state.time)
    return out


def save_checkpoint(path: str, state: State,
                    clock_metadata: Optional[Dict[str, Any]] = None):
    """Write the state bitwise to `path` (atomic: temp file + rename)."""
    payload = _flatten_state(state)
    if clock_metadata:
        for k, v in clock_metadata.items():
            payload[f"clock.{k}"] = np.asarray(v)
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_checkpoint(path: str, dtype=None
                    ) -> Tuple[State, Dict[str, Any]]:
    """Read a checkpoint back into a State (+ clock metadata dict)."""
    import jax.numpy as jnp
    z = np.load(path)
    def a(k):
        arr = z[k]
        return jnp.asarray(arr if dtype is None else arr.astype(dtype))

    vel = VelocitySolverState(
        u_velocity=a("velocity.u_velocity"),
        v_velocity=a("velocity.v_velocity"),
        stress11=a("velocity.stress11"),
        stress22=a("velocity.stress22"),
        stress12=a("velocity.stress12"),
        solve_velocity_prev=a("velocity.solve_velocity_prev"))
    tracers = {k[len("tracers."):]: a(k) for k in z.files
               if k.startswith("tracers.")}
    clock = {k[len("clock."):]: z[k] for k in z.files
             if k.startswith("clock.")}
    return State(velocity=vel, tracers=tracers, time=a("time")), clock


def write_restart_timestamp(run_dir: str, timestamp: str):
    """Atomically record the latest restart time
    (reference mpas_seaice_core.F:341-354)."""
    path = os.path.join(run_dir, "restart_timestamp")
    fd, tmp = tempfile.mkstemp(dir=run_dir)
    os.close(fd)
    with open(tmp, "w") as f:
        f.write(timestamp + "\n")
    os.replace(tmp, path)


def read_restart_timestamp(run_dir: str) -> Optional[str]:
    path = os.path.join(run_dir, "restart_timestamp")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return f.read().strip()
