"""Critical-error handling: cooperative abort with full state dump.

JAX re-design of `mpas_seaice_error.F` (seaice_check_critical_
error :80 — max-reduce an abort flag across ranks, write the abort
stream, halt) and the Registry abort/abort_block crash-dump streams
(Registry.xml:2163-2248): the abort decision comes from the jit-able
`diagnostics.check_state`; on failure the full State pytree plus the
failing-check list is dumped bitwise before raising.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import jax

from .diagnostics import check_state
from .model import State


class SeaIceAbort(RuntimeError):
    """Raised after a failed state check; the dump path is attached."""

    def __init__(self, message: str, dump_path: Optional[str]):
        super().__init__(message)
        self.dump_path = dump_path


def write_abort_dump(run_dir: str, state: State, timestamp: str,
                     failed_checks) -> str:
    """Write the crash-dump 'abort stream' (full prognostic state +
    metadata), mirroring config_full_abort_write (Registry :356-359)."""
    from .io.checkpoint import save_checkpoint
    os.makedirs(run_dir, exist_ok=True)
    path = os.path.join(run_dir, f"abort.{timestamp}.npz")
    save_checkpoint(path, state, {
        "failed_checks": np.array([str(f) for f in failed_checks])})
    return path


def write_cell_failure_dump(run_dir: str, state: State, cell_idx,
                            reason: str, timestamp: str,
                            max_cells: int = 32) -> str:
    """Per-cell failure dump: the FULL column state of the failing
    cells (every tracer sliced at those cells) plus the warning
    reason — the analog of the reference's column warning buffer and
    per-cell state print on abort (ice_warnings.F90;
    mpas_seaice_column.F:1872-1939 prints lat/lon and all category
    tracers of the failing cell)."""
    os.makedirs(run_dir, exist_ok=True)
    cell_idx = np.asarray(cell_idx)[:max_cells]
    fields = {"cell_index": cell_idx,
              "reason": np.array(reason)}
    tracers = jax.device_get(state.tracers)
    # sharded states carry a leading shard axis; flatten it so the cell
    # index addresses the stacked (shard*localCell) dimension
    sharded = np.asarray(tracers["iceAreaCategory"]).ndim == 3
    for name, arr in tracers.items():
        a = np.asarray(arr)
        if sharded:
            a = a.reshape((-1,) + a.shape[2:])
        fields["tracer_" + name] = a[cell_idx]
    path = os.path.join(run_dir, f"cell_failure.{timestamp}.npz")
    np.savez(path, **fields)
    return path


def raise_on_failed_checks(checks: Dict[str, Any], state: State,
                           timestamp: str,
                           run_dir: Optional[str] = None,
                           cell_masks: Optional[Dict[str, Any]] = None
                           ) -> None:
    """Host abort gate for checks already computed on-device (inside
    the jitted step — the per-step seaice_check_state analog).

    cell_masks: optional {check_name: per-cell bool 'problem' mask}
    for checks with per-cell attribution (column warnings); failing
    cells get a dedicated full-column dump."""
    checks = jax.device_get(checks)
    if bool(np.all(checks["ok"])):
        return
    failed = [k for k, v in checks.items()
              if k != "ok" and not bool(np.all(v))]
    dump = None
    cell_dumps = []
    if run_dir is not None:
        dump = write_abort_dump(run_dir, state, timestamp, failed)
        if cell_masks:
            for name in failed:
                if name not in cell_masks:
                    continue
                mask = np.asarray(jax.device_get(cell_masks[name]))
                while mask.ndim > 1:       # [*, nCat, ...] -> per cell
                    mask = mask.any(-1)
                idx = np.nonzero(mask.reshape(-1))[0]
                if len(idx):
                    cell_dumps.append(write_cell_failure_dump(
                        run_dir, state, idx, name, timestamp))
    raise SeaIceAbort(
        f"critical state-check failure at {timestamp}: {failed}"
        + (f" (state dumped to {dump})" if dump else "")
        + (f" (failing cells dumped to {cell_dumps})"
           if cell_dumps else ""), dump)


def check_critical_error(state: State, timestamp: str,
                         run_dir: Optional[str] = None,
                         max_velocity: float = 5.0) -> None:
    """Host-side abort gate: evaluate the state checks; on failure dump
    the state and raise SeaIceAbort. Under shard_map the checks reduce
    over all shards automatically (jnp.all over the stacked axis), the
    analog of the reference's dmpar max-reduce of abortFlag."""
    checks = jax.device_get(check_state(state,
                                        max_velocity=max_velocity))
    if bool(np.all(checks["ok"])):
        return
    failed = [k for k, v in checks.items()
              if k != "ok" and not bool(np.all(v))]
    dump = None
    if run_dir is not None:
        dump = write_abort_dump(run_dir, state, timestamp, failed)
    raise SeaIceAbort(
        f"critical state-check failure at {timestamp}: {failed}"
        + (f" (state dumped to {dump})" if dump else ""), dump)
