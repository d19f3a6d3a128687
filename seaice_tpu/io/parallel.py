"""Parallel (per-shard) I/O: gatherless restart and history streams.

JAX replacement for the reference's PIO-based parallel I/O
(`config_pio_num_iotasks` / `config_pio_stride`, Registry.xml:380-396,
and the MPAS stream manager writing each task's owned elements directly
into shared NetCDF files).  Instead of one shared file written through
MPI-IO, each shard writes its OWNED slice (halo rows never leave the
device) to its own part file:

    <dir>/<name>.part-0003.npz       one per shard
    <dir>/<name>.manifest.json       global sizes + shard roster

Writes are embarrassingly parallel: on a multi-host slice each process
writes only its addressable shards (`process_index` selects them), with
no cross-host gather and no host ever holding the global state.  Reads
are halo-aware: reconstructing one shard's local block touches only the
part files of the shards that own its halo cells — not the whole
roster — so restart I/O also scales with the partition.

A separate `assemble_*` surface rebuilds global arrays for offline
analysis (the analog of `ncrcat` over PIO output).
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..parallel.partition import Partition


def _atomic_savez(path: str, payload: Dict[str, np.ndarray]):
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


def _part_path(directory: str, name: str, shard: int) -> str:
    return os.path.join(directory, f"{name}.part-{shard:04d}.npz")


def _manifest_path(directory: str, name: str) -> str:
    return os.path.join(directory, f"{name}.manifest.json")


def _owned_cell_slice(part: Partition, s: int, arr: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(owned rows, their global ids) of a stacked [S, nLocal, ...]
    cell field — pads (global id < 0) dropped."""
    b = part.blocks[s]
    n = b.n_cells_owned
    gid = b.cell_global[:n]
    ok = gid >= 0
    return np.asarray(arr[s, :n][ok]), gid[ok]


def _owned_vertex_slice(part: Partition, s: int, arr: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
    b = part.blocks[s]
    n = b.n_vertices_owned
    gid = b.vertex_global[:n]
    ok = gid >= 0
    return np.asarray(arr[s, :n][ok]), gid[ok]


# -- field kind dispatch ------------------------------------------------------

CELL, VERTEX = "cell", "vertex"


def _state_fields(state) -> List[Tuple[str, str, Any]]:
    """Flatten a (stacked) State into (name, kind, array) triples."""
    v = state.velocity
    out = [
        ("velocity.u_velocity", VERTEX, v.u_velocity),
        ("velocity.v_velocity", VERTEX, v.v_velocity),
        ("velocity.stress11", CELL, v.stress11),
        ("velocity.stress22", CELL, v.stress22),
        ("velocity.stress12", CELL, v.stress12),
        ("velocity.solve_velocity_prev", VERTEX, v.solve_velocity_prev),
    ]
    for k, arr in state.tracers.items():
        out.append((f"tracers.{k}", CELL, arr))
    return out


# -- restart write ------------------------------------------------------------

def save_sharded_checkpoint(directory: str, name: str, state,
                            part: Partition, n_cells_global: int,
                            n_vertices_global: int,
                            clock_metadata: Optional[Dict[str, Any]] = None,
                            shards: Optional[Sequence[int]] = None):
    """Write a sharded State ([S, nLocal, ...] stacked pytree) as one
    part file per shard, owned rows only, bitwise.

    `shards`: which shards THIS process writes (default: all — the
    single-host case).  On a multi-host slice pass the shard ids whose
    devices are addressable from this process; every process calls this
    with the same `state`/`part` and disjoint `shards`, giving a fully
    parallel write with no gather (reference PIO io-task semantics)."""
    fields = _state_fields(state)
    time_val = np.asarray(state.time)
    if shards is None:
        shards = range(part.n_shards)
    for s in shards:
        payload: Dict[str, np.ndarray] = {}
        for fname, kind, arr in fields:
            a = np.asarray(arr)
            if kind == CELL:
                rows, gid = _owned_cell_slice(part, s, a)
            else:
                rows, gid = _owned_vertex_slice(part, s, a)
            payload[f"{kind}:{fname}"] = rows
        _, cgid = _owned_cell_slice(part, s, np.asarray(fields[2][2]))
        _, vgid = _owned_vertex_slice(part, s, np.asarray(fields[0][2]))
        payload["cell_global"] = cgid
        payload["vertex_global"] = vgid
        payload["time"] = time_val
        _atomic_savez(_part_path(directory, name, s), payload)
    manifest = {
        "n_shards": int(part.n_shards),
        "n_cells_global": int(n_cells_global),
        "n_vertices_global": int(n_vertices_global),
        "clock": {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                  for k, v in (clock_metadata or {}).items()},
    }
    mpath = _manifest_path(directory, name)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(
        os.path.abspath(mpath)))
    os.close(fd)
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, mpath)


# -- restart read (halo-aware, per-shard) -------------------------------------

class _PartCache:
    """Lazily opened part files with searchsorted row lookup (owned id
    lists are globally sorted per shard — partition_mesh sorts them)."""

    def __init__(self, directory: str, name: str):
        self.directory = directory
        self.name = name
        self._open: Dict[int, Any] = {}

    def part(self, s: int):
        if s not in self._open:
            self._open[s] = np.load(_part_path(
                self.directory, self.name, s))
        return self._open[s]

    def rows(self, s: int, kind: str, field: str,
             gids: np.ndarray) -> np.ndarray:
        z = self.part(s)
        ids = z[f"{kind}_global"]
        pos = np.searchsorted(ids, gids)
        pos = np.clip(pos, 0, len(ids) - 1)
        if not np.array_equal(ids[pos], gids):
            raise ValueError(
                f"shard {s} part file does not own all requested "
                f"{kind} ids — partition mismatch with checkpoint")
        return z[f"{kind}:{field}"][pos]


def load_sharded_checkpoint(directory: str, name: str, part: Partition,
                            state_template,
                            shards: Optional[Sequence[int]] = None,
                            dtype=None):
    """Reconstruct the stacked local State for `part` from part files.

    Halo-aware: each local block pulls owned rows from its own part and
    halo rows from the parts of the shards that own them (2-deep halo
    ⇒ a handful of neighbor files), so no process reads the full
    roster.  `state_template` supplies the pytree structure and local
    shapes (e.g. `model.init_state()`); `shards=None` loads all blocks
    (single host).  Returns (stacked State, clock metadata dict)."""
    import jax.numpy as jnp

    from ..dynamics.evp import VelocitySolverState
    from ..model import State

    with open(_manifest_path(directory, name)) as f:
        manifest = json.load(f)
    if manifest["n_shards"] != part.n_shards:
        raise ValueError(
            f"checkpoint has {manifest['n_shards']} shards, partition "
            f"has {part.n_shards} (repartition restart requires "
            f"assemble_checkpoint + scatter)")
    cache = _PartCache(directory, name)
    if shards is None:
        shards = range(part.n_shards)
    fields = _state_fields(state_template)
    owner = {CELL: part.cell_owner, VERTEX: part.vertex_owner}

    filled: Dict[str, List[np.ndarray]] = {f[0]: [] for f in fields}
    time_val = None
    for s in shards:
        b = part.blocks[s]
        gid = {CELL: b.cell_global, VERTEX: b.vertex_global}
        for fname, kind, arr in fields:
            a = np.asarray(arr)
            local = np.zeros(a.shape[1:], a.dtype)
            g = gid[kind]
            ok = g >= 0
            own = owner[kind][np.maximum(g, 0)]
            for src in np.unique(own[ok]):
                sel = ok & (own == src)
                local[sel] = cache.rows(int(src), kind, fname, g[sel])
            filled[fname].append(local)
        if time_val is None:
            time_val = cache.part(s)["time"]

    def stacked(fname):
        a = np.stack(filled[fname])
        return jnp.asarray(a if dtype is None else a.astype(dtype))

    vel = VelocitySolverState(
        u_velocity=stacked("velocity.u_velocity"),
        v_velocity=stacked("velocity.v_velocity"),
        stress11=stacked("velocity.stress11"),
        stress22=stacked("velocity.stress22"),
        stress12=stacked("velocity.stress12"),
        solve_velocity_prev=stacked("velocity.solve_velocity_prev"))
    tracers = {f[0][len("tracers."):]: stacked(f[0])
               for f in fields if f[0].startswith("tracers.")}
    state = State(velocity=vel, tracers=tracers,
                  time=jnp.asarray(time_val))
    return state, manifest.get("clock", {})


def assemble_checkpoint(directory: str, name: str
                        ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Rebuild GLOBAL arrays from all part files (offline analysis /
    repartition path).  Returns ({field: global array}, clock)."""
    with open(_manifest_path(directory, name)) as f:
        manifest = json.load(f)
    nS = manifest["n_shards"]
    sizes = {CELL: manifest["n_cells_global"],
             VERTEX: manifest["n_vertices_global"]}
    out: Dict[str, np.ndarray] = {}
    for s in range(nS):
        z = np.load(_part_path(directory, name, s))
        ids = {k: z[f"{k}_global"] for k in (CELL, VERTEX)}
        for key in z.files:
            if ":" not in key:
                continue
            kind, fname = key.split(":", 1)
            rows = z[key]
            if fname not in out:
                out[fname] = np.zeros((sizes[kind],) + rows.shape[1:],
                                      rows.dtype)
            out[fname][ids[kind]] = rows
    return out, manifest.get("clock", {})


# -- history stream -----------------------------------------------------------

class ShardedOutputStream:
    """Per-shard history stream: each output alarm appends the owned
    slice of the requested cell/vertex fields to an in-memory record;
    `flush()` writes one part file per shard (parallel across hosts via
    `shards`) plus a manifest.  `assemble_history` rebuilds the global
    [Time, nCells/nVertices, ...] arrays offline."""

    def __init__(self, directory: str, name: str, part: Partition,
                 n_cells_global: int, n_vertices_global: int):
        self.directory = directory
        self.name = name
        self.part = part
        self.n_cells_global = n_cells_global
        self.n_vertices_global = n_vertices_global
        self.records: List[Dict[str, Tuple[str, np.ndarray]]] = []
        self.timestamps: List[str] = []

    def write(self, cell_fields: Dict[str, np.ndarray],
              vertex_fields: Dict[str, np.ndarray], timestamp: str):
        """fields: stacked [S, nLocal, ...] arrays."""
        rec: Dict[str, Tuple[str, np.ndarray]] = {}
        for k, v in cell_fields.items():
            rec[k] = (CELL, np.asarray(v))
        for k, v in vertex_fields.items():
            rec[k] = (VERTEX, np.asarray(v))
        self.records.append(rec)
        self.timestamps.append(timestamp)

    def flush(self, shards: Optional[Sequence[int]] = None):
        if not self.records:
            return
        part = self.part
        if shards is None:
            shards = range(part.n_shards)
        for s in shards:
            payload: Dict[str, np.ndarray] = {}
            for key, (kind, _a) in self.records[0].items():
                slicer = (_owned_cell_slice if kind == CELL
                          else _owned_vertex_slice)
                stackrows = []
                for rec in self.records:
                    rows, gid = slicer(part, s, rec[key][1])
                    stackrows.append(rows)
                payload[f"{kind}:{key}"] = np.stack(stackrows)
                payload[f"{kind}_global"] = gid
            payload["xtime"] = np.array(self.timestamps)
            _atomic_savez(_part_path(self.directory, self.name, s),
                          payload)
        manifest = {
            "n_shards": int(part.n_shards),
            "n_cells_global": int(self.n_cells_global),
            "n_vertices_global": int(self.n_vertices_global),
            "n_records": len(self.records),
        }
        with open(_manifest_path(self.directory, self.name), "w") as f:
            json.dump(manifest, f)


def assemble_history(directory: str, name: str
                     ) -> Tuple[Dict[str, np.ndarray], List[str]]:
    """Global [Time, nGlobal, ...] arrays from a ShardedOutputStream."""
    with open(_manifest_path(directory, name)) as f:
        manifest = json.load(f)
    nS = manifest["n_shards"]
    sizes = {CELL: manifest["n_cells_global"],
             VERTEX: manifest["n_vertices_global"]}
    out: Dict[str, np.ndarray] = {}
    xtime: List[str] = []
    for s in range(nS):
        z = np.load(_part_path(directory, name, s))
        ids = {k: z[f"{k}_global"] for k in (CELL, VERTEX)
               if f"{k}_global" in z.files}
        if not xtime:
            xtime = [str(t) for t in z["xtime"]]
        for key in z.files:
            if ":" not in key:
                continue
            kind, fname = key.split(":", 1)
            rows = z[key]                    # [Time, nOwned, ...]
            if fname not in out:
                out[fname] = np.zeros(
                    (rows.shape[0], sizes[kind]) + rows.shape[2:],
                    rows.dtype)
            out[fname][:, ids[kind]] = rows
    return out, xtime
