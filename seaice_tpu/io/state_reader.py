"""File-based initial ice state (MPAS input-stream analog).

JAX replacement for the reference's Registry `input` stream ice
fields (Registry.xml:1851-1909: iceAreaCategory, iceVolumeCategory,
snowVolumeCategory, surfaceTemperature, iceEnthalpy, iceSalinity,
snowEnthalpy, uVelocity, vVelocity read at init,
`mpas_seaice_initialize.F`): reads a classic-NetCDF (or npz) state
file in the MPAS dimension convention — Registry Fortran dims
"nCategories nCells Time" appear in the file C-ordered as
(Time, nCells, nCategories), layered fields as
(Time, nCells, nCategories, nLayers) — into the model's tracer state.
Fields absent from the file keep their `init_state` defaults; the
reference's initial-halo machinery is subsumed by the partition
scatter (halos are filled from global arrays on decomposition).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np

# Registry input-stream field names == our tracer names (cell fields;
# trailing dims after nCells in parentheses)
CELL_STATE_FIELDS = (
    "iceAreaCategory", "iceVolumeCategory", "snowVolumeCategory",
    "surfaceTemperature", "iceEnthalpy", "iceSalinity", "snowEnthalpy",
    "iceAge", "firstYearIceArea", "levelIceArea", "levelIceVolume",
    "pondArea", "pondDepth", "pondLidThickness", "snowGrainRadius",
    "snowIceMass", "snowLiquidMass", "brineHeight",
    "verticalSalinity", "bioTracers",
)
VERTEX_STATE_FIELDS = ("uVelocity", "vVelocity")


def write_ice_state(path: str, tracers: Dict[str, Any],
                    u_velocity=None, v_velocity=None,
                    timestamp: str = "0001-01-01_00:00:00"):
    """Write an initial-condition file in the MPAS convention (the
    test/interchange writer; one time record)."""
    arrays: Dict[str, np.ndarray] = {}
    for name in CELL_STATE_FIELDS:
        if name in tracers:
            arrays[name] = np.asarray(tracers[name])
    if u_velocity is not None:
        arrays["uVelocity"] = np.asarray(u_velocity)
    if v_velocity is not None:
        arrays["vVelocity"] = np.asarray(v_velocity)

    if path.endswith(".npz"):
        np.savez(path, xtime=np.array([timestamp]), **arrays)
        return
    from scipy.io import netcdf_file
    nc = netcdf_file(path, "w")
    nc.createDimension("Time", None)
    nc.createDimension("StrLen", 64)
    dims_known: Dict[str, int] = {}

    def dim_for(n, hint):
        for d, sz in dims_known.items():
            if sz == n and d.startswith(hint):
                return d
        name = f"{hint}{len([d for d in dims_known if d.startswith(hint)])}"
        # canonical MPAS names for the common axes
        canon = {"nCells": 0, "nVertices": 0, "nCategories": 1}
        if hint in ("nCells", "nVertices", "nCategories") and \
                hint not in dims_known:
            name = hint
        nc.createDimension(name, n)
        dims_known[name] = n
        return name

    for name, a in arrays.items():
        hints = (["nVertices"] if name in VERTEX_STATE_FIELDS
                 else ["nCells", "nCategories", "nLayers"])
        dnames = ["Time"]
        for ax, n in enumerate(a.shape):
            hint = hints[ax] if ax < len(hints) else "dim"
            dnames.append(dim_for(n, hint))
        var = nc.createVariable(name, "d", tuple(dnames))
        var[:] = a[None]
    tvar = nc.createVariable("xtime", "c", ("Time", "StrLen"))
    tvar[0] = np.frombuffer(timestamp.ljust(64)[:64].encode(),
                            dtype="S1")
    nc.close()


def read_ice_state(path: str) -> Dict[str, np.ndarray]:
    """Read the last time record of every known state field present in
    the file.  Returns {field: array} with the Time axis stripped."""
    out: Dict[str, np.ndarray] = {}
    if path.endswith(".npz"):
        z = np.load(path)
        for name in CELL_STATE_FIELDS + VERTEX_STATE_FIELDS:
            if name in z.files:
                out[name] = z[name]
        return out
    from scipy.io import netcdf_file
    nc = netcdf_file(path, "r", mmap=False)
    try:
        for name in CELL_STATE_FIELDS + VERTEX_STATE_FIELDS:
            if name in nc.variables:
                v = nc.variables[name]
                a = np.array(v[:])
                out[name] = a[-1] if v.dimensions and \
                    v.dimensions[0] == "Time" else a
    finally:
        nc.close()
    return out


def init_state_from_file(model, path: str):
    """Build a model State from an IC/restart file (reference input
    stream at init, mpas_seaice_initialize.F): fields present in the
    file override the `init_state` defaults; velocities load into the
    solver state when present."""
    import jax.numpy as jnp

    from ..utils.pytree import replace

    fields = read_ice_state(path)
    state = model.init_state(
        fields.get("iceAreaCategory"),
        fields.get("iceVolumeCategory"),
        fields.get("snowVolumeCategory"))
    tr = dict(state.tracers)
    for name, a in fields.items():
        if name in VERTEX_STATE_FIELDS:
            continue
        if name in tr:
            want = tr[name].shape
            if a.shape != want:
                raise ValueError(
                    f"{name}: file shape {a.shape} != model {want}")
            tr[name] = jnp.asarray(a, model.dtype)
    state = replace(state, tracers=tr)
    vel = state.velocity
    if "uVelocity" in fields:
        vel = replace(vel, u_velocity=jnp.asarray(
            fields["uVelocity"], model.dtype))
    if "vVelocity" in fields:
        vel = replace(vel, v_velocity=jnp.asarray(
            fields["vVelocity"], model.dtype))
    return replace(state, velocity=vel)
