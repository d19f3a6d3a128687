"""The trajectories pinned by the regression tests.

`tests/data_regression_box.npz` holds the 12-hour planar box run,
`tests/data_regression_box_50min.npz` its first 50 minutes (5 steps),
and `tests/data_regression_sphere.npz` a 3-step full-physics run on the
panel-ordered icosahedral mesh (subdiv 3).  The tests replay them on the
CPU and `chip_smoke.py` replays them on the card; both compare against
the same files.

The 12-hour box run is ill-conditioned: on the CPU, a 1e-15 relative
change of the initial ice area stays below 5e-15 m/s for 5 steps, then
grows to 2e-5 m/s by hour 2 and 1e-4 m/s by hour 9 (max |u| is 0.21
m/s), with no solve-mask change on the way.  It
pins the CPU's own arithmetic; another device's rounding cannot match it
to any tight tolerance, so the card is held to the 50-minute prefix.

Regenerate a file only for a deliberate change of numerics, e.g.
`np.savez(path, **box_run(12.0))` or `sphere_full_physics()`.
"""

from __future__ import annotations

import os
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from . import box

DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "tests")
FILES = {"box": "data_regression_box.npz",
         "box_50min": "data_regression_box_50min.npz",
         "sphere": "data_regression_sphere.npz"}


def pinned(name: str) -> Dict[str, np.ndarray]:
    """The stored trajectory end state (a key of FILES)."""
    with np.load(os.path.join(DATA_DIR, FILES[name])) as f:
        return {k: f[k] for k in f.files}


def box_12h() -> Dict[str, np.ndarray]:
    return box_run(12.0)


def box_50min() -> Dict[str, np.ndarray]:
    return box_run(50.0 / 60.0)


def box_run(hours: float) -> Dict[str, np.ndarray]:
    """`hours` of the EVP box test (20x20 quads, 120 subcycles, f64)."""
    from ..config import box_test_config
    from ..model import SeaIceModel

    cfg = box_test_config(elastic_subcycles=120)
    mesh = box.box_test_mesh(20, 20)
    mesh.f_vertex = box.box_coriolis_parameter(mesh)
    model = SeaIceModel(mesh, cfg, dtype=jnp.float64)
    area, vol, snow = box.box_initial_state(mesh, 1)
    state = model.init_state(area, vol, snow)
    step = model.make_step()
    for i in range(int(round(hours * 3600 / cfg.run.dt))):
        forcing = box.box_forcing(mesh, i * cfg.run.dt)
        state, _ = step(model.tensors, state, forcing)
    return {"u": np.asarray(state.velocity.u_velocity),
            "v": np.asarray(state.velocity.v_velocity),
            "area": np.asarray(state.tracers["iceAreaCategory"]),
            "vol": np.asarray(state.tracers["iceVolumeCategory"])}


def sphere_full_physics() -> Dict[str, np.ndarray]:
    """3 full-physics steps on the panel-ordered icosahedral mesh
    (mushy + dEdd + lvl ponds + Rothrock + IR + metric terms, f64)."""
    from ..config import (AdvectionConfig, ColumnConfig, Config,
                          RunConfig, VelocitySolverConfig)
    from ..dynamics.evp import DynamicsForcing
    from ..mesh import icosahedral_mesh
    from ..mesh.panels import panel_reorder
    from ..model import SeaIceModel
    from ..parallel.sharded import full_physics_inputs
    from ..utils.pytree import replace

    mesh, _lay = panel_reorder(icosahedral_mesh(3), 3)
    cfg = Config(
        run=RunConfig(dt=1800.0, n_categories=3, n_ice_layers=4),
        velocity=VelocitySolverConfig(
            elastic_subcycle_number=8, rotate_cartesian_grid=True,
            include_metric_terms=True, geostrophic_surface_tilt=False),
        advection=AdvectionConfig(),
        column=ColumnConfig(ktherm=2, shortwave="dEdd",
                            pond_scheme="lvl", kstrength=1))
    model = SeaIceModel(mesh, cfg, dtype=jnp.float64)
    (area, vol, snow, extra, atm, ocn, coszen) = full_physics_inputs(
        mesh, cfg, jnp.float64)
    state = model.init_state(area, vol, snow)
    tr = dict(state.tracers)
    tr.update({k: jnp.asarray(v) for k, v in extra.items()})
    state = replace(state, tracers=tr)
    step = model.make_step()
    nc = mesh.n_cells
    rng = np.random.default_rng(7)
    f64 = jnp.float64
    forcing = DynamicsForcing(
        u_air_velocity=jnp.asarray(5 * rng.standard_normal(nc), f64),
        v_air_velocity=jnp.asarray(2 * rng.standard_normal(nc), f64),
        air_density=jnp.full((nc,), 1.3, f64),
        u_ocean_velocity=jnp.asarray(0.05 * rng.standard_normal(nc), f64),
        v_ocean_velocity=jnp.asarray(0.05 * rng.standard_normal(nc), f64),
        sea_surface_tilt_u=jnp.zeros((nc,), f64),
        sea_surface_tilt_v=jnp.zeros((nc,), f64),
        land_ice_mask=jnp.zeros((nc,), f64))
    atm_j = jax.tree.map(lambda x: jnp.asarray(x, f64), atm)
    ocn_j = jax.tree.map(lambda x: jnp.asarray(x, f64), ocn)
    for _ in range(3):
        state, _ = step(model.tensors, state, forcing, atm_j, ocn_j,
                        coszen=jnp.asarray(coszen, f64))
    tr = state.tracers
    return {"u": np.asarray(state.velocity.u_velocity),
            "v": np.asarray(state.velocity.v_velocity),
            "area": np.asarray(tr["iceAreaCategory"]),
            "vol": np.asarray(tr["iceVolumeCategory"]),
            "tsfc": np.asarray(tr["surfaceTemperature"])}
