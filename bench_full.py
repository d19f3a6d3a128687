"""Full-physics global workload and its step-time benchmark.

QU120km-scale quasi-uniform global mesh (icosahedral subdiv 6, 40,962
cells, ~120 km), 5 categories, 7 ice layers, full physics: mushy
thermodynamics (ktherm=2), delta-Eddington shortwave, level-ice ponds,
Rothrock strength, EVP 120 subcycles (variational/Wachspress),
full-tracer incremental remapping, ridging.

`build()` is shared with `chip_smoke.py`.  Run on the GPU:

    python bench_full.py [--subdiv 6] [--mesh panel|voronoi|icos]

It refuses to run without a GPU and prints one JSON line: steady
ms/step (host clock around `block_until_ready`, after warm-up) with the
device and the card's name and power limit.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)


def build(subdiv=6, n_subcycles=120, dt=1800.0, mesh_kind="panel",
          dtype=None):
    """Mesh + model + state + forcing of the workload."""
    return build_workload(build_mesh(subdiv, mesh_kind), n_subcycles, dt,
                          dtype)


def build_mesh(subdiv=6, mesh_kind="panel"):
    """The global mesh of the workload.

    panel:   icosahedral hex mesh in rhombic-panel order (the EVP solve
             runs on shifts, dynamics/variational_panel.py);
    icos:    the same mesh in generator order (gather path);
    voronoi: SCVT-style spherical Voronoi mesh, the family deployments
             use: no panel or raster structure (gather path)."""
    from seaice_tpu.mesh import icosahedral_mesh, spherical_voronoi_mesh

    if mesh_kind == "panel":
        from seaice_tpu.mesh.panels import panel_reorder
        mesh, _lay = panel_reorder(icosahedral_mesh(subdiv), subdiv)
        return mesh
    if mesh_kind == "icos":
        return icosahedral_mesh(subdiv)
    if mesh_kind == "voronoi":
        return spherical_voronoi_mesh(subdiv)
    raise ValueError(f"unknown mesh_kind {mesh_kind!r}")


def workload_config(n_subcycles=120, dt=1800.0):
    """Full physics: 5 categories, 7 layers, mushy thermodynamics, dEdd
    shortwave, level ponds, Rothrock strength, EVP, IR, ridging."""
    from seaice_tpu.config import (AdvectionConfig, ColumnConfig, Config,
                                   RunConfig, VelocitySolverConfig)
    return Config(
        run=RunConfig(dt=dt, n_categories=5, n_ice_layers=7),
        velocity=VelocitySolverConfig(
            elastic_subcycle_number=n_subcycles,
            rotate_cartesian_grid=True, include_metric_terms=True,
            geostrophic_surface_tilt=False),
        advection=AdvectionConfig(),
        column=ColumnConfig(ktherm=2, shortwave="dEdd",
                            pond_scheme="lvl", kstrength=1))


def build_workload(mesh, n_subcycles=120, dt=1800.0, dtype=None):
    """(model, initial state, (dynamics, atmos, ocean, coszen) forcing)
    on `mesh` in `dtype` (default float32): polar ice caps under a
    zonal wind, a slab ocean and constant shortwave."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from seaice_tpu.column.driver import AtmosForcing, OceanForcing
    from seaice_tpu.column.driver import slab_ocean_frzmlt
    from seaice_tpu.column.thermo_shared import (
        ice_enthalpy_from_temperature, melting_temperature,
        salinity_profile, snow_enthalpy_from_temperature)
    from seaice_tpu.dynamics.evp import DynamicsForcing
    from seaice_tpu.mesh.rotation import latlon_vector_rotation_forward
    from seaice_tpu.model import SeaIceModel
    from seaice_tpu.utils.pytree import replace

    dtype = jnp.float32 if dtype is None else dtype
    cfg = workload_config(n_subcycles, dt)
    model = SeaIceModel(mesh, cfg, dtype=dtype)

    nc, ncat, ni, ns = mesh.n_cells, 5, 7, 1
    polar = np.abs(mesh.lat_cell) > np.deg2rad(65.0)
    h = model.column.hin_max
    mids = 0.5 * (h[:-1] + np.minimum(h[1:], 10.0))
    area = np.where(polar[:, None], 0.9 / ncat, 0.0) * np.ones((1, ncat))
    state = model.init_state(area, area * mids, area * 0.05)
    S = salinity_profile(ni)
    has = area[..., None] > 0
    tr = dict(state.tracers)
    tr["surfaceTemperature"] = jnp.asarray(
        np.where(area > 0, -15.0, 0.0), dtype)
    tr["iceEnthalpy"] = ice_enthalpy_from_temperature(
        jnp.asarray(np.where(has, -10.0, 0.0) * np.ones((nc, ncat, ni)),
                    dtype),
        melting_temperature(
            jnp.asarray(np.tile(S, (nc, ncat, 1)), dtype))) * has
    tr["iceSalinity"] = jnp.asarray(np.tile(S, (nc, ncat, 1)),
                                    dtype) * has
    tr["snowEnthalpy"] = snow_enthalpy_from_temperature(
        jnp.asarray(-12.0 * np.ones((nc, ncat, ns)), dtype)) * has
    state = replace(state, tracers=tr)

    lat, lon = mesh.lat_cell, mesh.lon_cell
    u_t = 6.0 * np.cos(lat) + 2.0 * np.sin(lon)
    v_t = 1.5 * np.sin(2 * lon)
    uw, vw = latlon_vector_rotation_forward(
        u_t, v_t, mesh.x_cell, mesh.y_cell, mesh.z_cell)
    one = np.ones(nc)
    z = jnp.zeros((nc,), dtype)
    dyn = DynamicsForcing(
        u_air_velocity=jnp.asarray(uw, dtype),
        v_air_velocity=jnp.asarray(vw, dtype),
        air_density=jnp.full((nc,), 1.3, dtype),
        u_ocean_velocity=z, v_ocean_velocity=z,
        sea_surface_tilt_u=z, sea_surface_tilt_v=z,
        land_ice_mask=z)
    t_air = 288.0 - 45.0 * np.sin(np.abs(lat)) ** 2
    atm = AtmosForcing(
        air_temperature=t_air, specific_humidity=4e-4 * one,
        u_air=np.asarray(uw), v_air=np.asarray(vw),
        longwave_down=180.0 * one,
        sw_vis_dir=30.0 * one, sw_vis_dif=20.0 * one,
        sw_ir_dir=25.0 * one, sw_ir_dif=15.0 * one,
        rain_rate=0.0 * one, snow_rate=2e-6 * one,
        air_density=1.3 * one, air_level_height=10.0 * one)
    sst = np.where(polar, -1.7, 8.0)
    Tf = np.full(nc, -1.8)
    ocn = OceanForcing(
        sst=sst, sss=34.0 * one, freezing_temperature=Tf,
        frzmlt=np.asarray(slab_ocean_frzmlt(
            jnp.asarray(sst, dtype), jnp.asarray(Tf, dtype),
            jnp.full((nc,), 20.0, dtype), dt)),
        mixed_layer_depth=20.0 * one)
    atm = jax.tree.map(lambda x: jnp.asarray(x, dtype), atm)
    ocn = jax.tree.map(lambda x: jnp.asarray(x, dtype), ocn)
    coszen = jnp.asarray(np.clip(np.cos(lat - 0.3), 0.0, 1.0), dtype)
    return model, state, (dyn, atm, ocn, coszen)


def measure(subdiv=6, n_subcycles=120, mesh_kind="panel", n_steps=5):
    """(n_cells, steady seconds per step, compile seconds)."""
    import jax

    model, state, (dyn, atm, ocn, coszen) = build(
        subdiv, n_subcycles, mesh_kind=mesh_kind)
    step = model.make_step()
    args = (model.tensors, state, dyn, atm, ocn)
    t0 = time.perf_counter()
    compiled = step.lower(*args, coszen=coszen).compile()
    t_compile = time.perf_counter() - t0
    s = state
    times = []
    for i in range(n_steps + 1):
        t0 = time.perf_counter()
        s, _ = compiled(model.tensors, s, dyn, atm, ocn, coszen=coszen)
        jax.block_until_ready(s)
        if i:                      # the first call is the warm-up
            times.append(time.perf_counter() - t0)
    times.sort()
    return model.mesh.n_cells, times[len(times) // 2], t_compile


def main():
    import argparse
    from seaice_tpu.compile_cache import enable_compile_cache
    from seaice_tpu.utils.device import card_line, require_gpu

    ap = argparse.ArgumentParser()
    ap.add_argument("--subdiv", type=int, default=6)
    ap.add_argument("--subcycles", type=int, default=120)
    ap.add_argument("--mesh", default="panel",
                    choices=("panel", "icos", "voronoi"))
    args = ap.parse_args()
    device = require_gpu()
    enable_compile_cache()
    nc, dt_step, t_compile = measure(args.subdiv, args.subcycles,
                                     args.mesh)
    print(json.dumps({
        "metric": "global_full_physics_ms_per_step",
        "config": f"{args.mesh} subdiv={args.subdiv} ({nc} cells), "
                  "5 cat, 7 layers, mushy+dEdd+lvl ponds+Rothrock, EVP "
                  f"{args.subcycles} subcyc, full-tracer IR, ridging, f32",
        "ms_per_step": dt_step * 1e3,
        "compile_s": t_compile,
        "device": device,
        "card": card_line(),
    }))


if __name__ == "__main__":
    main()
