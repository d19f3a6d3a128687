#!/usr/bin/env python
"""Global coupled demo: column thermodynamics + EVP dynamics + transport
on a quasi-uniform icosahedral mesh with idealized forcing.

Usage:
  python examples/run_global.py --subdiv 4 --days 1      # GPU default
  JAX_PLATFORMS=cpu python examples/run_global.py --subdiv 3 --days 0.25
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--subdiv", type=int, default=4)
    ap.add_argument("--days", type=float, default=1.0)
    ap.add_argument("--subcycles", type=int, default=120)
    ap.add_argument("--f64", action="store_true")
    args = ap.parse_args()

    import jax
    from seaice_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()
    if args.f64:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from seaice_tpu.config import (AdvectionConfig, AdvectionType,
                                   ColumnConfig, Config, RunConfig,
                                   VelocitySolverConfig)
    from seaice_tpu.column import (AtmosForcing, OceanForcing,
                                   slab_ocean_frzmlt)
    from seaice_tpu.column.thermo_shared import (
        ice_enthalpy_from_temperature, melting_temperature,
        salinity_profile, snow_enthalpy_from_temperature)
    from seaice_tpu.dynamics.evp import DynamicsForcing
    from seaice_tpu.mesh import (icosahedral_mesh,
                                 latlon_vector_rotation_forward)
    from seaice_tpu.model import SeaIceModel
    from seaice_tpu.utils.pytree import replace

    dtype = jnp.float64 if args.f64 else jnp.float32
    t0 = time.perf_counter()
    mesh = icosahedral_mesh(args.subdiv)
    print(f"mesh: {mesh.n_cells} cells "
          f"(~{np.sqrt(mesh.area_cell.mean())/1e3:.0f} km), "
          f"built in {time.perf_counter()-t0:.1f}s")

    cfg = Config(
        run=RunConfig(dt=1800.0, n_categories=5, n_ice_layers=7),
        velocity=VelocitySolverConfig(
            elastic_subcycle_number=args.subcycles,
            rotate_cartesian_grid=True, include_metric_terms=True,
            geostrophic_surface_tilt=False),
        advection=AdvectionConfig(advection_type=AdvectionType.UPWIND),
        column=ColumnConfig())
    t0 = time.perf_counter()
    model = SeaIceModel(mesh, cfg, dtype=dtype)
    print(f"tensors built in {time.perf_counter()-t0:.1f}s")

    # polar ice caps across the thinner categories
    nc, ncat, ni, ns = mesh.n_cells, 5, 7, 1
    polar = np.abs(mesh.lat_cell) > np.deg2rad(60.0)
    h = model.column.hin_max
    mids = 0.5 * (h[:-1] + np.minimum(h[1:], 10.0))
    area = np.where(polar[:, None], 0.95 / ncat, 0.0) * np.ones((1, ncat))
    vol = area * mids
    state = model.init_state(area, vol, area * 0.05)
    S = salinity_profile(ni)
    has = area[..., None] > 0
    tr = dict(state.tracers)
    tr["surfaceTemperature"] = jnp.asarray(
        np.where(area > 0, -15.0, 0.0), dtype)
    tr["iceEnthalpy"] = ice_enthalpy_from_temperature(
        jnp.asarray(np.where(has, -10.0, 0.0) * np.ones((nc, ncat, ni)),
                    dtype),
        melting_temperature(jnp.asarray(np.tile(S, (nc, ncat, 1)),
                                        dtype))) * has
    tr["iceSalinity"] = jnp.asarray(np.tile(S, (nc, ncat, 1)), dtype) * \
        has
    tr["snowEnthalpy"] = snow_enthalpy_from_temperature(
        jnp.asarray(-12.0 * np.ones((nc, ncat, ns)), dtype)) * has
    state = replace(state, tracers=tr)

    # idealized forcing: zonal wind + polar-night atmosphere
    u_t = 6.0 * np.cos(mesh.lat_cell)
    v_t = np.zeros(nc)
    u_rot, v_rot = latlon_vector_rotation_forward(
        u_t, v_t, mesh.x_cell, mesh.y_cell, mesh.z_cell)
    z = jnp.zeros((nc,), dtype)
    forcing = DynamicsForcing(
        u_air_velocity=jnp.asarray(u_rot, dtype),
        v_air_velocity=jnp.asarray(v_rot, dtype),
        air_density=jnp.full((nc,), 1.3, dtype),
        u_ocean_velocity=z, v_ocean_velocity=z,
        sea_surface_tilt_u=z, sea_surface_tilt_v=z, land_ice_mask=z)
    one = jnp.ones((nc,), dtype)
    t_air = jnp.asarray(np.where(polar, 250.0, 280.0), dtype)
    atm = AtmosForcing(
        air_temperature=t_air, specific_humidity=0.0005 * one,
        u_air=forcing.u_air_velocity, v_air=forcing.v_air_velocity,
        longwave_down=jnp.asarray(np.where(polar, 170.0, 320.0), dtype),
        sw_vis_dir=10.0 * one, sw_vis_dif=10.0 * one,
        sw_ir_dir=8.0 * one, sw_ir_dif=8.0 * one,
        rain_rate=0.0 * one, snow_rate=1e-5 * one,
        air_density=1.3 * one, air_level_height=10.0 * one)
    sst = jnp.asarray(np.where(polar, -1.7, 10.0), dtype)
    Tf = -1.8 * one
    ocn = OceanForcing(
        sst=sst, sss=34.0 * one, freezing_temperature=Tf,
        frzmlt=slab_ocean_frzmlt(sst, Tf, 20.0 * one, cfg.run.dt),
        mixed_layer_depth=20.0 * one)

    step = model.make_step()
    s, _ = step(model.tensors, state, forcing, atm, ocn)
    print("compiled in", round(time.perf_counter() - t0, 1), "s")
    float(jnp.abs(s.velocity.u_velocity).max())

    n = int(args.days * 86400 / cfg.run.dt)
    t0 = time.perf_counter()
    for i in range(n):
        s, diags = step(model.tensors, s, forcing, atm, ocn)
    umax = float(jnp.abs(s.velocity.u_velocity).max())
    wall = time.perf_counter() - t0
    a = np.asarray(s.tracers["iceAreaCategory"]).sum(-1)
    v = np.asarray(s.tracers["iceVolumeCategory"]).sum(-1)
    fx = diags["column_fluxes"]
    print(f"{n} steps ({args.days} days) in {wall:.1f}s "
          f"({wall/n*1e3:.1f} ms/step; "
          f"{mesh.n_cells*args.subcycles*n/wall/1e6:.1f} "
          f"Mcell-subcyc/s)")
    print(f"max|u| = {umax:.3f} m/s, aice in [{a.min():.3f}, "
          f"{a.max():.3f}], mean polar h = "
          f"{v[polar].sum()/max(a[polar].sum(),1e-9):.2f} m")
    print(f"congel total = {float(fx.congel.sum()):.3e} m, "
          f"frazil = {float(fx.frazil.sum()):.3e} m")
    assert np.isfinite(a).all() and umax < 1.5
    print("global run OK")


if __name__ == "__main__":
    main()
