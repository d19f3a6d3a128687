#!/usr/bin/env python
"""The 5-day global standalone benchmark configuration.

The analog of the reference's headline config (5-day QU120km standalone
run, BASELINE.json configs[2]): full physics — column thermodynamics,
EVP (120 subcycles, variational/Wachspress), incremental-remapping
transport, ridging — on a quasi-uniform icosahedral mesh with
synthetic seasonal CORE-style forcing through the forcing subsystem and
the standalone run loop (output + restart streams + state checks).

Usage:
  python examples/run_5day_global.py --subdiv 6           # ~120 km, GPU
  JAX_PLATFORMS=cpu python examples/run_5day_global.py --subdiv 3 --days 1
"""

import argparse
import os
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)


def synthetic_core_forcing(mesh):
    """Synthetic CORE-style forcing: seasonal + latitude-dependent
    6-hourly atmosphere (16 records across the year, cyclic), monthly
    cloud/precip, and a fixed ocean.  Returns (atmos, ocean) for
    StandaloneRunner."""
    import numpy as np

    from seaice_tpu.forcing import ForcingSeries
    from seaice_tpu.forcing.core import (CoreAtmosForcing,
                                         NcarOceanForcing,
                                         monthly_times)

    nc = mesh.n_cells
    polar = np.abs(mesh.lat_cell) > np.deg2rad(65.0)
    lat = mesh.lat_cell
    lon = mesh.lon_cell
    n_samp = 16
    times = np.linspace(0.0, 365 * 86400.0, n_samp, endpoint=False)
    t_air = np.zeros((n_samp, nc))
    q = np.zeros((n_samp, nc))
    u_wind = np.zeros((n_samp, nc))
    v_wind = np.zeros((n_samp, nc))
    from seaice_tpu.mesh.rotation import latlon_vector_rotation_forward
    for i, tsec in enumerate(times):
        season = np.cos(2 * np.pi * (tsec / (365 * 86400.0) - 14 / 365))
        t_air[i] = 288.0 - 45.0 * np.sin(np.abs(lat)) ** 2 \
            - 12.0 * season * np.sin(lat)
        q[i] = np.clip(5e-3 * np.exp((t_air[i] - 288.0) / 12.0),
                       1e-4, 2e-2)
        u_t = 6.0 * np.cos(lat) + 2.0 * np.sin(
            2 * np.pi * tsec / (10 * 86400.0) + lon)
        v_t = 1.5 * np.sin(2 * lon + 2 * np.pi * tsec / (5 * 86400.0))
        u_wind[i], v_wind[i] = latlon_vector_rotation_forward(
            u_t, v_t, mesh.x_cell, mesh.y_cell, mesh.z_cell)
    six = ForcingSeries(times=times, fields={
        "airTemperature": t_air, "airSpecificHumidity": q,
        "uAirVelocity": u_wind, "vAirVelocity": v_wind})
    mon = ForcingSeries(times=monthly_times(), fields={
        "cloudFraction": np.tile(
            (0.5 + 0.3 * np.sin(np.abs(lat)))[None, :], (12, 1)),
        "precipitationRate": np.full((12, nc), 2e-6)})
    atmos = CoreAtmosForcing(six_hourly=six, monthly=mon, lon=lon,
                             lat=lat)
    sst = np.where(polar, -1.7, 8.0 + 14.0 * np.cos(lat) ** 2)
    ocean = NcarOceanForcing(ForcingSeries(
        times=np.array([0.0]),
        fields={"seaSurfaceTemperature": sst[None, :],
                "seaSurfaceSalinity": np.full((1, nc), 34.0),
                "seaFreezingTemperature": np.full((1, nc), -1.8),
                "oceanMixedLayerDepth": np.full((1, nc), 20.0),
                "uOceanVelocity": np.zeros((1, nc)),
                "vOceanVelocity": np.zeros((1, nc))}))
    return atmos, ocean


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--subdiv", type=int, default=5)
    ap.add_argument("--days", type=float, default=5.0)
    ap.add_argument("--subcycles", type=int, default=120)
    ap.add_argument("--dt", type=float, default=1800.0)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--outdir", default=os.path.join(_ROOT, "runs",
                                                     "5day_global"))
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
    from seaice_tpu.column.thermo_shared import (
        ice_enthalpy_from_temperature, melting_temperature,
        salinity_profile, snow_enthalpy_from_temperature)
    from seaice_tpu.io.output import OutputStream
    from seaice_tpu.mesh import icosahedral_mesh
    from seaice_tpu.model import SeaIceModel
    from seaice_tpu.run import RunStreams, StandaloneRunner
    from seaice_tpu.utils.pytree import replace

    dtype = jnp.float64 if args.f64 else jnp.float32
    t0 = time.perf_counter()
    mesh = icosahedral_mesh(args.subdiv)
    print(f"mesh: {mesh.n_cells} cells "
          f"(~{np.sqrt(mesh.area_cell.mean())/1e3:.0f} km) in "
          f"{time.perf_counter()-t0:.1f}s")

    cfg = Config(
        run=RunConfig(dt=args.dt, n_categories=5, n_ice_layers=7),
        velocity=VelocitySolverConfig(
            elastic_subcycle_number=args.subcycles,
            rotate_cartesian_grid=True, include_metric_terms=True,
            geostrophic_surface_tilt=False),
        advection=AdvectionConfig(
            advection_type=AdvectionType.INCREMENTAL_REMAP),
        column=ColumnConfig())
    t0 = time.perf_counter()
    model = SeaIceModel(mesh, cfg, dtype=dtype)
    print(f"tensors in {time.perf_counter()-t0:.1f}s")

    # initial polar ice
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

    atmos, ocean = synthetic_core_forcing(mesh)

    os.makedirs(args.outdir, exist_ok=True)
    out = OutputStream(os.path.join(args.outdir, "output.nc"),
                       {"nCells": nc, "nVertices": mesh.n_vertices})
    runner = StandaloneRunner(
        model, state, atmos_forcing=atmos, ocean_forcing=ocean,
        streams=RunStreams(output=out, output_interval=86400.0,
                           restart_dir=args.outdir,
                           restart_interval=5 * 86400.0))

    n = int(args.days * 86400 / args.dt)
    print(f"running {n} steps ({args.days} days)...")
    t0 = time.perf_counter()
    state = runner.run(n, check_interval=24)
    wall = time.perf_counter() - t0
    out.flush()

    a = np.asarray(state.tracers["iceAreaCategory"]).sum(-1)
    v = np.asarray(state.tracers["iceVolumeCategory"]).sum(-1)
    u = np.asarray(state.velocity.u_velocity)
    import jax as _jax
    print(f"done in {wall:.1f}s wall "
          f"({wall/n*1e3:.1f} ms/step incl. host loop; "
          f"{mesh.n_cells*args.subcycles*n/wall/1e6:.1f} "
          f"Mcell-subcyc/s)")
    print(runner.timers.report())
    print(f"final: aice max {a.max():.3f}, total volume "
          f"{(v*mesh.area_cell).sum()/1e12:.2f} thousand km^3, "
          f"max|u| {np.abs(u).max():.3f} m/s")
    assert np.isfinite(a).all() and np.abs(u).max() < 1.5
    print("5-day global run OK")


if __name__ == "__main__":
    main()
