#!/usr/bin/env python
"""The file-driven 5-day run at QU120km scale (BASELINE configs[2]).

Everything comes from files, none of them written by `seaice_tpu`'s own
writers: the mesh is an MPAS-convention NetCDF file produced by the
independent ConvexHull-based generator (`tests/mpas_fixture.py` —
exact reference naming / dims / 1-based connectivity,
`/root/reference/src/Registry.xml:5-120`), and the atmosphere/ocean
forcing are CORE-layout NetCDF files written here with plain scipy
netcdf calls.  The whole path is file -> mesh reader -> forcing reader
-> StandaloneRunner -> restart, the feasible analog of the reference's
5-day QU120km gate (`/root/reference/testing_and_setup/testing/
README.rst:60-76`; the Fortran reference itself is unbuildable in this
image — no gfortran/mpif90).

Usage:
  python examples/run_5day_from_files.py                   # subdiv 6 ~ QU120km count
  JAX_PLATFORMS=cpu python examples/run_5day_from_files.py --subdiv 3 --days 0.5
  python examples/run_5day_from_files.py --verify-restart  # + bitwise restart gate
"""

import argparse
import os
import sys
import time

_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, _ROOT)


def write_forcing_files(outdir, mesh):
    """CORE-layout 6-hourly + monthly atmosphere and NCAR monthly ocean
    files, written with plain scipy netcdf (not seaice_tpu writers)."""
    import numpy as np
    from scipy.io import netcdf_file

    nc = mesh.n_cells
    lat, lon = mesh.lat_cell, mesh.lon_cell

    def write(path, times, fields):
        f = netcdf_file(path, "w")
        f.createDimension("Time", len(times))
        f.createDimension("nCells", nc)
        v = f.createVariable("xtime_seconds", "d", ("Time",))
        v[:] = times
        for k, a in fields.items():
            v = f.createVariable(k, "d", ("Time", "nCells"))
            v[:] = a
        f.close()

    # 6-hourly atmosphere across the year (16 sample times, cyclic)
    n_samp = 16
    t6 = np.linspace(0.0, 365 * 86400.0, n_samp, endpoint=False)
    t_air = np.zeros((n_samp, nc))
    q = np.zeros((n_samp, nc))
    u_wind = np.zeros((n_samp, nc))
    v_wind = np.zeros((n_samp, nc))
    from seaice_tpu.mesh.rotation import latlon_vector_rotation_forward
    for i, tsec in enumerate(t6):
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
    six_path = os.path.join(outdir, "core_sixhourly.nc")
    write(six_path, t6, {
        "airTemperature": t_air, "airSpecificHumidity": q,
        "uAirVelocity": u_wind, "vAirVelocity": v_wind})

    tm = (np.arange(12) + 0.5) * (365.0 * 86400.0 / 12)
    mon_path = os.path.join(outdir, "core_monthly.nc")
    write(mon_path, tm, {
        "cloudFraction": np.tile(
            (0.5 + 0.3 * np.sin(np.abs(lat)))[None, :], (12, 1)),
        "rainfallRate": np.full((12, nc), 2e-6)})

    polar = np.abs(lat) > np.deg2rad(65.0)
    sst = np.where(polar, -1.7, 8.0 + 14.0 * np.cos(lat) ** 2)
    ocn_path = os.path.join(outdir, "ocean.nc")
    write(ocn_path, tm, {
        "seaSurfaceTemperature": np.tile(sst[None, :], (12, 1)),
        "seaSurfaceSalinity": np.full((12, nc), 34.0),
        "uOceanVelocity": np.zeros((12, nc)),
        "vOceanVelocity": np.zeros((12, nc)),
        "oceanMixedLayerDepth": np.full((12, nc), 20.0)})
    return six_path, mon_path, ocn_path


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--subdiv", type=int, default=6)
    ap.add_argument("--days", type=float, default=5.0)
    ap.add_argument("--subcycles", type=int, default=120)
    ap.add_argument("--dt", type=float, default=1800.0)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--outdir", default=os.path.join(_ROOT, "runs",
                                                     "5day_files"))
    ap.add_argument("--verify-restart", action="store_true",
                    help="rerun the second half from the mid-run "
                    "restart file and require bitwise equality")
    ap.add_argument("--save-final", default=None,
                    help="write the final prognostic state to this "
                    ".npz (for precision/trajectory comparisons)")
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
    from seaice_tpu.io.checkpoint import load_checkpoint, save_checkpoint
    from seaice_tpu.io.forcing_reader import (core_atmos_from_files,
                                              ncar_ocean_from_file)
    from seaice_tpu.io.mesh_reader import read_mpas_mesh
    from seaice_tpu.model import SeaIceModel
    from seaice_tpu.namelist import RunSetup, initial_state_from_setup
    from seaice_tpu.run import StandaloneRunner

    os.makedirs(args.outdir, exist_ok=True)
    dtype = jnp.float64 if args.f64 else jnp.float32

    # -- mesh file: generate once with the independent generator, then
    #    always READ it back through the MPAS reader
    mesh_path = os.path.join(args.outdir, f"mesh_icos{args.subdiv}.nc")
    if not os.path.exists(mesh_path):
        sys.path.insert(0, os.path.join(_ROOT, "tests"))
        from mpas_fixture import write_icosahedral_mpas_file
        t0 = time.perf_counter()
        write_icosahedral_mpas_file(mesh_path, subdiv=args.subdiv)
        print(f"mesh file generated in {time.perf_counter()-t0:.1f}s")
    t0 = time.perf_counter()
    mesh = read_mpas_mesh(mesh_path)
    print(f"mesh read: {mesh.n_cells} cells "
          f"(~{np.sqrt(mesh.area_cell.mean())/1e3:.0f} km) in "
          f"{time.perf_counter()-t0:.1f}s")

    # -- forcing files (regenerated if absent), read via the readers
    six_path = os.path.join(args.outdir, "core_sixhourly.nc")
    if not os.path.exists(six_path):
        write_forcing_files(args.outdir, mesh)
    atmos = core_atmos_from_files(
        six_path, os.path.join(args.outdir, "core_monthly.nc"),
        mesh.lon_cell, mesh.lat_cell)
    ocean = ncar_ocean_from_file(os.path.join(args.outdir, "ocean.nc"))

    cfg = Config(
        run=RunConfig(dt=args.dt, n_categories=5, n_ice_layers=7),
        velocity=VelocitySolverConfig(
            elastic_subcycle_number=args.subcycles,
            rotate_cartesian_grid=True, include_metric_terms=True,
            geostrophic_surface_tilt=False),
        advection=AdvectionConfig(
            advection_type=AdvectionType.INCREMENTAL_REMAP),
        column=ColumnConfig())
    setup = RunSetup(initial_condition_type="cice_default",
                     initial_latitude_north=65.0,
                     initial_latitude_south=-65.0)

    def build():
        model = SeaIceModel(mesh, cfg, dtype=dtype)
        state = initial_state_from_setup(model, setup)
        return model, state

    t0 = time.perf_counter()
    model, state = build()
    print(f"tensors in {time.perf_counter()-t0:.1f}s")

    n = int(args.days * 86400 / args.dt)
    n_half = n // 2
    runner = StandaloneRunner(model, state, atmos_forcing=atmos,
                              ocean_forcing=ocean)
    print(f"running {n} steps ({args.days} days) from files...")
    t0 = time.perf_counter()
    state_mid = runner.run(n_half, check_interval=24)
    ckpt = os.path.join(args.outdir, "restart_mid.npz")
    save_checkpoint(ckpt, state_mid,
                    {"clock_seconds": runner.clock.seconds})
    state = runner.run(n - n_half, check_interval=24)
    wall = time.perf_counter() - t0

    a = np.asarray(state.tracers["iceAreaCategory"]).sum(-1)
    v = np.asarray(state.tracers["iceVolumeCategory"]).sum(-1)
    u = np.asarray(state.velocity.u_velocity)
    print(f"done in {wall:.1f}s wall "
          f"({wall/n*1e3:.1f} ms/step incl. host loop; "
          f"{mesh.n_cells*args.subcycles*n/wall/1e6:.1f} "
          f"Mcell-subcyc/s)")
    print(runner.timers.report())
    print(f"final: aice max {a.max():.3f}, total volume "
          f"{(v*mesh.area_cell).sum()/1e12:.2f} thousand km^3, "
          f"max|u| {np.abs(u).max():.3f} m/s")
    assert np.isfinite(a).all() and np.abs(u).max() < 1.5
    if args.save_final:
        np.savez(args.save_final,
                 u_velocity=np.asarray(state.velocity.u_velocity),
                 v_velocity=np.asarray(state.velocity.v_velocity),
                 **{k: np.asarray(v_)
                    for k, v_ in state.tracers.items()})
        print(f"final state -> {args.save_final}")

    if args.verify_restart:
        state_r, meta = load_checkpoint(ckpt)
        model2 = SeaIceModel(mesh, cfg, dtype=dtype)
        runner2 = StandaloneRunner(model2, state_r,
                                   atmos_forcing=atmos,
                                   ocean_forcing=ocean)
        runner2.clock.seconds = float(meta["clock_seconds"])
        state_b = runner2.run(n - n_half, check_interval=24)
        for k in state.tracers:
            np.testing.assert_array_equal(
                np.asarray(state.tracers[k]),
                np.asarray(state_b.tracers[k]), err_msg=k)
        np.testing.assert_array_equal(
            np.asarray(state.velocity.u_velocity),
            np.asarray(state_b.velocity.u_velocity))
        print("restart bitwise OK")
    print("5-day file-driven run OK")


if __name__ == "__main__":
    main()
