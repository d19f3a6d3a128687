#!/usr/bin/env python
"""Catch the column that fails BL99 convergence in the f32 5-day
file-driven gate: restart from the mid-run checkpoint, step with
per-step checks + cell dumps, and print the offending column."""
import argparse
import os
import sys

_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, _ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default=os.path.join(_ROOT, "runs",
                                                     "5day_files"))
    ap.add_argument("--subdiv", type=int, default=6)
    ap.add_argument("--f64", action="store_true")
    args = ap.parse_args()
    import jax
    if args.f64:
        jax.config.update("jax_enable_x64", True)
    import os as _os
    if _os.environ.get("JAX_PLATFORMS"):
        jax.config.update("jax_platforms",
                          _os.environ["JAX_PLATFORMS"].split(",")[0])
    import numpy as np
    import jax.numpy as jnp
    from seaice_tpu.config import (AdvectionConfig, AdvectionType,
                                   ColumnConfig, Config, RunConfig,
                                   VelocitySolverConfig)
    from seaice_tpu.forcing import ModelClock
    from seaice_tpu.io.checkpoint import load_checkpoint
    from seaice_tpu.io.forcing_reader import (core_atmos_from_files,
                                              ncar_ocean_from_file)
    from seaice_tpu.io.mesh_reader import read_mpas_mesh
    from seaice_tpu.model import SeaIceModel
    from seaice_tpu.run import RunStreams, StandaloneRunner
    from seaice_tpu.error import SeaIceAbort

    outdir = args.outdir
    mesh = read_mpas_mesh(os.path.join(
        outdir, f"mesh_icos{args.subdiv}.nc"))
    dtype = jnp.float64 if args.f64 else jnp.float32
    cfg = Config(
        run=RunConfig(dt=1800.0, n_categories=5, n_ice_layers=7),
        velocity=VelocitySolverConfig(
            elastic_subcycle_number=120,
            rotate_cartesian_grid=True, include_metric_terms=True,
            geostrophic_surface_tilt=False),
        advection=AdvectionConfig(
            advection_type=AdvectionType.INCREMENTAL_REMAP),
        column=ColumnConfig())
    model = SeaIceModel(mesh, cfg, dtype=dtype)
    state, meta = load_checkpoint(
        os.path.join(outdir, "restart_mid.npz"), dtype=dtype)
    atmos = core_atmos_from_files(
        os.path.join(outdir, "core_sixhourly.nc"),
        os.path.join(outdir, "core_monthly.nc"),
        mesh.lon_cell, mesh.lat_cell)
    ocean = ncar_ocean_from_file(os.path.join(outdir, "ocean.nc"))

    dump_dir = os.path.join(outdir, "thermo_debug")
    os.makedirs(dump_dir, exist_ok=True)
    runner = StandaloneRunner(
        model, state, atmos_forcing=atmos, ocean_forcing=ocean,
        streams=RunStreams(restart_dir=dump_dir))
    runner.clock = ModelClock(seconds=float(meta["clock_seconds"]))
    for k in range(130):
        try:
            runner.run(1, check_interval=1)
        except SeaIceAbort as e:
            print("abort at substep", k, runner.clock.timestamp())
            print(e)
            return
    print("no abort in 130 steps; timestamp",
          runner.clock.timestamp())


if __name__ == "__main__":
    main()
