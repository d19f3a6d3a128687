#!/usr/bin/env python
"""Exact repro of the unconverged BL99 column: run to the step before
the abort, derive the real forcing, monkeypatch temperature_changes
to capture its concrete (eager) inputs, and save them for analysis.

Usage:
  JAX_PLATFORMS=cpu python dev/repro_thermo_cell.py \
      --outdir runs/s4f64 --subdiv 4 --f64 --steps 87
"""
import argparse
import os
import sys

_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, _ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", default=os.path.join(_ROOT, "runs", "s4f64"))
    ap.add_argument("--subdiv", type=int, default=4)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--steps", type=int, default=87,
                    help="abort substep index (run steps-1 then probe)")
    ap.add_argument("--save", default=os.path.join(
        _ROOT, "runs", "thermo_cell_inputs.npz"))
    args = ap.parse_args()

    import jax
    if args.f64:
        jax.config.update("jax_enable_x64", True)
    if os.environ.get("JAX_PLATFORMS"):
        jax.config.update("jax_platforms",
                          os.environ["JAX_PLATFORMS"].split(",")[0])
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
    from seaice_tpu.run import StandaloneRunner

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

    runner = StandaloneRunner(model, state, atmos_forcing=atmos,
                              ocean_forcing=ocean)
    runner.clock = ModelClock(seconds=float(meta["clock_seconds"]))
    runner.run(args.steps - 1, check_interval=10 ** 9)
    print("pre-abort state at", runner.clock.timestamp())

    # -- replicate the device step's forcing derivation eagerly --
    from seaice_tpu.forcing.core import derive_atmos_fields
    from seaice_tpu.column.orbital import compute_coszen
    d = dtype
    sixh, monthly = atmos.raw_snapshot(runner.clock)
    sixh = {k: jnp.asarray(v, d) for k, v in sixh.items()}
    monthly = {k: jnp.asarray(v, d) for k, v in monthly.items()}
    ocn_raw = {k: jnp.asarray(v, d)
               for k, v in ocean.snapshot(runner.clock).items()}
    lon = jnp.asarray(atmos.lon, d)
    lat = jnp.asarray(atmos.lat, d)
    st = runner.state
    aicen = st.tracers["iceAreaCategory"]
    aice = aicen.sum(-1)
    tsfc = jnp.where(aice > 1e-11,
                     (st.tracers["surfaceTemperature"] * aicen
                      ).sum(-1) / jnp.maximum(aice, 1e-11), 0.0)
    sec = jnp.asarray(runner.clock.seconds_today, d)
    doy = jnp.asarray(float(runner.clock.day_of_year), d)
    atm_raw = derive_atmos_fields(
        sixh, monthly, lon, lat, aice, tsfc,
        ocn_raw["seaSurfaceTemperature"], sec, doy)
    coszen, _ = compute_coszen(lat, lon, doy, sec)
    atmf, ocnf = runner._column_forcing(atm_raw, ocn_raw,
                                        cfg.run.dt)

    # -- capture temperature_changes inputs eagerly --
    from seaice_tpu.column import bl99
    orig = bl99.temperature_changes
    captured = {}

    def capture(dt, rhoa, flw, potT, Qa, shcoef, lhcoef,
                fswsfc, fswint, Sswabs, Iswabs,
                hilyr, hslyr, zqin, zTin, zqsn, zTsn, zSin,
                Tsf, Tbot, einit, **kw):
        captured.update(dict(
            dt=np.asarray(dt), rhoa=np.asarray(rhoa),
            flw=np.asarray(flw), potT=np.asarray(potT),
            Qa=np.asarray(Qa), shcoef=np.asarray(shcoef),
            lhcoef=np.asarray(lhcoef), fswsfc=np.asarray(fswsfc),
            fswint=np.asarray(fswint), Sswabs=np.asarray(Sswabs),
            Iswabs=np.asarray(Iswabs), hilyr=np.asarray(hilyr),
            hslyr=np.asarray(hslyr), zqin=np.asarray(zqin),
            zTin=np.asarray(zTin), zqsn=np.asarray(zqsn),
            zTsn=np.asarray(zTsn), zSin=np.asarray(zSin),
            Tsf=np.asarray(Tsf), Tbot=np.asarray(Tbot),
            einit=np.asarray(einit)))
        return orig(dt, rhoa, flw, potT, Qa, shcoef, lhcoef,
                    fswsfc, fswint, Sswabs, Iswabs,
                    hilyr, hslyr, zqin, zTin, zqsn, zTsn, zSin,
                    Tsf, Tbot, einit, **kw)

    bl99.temperature_changes = capture
    import seaice_tpu.column.vertical as vert
    vert.temperature_changes = capture
    try:
        tr2, fluxes = model.column.step_thermodynamics(
            cfg.run.dt, dict(st.tracers), atmf, ocnf, coszen=coszen)
    finally:
        bl99.temperature_changes = orig
        vert.temperature_changes = orig
    warn = np.asarray(fluxes.warnings["thermo_unconverged"])
    bad = np.nonzero(warn.any(-1))[0]
    print("unconverged cells:", bad, "cats:",
          [np.nonzero(warn[b])[0] for b in bad])
    if len(bad) == 0:
        print("no failure reproduced at this substep")
        return
    np.savez(args.save, bad_cells=bad,
             bad_cats=np.nonzero(warn[bad[0]])[0],
             **captured)
    print("inputs ->", args.save)


if __name__ == "__main__":
    main()
