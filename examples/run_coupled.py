"""Coupled-driver demo: drive the ice model through the NUOPC-style
import/export surface (the reference's ice_comp_mct/ice_comp_nuopc
role, driver/ice_comp_mct.F:1004).

A toy "coupler" supplies atmosphere/ocean fields each coupling
interval; the ice model sub-cycles its own dt inside one jitted scan
and returns interval-mean fluxes.

    JAX_PLATFORMS=cpu python examples/run_coupled.py --hours 6
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np


def toy_import_fields(nc, seed=0):
    """One couple interval of coupler imports (NUOPC names): a cold,
    windy atmosphere over a near-freezing ocean."""
    rng = np.random.default_rng(seed)
    return {
        "So_t": np.full(nc, -1.6), "So_s": np.full(nc, 32.0),
        "Sa_u": 6.0 + rng.standard_normal(nc),
        "Sa_v": 2.0 + rng.standard_normal(nc),
        "Sa_ptem": np.full(nc, 258.0), "Sa_shum": np.full(nc, 8e-4),
        "Sa_dens": np.full(nc, 1.3),
        "Faxa_lwdn": np.full(nc, 200.0),
        "Faxa_swvdr": np.full(nc, 30.0),
        "Faxa_swvdf": np.full(nc, 20.0),
        "Faxa_swndr": np.full(nc, 25.0),
        "Faxa_swndf": np.full(nc, 15.0),
        "Faxa_rain": np.zeros(nc), "Faxa_snow": np.full(nc, 1e-8),
    }


def coupled_box_model(nx=12, dtype=None):
    """The demo's model: the EVP box (40 subcycles) with the column
    package on, and its initial state."""
    import dataclasses

    import jax.numpy as jnp

    from seaice_tpu.config import box_test_config
    from seaice_tpu.model import SeaIceModel
    from seaice_tpu.testcases import box

    cfg = box_test_config(elastic_subcycles=40)
    cfg = dataclasses.replace(cfg, column=dataclasses.replace(
        cfg.column, use_column_package=True))
    mesh = box.box_test_mesh(nx, nx)
    mesh.f_vertex = box.box_coriolis_parameter(mesh)
    model = SeaIceModel(mesh, cfg, dtype=jnp.float64 if dtype is None
                        else dtype)
    area, vol, snow = box.box_initial_state(mesh, n_categories=1)
    return model, model.init_state(area, vol, snow)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=12)
    ap.add_argument("--hours", type=float, default=6.0)
    ap.add_argument("--couple-interval", type=float, default=3600.0)
    args = ap.parse_args()

    from seaice_tpu.compile_cache import enable_compile_cache
    from seaice_tpu.coupled import CoupledDriver

    enable_compile_cache()
    model, state = coupled_box_model(args.nx)
    mesh = model.mesh

    drv = CoupledDriver(model, state,
                        coupling_interval=args.couple_interval)
    imports, exports = drv.advertise()
    print(f"advertised {len(imports)} import / {len(exports)} export "
          f"fields; {drv.n_substeps} substeps per couple interval")

    fields = toy_import_fields(mesh.n_cells)

    n_couples = int(args.hours * 3600.0 / args.couple_interval)
    for i in range(n_couples):
        out = drv.advance(fields)
        print(f"couple step {i + 1}/{n_couples} t={drv.clock.seconds/3600:5.1f} h  "
              f"aice_max={out['Si_ifrac'].max():.3f}  "
              f"sen={out['Faii_sen'].mean():7.2f} W/m2  "
              f"melth={out['Fioi_melth'].mean():7.2f} W/m2  "
              f"|tau|={np.hypot(out['Fioi_taux'], out['Fioi_tauy']).max():.3f}")
    print("done")


if __name__ == "__main__":
    main()
