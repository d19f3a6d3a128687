#!/usr/bin/env python
"""Run the EVP box test and report simple diagnostics.

Usage: JAX_PLATFORMS=cpu python examples/run_box_test.py --nx 20 --hours 2
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=20)
    ap.add_argument("--hours", type=float, default=2.0)
    ap.add_argument("--subcycles", type=int, default=120)
    ap.add_argument("--hex", action="store_true", dest="hex_mesh")
    ap.add_argument("--f32", action="store_true")
    args = ap.parse_args()

    import jax
    from seaice_tpu.compile_cache import enable_compile_cache
    enable_compile_cache()
    if not args.f32:
        jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from seaice_tpu.config import box_test_config
    from seaice_tpu.dynamics.evp import (
        build_dynamics_tensors, init_velocity_state, make_velocity_solver)
    from seaice_tpu.testcases import (
        box_test_mesh, box_forcing, box_initial_state,
        box_coriolis_parameter)

    dtype = jnp.float32 if args.f32 else jnp.float64
    mesh = box_test_mesh(nx=args.nx, ny=args.nx, hex_mesh=args.hex_mesh)
    mesh.f_vertex = box_coriolis_parameter(mesh)
    cfg = box_test_config(elastic_subcycles=args.subcycles)

    t0 = time.time()
    dyn = build_dynamics_tensors(mesh, cfg, dtype=dtype)
    print(f"init: {mesh.n_cells} cells, basis precompute "
          f"{time.time()-t0:.2f}s")

    step = jax.jit(make_velocity_solver(cfg, dyn))
    area, vol, snow = map(jnp.asarray, box_initial_state(mesh))
    state = init_velocity_state(mesh, dtype=dtype)

    n_steps = int(args.hours * 3600 / cfg.run.dt)
    t0 = time.time()
    for i in range(n_steps):
        forcing = box_forcing(mesh, i * cfg.run.dt, dtype=dtype)
        state, diags = step(state, forcing, area, vol, snow)
        if i == 0:
            jax.block_until_ready(state)
            print(f"first step (incl. compile): {time.time()-t0:.2f}s")
            t0 = time.time()
    jax.block_until_ready(state)
    elapsed = time.time() - t0
    per_step = elapsed / max(n_steps - 1, 1)

    u = np.asarray(state.u_velocity)
    v = np.asarray(state.v_velocity)
    speed = np.hypot(u, v)
    print(f"{n_steps} steps, {per_step*1e3:.1f} ms/step, "
          f"{mesh.n_cells * args.subcycles / per_step:.3g} "
          "cells*subcycles/s")
    print(f"max ice speed: {speed.max():.4f} m/s  "
          f"mean: {speed.mean():.4f} m/s  finite: {np.isfinite(u).all()}")


if __name__ == "__main__":
    main()
