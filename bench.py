"""Benchmark: EVP velocity solve on the planar box test at a QU120km-like
cell count (168 x 168 = 28,224 cells, 120 elastic subcycles, f32).

Run on the GPU:

    python bench.py

It refuses to run without a GPU and prints ONE JSON line: steady
ms/step and cells*subcycles/s (host clock around `block_until_ready`,
after a warm-up step), with the device JAX reports and the card's name
and power limit.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)


def measure(nx, n_subcycles, n_steps=20):
    """(n_cells, steady seconds per step, compile seconds)."""
    import jax
    import jax.numpy as jnp

    from seaice_tpu.config import box_test_config
    from seaice_tpu.mesh.structured import raster_reorder
    from seaice_tpu.model import SeaIceModel
    from seaice_tpu.testcases import box

    dtype = jnp.float32
    cfg = box_test_config(elastic_subcycles=n_subcycles)
    # raster vertex order enables the structured (shift-based) EVP
    # kernels on the regular grid
    mesh = raster_reorder(box.box_test_mesh(nx, nx))
    mesh.f_vertex = box.box_coriolis_parameter(mesh)
    model = SeaIceModel(mesh, cfg, dtype=dtype)
    area, vol, snow = box.box_initial_state(mesh, n_categories=1)
    state = model.init_state(area, vol, snow)
    forcing = box.box_forcing(mesh, t=0.0, dtype=dtype)

    step = model.make_step()
    t0 = time.perf_counter()
    compiled = step.lower(model.tensors, state, forcing).compile()
    t_compile = time.perf_counter() - t0
    times = []
    s = state
    for i in range(n_steps + 1):
        t0 = time.perf_counter()
        s, _ = compiled(model.tensors, s, forcing)
        jax.block_until_ready(s)
        if i:                      # the first call is the warm-up
            times.append(time.perf_counter() - t0)
    times.sort()
    return mesh.n_cells, times[len(times) // 2], t_compile


def main():
    from seaice_tpu.compile_cache import enable_compile_cache
    from seaice_tpu.utils.device import card_line, require_gpu

    device = require_gpu()
    enable_compile_cache()
    nx = 168                           # 28,224 cells ~ QU120km ocean count
    n_subcycles = 120                  # reference default (Registry:579-582)
    nc, dt_step, t_compile = measure(nx, n_subcycles)
    print(json.dumps({
        "metric": "evp_box_ms_per_step",
        "config": f"planar box {nx}x{nx} ({nc} cells), EVP "
                  f"{n_subcycles} subcycles, f32",
        "ms_per_step": dt_step * 1e3,
        "cells_subcycles_per_s": nc * n_subcycles / dt_step,
        "compile_s": t_compile,
        "device": device,
        "card": card_line(),
    }))


if __name__ == "__main__":
    main()
