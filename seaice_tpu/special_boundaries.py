"""Special boundaries: test-harness Dirichlet overrides.

JAX re-design of `mpas_seaice_special_boundaries.F` (init :61,
setters :253-415): masked overrides of velocity and tracer values at
marked vertices/cells, applied after each solve/advection step.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import jax.numpy as jnp

from .utils.pytree import pytree_dataclass


@pytree_dataclass
class SpecialBoundaries:
    """Dirichlet boundary description (device arrays)."""
    vertex_mask: Any       # [nVertices] {0,1}: override velocity here
    u_value: Any           # [nVertices]
    v_value: Any
    cell_mask: Any         # [nCells] {0,1}: override tracers here
    tracer_values: Dict[str, Any]   # name -> [nCells, ...] target values


def no_special_boundaries(n_vertices: int, n_cells: int,
                          dtype=jnp.float64) -> SpecialBoundaries:
    return SpecialBoundaries(
        vertex_mask=jnp.zeros((n_vertices,), dtype),
        u_value=jnp.zeros((n_vertices,), dtype),
        v_value=jnp.zeros((n_vertices,), dtype),
        cell_mask=jnp.zeros((n_cells,), dtype),
        tracer_values={})


def apply_velocity_boundaries(sb: SpecialBoundaries, u, v):
    """(reference seaice_set_special_boundaries_velocity :253)"""
    m = sb.vertex_mask > 0
    return jnp.where(m, sb.u_value, u), jnp.where(m, sb.v_value, v)


def apply_tracer_boundaries(sb: SpecialBoundaries,
                            tracers: Dict[str, Any]) -> Dict[str, Any]:
    """(reference seaice_set_special_boundaries_tracers :345)"""
    out = dict(tracers)
    for name, target in sb.tracer_values.items():
        if name not in out:
            continue
        cur = out[name]
        m = sb.cell_mask
        m = m.reshape(m.shape + (1,) * (cur.ndim - m.ndim)) > 0
        out[name] = jnp.where(m, target, cur)
    return out
