"""Variational kernels in the transposed (cell-minor) layout.

The straightforward [nCells, maxEdges] layout puts the tiny corner axis
(6-7) minor-most and issues one gather per field. This path:

  * keeps all corner fields as [maxEdges, nCells], so the long cell
    axis is the contiguous one for elementwise work and contractions;
  * stacks fields before gathering (one [*, 2]-stacked gather instead
    of one gather per field);
  * elides the spherical metric-term arithmetic at trace time on
    planar meshes.

Numerics are identical to variational.py (same sums, same masking);
the EVP subcycle loop carries stresses in the transposed layout and
transposes only at loop entry/exit.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import jax.numpy as jnp

from ..mesh.core import Mesh, MeshTensors
from ..utils.pytree import pytree_dataclass
from .. import constants as c


@pytree_dataclass
class FastTensors:
    """Transposed static tensors for the subcycle kernels."""
    voc_T: Any            # [me, nc] vertex index per corner
    voc_mask_T: Any       # [me, nc]
    basis_grad_T: Any     # [me(b), 2, me(g), nc] d(basis_b)/dx|dy at g
    basis_int_T: Any      # [me(s), 2, me(j), nc] integrals u|v
    basis_metric_T: Any   # [me(s), me(j), nc]
    flat_corner_idx: Any  # [vd, nv] = cov*me + cva (flattened corner id)
    cov_mask_T: Any       # [vd, nv]
    denominator: Any      # [nv]
    tan_lat_vertex: Any   # [nv]


def build_fast_tensors(mesh: Mesh, basis, dtype=jnp.float32) -> FastTensors:
    """Transpose the precomputed basis tensors (host-side numpy)."""
    me = mesh.max_edges
    nv = mesh.n_vertices
    ne_mask = (np.arange(me)[None, :] <
               mesh.n_edges_on_cell[:, None]) & \
        (mesh.vertices_on_cell >= 0)
    voc = np.where(ne_mask, mesh.vertices_on_cell, 0)

    bg = np.stack([basis.basis_gradient_u, basis.basis_gradient_v],
                  axis=2)                   # [nc, me(b), 2, me(g)]
    bi = np.stack([basis.basis_integrals_u, basis.basis_integrals_v],
                  axis=2)

    cov_valid = mesh.cells_on_vertex >= 0
    cva_valid = mesh.cell_vertices_at_vertex >= 0
    ok = cov_valid & cva_valid
    cov = np.where(ok, mesh.cells_on_vertex, 0)
    cva = np.where(ok, mesh.cell_vertices_at_vertex, 0)
    flat = cov * me + cva

    return FastTensors(
        voc_T=jnp.asarray(voc.T, jnp.int32),
        voc_mask_T=jnp.asarray(ne_mask.T, dtype),
        basis_grad_T=jnp.asarray(np.transpose(bg, (1, 2, 3, 0)), dtype),
        basis_int_T=jnp.asarray(np.transpose(bi, (1, 2, 3, 0)), dtype),
        basis_metric_T=jnp.asarray(
            np.transpose(basis.basis_integrals_metric, (1, 2, 0)),
            dtype),
        flat_corner_idx=jnp.asarray(flat.T, jnp.int32),
        cov_mask_T=jnp.asarray(ok.T, dtype),
        denominator=jnp.asarray(basis.variational_denominator, dtype),
        tan_lat_vertex=jnp.asarray(basis.tan_lat_vertex_over_radius,
                                   dtype),
    )


def strain_tensor_T(ft: FastTensors, u, v, include_metric: bool = False):
    """Strain at cell corners, transposed layout.
    Returns (e11, e22, e12) each [me, nc]."""
    uv = jnp.stack([u, v], axis=-1)            # [nv, 2]
    g = uv[ft.voc_T] * ft.voc_mask_T[..., None]  # [me, nc, 2]
    u_c = g[..., 0]                            # [me(b), nc]
    v_c = g[..., 1]
    # e[g, c] = sum_b vel[b, c] * grad[b, d, g, c]
    gx = ft.basis_grad_T[:, 0]                 # [me(b), me(g), nc]
    gy = ft.basis_grad_T[:, 1]
    e11 = (u_c[:, None, :] * gx).sum(0)        # [me(g), nc]
    e22 = (v_c[:, None, :] * gy).sum(0)
    e12 = 0.5 * ((u_c[:, None, :] * gy).sum(0) +
                 (v_c[:, None, :] * gx).sum(0))
    if include_metric:
        tl = ft.tan_lat_vertex[ft.voc_T] * ft.voc_mask_T
        e11 = e11 - v_c * tl
        e12 = e12 + 0.5 * u_c * tl
    return e11, e22, e12


def stress_divergence_T(ft: FastTensors, s11, s22, s12, solve_velocity,
                        include_metric: bool = False):
    """Stress divergence at vertices from transposed corner stresses
    [me, nc]. Returns (div_u, div_v) [nv]."""
    bu = ft.basis_int_T[:, 0]                  # [me(s), me(j), nc]
    bv = ft.basis_int_T[:, 1]
    pu = (s11[:, None, :] * bu).sum(0) + (s12[:, None, :] * bv).sum(0)
    pv = (s22[:, None, :] * bv).sum(0) + (s12[:, None, :] * bu).sum(0)
    if include_metric:
        mu = (s12[:, None, :] * ft.basis_metric_T).sum(0)
        mv = (s11[:, None, :] * ft.basis_metric_T).sum(0)
        tl = ft.tan_lat_vertex[None, :]
        # stack (pu + mu*tl-at-vertex later, pv, mu, mv) -> gather once
        stacked = jnp.stack([pu, pv, mu, mv], axis=-1)  # [me(j), nc, 4]
    else:
        stacked = jnp.stack([pu, pv], axis=-1)          # [me(j), nc, 2]
    flat = jnp.moveaxis(stacked, 0, 1).reshape(
        (stacked.shape[1] * stacked.shape[0],) + stacked.shape[2:])
    g = flat[ft.flat_corner_idx] * ft.cov_mask_T[..., None]  # [vd,nv,F]
    if include_metric:
        tlv = ft.tan_lat_vertex[None, :]
        du = -(g[..., 0] + g[..., 2] * tlv).sum(0)
        dv = (-g[..., 1] + g[..., 3] * tlv).sum(0)
    else:
        du = -g[..., 0].sum(0)
        dv = -g[..., 1].sum(0)
    du = jnp.where(solve_velocity > 0, du / ft.denominator, 0.0)
    dv = jnp.where(solve_velocity > 0, dv / ft.denominator, 0.0)
    return du, dv


# -- structured (raster quad) fast path --------------------------------------
# When the mesh is a raster-ordered regular quad grid (box/square
# testcases), the two per-subcycle gathers become static 2-D shifts:
# contiguous slices instead of per-index gathers.  See
# mesh/structured.py.

def gather_corners_S(layout, u, v):
    """Vertex velocities at cell corners via raster shifts.
    Returns (u_c, v_c) each [me, nc] (same layout/numerics as the
    voc_T gather: all corners valid on a regular quad)."""
    import jax.numpy as jnp
    nxc, nyc = layout.nxc, layout.nyc
    u2 = u.reshape(layout.nxv, layout.nyv)
    v2 = v.reshape(layout.nxv, layout.nyv)
    uc, vc = [], []
    for (oi, oj) in layout.offsets:
        uc.append(u2[oi:oi + nxc, oj:oj + nyc].reshape(-1))
        vc.append(v2[oi:oi + nxc, oj:oj + nyc].reshape(-1))
    return jnp.stack(uc), jnp.stack(vc)


def strain_tensor_S(ft: FastTensors, layout, u, v):
    """strain_tensor_T with the gather replaced by shifts (planar)."""
    import jax.numpy as jnp
    u_c, v_c = gather_corners_S(layout, u, v)
    gx = ft.basis_grad_T[:, 0]
    gy = ft.basis_grad_T[:, 1]
    e11 = (u_c[:, None, :] * gx).sum(0)
    e22 = (v_c[:, None, :] * gy).sum(0)
    e12 = 0.5 * ((u_c[:, None, :] * gy).sum(0) +
                 (v_c[:, None, :] * gx).sum(0))
    return e11, e22, e12


def stress_divergence_S(ft: FastTensors, layout, s11, s22, s12,
                        solve_velocity):
    """stress_divergence_T with the vertex gather replaced by static
    slice scatter-adds (planar)."""
    import jax.numpy as jnp
    bu = ft.basis_int_T[:, 0]
    bv = ft.basis_int_T[:, 1]
    pu = (s11[:, None, :] * bu).sum(0) + (s12[:, None, :] * bv).sum(0)
    pv = (s22[:, None, :] * bv).sum(0) + (s12[:, None, :] * bu).sum(0)
    nxc, nyc = layout.nxc, layout.nyc
    du2 = jnp.zeros((layout.nxv, layout.nyv), pu.dtype)
    dv2 = jnp.zeros((layout.nxv, layout.nyv), pu.dtype)
    for b, (oi, oj) in enumerate(layout.offsets):
        du2 = du2.at[oi:oi + nxc, oj:oj + nyc].add(
            pu[b].reshape(nxc, nyc))
        dv2 = dv2.at[oi:oi + nxc, oj:oj + nyc].add(
            pv[b].reshape(nxc, nyc))
    du = -du2.reshape(-1)
    dv = -dv2.reshape(-1)
    du = jnp.where(solve_velocity > 0, du / ft.denominator, 0.0)
    dv = jnp.where(solve_velocity > 0, dv / ft.denominator, 0.0)
    return du, dv
