"""Incremental-remapping transport: the jitted pipeline.

JAX re-design of the reference IR driver
(`/root/reference/src/shared/mpas_seaice_advection_incremental_remap.F:2338-2667`
and the stage kernels it calls). The Fortran per-edge branching of
`find_departure_triangles` (:5365-6269) becomes a *fixed-slot* masked dense
computation: every potential departure triangle has a static slot, invalid
slots carry zero area, and all case analysis is `jnp.where` selects — no
data-dependent control flow, so the whole dynamics-substep transport is one
XLA program.

Slot layout (N_TRI_SLOTS = 10, see geometry.py):
  s = 4*v + 2*side + {0,1} for v in {V1,V2}, side in {left,right}:
      slot a = side triangle (V, D, IP), slot b = quad-mesh split extra
      triangle (V, IP0, IP) when the D1-D2 segment also crosses the
      colinear edge E5/E6;
  s = 8, 9: the two central triangles in C1/C2.

Algorithm stages per dynamics substep (reference :2338-2667):
  masks -> reconstruct (gradient, limiter, barycenters) ->
  departure points (:5255) -> departure triangles (:5365) ->
  quadrature points (:6546) -> flux integration (:6667) ->
  mass/tracer-product update (:7125) -> zap small mass (:8764).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .geometry import RemapTensors, N_TRI_SLOTS
from .tracers import TracerTree, TracerSpec

EPS11 = 1.0e-11
SMALL_MASS = 1.0e-22    # zap threshold (reference :8786)
BIG = 1.0e30

# moment column indices in RemapTensors.geom_moments
_M = {name: i for i, name in enumerate(
    ["x", "y", "xx", "xy", "yy",
     "xxx", "xxy", "xyy", "yyy",
     "xxxx", "xxxy", "xxyy", "xyyy", "yyyy"])}


def _mom(rt: RemapTensors, name: str):
    return rt.geom_moments[:, _M[name]]


# -- geometry primitives (vectorized over edges) ------------------------------

def _segment_intersection(p1x, p1y, p2x, p2y, p3x, p3y, p4x, p4y):
    """Strict segment-segment intersection (reference
    find_line_intersection, :8934-9016): True only for interior crossings
    (t1, t2 strictly in (0,1)); shared endpoints do not intersect."""
    rx, ry = p2x - p1x, p2y - p1y
    sx, sy = p4x - p3x, p4y - p3y
    cross = rx * sy - ry * sx
    cross_min = EPS11 * jnp.sqrt(
        (rx * rx + ry * ry) * (sx * sx + sy * sy))
    nonparallel = jnp.abs(cross) > cross_min
    safe = jnp.where(nonparallel, cross, 1.0)
    t1 = (sy * (p3x - p1x) - sx * (p3y - p1y)) / safe
    t2 = (ry * (p3x - p1x) - rx * (p3y - p1y)) / safe
    hit = nonparallel & (t1 > 0.0) & (t1 < 1.0) & (t2 > 0.0) & (t2 < 1.0)
    ix = p1x + t1 * rx
    iy = p1y + t1 * ry
    return hit, jnp.where(nonparallel, ix, BIG), \
        jnp.where(nonparallel, iy, BIG)


def _in_left_half_plane(px, py, ax, ay, bx, by):
    """True iff point p is in the left half-plane of the line a->b
    (reference point_in_half_plane, :9201-9234; >= 0 counts as left)."""
    return (bx - ax) * (py - ay) - (by - ay) * (px - ax) >= 0.0


def _tri_area(x, y):
    """abs area of triangles with vertices x,y [..., 3]."""
    return jnp.abs(0.5 * (
        (x[..., 1] - x[..., 0]) * (y[..., 2] - y[..., 0]) -
        (y[..., 1] - y[..., 0]) * (x[..., 2] - x[..., 0])))


# -- stage 1: departure points (reference :5255-5350) -------------------------

def departure_points(u_vertex, v_vertex, dt):
    """Backward trajectory -u*dt in vertex-local coordinates. Returns
    (dpx, dpy, cfl_violation_count)."""
    dpx = -u_vertex * dt
    dpy = -v_vertex * dt
    return dpx, dpy


def cfl_violations(dpx, dpy, rt: RemapTensors):
    """Count of vertices whose trajectory exceeds the shortest adjacent
    edge (non-fatal warning in the reference, :5330-5350)."""
    traj = jnp.sqrt(dpx ** 2 + dpy ** 2)
    return jnp.sum(traj > rt.min_length_edges_on_vertex)


# -- stage 2: departure triangles (reference :5365-6269) ----------------------

def find_departure_triangles(rt: RemapTensors, dpx, dpy, vertex_degree: int):
    """Fixed-slot departure-triangle decomposition per edge.

    Returns dict with:
      tri_x, tri_y : [nEdges, N_TRI_SLOTS, 3] vertices in edge coordinates
      cell_slot    : [nEdges, N_TRI_SLOTS] int index into cellsOnEdgeRemap
      area         : [nEdges, N_TRI_SLOTS] signed area (+: C1 -> C2 flux)
      mask_edge    : [nEdges]
    Triangle vertex-on-edge assignment per slot is static: _VOE_IDX.
    """
    ne = rt.x_vertex_on_edge.shape[0]
    dtype = dpx.dtype
    voe = rt.vertices_on_edge                         # [nEdges, 2]

    # departure points in edge coordinates (reference :5633-5649)
    dp = jnp.stack([
        jnp.stack([rt.x_vertex_on_edge[:, 0] + dpx[voe[:, 0]],
                   rt.y_vertex_on_edge[:, 0] + dpy[voe[:, 0]]], axis=-1),
        jnp.stack([rt.x_vertex_on_edge[:, 1] + dpx[voe[:, 1]],
                   rt.y_vertex_on_edge[:, 1] + dpy[voe[:, 1]]], axis=-1),
    ], axis=1)                                         # [nEdges, 2, 2]

    v1x, v1y = rt.x_vertex_on_edge[:, 0], rt.y_vertex_on_edge[:, 0]
    v2x, v2y = rt.x_vertex_on_edge[:, 1], rt.y_vertex_on_edge[:, 1]
    vx = jnp.stack([v1x, v2x], axis=1)                 # [nEdges, 2]
    vy = jnp.stack([v1y, v2y], axis=1)

    # maskEdge: remap edge with a nonzero departure vector (:5597-5607)
    dlen = (dpx[voe] ** 2 + dpy[voe] ** 2).sum(axis=1)
    mask_edge = (rt.remap_edge > 0) & (dlen > 0.0)

    S = N_TRI_SLOTS
    tri_x = jnp.zeros((ne, S, 3), dtype)
    tri_y = jnp.zeros((ne, S, 3), dtype)
    cell_slot = jnp.zeros((ne, S), jnp.int32)
    sign = jnp.zeros((ne, S), dtype)
    valid = jnp.zeros((ne, S), dtype=bool)

    dpx_e = dp[:, :, 0]
    dpy_e = dp[:, :, 1]

    def set_tri(s, ok, ax, ay, bx, by, cx, cy, cslot, sgn):
        nonlocal tri_x, tri_y, cell_slot, sign, valid
        t_x = jnp.stack([ax, bx, cx], axis=-1)
        t_y = jnp.stack([ay, by, cy], axis=-1)
        tri_x = tri_x.at[:, s, :].set(jnp.where(ok[:, None], t_x, 0.0))
        tri_y = tri_y.at[:, s, :].set(jnp.where(ok[:, None], t_y, 0.0))
        cell_slot = cell_slot.at[:, s].set(
            jnp.where(ok, cslot, 0).astype(jnp.int32))
        sign = sign.at[:, s].set(jnp.where(ok, sgn, 0.0))
        valid = valid.at[:, s].set(ok)

    # -- side passes (reference :5711-5964). Sequential over the 4 side
    # edges because an intersection replaces the departure point for the
    # remaining passes (:5960-5963).
    for v in (0, 1):
        for side in (0, 1):
            # edges_on_edge_remap slots (0-based): 0=E1, 1=E2, 2=E3, 3=E4.
            # V1 pairs with E1 (left) / E3 (right); V2 with E2 / E4.
            er = {(0, 0): 0, (0, 1): 2, (1, 0): 1, (1, 1): 3}[(v, side)]
            vr = er + 2                      # far vertex slot V3..V6

            exists = rt.edges_on_edge_remap_mask[:, er] > 0
            fvx = rt.x_vertex_on_edge[:, vr]
            fvy = rt.y_vertex_on_edge[:, vr]
            hit, ipx, ipy = _segment_intersection(
                dpx_e[:, 0], dpy_e[:, 0], dpx_e[:, 1], dpy_e[:, 1],
                vx[:, v], vy[:, v], fvx, fvy)
            hit = hit & exists & mask_edge
            sgn = 1.0 if side == 0 else -1.0
            s_a = 4 * v + 2 * side
            s_b = s_a + 1

            if vertex_degree == 4:
                # possible split by the colinear edge E5/E6 (:5810-5958)
                er56 = 4 + v
                exists56 = rt.edges_on_edge_remap_mask[:, er56] > 0
                f56x = rt.x_vertex_on_edge[:, 6 + v]   # V7 or V8
                f56y = rt.y_vertex_on_edge[:, 6 + v]
                hit0, ip0x, ip0y = _segment_intersection(
                    dpx_e[:, 0], dpy_e[:, 0], dpx_e[:, 1], dpy_e[:, 1],
                    vx[:, v], vy[:, v], f56x, f56y)
                split = hit & hit0 & exists56
                # triangle a: (V, D, IP) normally; (V, D, IP0) when split.
                # source cell: C3/C4 (2+v) on own side; the split or a
                # right-side crossing moves it to C5/C6 (4+v).
                own = 2 + v if side == 0 else 4 + v
                other = 4 + v if side == 0 else 2 + v
                ax, ay = vx[:, v], vy[:, v]
                bx, by = dpx_e[:, v], dpy_e[:, v]
                cx = jnp.where(split, ip0x, ipx)
                cy = jnp.where(split, ip0y, ipy)
                cs = jnp.where(split, other, own)
                set_tri(s_a, hit, ax, ay, bx, by, cx, cy, cs, sgn)
                # triangle b: (V, IP0, IP) on the opposite side of E5/E6
                cs_b = jnp.full((ne,), own, jnp.int32)
                set_tri(s_b, split, ax, ay, ip0x, ip0y, ipx, ipy,
                        cs_b, sgn)
            else:
                own = 2 + v                  # hex: always C3/C4
                set_tri(s_a, hit, vx[:, v], vy[:, v],
                        dpx_e[:, v], dpy_e[:, v], ipx, ipy,
                        jnp.full((ne,), own, jnp.int32), sgn)

            # replace departure point with the intersection (:5960-5963)
            dpx_e = dpx_e.at[:, v].set(jnp.where(hit, ipx, dpx_e[:, v]))
            dpy_e = dpy_e.at[:, v].set(jnp.where(hit, ipy, dpy_e[:, v]))

    # -- central triangles (reference :5976-6157)
    hit_m, ip0x, ip0y = _segment_intersection(
        dpx_e[:, 0], dpy_e[:, 0], dpx_e[:, 1], dpy_e[:, 1],
        v1x, v1y, v2x, v2y)

    # degenerate-quad filter for the no-intersection branch (:6050-6060)
    quad_area = (_tri_area(
        jnp.stack([v1x, v2x, dpx_e[:, 1]], -1),
        jnp.stack([v1y, v2y, dpy_e[:, 1]], -1)) + _tri_area(
        jnp.stack([v1x, dpx_e[:, 1], dpx_e[:, 0]], -1),
        jnp.stack([v1y, dpy_e[:, 1], dpy_e[:, 0]], -1)))
    quad_ok = quad_area > 0.0

    for v, s in ((0, 8), (1, 9)):
        in_left = _in_left_half_plane(
            dpx_e[:, v], dpy_e[:, v], v1x, v1y, v2x, v2y)
        cs = jnp.where(in_left, 0, 1)        # C1 or C2
        sgn = jnp.where(in_left, 1.0, -1.0)
        if v == 0:
            # intersect: (V1, D1, IP0); else: (V1, V2, D1)
            ax, ay = v1x, v1y
            bx = jnp.where(hit_m, dpx_e[:, 0], v2x)
            by = jnp.where(hit_m, dpy_e[:, 0], v2y)
            cx = jnp.where(hit_m, ip0x, dpx_e[:, 0])
            cy = jnp.where(hit_m, ip0y, dpy_e[:, 0])
        else:
            # intersect: (V2, D2, IP0); else: (V2, D1, D2)
            ax, ay = v2x, v2y
            bx = jnp.where(hit_m, dpx_e[:, 1], dpx_e[:, 0])
            by = jnp.where(hit_m, dpy_e[:, 1], dpy_e[:, 0])
            cx = jnp.where(hit_m, ip0x, dpx_e[:, 1])
            cy = jnp.where(hit_m, ip0y, dpy_e[:, 1])
        ok = mask_edge & (hit_m | quad_ok)
        set_tri(s, ok, ax, ay, bx, by, cx, cy, cs, sgn)

    area = _tri_area(tri_x, tri_y) * sign * valid
    return {"tri_x": tri_x, "tri_y": tri_y, "cell_slot": cell_slot,
            "area": area, "valid": valid,
            "mask_edge": mask_edge.astype(dtype)}


# vertexOnEdge index (0 or 1) per slot — static by construction
_VOE_IDX = np.array([0, 0, 0, 0, 1, 1, 1, 1, 0, 1], np.int32)


def triangles_to_cell_coords(rt: RemapTensors, tris: dict):
    """Shift triangle vertices from edge to source-cell coordinates and
    compute the 6 quadrature points per triangle (reference
    shift_vertices_of_departure_triangle :6343-6460 planar branch +
    get_triangle_quadrature_points :6546-6640).

    Planar: translation via the shared vertex, robust across periodic
    seams: offset = xLocal(cell, sharedVertex) - xVertexOnEdge(sharedVertex).
    Returns (cell [nE,S], xq, yq [nE,S,6], area [nE,S]).

    The slot choice is data-dependent, but all the per-slot tables
    (cell index, mask, rotation, shared-vertex coordinates) are static
    per (edge, k) — so instead of take-along-axis row gathers the lookup
    is a ONE-HOT CONTRACTION over the K=6 cell slots: exact at HIGHEST
    precision (one term is 1.0, the rest 0.0) and pure vector math.
    """
    cell_slot = tris["cell_slot"]                     # [nE, S]
    dtype = tris["tri_x"].dtype
    K = rt.cells_on_edge_remap.shape[1]
    hi = jax.lax.Precision.HIGHEST                    # exact f32 contraction
    oh_b = cell_slot[..., None] == jnp.arange(K, dtype=cell_slot.dtype)
    onehot = oh_b.astype(dtype)                       # [nE, S, K]
    cell = jnp.sum(jnp.where(oh_b, rt.cells_on_edge_remap[:, None, :], 0),
                   axis=-1)                           # [nE, S] int32
    cmask = jnp.einsum("esk,ek->es", onehot,
                       rt.cells_on_edge_remap_mask, precision=hi)
    # rotate edge-frame vectors (relative to the shared vertex) into the
    # cell frame, then translate: on planar meshes the rotation is the
    # identity; on the sphere it is the precomputed tangent-frame
    # rotation (replaces reference shift_vertices basis transforms)
    R = jnp.einsum("esk,ekij->esij", onehot,
                   rt.edge_to_cell_rot, precision=hi)   # [nE, S, 2, 2]
    xyv = jnp.einsum("esk,ekvx->esvx", onehot,
                     rt.xy_local_on_edge_remap, precision=hi)
    voe1 = jnp.asarray(_VOE_IDX == 1)[None, :]        # [1, S] static
    x0 = jnp.where(voe1, xyv[:, :, 1, 0], xyv[:, :, 0, 0])
    y0 = jnp.where(voe1, xyv[:, :, 1, 1], xyv[:, :, 0, 1])
    vx = jnp.where(voe1, rt.x_vertex_on_edge[:, 1:2],
                   rt.x_vertex_on_edge[:, 0:1])       # shared vertex
    vy = jnp.where(voe1, rt.y_vertex_on_edge[:, 1:2],
                   rt.y_vertex_on_edge[:, 0:1])
    dx = tris["tri_x"] - vx[..., None]
    dy = tris["tri_y"] - vy[..., None]
    rx = R[..., 0, 0, None] * dx + R[..., 0, 1, None] * dy
    ry = R[..., 1, 0, None] * dx + R[..., 1, 1, None] * dy
    tx = x0[..., None] + rx
    ty = y0[..., None] + ry
    # quadrature points: barycentric combination of the 3 vertices
    xq = jnp.einsum("qk,esk->esq", rt.qp_coeffs, tx, precision=hi)
    yq = jnp.einsum("qk,esk->esq", rt.qp_coeffs, ty, precision=hi)
    area = tris["area"] * cmask
    return cell, xq, yq, area


# -- stage 3: linear reconstruction (reference :3580-5255) --------------------

def _expand(a, extra_dims):
    """Append `extra_dims` singleton axes."""
    return a.reshape(a.shape + (1,) * extra_dims)


def batched_neighbor_gather(arrs, coc):
    """ONE neighbor gather for a list of [nC, ...] arrays (indices are
    shared across the whole tracer tree; per-index gather cost
    amortizes — the same layout trick as integrate_fluxes)."""
    flats = [a.reshape(a.shape[0], -1) for a in arrs]
    widths = [f.shape[1] for f in flats]
    g = jnp.concatenate(flats, axis=1)[coc]          # [nC, K, F]
    out = []
    off = 0
    for a, w in zip(arrs, widths):
        out.append(g[..., off:off + w].reshape(
            (a.shape[0], coc.shape[1]) + a.shape[1:]))
        off += w
    return out


def compute_gradient(rt: RemapTensors, mesh_cells_on_cell,
                     mesh_cells_on_cell_mask, field, field_mask, mask_cell,
                     f_n=None, m_n=None):
    """Least-squares cell-center gradient from edge-normal differences
    (reference compute_gradient_2d/3d, :4204-4630). field: [nCells, ...];
    returns (gx, gy) of the same shape.  f_n/m_n: optional pre-gathered
    neighbor values (batched_neighbor_gather)."""
    extra = field.ndim - 1
    coc = mesh_cells_on_cell                        # [nC, K]
    neigh_ok = mesh_cells_on_cell_mask              # [nC, K]
    if f_n is None:
        f_n = field[coc]                            # [nC, K, ...]
    if m_n is None:
        m_n = field_mask[coc]
    dc = jnp.maximum(rt.dc_edge_on_cell, EPS11)
    # normal gradient along the C1->C2 edge direction, masked where either
    # side is not physically meaningful
    fm_c = jnp.expand_dims(field_mask, 1)           # [nC, 1, ...]
    ng = (f_n - jnp.expand_dims(field, 1)) / _expand(dc, extra) \
        * _expand(neigh_ok, extra) * m_n * fm_c
    # reference sign convention: ng is the gradient component along the
    # C1->C2 normal, matching the least-squares coeffs' normals
    esoc = _expand(rt.edge_sign_on_cell, extra)
    ng = ng * esoc
    gx = (ng * _expand(rt.coeffs_reconstruct[..., 0], extra)).sum(axis=1)
    gy = (ng * _expand(rt.coeffs_reconstruct[..., 1], extra)).sum(axis=1)
    mc = _expand(mask_cell, extra)
    return gx * mc, gy * mc


def limit_gradient(rt: RemapTensors, mesh_cells_on_cell,
                   mesh_cells_on_cell_mask, field, field_mask,
                   xb, yb, gx, gy, mask_cell, f_n=None, m_n=None):
    """Monotone gradient limiter (reference limit_tracer_gradient_2d/3d,
    :4802-5200): scale the gradient so reconstructed values at cell
    corners stay within the neighborhood min/max."""
    extra = field.ndim - 1
    coc = mesh_cells_on_cell
    if f_n is None:
        f_n = field[coc]                            # [nC, K, ...]
    if m_n is None:
        m_n = field_mask[coc]
    m_n = m_n * _expand(mesh_cells_on_cell_mask, extra)
    max_n = jnp.max(jnp.where(m_n > 0, f_n, -BIG), axis=1)
    min_n = jnp.min(jnp.where(m_n > 0, f_n, BIG), axis=1)
    max_n = jnp.maximum(max_n, field) - field
    min_n = jnp.minimum(min_n, field) - field

    # deviation at cell corners from the barycenter (valid slots only)
    dx = _expand(rt.x_local, extra) - jnp.expand_dims(xb, 1)
    dy = _expand(rt.y_local, extra) - jnp.expand_dims(yb, 1)
    k_ok = _expand(rt.edges_on_cell_mask, extra)
    dev = (jnp.expand_dims(gx, 1) * dx + jnp.expand_dims(gy, 1) * dy) * k_ok
    max_l = jnp.maximum(jnp.max(dev, axis=1), 0.0)
    min_l = jnp.minimum(jnp.min(dev, axis=1), 0.0)

    def factor(local, neigh):
        need = jnp.abs(local) > jnp.abs(neigh)
        safe = jnp.where(need, local, 1.0)
        return jnp.where(need, jnp.maximum(0.0, neigh / safe), 1.0)

    f = jnp.minimum(factor(max_l, max_n), factor(min_l, min_n))
    f = jnp.maximum(0.0, f - EPS11)                 # roundoff guard (:4975)
    f = f * _expand(mask_cell, extra)
    return gx * f, gy * f


def barycenter(rt: RemapTensors, depth: int, chain):
    """Barycenter of mass (depth 1) or mass*tracer (depth 2) distributions,
    or the cell centroid (depth 0); reference
    compute_barycenter_coordinates :4658-4797.

    chain: list of (mean, center, gx, gy) for the ancestor chain root-first
    (length == depth), all [nCells, nCat]-shaped.
    Returns (xb, yb) with the shape of the chain fields (or [nCells] for
    depth 0)."""
    if depth == 0:
        return _mom(rt, "x"), _mom(rt, "y")

    if depth == 1:
        (mean0, c0, cx, cy), = chain
        recip = jnp.where(jnp.abs(mean0) > 0.0, 1.0 / jnp.where(
            mean0 == 0, 1.0, mean0), 0.0)
        ex = lambda n: _expand(_mom(rt, n), mean0.ndim - 1)  # noqa: E731
        xb = (c0 * ex("x") + cx * ex("xx") + cy * ex("xy")) * recip
        yb = (c0 * ex("y") + cx * ex("xy") + cy * ex("yy")) * recip
        return xb, yb

    if depth == 2:
        (mean0, ctr0, gx0, gy0), (mean1, ctr1, gx1, gy1) = chain
        c0 = ctr0 * ctr1
        cx = ctr0 * gx1 + gx0 * ctr1
        cy = ctr0 * gy1 + gy0 * ctr1
        cxx = gx0 * gx1
        cxy = gx0 * gy1 + gy0 * gx1
        cyy = gy0 * gy1
        prod = mean0 * mean1
        recip = jnp.where(jnp.abs(prod) > 0.0, 1.0 / jnp.where(
            prod == 0, 1.0, prod), 0.0)
        ex = lambda n: _expand(_mom(rt, n), prod.ndim - 1)  # noqa: E731
        xb = (c0 * ex("x") + cx * ex("xx") + cy * ex("xy") +
              cxx * ex("xxx") + cxy * ex("xxy") + cyy * ex("xyy")) * recip
        yb = (c0 * ex("y") + cx * ex("xy") + cy * ex("yy") +
              cxx * ex("xxy") + cxy * ex("xyy") + cyy * ex("yyy")) * recip
        return xb, yb

    if depth == 3:
        # center of mass*tracer1*tracer2 (reference :4755-4793)
        (mean0, c0_, gx0, gy0), (mean1, c1_, gx1, gy1), \
            (mean2, c2_, gx2, gy2) = chain
        c0 = c0_ * c1_ * c2_
        cx = c0_ * c1_ * gx2 + c0_ * gx1 * c2_ + gx0 * c1_ * c2_
        cy = c0_ * c1_ * gy2 + c0_ * gy1 * c2_ + gy0 * c1_ * c2_
        cxx = c0_ * gx1 * gx2 + gx0 * c1_ * gx2 + gx0 * gx1 * c2_
        cxy = (c0_ * gx1 * gy2 + gx0 * gy1 * c2_ + gy0 * c1_ * gx2 +
               c0_ * gy1 * gx2 + gx0 * c1_ * gy2 + gy0 * gx1 * c2_)
        cyy = c0_ * gy1 * gy2 + gy0 * c1_ * gy2 + gy0 * gy1 * c2_
        cxxx = gx0 * gx1 * gx2
        cxxy = gx0 * gx1 * gy2 + gx0 * gy1 * gx2 + gy0 * gx1 * gx2
        cxyy = gy0 * gy1 * gx2 + gy0 * gx1 * gy2 + gx0 * gy1 * gy2
        cyyy = gy0 * gy1 * gy2
        prod = mean0 * mean1 * mean2
        recip = jnp.where(jnp.abs(prod) > 0.0, 1.0 / jnp.where(
            prod == 0, 1.0, prod), 0.0)
        ex = lambda n: _expand(_mom(rt, n), prod.ndim - 1)  # noqa: E731
        xb = (c0 * ex("x") + cx * ex("xx") + cy * ex("xy") +
              cxx * ex("xxx") + cxy * ex("xxy") + cyy * ex("xyy") +
              cxxx * ex("xxxx") + cxxy * ex("xxxy") + cxyy * ex("xxyy") +
              cyyy * ex("xyyy")) * recip
        yb = (c0 * ex("y") + cx * ex("xy") + cy * ex("yy") +
              cxx * ex("xxy") + cxy * ex("xyy") + cyy * ex("yyy") +
              cxxx * ex("xxxy") + cxxy * ex("xxyy") + cxyy * ex("xyyy") +
              cyyy * ex("yyyy")) * recip
        return xb, yb

    raise NotImplementedError("barycenters beyond depth 3 (the reference "
                              "limits children to depth <= 3 as well)")


def reconstruct_fields(tree: TracerTree, fields: Dict[str, Any],
                       masks: Dict[str, Any], mask_cell,
                       rt: RemapTensors, cells_on_cell, cells_on_cell_mask,
                       monotonic: bool = True):
    """Build limited linear reconstructions for every tracer
    (reference construct_linear_tracer_fields :3580-4200).

    Returns dict name -> {center, gx, gy} plus name -> (xb, yb) barycenters
    for tracers that have children."""
    recon = {}
    barys = {}
    centroid = (_mom(rt, "x"), _mom(rt, "y"))
    # one shared neighbor gather for every tracer's values and masks
    arrs = []
    for spec in tree.specs:
        arrs.append(fields[spec.name])
        arrs.append(masks[spec.name])
    gathered = batched_neighbor_gather(arrs, cells_on_cell)
    neigh = {spec.name: (gathered[2 * i], gathered[2 * i + 1])
             for i, spec in enumerate(tree.specs)}
    for spec in tree.specs:
        f = fields[spec.name]
        fm = masks[spec.name]
        f_n, m_n = neigh[spec.name]
        gx, gy = compute_gradient(rt, cells_on_cell, cells_on_cell_mask,
                                  f, fm, mask_cell, f_n=f_n, m_n=m_n)
        # parent barycenter (centroid for the root)
        if spec.parent is None:
            pxb = _expand(centroid[0], f.ndim - 1)
            pyb = _expand(centroid[1], f.ndim - 1)
        else:
            pxb, pyb = barys[spec.parent]
            if f.ndim > pxb.ndim:               # 3D tracer with 2D parent
                pxb = jnp.expand_dims(pxb, -1)
                pyb = jnp.expand_dims(pyb, -1)
        pxb_b = jnp.broadcast_to(pxb, f.shape)
        pyb_b = jnp.broadcast_to(pyb, f.shape)
        if monotonic:
            gx, gy = limit_gradient(rt, cells_on_cell, cells_on_cell_mask,
                                    f, fm, pxb_b, pyb_b, gx, gy,
                                    mask_cell, f_n=f_n, m_n=m_n)
        center = f - gx * pxb_b - gy * pyb_b
        recon[spec.name] = {"center": center, "gx": gx, "gy": gy}

        if tree.has_child(spec.name):
            depth = tree.depth(spec.name)
            chain_names = tree.ancestors(spec.name) + [spec.name]
            chain = [(fields[n], recon[n]["center"], recon[n]["gx"],
                      recon[n]["gy"]) for n in chain_names]
            xb, yb = barycenter(rt, depth + 1, chain)
            xb = jnp.where(_expand(mask_cell, xb.ndim - 1) > 0, xb, 0.0)
            yb = jnp.where(_expand(mask_cell, yb.ndim - 1) > 0, yb, 0.0)
            barys[spec.name] = (xb, yb)
    return recon


# -- stage 4: flux integration (reference :6667-6982) -------------------------
#
# Redesign of integrate_fluxes_over_triangles: instead of carrying
# per-quad-point product value arrays ([nEdges, slots, 6, nCat] per
# tracer — the reference structure), each tracer's mass*tracer product
# is represented by its POLYNOMIAL COEFFICIENTS in the cell frame
# (products of linear reconstructions are polynomials of degree <=
# chain length; coefficient products are computed cellwise), and the
# triangle integrals of the monomials are computed once per (edge,
# slot). Same finite quadrature sum, reassociated — results match the
# reference formulation to roundoff.

# monomial exponents up to degree 4 (covers mass*t1*t2*t3 chains)
_MONOMIALS = [(0, 0), (1, 0), (0, 1),
              (2, 0), (1, 1), (0, 2),
              (3, 0), (2, 1), (1, 2), (0, 3),
              (4, 0), (3, 1), (2, 2), (1, 3), (0, 4)]
_MONO_IDX = {m: i for i, m in enumerate(_MONOMIALS)}


def _poly_mul_linear(poly: dict, c, gx, gy):
    """Multiply a monomial-coefficient dict by (c + gx*x + gy*y)."""
    out = {}
    for (i, j), a in poly.items():
        for (di, dj), b in (((0, 0), c), ((1, 0), gx), ((0, 1), gy)):
            key = (i + di, j + dj)
            term = a * b
            out[key] = out.get(key, 0.0) + term
    return out


def triangle_monomial_integrals(rt: RemapTensors, xq, yq,
                                max_degree: int):
    """mom[e, s, m] = sum_q w_q x_q^i y_q^j for monomials up to
    max_degree (exact for the same polynomials the reference's 6-point
    degree-4 rule integrates exactly)."""
    terms = [m for m in _MONOMIALS if m[0] + m[1] <= max_degree]
    w = rt.qp_weights
    cols = []
    for (i, j) in terms:
        v = jnp.einsum("q,esq->es", w, (xq ** i) * (yq ** j),
                       precision=jax.lax.Precision.HIGHEST)
        cols.append(v)
    return jnp.stack(cols, axis=-1), terms            # [nE, S, M]


def integrate_fluxes(tree: TracerTree, recon, rt: RemapTensors,
                     cell, xq, yq, area, mask_edge):
    """Edge fluxes of mass and mass*tracer products.
    Returns dict name -> flux [nEdges, nCat(, nLayers)].

    Layout: gathers run along the LEADING cell axis with all
    (category, coefficient) data flattened into the minor axis — the
    natural gather-major layout — and the coefficient contraction is a
    minor-axis reduce, so no [nE,S,nCat,M]-shaped intermediate needs a
    layout copy."""
    nE, S = cell.shape
    X = nE * S
    cellf = cell.reshape(-1)                         # [X]
    areaf = area.reshape(-1)                         # [X]
    max_depth = max(tree.depth(s.name) for s in tree.specs)
    mom, terms = triangle_monomial_integrals(rt, xq, yq,
                                             max_degree=max_depth + 1)
    term_idx = {m: i for i, m in enumerate(terms)}
    W = mom.reshape(X, len(terms))                   # [X, M]
    me = mask_edge[:, None]
    fluxes = {}
    polys = {}                       # 2D tracers: coeff dicts (cellwise)

    # pass 1: build every tracer's cellwise coefficient block and
    # concatenate them — the gather indices are shared, so ONE gather
    # moves all tracers' data (per-index cost amortized across the
    # whole tree)
    blocks = []                      # (name, kind, shape info, offset)
    cat = []
    off = 0
    for spec in tree.specs:
        r = recon[spec.name]
        c0, gx, gy = r["center"], r["gx"], r["gy"]
        if c0.ndim == 2:
            if spec.parent is None:
                poly = {(0, 0): c0, (1, 0): gx, (0, 1): gy}
            else:
                poly = _poly_mul_linear(polys[spec.parent], c0, gx, gy)
            polys[spec.name] = poly
            keys = sorted(poly.keys(), key=lambda m: term_idx[m])
            nCat = c0.shape[1]
            coeff = jnp.stack([poly[k] for k in keys],
                              axis=-1)               # [nc, nCat, M']
            flat = coeff.reshape(coeff.shape[0], -1)
            blocks.append((spec.name, "2d", (nCat, keys), off))
            off += flat.shape[1]
            cat.append(flat)
        else:
            nCat, nL = c0.shape[1], c0.shape[2]
            blocks.append((spec.name, "3d", (nCat, nL), off))
            for a in (c0, gx, gy):
                cat.append(a.reshape(a.shape[0], -1))
            off += 3 * nCat * nL
        # parent polynomial needed by 3D children even when this spec
        # is 3D itself (3D tracers are leaves in the reference tree)
    gathered = jnp.concatenate(cat, axis=1)[cellf]   # [X, F]

    for (name, kind, info, off) in blocks:
        if kind == "2d":
            nCat, keys = info
            Mp = len(keys)
            g = gathered[:, off:off + nCat * Mp].reshape(X, nCat, Mp)
            w = W[:, jnp.asarray([term_idx[k] for k in keys])]
            integral = (g * w[:, None, :]).sum(-1)   # [X, nCat]
            flux = (integral * areaf[:, None]).reshape(
                nE, S, nCat).sum(1) * me             # [nE, nCat]
        else:
            nCat, nL = info
            spec = tree.spec(name)
            ppoly = polys[spec.parent]
            keys = sorted(ppoly.keys(), key=lambda m: term_idx[m])
            Mp = len(keys)
            # the parent's block was already gathered
            poff = [b for b in blocks if b[0] == spec.parent][0][3]
            g = gathered[:, poff:poff + nCat * Mp].reshape(X, nCat, Mp)
            w0 = W[:, jnp.asarray([term_idx[k] for k in keys])]
            wx = W[:, jnp.asarray([term_idx[(k[0] + 1, k[1])]
                                   for k in keys])]
            wy = W[:, jnp.asarray([term_idx[(k[0], k[1] + 1)]
                                   for k in keys])]
            P0 = (g * w0[:, None, :]).sum(-1)        # [X, nCat]
            Px = (g * wx[:, None, :]).sum(-1)
            Py = (g * wy[:, None, :]).sum(-1)
            F3 = nCat * nL
            c3 = gathered[:, off:off + F3].reshape(X, nCat, nL)
            gx3 = gathered[:, off + F3:off + 2 * F3].reshape(
                X, nCat, nL)
            gy3 = gathered[:, off + 2 * F3:off + 3 * F3].reshape(
                X, nCat, nL)
            integral = (c3 * P0[..., None] + gx3 * Px[..., None]
                        + gy3 * Py[..., None])       # [X, nCat, nL]
            flux = (integral * areaf[:, None, None]).reshape(
                nE, S, nCat, nL).sum(1) * me[..., None]
        fluxes[name] = flux
    return fluxes


# -- stage 5: update (reference :7125-7523) -----------------------------------

def mass_tracer_products(tree: TracerTree, fields):
    """products[t] = mass * t1 * ... * t (root-down;
    reference compute_mass_tracer_products :6982-7120)."""
    products = {}
    for spec in tree.specs:
        if spec.parent is None:
            products[spec.name] = fields[spec.name]
        else:
            p = products[spec.parent]
            f = fields[spec.name]
            if f.ndim > p.ndim:
                p = jnp.expand_dims(p, -1)
            products[spec.name] = p * f
    return products


def update_mass_and_tracers(tree: TracerTree, fields, fluxes,
                            rt: RemapTensors, area_cell):
    """Flux-divergence update of mass and hierarchical tracer recovery
    (reference update_mass_and_tracers :7125-7523)."""
    products = mass_tracer_products(tree, fields)
    eoc = rt.edges_on_cell                           # [nC, K]
    new_fields = {}
    new_products = {}
    # ONE gather for every tracer's edge fluxes (shared indices):
    # concat minors, gather, signed-sum over the cell's edges, split
    shapes = {}
    cat = []
    off = 0
    offs = {}
    for spec in tree.specs:
        f = fluxes[spec.name]
        shapes[spec.name] = f.shape[1:]
        offs[spec.name] = off
        off += int(np.prod(f.shape[1:]))
        cat.append(f.reshape(f.shape[0], -1))
    fluxcat = jnp.concatenate(cat, axis=1)           # [nE, F]
    f_e = fluxcat[eoc]                               # [nC, K, F]
    sgn2 = (rt.edge_sign_on_cell * rt.edges_on_cell_mask)[..., None]
    divcat = (f_e * sgn2).sum(axis=1) / area_cell[:, None]   # [nC, F]
    for spec in tree.specs:
        sh = shapes[spec.name]
        o = offs[spec.name]
        div = divcat[:, o:o + int(np.prod(sh))].reshape(
            (divcat.shape[0],) + sh)
        new_prod = products[spec.name] - div
        if spec.parent is None:
            new_fields[spec.name] = new_prod
            new_products[spec.name] = new_prod
        else:
            pp = new_products[spec.parent]
            if new_prod.ndim > pp.ndim:
                pp = jnp.expand_dims(pp, -1)
            val = jnp.where(pp > 0.0, new_prod / jnp.where(
                pp == 0, 1.0, pp), 0.0)
            # monotone-recovery guard: in exact arithmetic the
            # recovered tracer of a consistent product/mass flux pair
            # is bounded by the pre-remap tracer range; for SLIVER
            # masses (new parent mass < 1e-8, i.e. tiny-product /
            # tiny-mass near-cancellation) the ratio can be roundoff
            # junk (observed: Tsfc = +55 C, positive ice enthalpies in
            # a 1.4e-11-area category, which then wedges the BL99
            # solve).  Clamp ONLY such slivers to the global
            # pre-remap range over physically-meaningful cells
            # (parent mass > eps11 — the reference's make_masks
            # exclusive threshold, :3024-3028); an exact no-op for
            # every in-bounds value, so conservation is untouched
            # except for the junk being repaired.
            old = fields[spec.name]
            pm_old = products[spec.parent]
            if old.ndim > pm_old.ndim:
                pm_old = jnp.expand_dims(pm_old, -1)
            meaningful = pm_old > 1e-11
            big = jnp.asarray(1e30, val.dtype)
            lo = jnp.min(jnp.where(meaningful, old, big), axis=0)
            hi = jnp.max(jnp.where(meaningful, old, -big), axis=0)
            none_valid = lo > hi
            lo = jnp.where(none_valid, 0.0, lo)
            hi = jnp.where(none_valid, 0.0, hi)
            tiny = pp < 1e-8
            val = jnp.where(tiny, jnp.clip(val, lo, hi), val)
            new_fields[spec.name] = val
            new_products[spec.name] = pp * val
    return new_fields


def zap_small_mass(tree: TracerTree, fields):
    """Zero out mass below 1e-22 (reference zap_small_mass :8764-8900);
    tracers riding on zapped mass are zeroed too."""
    root = tree.root.name
    m = fields[root]
    zap = (m > 0.0) & (m < SMALL_MASS)
    out = dict(fields)
    out[root] = jnp.where(zap, 0.0, m)
    for spec in tree.specs[1:]:
        f = out[spec.name]
        z = zap if f.ndim == zap.ndim else zap[..., None]
        out[spec.name] = jnp.where(z, 0.0, f)
    return out


# -- masks (reference make_masks :3404-3570) ----------------------------------

def make_masks(tree: TracerTree, fields, threshold: float = 0.0):
    """mask_cell [nCells] plus per-tracer physical-meaning masks."""
    root = tree.root.name
    mask_cell = (fields[root].sum(axis=1) > 0.0).astype(fields[root].dtype)
    masks = {root: jnp.ones_like(fields[root])}
    for spec in tree.specs[1:]:
        parent = fields[spec.parent]
        m = (parent > threshold).astype(parent.dtype)
        if fields[spec.name].ndim > m.ndim:
            m = jnp.broadcast_to(m[..., None], fields[spec.name].shape)
        masks[spec.name] = m
    return mask_cell, masks


# -- volume <-> thickness (reference :2500-2544, 2602-2650) -------------------

def to_transport_fields(tree: TracerTree, state: Dict[str, Any]):
    """Convert product-stored state entries (volumes) to per-area tracers
    (thickness) for transport."""
    root = tree.root.name
    area = state[root]
    out = {}
    for spec in tree.specs:
        f = state[spec.name]
        if spec.stored_as_product:
            parent = out[spec.parent] if spec.parent != root else area
            pa = area if spec.parent == root else state[spec.parent]
            f = jnp.where(pa > 0.0, f / jnp.where(pa == 0, 1.0, pa), 0.0)
        out[spec.name] = f
    return out


def from_transport_fields(tree: TracerTree, fields: Dict[str, Any]):
    """Inverse of to_transport_fields."""
    root = tree.root.name
    area = fields[root]
    out = {}
    for spec in tree.specs:
        f = fields[spec.name]
        if spec.stored_as_product:
            pa = area if spec.parent == root else out[spec.parent]
            f = f * pa
        out[spec.name] = f
    return out


# -- driver -------------------------------------------------------------------

def make_remap_step(tree: TracerTree, vertex_degree: int,
                    monotonic: bool = True):
    """Build the jitted IR transport step.

    Returns step(rt, cells_on_cell, cells_on_cell_mask, area_cell,
                 state, u_vertex, v_vertex, dt) -> new state,
    where `state` is a dict of tracer arrays in *storage* convention
    (volumes stored as volumes). Mirrors
    seaice_run_advection_incremental_remap (reference :2338-2667)."""

    def step(rt: RemapTensors, cells_on_cell, cells_on_cell_mask,
             area_cell, state, u_vertex, v_vertex, dt):
        fields = to_transport_fields(tree, state)
        mask_cell, masks = make_masks(tree, fields)
        recon = reconstruct_fields(tree, fields, masks, mask_cell, rt,
                                   cells_on_cell, cells_on_cell_mask,
                                   monotonic=monotonic)
        dpx, dpy = departure_points(u_vertex, v_vertex, dt)
        tris = find_departure_triangles(rt, dpx, dpy, vertex_degree)
        cell, xq, yq, area = triangles_to_cell_coords(rt, tris)
        with jax.named_scope("integrate_fluxes"):
            fluxes = integrate_fluxes(tree, recon, rt, cell, xq, yq,
                                      area, tris["mask_edge"])
        new_fields = update_mass_and_tracers(tree, fields, fluxes, rt,
                                             area_cell)
        new_fields = zap_small_mass(tree, new_fields)
        return from_transport_fields(tree, new_fields)

    return step


# -- runtime self-checks (reference :8126-8266, :8416-8700) -------------------

def global_conserved_sums(tree: TracerTree, state, area_cell):
    """sum_cells areaCell * massTracerProduct for every tracer — invariant
    under IR transport up to roundoff (reference conservation check)."""
    fields = to_transport_fields(tree, state)
    products = mass_tracer_products(tree, fields)
    out = {}
    for name, p in products.items():
        extra = p.ndim - 1
        out[name] = (p * _expand(area_cell, extra)).sum()
    return out


def local_extrema(tree: TracerTree, state, cells_on_cell,
                  cells_on_cell_mask):
    """Per-cell pre-remap neighborhood [min, max] for each TRACER
    (reference monotonicity-check setup :8416-8700).  Mass fields are
    excluded: convergent flow concentrates mass legitimately."""
    fields = to_transport_fields(tree, state)
    coc = jnp.maximum(cells_on_cell, 0)
    m = cells_on_cell_mask
    lo, hi = {}, {}
    for spec in tree.specs:
        if spec.parent is None or spec.stored_as_product:
            continue
        f = fields[spec.name]
        nb = f[coc]                                  # [nC, K, ...]
        extra = f.ndim - 1
        mm = _expand(m, extra)
        big = jnp.asarray(jnp.inf, f.dtype)
        nb_lo = jnp.where(mm > 0, nb, big).min(axis=1)
        nb_hi = jnp.where(mm > 0, nb, -big).max(axis=1)
        lo[spec.name] = jnp.minimum(nb_lo, f)
        hi[spec.name] = jnp.maximum(nb_hi, f)
    return lo, hi


def monotonicity_violation(tree: TracerTree, state, lo, hi,
                           tol: float = 1e-10):
    """Largest overshoot of any tracer beyond its pre-remap local
    bounds (0 when the limiter held; reference check :8416)."""
    fields = to_transport_fields(tree, state)
    worst = jnp.asarray(0.0)
    for name in lo:
        f = fields[name]
        scale = jnp.maximum(jnp.abs(hi[name]), 1.0)
        over = jnp.maximum(f - hi[name], 0.0) / scale
        under = jnp.maximum(lo[name] - f, 0.0) / scale
        worst = jnp.maximum(worst,
                            jnp.maximum(over.max(), under.max()))
    return jnp.maximum(worst - tol, 0.0)
