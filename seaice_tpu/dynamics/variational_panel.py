"""Panel-shift variational kernels for icosahedral global meshes.

The spherical analog of the raster-quad fast path
(`variational_fast.strain_tensor_S`): on the rhombic-panel layout
(mesh/panels.py) the per-subcycle corner gather and stress-divergence
scatter of the EVP hot loop (reference
`mpas_seaice_velocity_solver_variational.F:575-670,1064-1184`) become
STATIC CONTIGUOUS SLICES of flat padded arrays.  Gathers shrink from
O(nCells) indices to the O(N) seam ghosts plus a 12-cell exception
path (poles + panel-corner pentagons).

Layout: one flat "padded grid" index q = (p*(N+1) + a)*(N+1) + b per
panel position; cells live at (a=i+1, b=j), vertices at (a=i, b=j+1).
Divergence ghost positions (cell i=-1 -> a=0, j=N -> b=N) and corner
ghost positions (vertex i=N -> a=N, j=-1 -> b=0) fall inside the same
padded range, so ghost refresh is a small in-array scatter and every
corner/dual stencil offset is a single flat slice:
  corner slot k (cell q reads vertex plane t at q + D):
    s0:+1  s1:-N  s2:0 (t=0)   s3:-N  s4:0  s5:-(N+1) (t=1)
  dual (vertex q reads pu[slot] at q + D'):
    t=0: s0:-1  s1:+N  s2:0    t=1: s3:+N  s4:0  s5:+(N+1)
All arrays keep the long padded axis LAST (contiguous); numerics are
identical contractions to variational_fast with the corner axis
re-indexed by pattern slot (tests/test_panels.py asserts equality
against the gather path to roundoff).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import jax.numpy as jnp

from ..mesh.panels import CORNER_OFFSETS, PanelLayout
from ..utils.pytree import pytree_dataclass

# dual pattern: vertex (I,J,t) <- cell array offsets (see panels.py)
DUAL_OFFSETS = {0: ((-1, 0, 0), (0, 0, 1), (-1, 1, 2)),
                1: ((0, 0, 3), (-1, 1, 4), (0, 1, 5))}


def _corner_flat_offsets(N):
    """Flat q-offset per corner slot (cell q -> vertex plane t)."""
    out = []
    for (di, dj, t) in CORNER_OFFSETS:
        out.append(((di - 1) * (N + 1) + dj + 1, t))
    return out


def _dual_flat_offsets(N):
    """Flat q-offset per dual slot (vertex q -> pu[slot])."""
    out = {}
    for t, offs in DUAL_OFFSETS.items():
        out[t] = [((di + 1) * (N + 1) + dj - 1, slot)
                  for (di, dj, slot) in offs]
    return out


@pytree_dataclass
class PanelTensors:
    """Static tensors for the flat-padded panel-shift kernels."""
    # slot-indexed basis in PADDED layout [.., npc] (npc = padded grid
    # + 2 pole slots; zero at unused slots / ghost / exception cells)
    basis_grad_S: Any      # [6(b), 2, 6(g), npc]
    basis_int_S: Any       # [6(s), 2, 6(j), npc]
    basis_metric_S: Any    # [6(s), 6(j), npc]
    denominator: Any       # [nVertices] (real layout)
    tan_lat_vertex: Any    # [nVertices]
    slot_used: Any         # [6, npc]
    cell_pad_idx: Any      # [nCells] real cell -> padded column
    ring_of_slot: Any      # [6, nCells] (real layout; 0-padded)
    slot_of_ring_a: Any    # [6, nCells]
    # corner ghost refresh: vertex-plane flat positions <- real vertex
    ghost_vert_dst: Any    # [nGV] flat into [2(t), npp]
    ghost_vert_id: Any     # [nGV] real vertex ids
    # divergence ghost refresh: padded pu positions <- (slot, padded
    # cell column)
    ghost_pu_dst: Any      # [nGP] flat into [6, npp]
    ghost_pu_src: Any      # [nGP] flat into [6, npc] (slot*npc + col)
    # full GATHER maps replacing the pad+scatter builders (one
    # contiguous-output gather instead of two ghost scatters):
    plane_src: Any         # [2*npp] -> row into [1 zero row + uv]
    pu_src_full: Any       # [6*npp] -> flat into [6, npc]
    # dense EDGE-ROW maps: every seam ghost lives on the pad row/col of
    # its panel (vertex ghosts at a=N or b=0; divergence ghosts at a=0
    # or b=N), so the padded planes are a pure reshape of the
    # panel-major real arrays plus two tiny gathered edge strips
    # assembled by static concat — no scatter, no O(npp) gather
    plane_row_src: Any     # [2, 10, N+1] -> row into [1 zero + uv]
    plane_col_src: Any     # [2, 10, N]   -> row into [1 zero + uv]
    pu_row_src: Any        # [6, 10, N+1] -> flat into [1 zero + 6*npc]
    pu_col_src: Any        # [6, 10, N]   -> flat into [1 zero + 6*npc]
    # exception path (12 cells; ring-indexed contraction)
    exc_pad_cols: Any      # [12] padded columns of the exception cells
    exc_real: Any          # [12] real cell ids of the exception cells
    exc_voc: Any           # [me, 12] real ring vertex ids
    exc_mask: Any          # [me, 12]
    exc_basis_grad: Any    # [me, 2, me, 12]
    exc_basis_int: Any     # [me, 2, me, 12]
    exc_basis_metric: Any  # [me, me, 12]


def build_panel_tensors(mesh, lay: PanelLayout, basis,
                        dtype=jnp.float32) -> PanelTensors:
    """Slot-ify + pad the variational basis for a panel-reordered
    mesh (cell id = p*N^2+i*N+j, poles last; vertex id = panel-major,
    as produced by mesh.panels.panel_reorder)."""
    N = lay.N
    nc, nv, me = mesh.n_cells, mesh.n_vertices, mesh.max_edges
    assert me == 6
    npp = 10 * (N + 1) * (N + 1)
    npc = npp + 2

    # real cell -> padded column
    p = np.arange(10 * N * N) // (N * N)
    ij = np.arange(10 * N * N) % (N * N)
    i, j = ij // N, ij % N
    cell_pad = np.empty(nc, np.int64)
    cell_pad[:10 * N * N] = (p * (N + 1) + i + 1) * (N + 1) + j
    cell_pad[10 * N * N:] = npp + np.arange(2)

    bg = np.stack([basis.basis_gradient_u, basis.basis_gradient_v],
                  axis=2)                    # [nc, me(b), 2, me(g)]
    bi = np.stack([basis.basis_integrals_u, basis.basis_integrals_v],
                  axis=2)
    bm = np.asarray(basis.basis_integrals_metric)   # [nc, me(s), me(j)]

    so = np.asarray(lay.slot_of_ring)        # [nc, me] ring -> slot
    idx = np.where(so >= 0)
    cells_i, ring_i = idx
    slot_i = so[idx]
    # scatter ring axes into slot axes (row then column)
    tmp_g = np.zeros((nc, 6, 2, me))
    tmp_i = np.zeros((nc, 6, 2, me))
    tmp_m = np.zeros((nc, 6, me))
    tmp_g[cells_i, slot_i] = bg[cells_i, ring_i]
    tmp_i[cells_i, slot_i] = bi[cells_i, ring_i]
    tmp_m[cells_i, slot_i] = bm[cells_i, ring_i]
    bg_S = np.zeros((6, 2, 6, npc))
    bi_S = np.zeros((6, 2, 6, npc))
    bm_S = np.zeros((6, 6, npc))
    cp = cell_pad[cells_i]
    bg_S[:, :, slot_i, cp] = np.transpose(tmp_g[cells_i, :, :, ring_i],
                                          (1, 2, 0))
    bi_S[:, :, slot_i, cp] = np.transpose(tmp_i[cells_i, :, :, ring_i],
                                          (1, 2, 0))
    bm_S[:, slot_i, cp] = tmp_m[cells_i, :, ring_i].T

    slot_used = np.zeros((6, npc))
    slot_used[slot_i, cp] = 1.0
    ring_of_slot = np.zeros((nc, 6), np.int32)
    ring_of_slot[cells_i, slot_i] = ring_i
    slot_of_ring_a = np.where(so >= 0, so, 0).astype(np.int32)

    # corner ghosts: flat into [2, npp] (vertex planes, t-major)
    gvp = lay.ghost_vert_pos                 # (p, vi, vj, t)
    gv2d = (gvp[:, 0] * (N + 1) + gvp[:, 1]) * (N + 1) + gvp[:, 2] + 1
    gv_dst = gvp[:, 3] * npp + gv2d
    # divergence ghosts: dst flat into [6, npp]; src into [6, npc]
    gpp = lay.ghost_pu_pos                   # (slot, p, gi, gj)
    gp2d = (gpp[:, 1] * (N + 1) + gpp[:, 2] + 1) * (N + 1) + gpp[:, 3]
    gp_dst = gpp[:, 0] * npp + gp2d
    gp_src = (lay.ghost_pu_src[:, 1] * npc +
              cell_pad[lay.ghost_pu_src[:, 0]])

    # full gather maps (identity layout + ghost overrides)
    # vertex planes [2(t), npp]: position (t; p, a, b) holds real
    # vertex ((p*N + a)*N + (b-1))*2 + t for a<N, 1<=b<=N, else zero
    plane_src = np.zeros(2 * npp, np.int64)          # 0 = zero row
    tt, ppn, aa, bb = np.meshgrid(
        np.arange(2), np.arange(10), np.arange(N), np.arange(1, N + 1),
        indexing="ij")
    dst = tt * npp + (ppn * (N + 1) + aa) * (N + 1) + bb
    src = ((ppn * N + aa) * N + (bb - 1)) * 2 + tt + 1
    plane_src[dst.reshape(-1)] = src.reshape(-1)
    plane_src[gv_dst] = np.asarray(lay.ghost_vert_id) + 1
    # pu pads [6, npp]: identity from stacked [6, npc] + ghosts
    ss_, qq = np.meshgrid(np.arange(6), np.arange(npp), indexing="ij")
    pu_src_full = (ss_ * npc + qq).reshape(-1)
    pu_src_full[gp_dst] = gp_src

    # dense edge strips (see PanelTensors docstring): verify the ghost
    # sets really live on the pad rows/cols, then slice the full maps
    assert ((gvp[:, 1] == N) | (gvp[:, 2] == -1)).all(), \
        "vertex ghost off the pad row/col"
    assert ((gpp[:, 2] == -1) | (gpp[:, 3] == N)).all(), \
        "pu ghost off the pad row/col"
    ps2 = plane_src.reshape(2, 10, N + 1, N + 1)
    plane_row_src = ps2[:, :, N, :]              # a = N row
    plane_col_src = ps2[:, :, :N, 0]             # b = 0 col, a < N
    pu2 = pu_src_full.reshape(6, 10, N + 1, N + 1)
    # identity entries point back at zero-valued pad positions of
    # `stacked`, so gathering every strip entry from it is exact; the
    # (a=0, b=N) corner appears in both strips — the row strip wins
    # at merge time
    pu_row_src = pu2[:, :, 0, :]                 # a = 0 row
    pu_col_src = pu2[:, :, :, N]                 # b = N col (full)

    # exception path
    exc = np.asarray(lay.exception_cells)
    voc = np.asarray(mesh.vertices_on_cell)[exc]         # [12, me]
    neoc = np.asarray(mesh.n_edges_on_cell)[exc]
    mask = (np.arange(me)[None, :] < neoc[:, None]) & (voc >= 0)
    voc0 = np.where(mask, voc, 0)

    return PanelTensors(
        basis_grad_S=jnp.asarray(bg_S, dtype),
        basis_int_S=jnp.asarray(bi_S, dtype),
        basis_metric_S=jnp.asarray(bm_S, dtype),
        denominator=jnp.asarray(basis.variational_denominator, dtype),
        tan_lat_vertex=jnp.asarray(basis.tan_lat_vertex_over_radius,
                                   dtype),
        slot_used=jnp.asarray(slot_used, dtype),
        cell_pad_idx=jnp.asarray(cell_pad, jnp.int32),
        ring_of_slot=jnp.asarray(ring_of_slot.T, jnp.int32),
        slot_of_ring_a=jnp.asarray(slot_of_ring_a.T, jnp.int32),
        ghost_vert_dst=jnp.asarray(gv_dst, jnp.int32),
        ghost_vert_id=jnp.asarray(lay.ghost_vert_id, jnp.int32),
        ghost_pu_dst=jnp.asarray(gp_dst, jnp.int32),
        ghost_pu_src=jnp.asarray(gp_src, jnp.int32),
        plane_src=jnp.asarray(plane_src, jnp.int32),
        pu_src_full=jnp.asarray(pu_src_full, jnp.int32),
        plane_row_src=jnp.asarray(plane_row_src, jnp.int32),
        plane_col_src=jnp.asarray(plane_col_src, jnp.int32),
        pu_row_src=jnp.asarray(pu_row_src, jnp.int32),
        pu_col_src=jnp.asarray(pu_col_src, jnp.int32),
        exc_pad_cols=jnp.asarray(cell_pad[exc], jnp.int32),
        exc_real=jnp.asarray(exc, jnp.int32),
        exc_voc=jnp.asarray(voc0.T, jnp.int32),
        exc_mask=jnp.asarray(mask.T, dtype),
        exc_basis_grad=jnp.asarray(
            np.transpose(bg[exc], (1, 2, 3, 0)), dtype),
        exc_basis_int=jnp.asarray(
            np.transpose(bi[exc], (1, 2, 3, 0)), dtype),
        exc_basis_metric=jnp.asarray(
            np.transpose(bm[exc], (1, 2, 0)), dtype),
    )


# -- stress-state relabeling (once per velocity solve) -----------------------

def stress_ring_to_slot(pt: PanelTensors, s_ring_T):
    """[me, nCells] ring-indexed corner field -> padded slot-indexed
    [6, npc] (exception cells keep ring indexing in their columns)."""
    npc = pt.basis_grad_S.shape[-1]
    s = jnp.take_along_axis(s_ring_T, pt.ring_of_slot, axis=0)
    out = jnp.zeros((6, npc), s_ring_T.dtype)
    out = out.at[:, pt.cell_pad_idx].set(s)
    out = out * pt.slot_used
    return out.at[:, pt.exc_pad_cols].set(s_ring_T[:, pt.exc_real])


def stress_slot_to_ring(pt: PanelTensors, s_slot_pad):
    """Inverse: padded slot-indexed [6, npc] -> real ring [me, nc]."""
    s = s_slot_pad[:, pt.cell_pad_idx]            # [6, nc]
    out = jnp.take_along_axis(s, pt.slot_of_ring_a, axis=0)
    exc_vals = s_slot_pad[:, pt.exc_pad_cols]
    return out.at[:, pt.exc_real].set(exc_vals)


# -- kernels -----------------------------------------------------------------

def _vertex_planes(pt, N, uv):
    """Real [nv, F] vertex fields -> padded planes [2(t), npp, F] with
    seam ghosts filled.  The panel-major vertex numbering makes the
    plane interior a pure reshape of `uv` (vertex ((p*N+a)*N+(b-1))*2+t
    sits at plane (t; p, a, b)); only the two pad strips per panel
    (a = N row, b = 0 column) hold seam ghosts, gathered as tiny dense
    edge strips and assembled by static concat — no scatter and no
    O(npp) gather (bitwise-identical to the full-map gather it
    replaced)."""
    npp = 10 * (N + 1) * (N + 1)
    F = uv.shape[-1]
    uv1 = jnp.concatenate(
        [jnp.zeros((1, F), uv.dtype), uv], axis=0)
    interior = jnp.moveaxis(
        uv.reshape(10, N, N, 2, F), 3, 0)        # [2, 10, N(a), N(q), F]
    gc = uv1[pt.plane_col_src]                   # [2, 10, N, F]
    gr = uv1[pt.plane_row_src]                   # [2, 10, N+1, F]
    body = jnp.concatenate([gc[:, :, :, None], interior], axis=3)
    planes = jnp.concatenate([body, gr[:, :, None]], axis=2)
    return planes.reshape(2, npp, F)


def strain_tensor_P(pt: PanelTensors, N: int, u, v,
                    include_metric: bool = False):
    """Strain at cell corners via flat panel shifts; returns
    [6, npc] padded slot-indexed arrays."""
    npp = 10 * (N + 1) * (N + 1)
    npc = pt.basis_grad_S.shape[-1]
    uv = jnp.stack([u, v], axis=-1)
    if include_metric:
        uv = jnp.concatenate([uv, pt.tan_lat_vertex[:, None]], axis=-1)
    planes = _vertex_planes(pt, N, uv)           # [2, npp, F]

    offs = _corner_flat_offsets(N)
    pad0 = N + 1                                  # safety margin
    F = planes.shape[-1]
    ext = jnp.zeros((2, npp + 2 * pad0, F), planes.dtype)
    ext = ext.at[:, pad0:pad0 + npp].set(planes)
    cs = []
    for (d, t) in offs:
        blk = ext[t, pad0 + d:pad0 + d + npp]     # [npp, F]
        cs.append(blk)
    corner = jnp.stack(cs)                        # [6, npp, F]
    zpad = jnp.zeros((6, npc - npp, F), corner.dtype)
    corner = jnp.concatenate([corner, zpad], axis=1)   # [6, npc, F]
    corner = corner * pt.slot_used[..., None]
    u_c = corner[..., 0]
    v_c = corner[..., 1]

    gx = pt.basis_grad_S[:, 0]                   # [6(b), 6(g), npc]
    gy = pt.basis_grad_S[:, 1]
    e11 = (u_c[:, None, :] * gx).sum(0)
    e22 = (v_c[:, None, :] * gy).sum(0)
    e12 = 0.5 * ((u_c[:, None, :] * gy).sum(0) +
                 (v_c[:, None, :] * gx).sum(0))
    if include_metric:
        tl_c = corner[..., 2]
        e11 = e11 - v_c * tl_c
        e12 = e12 + 0.5 * u_c * tl_c

    # exception cells: ring-indexed strain via the tiny gather
    uve = jnp.stack([u, v], axis=-1)[pt.exc_voc] * \
        pt.exc_mask[..., None]                   # [me, 12, 2]
    ue, ve = uve[..., 0], uve[..., 1]
    egx = pt.exc_basis_grad[:, 0]
    egy = pt.exc_basis_grad[:, 1]
    x11 = (ue[:, None, :] * egx).sum(0)
    x22 = (ve[:, None, :] * egy).sum(0)
    x12 = 0.5 * ((ue[:, None, :] * egy).sum(0) +
                 (ve[:, None, :] * egx).sum(0))
    if include_metric:
        tle = pt.tan_lat_vertex[pt.exc_voc] * pt.exc_mask
        x11 = x11 - ve * tle
        x12 = x12 + 0.5 * ue * tle
    e11 = e11.at[:, pt.exc_pad_cols].set(x11)
    e22 = e22.at[:, pt.exc_pad_cols].set(x22)
    e12 = e12.at[:, pt.exc_pad_cols].set(x12)
    return e11, e22, e12


def divergence_partials(pt: PanelTensors, s11, s22, s12,
                        include_metric: bool = False):
    """Cell-side partial products feeding the dual accumulation.
    Returns stacked [6, npc, F] (F=4 with metric)."""
    bu = pt.basis_int_S[:, 0]
    bv = pt.basis_int_S[:, 1]
    pu = (s11[:, None, :] * bu).sum(0) + (s12[:, None, :] * bv).sum(0)
    pv = (s22[:, None, :] * bv).sum(0) + (s12[:, None, :] * bu).sum(0)
    if include_metric:
        mu = (s12[:, None, :] * pt.basis_metric_S).sum(0)
        mv = (s11[:, None, :] * pt.basis_metric_S).sum(0)
        return jnp.stack([pu, pv, mu, mv], axis=-1)
    return jnp.stack([pu, pv], axis=-1)


def stress_divergence_P(pt: PanelTensors, N: int, s11, s22, s12,
                        solve_velocity, include_metric: bool = False):
    """Stress divergence at vertices via flat panel shifts.  s** are
    padded slot-indexed [6, npc]; returns real (du, dv) [nVertices]."""
    stacked = divergence_partials(pt, s11, s22, s12, include_metric)
    return divergence_finish(pt, N, stacked, s11, s22, s12,
                             solve_velocity, include_metric)


def divergence_finish(pt: PanelTensors, N: int, stacked,
                      s11, s22, s12, solve_velocity,
                      include_metric: bool = False):
    """Ghost refresh + dual accumulation + exception scatter +
    momentum-ready (du, dv).  `stacked` [6, npc, F] are the cell-side
    partials; s** are needed only for the exception columns."""
    npp = 10 * (N + 1) * (N + 1)
    npc = s11.shape[1]
    F = stacked.shape[-1]
    # seam ghost refresh: divergence ghosts live only on the pad strips
    # (a = 0 row, b = N column) of each panel, so the ghost values are
    # two tiny gathered edge strips merged by broadcast + select —
    # full-array elementwise ops instead of a row scatter or strided
    # static-slice sets.
    src_flat = stacked.reshape(6 * npc, F)
    gr0 = src_flat[pt.pu_row_src]                # [6, 10, N+1, F] a=0
    gcN = src_flat[pt.pu_col_src]                # [6, 10, N+1, F] b=N
    pads5 = stacked[:, :npp].reshape(6, 10, N + 1, N + 1, F)
    a_ix = jnp.arange(N + 1)
    row_mask = (a_ix == 0)[None, None, :, None, None]
    col_mask = (a_ix == N)[None, None, None, :, None]
    pads5 = jnp.where(row_mask, gr0[:, :, None, :, :],
                      jnp.where(col_mask, gcN[:, :, :, None, :],
                                pads5))
    pads = pads5.reshape(6, npp, F)

    pad0 = N + 1
    ext = jnp.zeros((6, npp + 2 * pad0, F), pads.dtype)
    ext = ext.at[:, pad0:pad0 + npp].set(pads)
    dual = _dual_flat_offsets(N)
    acc = []
    for t in (0, 1):
        tot = None
        for (d, slot) in dual[t]:
            blk = ext[slot, pad0 + d:pad0 + d + npp]
            tot = blk if tot is None else tot + blk
        acc.append(tot)
    g = jnp.stack(acc)                            # [2, npp, F]
    # padded vertex planes -> real vertex order
    g = g.reshape(2, 10, N + 1, N + 1, F)[:, :, :N, 1:]
    g = jnp.moveaxis(g, 0, 3).reshape(-1, F)      # [nv, F]

    tlv = pt.tan_lat_vertex
    if include_metric:
        du = -(g[:, 0] + g[:, 2] * tlv)
        dv = -g[:, 1] + g[:, 3] * tlv
    else:
        du = -g[:, 0]
        dv = -g[:, 1]

    # exception-cell contributions: ring-indexed scatter to their ring
    # vertices
    s11e = s11[:, pt.exc_pad_cols]
    s22e = s22[:, pt.exc_pad_cols]
    s12e = s12[:, pt.exc_pad_cols]
    ebu = pt.exc_basis_int[:, 0]
    ebv = pt.exc_basis_int[:, 1]
    pue = (s11e[:, None, :] * ebu).sum(0) + \
        (s12e[:, None, :] * ebv).sum(0)
    pve = (s22e[:, None, :] * ebv).sum(0) + \
        (s12e[:, None, :] * ebu).sum(0)
    if include_metric:
        mue = (s12e[:, None, :] * pt.exc_basis_metric).sum(0)
        mve = (s11e[:, None, :] * pt.exc_basis_metric).sum(0)
        tle = tlv[pt.exc_voc]
        cu = (pue + mue * tle) * pt.exc_mask
        cv = (pve - mve * tle) * pt.exc_mask
    else:
        cu = pue * pt.exc_mask
        cv = pve * pt.exc_mask
    du = du.at[pt.exc_voc.reshape(-1)].add(-cu.reshape(-1))
    dv = dv.at[pt.exc_voc.reshape(-1)].add(-cv.reshape(-1))

    du = jnp.where(solve_velocity > 0, du / pt.denominator, 0.0)
    dv = jnp.where(solve_velocity > 0, dv / pt.denominator, 0.0)
    return du, dv
