"""Structured (raster) quad-mesh detection and reordering.

JAX fast path: when the mesh is a regular quad grid (the
reference's square/box testcases, `testcases/square/*`), the EVP
subcycle's two gathers — vertex velocities to cell corners and corner
stresses back to vertices (`mpas_seaice_velocity_solver_variational.F`
:575-670, :1064-1184) — are expressible as static 2-D SHIFTS of
raster-ordered fields.  Shifts are contiguous slices, so the per-index
gathers disappear.

`detect_raster_quad` recognizes the layout; `raster_reorder` permutes a
mesh's vertices into raster order so the detection holds (cells from
the generators are already raster-ordered).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from .core import Mesh


@dataclasses.dataclass(frozen=True)
class RasterQuad:
    """Static description of a raster quad layout (plain Python ints —
    compile-time constants, never traced)."""
    nxc: int                 # cells in x (fastest-varying: raster j)
    nyc: int
    nxv: int                 # vertices in x
    nyv: int
    # corner slot -> vertex offset (iv - ic, jv - jc)
    offsets: Tuple[Tuple[int, int], ...]
    periodic: bool = False


def detect_raster_quad(mesh: Mesh) -> Optional[RasterQuad]:
    """Return the raster layout if this mesh is a raster-ordered
    regular quad grid, else None."""
    if mesh.on_sphere or mesh.max_edges != 4 or mesh.vertex_degree != 4:
        return None
    if mesh.period_x or mesh.period_y:
        return None       # periodic path not implemented yet
    # infer grid spacing from the first edge
    dc = float(np.median(mesh.dv_edge[mesh.dv_edge > 0]))
    if dc <= 0:
        return None
    x0v, y0v = mesh.x_vertex.min(), mesh.y_vertex.min()
    iv = np.round((mesh.x_vertex - x0v) / dc).astype(np.int64)
    jv = np.round((mesh.y_vertex - y0v) / dc).astype(np.int64)
    if not (np.allclose(iv * dc + x0v, mesh.x_vertex, atol=1e-6 * dc)
            and np.allclose(jv * dc + y0v, mesh.y_vertex,
                            atol=1e-6 * dc)):
        return None
    nxv, nyv = int(iv.max()) + 1, int(jv.max()) + 1
    if nxv * nyv != mesh.n_vertices:
        return None
    vid = iv * nyv + jv
    if not np.array_equal(np.sort(vid), np.arange(mesh.n_vertices)):
        return None
    if not np.array_equal(vid, np.arange(mesh.n_vertices)):
        return None       # vertices not raster-ordered; reorder first
    x0c, y0c = mesh.x_cell.min(), mesh.y_cell.min()
    ic = np.round((mesh.x_cell - x0c) / dc).astype(np.int64)
    jc = np.round((mesh.y_cell - y0c) / dc).astype(np.int64)
    nxc, nyc = int(ic.max()) + 1, int(jc.max()) + 1
    if nxc * nyc != mesh.n_cells:
        return None
    if not np.array_equal(ic * nyc + jc, np.arange(mesh.n_cells)):
        return None
    if nxv != nxc + 1 or nyv != nyc + 1:
        return None
    # constant corner offsets per slot
    offsets = []
    for b in range(4):
        vv = mesh.vertices_on_cell[:, b]
        if (vv < 0).any():
            return None
        oi = iv[vv] - ic
        oj = jv[vv] - jc
        if oi.min() != oi.max() or oj.min() != oj.max():
            return None
        o = (int(oi[0]), int(oj[0]))
        if o not in ((0, 0), (1, 0), (0, 1), (1, 1)):
            return None
        offsets.append(o)
    return RasterQuad(nxc=nxc, nyc=nyc, nxv=nxv, nyv=nyv,
                      offsets=tuple(offsets))


def raster_reorder(mesh: Mesh) -> Mesh:
    """Permute the mesh's vertices into raster order (iv*nyv + jv) so
    detect_raster_quad succeeds.  Cells from the generators are already
    raster-ordered; a no-op for meshes that aren't regular quads."""
    if mesh.on_sphere or mesh.max_edges != 4:
        return mesh
    dc = float(np.median(mesh.dv_edge[mesh.dv_edge > 0]))
    x0, y0 = mesh.x_vertex.min(), mesh.y_vertex.min()
    iv = np.round((mesh.x_vertex - x0) / dc).astype(np.int64)
    jv = np.round((mesh.y_vertex - y0) / dc).astype(np.int64)
    nyv = int(jv.max()) + 1
    vid = iv * nyv + jv
    if not np.array_equal(np.sort(vid), np.arange(mesh.n_vertices)):
        return mesh
    # new_of_old[old] = new position; old_of_new[new] = old index
    new_of_old = vid
    old_of_new = np.argsort(new_of_old)

    def pv(a):      # permute per-vertex rows
        return None if a is None else a[old_of_new]

    def ri(a):      # remap vertex index values
        if a is None:
            return None
        return np.where(a >= 0, new_of_old[np.maximum(a, 0)], -1)

    m = dataclasses.replace(
        mesh,
        vertices_on_cell=ri(mesh.vertices_on_cell),
        cells_on_vertex=pv(mesh.cells_on_vertex),
        edges_on_vertex=pv(mesh.edges_on_vertex),
        vertices_on_edge=ri(mesh.vertices_on_edge),
        x_vertex=pv(mesh.x_vertex), y_vertex=pv(mesh.y_vertex),
        z_vertex=pv(mesh.z_vertex),
        lat_vertex=pv(mesh.lat_vertex), lon_vertex=pv(mesh.lon_vertex),
        area_triangle=pv(mesh.area_triangle),
        kite_areas_on_vertex=pv(mesh.kite_areas_on_vertex),
        f_vertex=pv(mesh.f_vertex),
        # derived fields are vertex-indexed; rebuild them
        cell_vertices_at_vertex=None,
        interior_vertex=None,
    )
    return m.finalize()
