"""Planar mesh generators (periodic or bounded quad / hex).

JAX replacement for the reference's grid-generation tooling
(`/root/reference/testing_and_setup/testcases/square/*/create_grids.py`):
builds the full MPAS-style connectivity (verticesOnCell, cellsOnVertex,
edges, kite areas, dual areas) directly in NumPy.

Construction is generic: every cell's polygon corners are generated in CCW
order, then vertices/edges are deduplicated by quantized coordinates (with
periodic wrapping), and inverse connectivity follows.
"""

from __future__ import annotations

import numpy as np

from .core import Mesh

SQRT3 = np.sqrt(3.0)


def _dedupe_points(points: np.ndarray, tol: float):
    """Map [N,2] points to unique ids, merging points within tol.

    Uses a KD-tree clustering so coincident points split across a rounding
    boundary still merge. Returns (ids[N], unique_coords[M,2]).
    """
    from scipy.spatial import cKDTree

    tree = cKDTree(points)
    pairs = tree.query_pairs(tol, output_type="ndarray")
    # union-find over near-coincident pairs
    parent = np.arange(len(points))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for a, b in pairs:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)
    roots = np.array([find(a) for a in range(len(points))])
    uniq_roots, ids = np.unique(roots, return_inverse=True)
    return ids.astype(np.int64), points[uniq_roots]


def _build_from_polygons(cell_centers: np.ndarray,
                         corners: np.ndarray,
                         corner_valid: np.ndarray,
                         lx: float, ly: float,
                         periodic_x: bool, periodic_y: bool,
                         vertex_degree: int) -> Mesh:
    """Assemble a Mesh from per-cell CCW polygon corners.

    cell_centers: [nCells, 2]; corners: [nCells, maxEdges, 2] (CCW);
    corner_valid: [nCells, maxEdges] bool. Periodic coordinates are wrapped
    into [0, lx) x [0, ly) for identification only; stored coordinates keep
    the per-cell local (unwrapped) values for cell geometry, while vertex
    coordinates are the wrapped representatives.
    """
    n_cells, max_edges, _ = corners.shape
    dc_scale = max(lx, ly) / max(n_cells, 1) ** 0.5
    tol = 1e-6 * max(dc_scale, 1.0)

    def _wrap(coords, period):
        w = np.mod(coords, period)
        # snap points within tol of the seam onto 0 so both images merge
        return np.where(w > period - tol, 0.0, w)

    wrapped = corners.copy()
    if periodic_x:
        wrapped[..., 0] = _wrap(wrapped[..., 0], lx)
    if periodic_y:
        wrapped[..., 1] = _wrap(wrapped[..., 1], ly)

    flat = wrapped.reshape(-1, 2)
    flat_valid = corner_valid.reshape(-1)
    ids_all = np.full(len(flat), -1, dtype=np.int64)
    ids, vcoords = _dedupe_points(flat[flat_valid], tol)
    ids_all[flat_valid] = ids
    vertices_on_cell = ids_all.reshape(n_cells, max_edges).astype(np.int32)
    n_vertices = len(vcoords)

    n_edges_on_cell = corner_valid.sum(axis=1).astype(np.int32)

    # edges: midpoint of consecutive corner pairs (CCW, edge k joins corner
    # k-1 -> k in the Wachspress convention; here edge slot k joins corner k
    # and corner k+1 for bookkeeping — any consistent convention works since
    # edge connectivity is only used by transport).
    mids = []
    edge_cellpairs = []
    edge_vertpairs = []
    for k in range(max_edges):
        nxt = (k + 1) % max_edges
        valid = corner_valid[:, k]
        # for ragged cells, corner k+1 may be invalid; the wrap is to
        # n_edges_on_cell-1 -> 0
        nxt_idx = np.where((k + 1) < n_edges_on_cell, (k + 1) % max_edges, 0)
        a = wrapped[np.arange(n_cells), np.full(n_cells, k)]
        b = wrapped[np.arange(n_cells), nxt_idx]
        m = 0.5 * (corners[:, k] + corners[np.arange(n_cells), nxt_idx])
        if periodic_x:
            m[:, 0] = _wrap(m[:, 0], lx)
        if periodic_y:
            m[:, 1] = _wrap(m[:, 1], ly)
        mids.append(np.where(valid[:, None], m, np.nan))
        edge_cellpairs.append(np.arange(n_cells))
        va = vertices_on_cell[:, k]
        vb = vertices_on_cell[np.arange(n_cells), nxt_idx]
        edge_vertpairs.append(np.stack([va, vb], axis=1))

    mids = np.stack(mids, axis=1)           # [nCells, maxEdges, 2]
    evp = np.stack(edge_vertpairs, axis=1)  # [nCells, maxEdges, 2]
    flat_m = mids.reshape(-1, 2)
    m_valid = corner_valid.reshape(-1) & ~np.isnan(flat_m[:, 0])
    eids_all = np.full(len(flat_m), -1, dtype=np.int64)
    eids, ecoords = _dedupe_points(flat_m[m_valid], tol)
    eids_all[m_valid] = eids
    edges_on_cell = eids_all.reshape(n_cells, max_edges).astype(np.int32)
    n_edges = len(ecoords)

    # cells_on_edge / vertices_on_edge
    cells_on_edge = np.full((n_edges, 2), -1, dtype=np.int32)
    vertices_on_edge = np.full((n_edges, 2), -1, dtype=np.int32)
    cell_idx = np.repeat(np.arange(n_cells), max_edges)
    flat_eid = edges_on_cell.reshape(-1)
    flat_evp = evp.reshape(-1, 2)
    for i in range(len(flat_eid)):
        e = flat_eid[i]
        if e < 0:
            continue
        if cells_on_edge[e, 0] < 0:
            cells_on_edge[e, 0] = cell_idx[i]
            vertices_on_edge[e] = flat_evp[i]
        elif cells_on_edge[e, 0] != cell_idx[i]:
            cells_on_edge[e, 1] = cell_idx[i]

    # cells_on_vertex (inverse of vertices_on_cell); order arbitrary but
    # consistent with cell_vertices_at_vertex computed in finalize()
    voc_flat = vertices_on_cell.reshape(-1)
    cells_on_vertex = np.full((n_vertices, vertex_degree), -1, dtype=np.int32)
    fill = np.zeros(n_vertices, dtype=np.int32)
    for i in range(len(voc_flat)):
        v = voc_flat[i]
        if v >= 0:
            cells_on_vertex[v, fill[v]] = cell_idx[i]
            fill[v] += 1

    # cells_on_cell via shared edges
    cells_on_cell = np.full((n_cells, max_edges), -1, dtype=np.int32)
    for c in range(n_cells):
        for k in range(max_edges):
            e = edges_on_cell[c, k]
            if e < 0:
                continue
            a, b = cells_on_edge[e]
            cells_on_cell[c, k] = b if a == c else a

    # edges_on_vertex
    edges_on_vertex = np.full((n_vertices, vertex_degree), -1, dtype=np.int32)
    fill_e = np.zeros(n_vertices, dtype=np.int32)
    for e in range(n_edges):
        for v in vertices_on_edge[e]:
            if v >= 0 and fill_e[v] < vertex_degree:
                if e not in edges_on_vertex[v, :fill_e[v]]:
                    edges_on_vertex[v, fill_e[v]] = e
                    fill_e[v] += 1

    # geometry: areas via shoelace on local (unwrapped) corner coords
    rel = corners - cell_centers[:, None, :]
    area_cell = np.zeros(n_cells)
    for c in range(n_cells):
        n = n_edges_on_cell[c]
        x = rel[c, :n, 0]
        y = rel[c, :n, 1]
        area_cell[c] = 0.5 * np.abs(
            np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))

    # kite areas: quad (vertex, edge-mid, center, edge-mid) per (cell,corner)
    kite = np.zeros((n_cells, max_edges))
    for c in range(n_cells):
        n = n_edges_on_cell[c]
        for k in range(n):
            vprev = rel[c, (k - 1) % n]
            vk = rel[c, k]
            vnext = rel[c, (k + 1) % n]
            m0 = 0.5 * (vprev + vk)   # midpoint of edge (k-1,k)
            m1 = 0.5 * (vk + vnext)   # midpoint of edge (k,k+1)
            quad = np.array([vk, m1, [0.0, 0.0], m0])
            x, y = quad[:, 0], quad[:, 1]
            kite[c, k] = 0.5 * np.abs(
                np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))

    kite_areas_on_vertex = np.zeros((n_vertices, vertex_degree))
    area_triangle = np.zeros(n_vertices)
    for c in range(n_cells):
        n = n_edges_on_cell[c]
        for k in range(n):
            v = vertices_on_cell[c, k]
            slot = np.where(cells_on_vertex[v] == c)[0]
            if len(slot):
                kite_areas_on_vertex[v, slot[0]] = kite[c, k]
    area_triangle = kite_areas_on_vertex.sum(axis=1)

    # edge lengths
    dv_edge = np.zeros(n_edges)
    dc_edge = np.zeros(n_edges)
    for e in range(n_edges):
        v1, v2 = vertices_on_edge[e]
        if v1 >= 0 and v2 >= 0:
            d = vcoords[v1] - vcoords[v2]
            if periodic_x:
                d[0] -= lx * np.round(d[0] / lx)
            if periodic_y:
                d[1] -= ly * np.round(d[1] / ly)
            dv_edge[e] = np.hypot(*d)
        c1, c2 = cells_on_edge[e]
        if c1 >= 0 and c2 >= 0:
            d = cell_centers[c1] - cell_centers[c2]
            if periodic_x:
                d[0] -= lx * np.round(d[0] / lx)
            if periodic_y:
                d[1] -= ly * np.round(d[1] / ly)
            dc_edge[e] = np.hypot(*d)

    mesh = Mesh(
        n_cells=n_cells, n_vertices=n_vertices, n_edges=n_edges,
        max_edges=max_edges, vertex_degree=vertex_degree,
        on_sphere=False, sphere_radius=0.0,
        period_x=lx if periodic_x else 0.0,
        period_y=ly if periodic_y else 0.0,
        vertices_on_cell=vertices_on_cell,
        n_edges_on_cell=n_edges_on_cell,
        cells_on_vertex=cells_on_vertex,
        edges_on_cell=edges_on_cell,
        cells_on_cell=cells_on_cell,
        cells_on_edge=cells_on_edge,
        vertices_on_edge=vertices_on_edge,
        edges_on_vertex=edges_on_vertex,
        x_cell=cell_centers[:, 0].copy(),
        y_cell=cell_centers[:, 1].copy(),
        z_cell=np.zeros(n_cells),
        x_vertex=vcoords[:, 0].copy(),
        y_vertex=vcoords[:, 1].copy(),
        z_vertex=np.zeros(n_vertices),
        x_edge=ecoords[:, 0].copy(),
        y_edge=ecoords[:, 1].copy(),
        lat_cell=np.zeros(n_cells), lon_cell=np.zeros(n_cells),
        lat_vertex=np.zeros(n_vertices), lon_vertex=np.zeros(n_vertices),
        area_cell=area_cell,
        area_triangle=area_triangle,
        kite_areas_on_vertex=kite_areas_on_vertex,
        dv_edge=dv_edge, dc_edge=dc_edge,
    )
    return mesh.finalize()


def planar_quad_mesh(nx: int, ny: int, dc: float,
                     periodic: bool = False) -> Mesh:
    """Planar quadrilateral mesh: nx*ny square cells of side dc."""
    i, j = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    i = i.reshape(-1)
    j = j.reshape(-1)
    xc = (i + 0.5) * dc
    yc = (j + 0.5) * dc
    centers = np.stack([xc, yc], axis=1)
    # CCW corners: SW, SE, NE, NW
    offs = np.array([[-0.5, -0.5], [0.5, -0.5], [0.5, 0.5], [-0.5, 0.5]]) * dc
    corners = centers[:, None, :] + offs[None, :, :]
    valid = np.ones((nx * ny, 4), dtype=bool)
    return _build_from_polygons(centers, corners, valid,
                                nx * dc, ny * dc, periodic, periodic,
                                vertex_degree=4)


def planar_hex_mesh(nx: int, ny: int, dc: float,
                    periodic: bool = False) -> Mesh:
    """Planar hexagonal mesh (pointy-top hexes, rows offset by dc/2).

    dc is the distance between adjacent cell centers (width across flats).
    For periodic meshes ny must be even.
    """
    if periodic and ny % 2 != 0:
        raise ValueError("periodic hex mesh requires even ny")
    r = dc / SQRT3  # circumradius = hex edge length
    i, j = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    i = i.reshape(-1)
    j = j.reshape(-1)
    xc = i * dc + 0.5 * dc * (j % 2)
    yc = j * 1.5 * r
    centers = np.stack([xc, yc], axis=1)
    ang = np.deg2rad(np.array([330.0, 30.0, 90.0, 150.0, 210.0, 270.0]))
    offs = np.stack([r * np.cos(ang), r * np.sin(ang)], axis=1)  # CCW
    corners = centers[:, None, :] + offs[None, :, :]
    valid = np.ones((nx * ny, 6), dtype=bool)
    return _build_from_polygons(centers, corners, valid,
                                nx * dc, ny * 1.5 * r, periodic, periodic,
                                vertex_degree=3)
