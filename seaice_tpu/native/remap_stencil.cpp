// Native remap-stencil builder.
//
// C++ replacement for the O(nEdges) Python loops in
// seaice_tpu/transport/geometry.py (the JAX analog of the
// reference's get_geometry_incremental_remap stencil construction,
// /root/reference/src/shared/mpas_seaice_advection_incremental_remap.F:
// 1105-1808): builds the per-edge remap stencil (C1..C6, E1..E6, local
// vertex indices), the CFL edge-length minima, and cell/edge
// orientation signs.  Compiled to a shared library at first use and
// bound via ctypes; the Python implementation remains as the reference
// fallback (equality-tested).

#include <cstdint>
#include <cmath>

extern "C" {

// All connectivity is 0-based with -1 for invalid entries, matching the
// host-side Mesh convention.
void build_remap_stencil(
    int64_t ne, int64_t nc, int64_t nv, int64_t me, int64_t vd,
    const int32_t* cells_on_edge,      // [ne, 2]
    const int32_t* vertices_on_edge,   // [ne, 2]
    const int32_t* edges_on_cell,      // [nc, me]
    const int32_t* vertices_on_cell,   // [nc, me]
    const int32_t* n_edges_on_cell,    // [nc]
    const int32_t* edges_on_vertex,    // [nv, vd]
    const double* dv_edge,             // [ne]
    int32_t* remap_edge,               // out [ne]
    int32_t* cells_rm,                 // out [ne, 6]
    int32_t* edges_rm,                 // out [ne, 6]
    int32_t* vocr,                     // out [ne, 6, 2]
    double* min_len,                   // out [nv]
    double* esoc)                      // out [nc, me]
{
    auto coe = [&](int64_t e, int k) { return cells_on_edge[e * 2 + k]; };
    auto voe = [&](int64_t e, int k) {
        return vertices_on_edge[e * 2 + k]; };
    auto eoc = [&](int64_t c, int k) { return edges_on_cell[c * me + k]; };
    auto voc = [&](int64_t c, int k) {
        return vertices_on_cell[c * me + k]; };

    // edge of cell c containing vertex v, excluding up to 3 edges
    auto edge_of_cell_with_vertex = [&](int32_t c, int32_t v,
                                        int32_t x0, int32_t x1,
                                        int32_t x2) -> int32_t {
        if (c < 0) return -1;
        for (int k = 0; k < n_edges_on_cell[c]; ++k) {
            int32_t e2 = eoc(c, k);
            if (e2 < 0 || e2 == x0 || e2 == x1 || e2 == x2) continue;
            if (voe(e2, 0) == v || voe(e2, 1) == v) return e2;
        }
        return -1;
    };
    auto other_cell = [&](int32_t e2, int32_t c) -> int32_t {
        if (e2 < 0) return -1;
        int32_t a = coe(e2, 0), b = coe(e2, 1);
        return (a == c) ? b : a;
    };

    for (int64_t e = 0; e < ne; ++e) {
        remap_edge[e] = (coe(e, 0) >= 0 && coe(e, 1) >= 0) ? 1 : 0;
        for (int s = 0; s < 6; ++s) {
            cells_rm[e * 6 + s] = -1;
            edges_rm[e * 6 + s] = -1;
            vocr[(e * 6 + s) * 2 + 0] = -1;
            vocr[(e * 6 + s) * 2 + 1] = -1;
        }
        if (!remap_edge[e]) continue;
        int32_t v1 = voe(e, 0), v2 = voe(e, 1);
        int32_t c1 = coe(e, 0), c2 = coe(e, 1);
        cells_rm[e * 6 + 0] = c1;
        cells_rm[e * 6 + 1] = c2;
        int32_t e1 = edge_of_cell_with_vertex(c1, v1, e, -9, -9);
        int32_t e2_ = edge_of_cell_with_vertex(c1, v2, e, -9, -9);
        int32_t e3 = edge_of_cell_with_vertex(c2, v1, e, -9, -9);
        int32_t e4 = edge_of_cell_with_vertex(c2, v2, e, -9, -9);
        edges_rm[e * 6 + 0] = e1;
        edges_rm[e * 6 + 1] = e2_;
        edges_rm[e * 6 + 2] = e3;
        edges_rm[e * 6 + 3] = e4;
        if (vd == 4) {
            // E5/E6: remaining edge at V1/V2
            const int32_t known1[3] = {(int32_t)e, e1, e3};
            const int32_t known2[3] = {(int32_t)e, e2_, e4};
            for (int kk = 0; kk < 2; ++kk) {
                int32_t v = kk == 0 ? v1 : v2;
                const int32_t* known = kk == 0 ? known1 : known2;
                for (int j = 0; j < vd; ++j) {
                    int32_t cand = edges_on_vertex[(int64_t)v * vd + j];
                    if (cand >= 0 && cand != known[0] &&
                        cand != known[1] && cand != known[2]) {
                        edges_rm[e * 6 + 4 + kk] = cand;
                        break;
                    }
                }
            }
        }
        if (vd == 3) {
            int32_t c3 = other_cell(e1, c1);
            if (c3 < 0 || c3 == c2) {
                c3 = other_cell(e3, c2);
                if (c3 == c1) c3 = -1;
            }
            int32_t c4 = other_cell(e2_, c1);
            if (c4 < 0 || c4 == c2) {
                c4 = other_cell(e4, c2);
                if (c4 == c1) c4 = -1;
            }
            cells_rm[e * 6 + 2] = c3;
            cells_rm[e * 6 + 3] = c4;
        } else {
            cells_rm[e * 6 + 2] = other_cell(e1, c1);
            cells_rm[e * 6 + 3] = other_cell(e2_, c1);
            cells_rm[e * 6 + 4] = other_cell(e3, c2);
            cells_rm[e * 6 + 5] = other_cell(e4, c2);
        }
        // local index of V1/V2 within each remap cell's vertex list
        for (int s = 0; s < 6; ++s) {
            int32_t cc = cells_rm[e * 6 + s];
            if (cc < 0) continue;
            for (int t = 0; t < 2; ++t) {
                int32_t vt = t == 0 ? v1 : v2;
                for (int k = 0; k < n_edges_on_cell[cc]; ++k) {
                    if (voc(cc, k) == vt) {
                        vocr[(e * 6 + s) * 2 + t] = k;
                        break;
                    }
                }
            }
        }
    }

    // CFL minimum edge length at each vertex
    for (int64_t v = 0; v < nv; ++v) min_len[v] = 0.0;
    for (int64_t v = 0; v < nv; ++v) min_len[v] = 1.0e300;
    for (int64_t e = 0; e < ne; ++e) {
        int32_t v1 = voe(e, 0), v2 = voe(e, 1);
        if (v1 < 0 || v2 < 0) continue;
        double ln = dv_edge[e];
        if (ln < min_len[v1]) min_len[v1] = ln;
        if (ln < min_len[v2]) min_len[v2] = ln;
    }
    for (int64_t v = 0; v < nv; ++v)
        if (min_len[v] > 1.0e299) min_len[v] = 0.0;

    // +-1 orientation of each cell relative to its edges
    for (int64_t c = 0; c < nc; ++c) {
        for (int k = 0; k < me; ++k) esoc[c * me + k] = 0.0;
        for (int k = 0; k < n_edges_on_cell[c]; ++k) {
            int32_t e = eoc(c, k);
            if (e < 0) continue;
            esoc[c * me + k] = (coe(e, 0) == c) ? 1.0 : -1.0;
        }
    }
}

}  // extern "C"
