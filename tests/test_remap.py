"""Incremental-remapping transport tests.

Mirrors the reference's runtime self-checks (conservation :8126, global
monotonicity bounds :8416) and the advection testcase strategy
(testing_and_setup/testcases/advection: solid-body transport of tracer
blobs with error convergence).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from seaice_tpu.mesh import planar_quad_mesh, planar_hex_mesh
from seaice_tpu.transport import (
    build_remap_geometry, standard_tracer_tree, mass_only_tree,
    make_remap_step, global_conserved_sums, find_departure_triangles,
    triangles_to_cell_coords)
from seaice_tpu.transport.tracers import TracerSpec, TracerTree


def _setup(mesh, tree):
    geom = build_remap_geometry(mesh)
    rt = geom.tensors()
    mt = mesh.tensors(jnp.float64)
    step = make_remap_step(tree, mesh.vertex_degree)
    import functools
    bound = functools.partial(jax.jit(step, static_argnums=()),
                              rt, mt.cells_on_cell, mt.cells_on_cell_mask,
                              jnp.asarray(mesh.area_cell))
    return rt, mt, bound


def _uniform_velocity(mesh, u, v):
    nv = mesh.n_vertices
    return (jnp.full((nv,), u, jnp.float64),
            jnp.full((nv,), v, jnp.float64))


@pytest.mark.parametrize("mesh_kind", ["quad", "hex"])
def test_departure_triangle_area_closure(mesh_kind):
    """Sum of |triangle areas| per edge equals the swept-quad area for a
    uniform flow (every edge's departure region decomposes exactly)."""
    if mesh_kind == "quad":
        mesh = planar_quad_mesh(8, 8, 1000.0, periodic=True)
    else:
        mesh = planar_hex_mesh(8, 8, 1000.0, periodic=True)
    geom = build_remap_geometry(mesh)
    rt = geom.tensors()
    dt = 100.0
    u, v = 1.3, 0.7   # m/s, well under CFL
    dpx = jnp.full((mesh.n_vertices,), -u * dt, jnp.float64)
    dpy = jnp.full((mesh.n_vertices,), -v * dt, jnp.float64)
    tris = find_departure_triangles(rt, dpx, dpy, mesh.vertex_degree)
    cell, xq, yq, area = triangles_to_cell_coords(rt, tris)

    # uniform translation: swept area of edge = |cross(edge_vec, d)| where
    # d = (u,v)*dt; signed areas must sum to the signed swept area.
    ex = mesh.x_vertex[mesh.vertices_on_edge[:, 1]] - \
        mesh.x_vertex[mesh.vertices_on_edge[:, 0]]
    ey = mesh.y_vertex[mesh.vertices_on_edge[:, 1]] - \
        mesh.y_vertex[mesh.vertices_on_edge[:, 0]]
    if mesh.period_x:
        ex -= mesh.period_x * np.round(ex / mesh.period_x)
    if mesh.period_y:
        ey -= mesh.period_y * np.round(ey / mesh.period_y)
    # positive flux = C1 -> C2; C1 is left of V1->V2, so the signed swept
    # area is cross(edge, -d) ... sign checked via conservation below; here
    # compare magnitudes
    expected = np.abs(ex * (v * dt) - ey * (u * dt))
    got = np.abs(np.asarray(area).sum(axis=1))
    mask = np.asarray(tris["mask_edge"]) > 0
    np.testing.assert_allclose(got[mask], expected[mask], rtol=1e-10)


@pytest.mark.parametrize("mesh_kind", ["quad", "hex"])
def test_uniform_field_invariant(mesh_kind):
    """A uniform tracer in a uniform flow stays exactly uniform
    (free-stream preservation) and mass is conserved to roundoff."""
    if mesh_kind == "quad":
        mesh = planar_quad_mesh(10, 10, 2000.0, periodic=True)
    else:
        mesh = planar_hex_mesh(10, 10, 2000.0, periodic=True)
    tree = mass_only_tree()
    rt, mt, step = _setup(mesh, tree)
    state = {"iceAreaCategory": jnp.full((mesh.n_cells, 1), 0.7,
                                         jnp.float64)}
    u, v = _uniform_velocity(mesh, 1.0, 0.5)
    dt = 600.0
    s0 = global_conserved_sums(tree, state, jnp.asarray(mesh.area_cell))
    out = step(state, u, v, dt)
    s1 = global_conserved_sums(tree, out, jnp.asarray(mesh.area_cell))
    np.testing.assert_allclose(np.asarray(out["iceAreaCategory"]), 0.7,
                               rtol=1e-12)
    np.testing.assert_allclose(float(s0["iceAreaCategory"]),
                               float(s1["iceAreaCategory"]), rtol=1e-13)


def test_conservation_and_monotonicity_random():
    """Random smooth fields + rotating flow: machine-precision conservation
    of every mass*tracer product, and monotone bounds on tracers."""
    mesh = planar_quad_mesh(12, 12, 2000.0, periodic=True)
    tree = standard_tracer_tree(n_ice_layers=3, n_snow_layers=1)
    rt, mt, step = _setup(mesh, tree)
    rng = np.random.RandomState(0)
    nc, ncat = mesh.n_cells, 2

    x = mesh.x_cell / (12 * 2000.0)
    y = mesh.y_cell / (12 * 2000.0)
    area = 0.3 + 0.3 * np.sin(2 * np.pi * x)[:, None] * \
        np.cos(2 * np.pi * y)[:, None] * np.ones((1, ncat))
    thick = 1.0 + 0.5 * np.cos(2 * np.pi * x)[:, None] * np.ones((1, ncat))
    tsfc = -10.0 + 5.0 * rng.rand(nc, ncat)
    enth = -2e8 * (1.0 + 0.1 * rng.rand(nc, ncat, 3))
    salin = 4.0 + rng.rand(nc, ncat, 3)
    senth = -1e8 * (1.0 + 0.1 * rng.rand(nc, ncat, 1))

    state = {
        "iceAreaCategory": jnp.asarray(area),
        "iceVolumeCategory": jnp.asarray(area * thick),
        "snowVolumeCategory": jnp.asarray(area * 0.1),
        "surfaceTemperature": jnp.asarray(tsfc),
        "iceEnthalpy": jnp.asarray(enth),
        "iceSalinity": jnp.asarray(salin),
        "snowEnthalpy": jnp.asarray(senth),
    }
    # rotating flow
    uu = 0.5 * (2 * mesh.y_vertex / (12 * 2000.0) - 1.0)
    vv = -0.5 * (2 * mesh.x_vertex / (12 * 2000.0) - 1.0)
    u = jnp.asarray(uu)
    v = jnp.asarray(vv)
    dt = 600.0

    ac = jnp.asarray(mesh.area_cell)
    s0 = global_conserved_sums(tree, state, ac)
    out = step(state, u, v, dt)
    s1 = global_conserved_sums(tree, out, ac)
    for name in s0:
        np.testing.assert_allclose(float(s0[name]), float(s1[name]),
                                   rtol=1e-11, err_msg=name)

    # monotonicity: surfaceTemperature (a pure tracer) must stay within
    # global input bounds
    t_new = np.asarray(out["surfaceTemperature"])
    a_new = np.asarray(out["iceAreaCategory"])
    has = a_new > 1e-11
    assert t_new[has].max() <= tsfc.max() + 1e-9
    assert t_new[has].min() >= tsfc.min() - 1e-9
    # mass is not bounded above (convergent flow concentrates it) but the
    # positivity guarantee of the limited reconstruction must hold
    assert a_new.min() >= -1e-12


def test_linear_field_exact_translation():
    """With the limiter off, IR transports a linear tracer field exactly
    (2nd-order reconstruction is exact for linear fields): after
    translating one full period, the field returns to its start."""
    n = 16
    dc = 1000.0
    mesh = planar_quad_mesh(n, n, dc, periodic=True)
    tree = mass_only_tree()
    geom = build_remap_geometry(mesh)
    rt = geom.tensors()
    mt = mesh.tensors(jnp.float64)
    step = jax.jit(make_remap_step(tree, mesh.vertex_degree,
                                   monotonic=False))

    # mass field: smooth sinusoid
    x = mesh.x_cell / (n * dc)
    m0 = 0.5 + 0.25 * np.sin(2 * np.pi * x)
    state = {"iceAreaCategory": jnp.asarray(m0[:, None])}
    u_speed = 1.0
    nsteps = 40
    dt = n * dc / u_speed / nsteps        # one full period
    u, v = _uniform_velocity(mesh, u_speed, 0.0)
    ac = jnp.asarray(mesh.area_cell)
    for _ in range(nsteps):
        state = step(rt, mt.cells_on_cell, mt.cells_on_cell_mask, ac,
                     state, u, v, dt)
    m1 = np.asarray(state["iceAreaCategory"])[:, 0]
    err = np.abs(m1 - m0).max()
    # sinusoid isn't linear so exactness doesn't hold, but 2nd-order
    # accuracy at CFL ~ 0.4 over 40 steps keeps the error small; the
    # rate itself is checked by test_convergence_second_order
    assert err < 1e-2, err


def test_convergence_second_order():
    """Error in a translated sinusoid decreases ~4x when dx halves."""
    errs = []
    for n in (8, 16):
        dc = 16000.0 / n
        mesh = planar_quad_mesh(n, n, dc, periodic=True)
        tree = mass_only_tree()
        geom = build_remap_geometry(mesh)
        rt = geom.tensors()
        mt = mesh.tensors(jnp.float64)
        step = jax.jit(make_remap_step(tree, mesh.vertex_degree,
                                       monotonic=False))
        x = mesh.x_cell / 16000.0
        m0 = 0.5 + 0.25 * np.sin(2 * np.pi * x)
        state = {"iceAreaCategory": jnp.asarray(m0[:, None])}
        nsteps = 2 * n
        dt = 16000.0 / 1.0 / nsteps
        u, v = _uniform_velocity(mesh, 1.0, 0.0)
        ac = jnp.asarray(mesh.area_cell)
        for _ in range(nsteps):
            state = step(rt, mt.cells_on_cell, mt.cells_on_cell_mask, ac,
                         state, u, v, dt)
        m1 = np.asarray(state["iceAreaCategory"])[:, 0]
        errs.append(np.abs(m1 - m0).max())
    assert errs[1] < errs[0] / 2.5, errs


def test_tracer_hierarchy_recovery():
    """Uniform thickness on a varying area field stays exactly uniform
    (the hierarchy transports tracer means, not products)."""
    mesh = planar_hex_mesh(10, 10, 1000.0, periodic=True)
    tree = TracerTree((
        TracerSpec("iceAreaCategory", None),
        TracerSpec("iceVolumeCategory", "iceAreaCategory",
                   stored_as_product=True),
    ))
    rt, mt, step = _setup(mesh, tree)
    x = mesh.x_cell / (10 * 1000.0)
    area = (0.4 + 0.2 * np.sin(2 * np.pi * x))[:, None]
    h = 2.5
    state = {"iceAreaCategory": jnp.asarray(area),
             "iceVolumeCategory": jnp.asarray(area * h)}
    u, v = _uniform_velocity(mesh, 0.8, -0.3)
    out = step(state, u, v, 300.0)
    a = np.asarray(out["iceAreaCategory"])
    vol = np.asarray(out["iceVolumeCategory"])
    has = a > 1e-11
    np.testing.assert_allclose(vol[has] / a[has], h, rtol=1e-10)


def test_native_stencil_matches_python():
    """The C++ remap-stencil builder must reproduce the Python reference
    implementation exactly (seaice_tpu/native/remap_stencil.cpp)."""
    from seaice_tpu import native
    import seaice_tpu.transport.geometry as G

    if not native.native_available():
        pytest.skip("native toolchain unavailable")
    for mesh in (planar_quad_mesh(10, 10, 1000.0, periodic=True),
                 planar_hex_mesh(8, 8, 1000.0, periodic=True)):
        g_nat = G.build_remap_geometry(mesh)
        lib, failed = native._lib, native._build_failed
        native._lib, native._build_failed = None, True
        try:
            g_py = G.build_remap_geometry(mesh)
        finally:
            native._lib, native._build_failed = lib, failed
        for f in ("remap_edge", "cells_on_edge_remap",
                  "edges_on_edge_remap", "vertex_on_cell_remap",
                  "min_length_edges_on_vertex", "edge_sign_on_cell",
                  "x_vertex_on_edge", "y_vertex_on_edge"):
            a = np.asarray(getattr(g_nat, f))
            b = np.asarray(getattr(g_py, f))
            assert np.array_equal(a, b), f


def test_runtime_self_checks_in_model():
    """conservation_check/monotonicity_check flags wire the IR runtime
    self-checks into the step diagnostics (reference optional checks,
    ..._incremental_remap.F:8126,8416)."""
    import dataclasses
    import jax
    from seaice_tpu.config import box_test_config
    from seaice_tpu.model import SeaIceModel
    from seaice_tpu.testcases import box

    from seaice_tpu.config import AdvectionType
    cfg = box_test_config(elastic_subcycles=2)
    cfg = dataclasses.replace(cfg, advection=dataclasses.replace(
        cfg.advection,
        advection_type=AdvectionType.INCREMENTAL_REMAP,
        conservation_check=True,
        monotonicity_check=True))
    mesh = box.box_test_mesh(8, 8)
    mesh.f_vertex = box.box_coriolis_parameter(mesh)
    model = SeaIceModel(mesh, cfg, dtype=jnp.float64)
    area, vol, snow = box.box_initial_state(mesh, 1)
    state = model.init_state(area, vol, snow)
    step = model.make_step()
    out, diags = step(model.tensors, state,
                      box.box_forcing(mesh, t=0.0))
    assert float(diags["ir_conservation_error"]) < 1e-11
    assert float(diags["ir_monotonicity_violation"]) == 0.0

