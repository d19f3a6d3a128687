"""Every contraction of data in the model step asks for full precision.

On the GPU, XLA may run a float32 contraction that names no precision
in TF32 (10-bit mantissa), the class of error that made a reduced-
precision flux path diverge within days.  The step's jaxpr must carry
`Precision.HIGHEST` on every `dot_general` over floating data.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.extend import core as jcore


def _dot_generals(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for p in eqn.params.values():
            for sub in (p if isinstance(p, (list, tuple)) else [p]):
                if isinstance(sub, jcore.ClosedJaxpr):
                    yield from _dot_generals(sub.jaxpr)
                elif isinstance(sub, jcore.Jaxpr):
                    yield from _dot_generals(sub)


def _box_workload():
    from bench_full import workload_config
    from seaice_tpu.model import SeaIceModel
    from seaice_tpu.parallel.sharded import full_physics_inputs
    from seaice_tpu.testcases import box
    from seaice_tpu.utils.pytree import replace
    import dataclasses

    cfg = workload_config(n_subcycles=2)
    cfg = cfg.replace(velocity=dataclasses.replace(
        cfg.velocity, rotate_cartesian_grid=False,
        include_metric_terms=False))
    mesh = box.box_test_mesh(6, 6)
    mesh.f_vertex = box.box_coriolis_parameter(mesh)
    model = SeaIceModel(mesh, cfg, dtype=jnp.float64)
    area, vol, snow, extra, atm, ocn, coszen = full_physics_inputs(
        mesh, cfg, jnp.float64)
    state = model.init_state(area, vol, snow)
    state = replace(state, tracers={**state.tracers, **extra})
    forcing = box.box_forcing(mesh, t=0.0)
    as_f64 = lambda t: jax.tree.map(  # noqa: E731
        lambda x: jnp.asarray(x, jnp.float64), t)
    return model, state, (forcing, as_f64(atm), as_f64(ocn),
                          jnp.asarray(coszen))


@pytest.mark.parametrize("mesh_kind", ["box", "panel", "voronoi"])
def test_step_contractions_are_highest(mesh_kind):
    if mesh_kind == "box":
        model, state, (dyn, atm, ocn, cz) = _box_workload()
    else:
        import bench_full
        model, state, (dyn, atm, ocn, cz) = bench_full.build(
            subdiv=2, n_subcycles=2, mesh_kind=mesh_kind,
            dtype=jnp.float64)
    closed = jax.make_jaxpr(model.make_step(jit=False))(
        model.tensors, state, dyn, atm, ocn, coszen=cz)
    dots = [e for e in _dot_generals(closed.jaxpr)
            if all(np.issubdtype(v.aval.dtype, np.floating)
                   for v in e.invars)]
    assert dots, "the step has no floating contraction to check"
    highest = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
    loose = [str(e.params["precision"]) for e in dots
             if e.params["precision"] != highest]
    assert not loose, f"{len(loose)} of {len(dots)} contractions: {loose}"
