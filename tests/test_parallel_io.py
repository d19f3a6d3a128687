"""Parallel (per-shard) I/O: gatherless restart and history streams.

The JAX analog of the reference's PIO io-task layer
(Registry.xml:380-396): each shard writes only its owned rows; restart
reads are halo-aware (only owner parts touched); reassembly matches the
host-gather path bitwise."""

import os

import numpy as np
import jax
import jax.numpy as jnp

from seaice_tpu.config import box_test_config
from seaice_tpu.io.parallel import (
    ShardedOutputStream, assemble_checkpoint, assemble_history,
    load_sharded_checkpoint, save_sharded_checkpoint)
from seaice_tpu.parallel import ShardedSeaIceModel
from seaice_tpu.testcases import box


def _sharded_model(n_shards=4, nx=12, subcycles=4):
    cfg = box_test_config(elastic_subcycles=subcycles)
    mesh = box.box_test_mesh(nx, nx)
    mesh.f_vertex = box.box_coriolis_parameter(mesh)
    area, vol, snow = box.box_initial_state(mesh, n_categories=1)
    model = ShardedSeaIceModel(mesh, cfg, n_shards, dtype=jnp.float64)
    state = model.init_state(area, vol, snow)
    return model, state, mesh


def _stepped_state(model, state, mesh, n=2):
    step = model.make_step()
    forcing = model.scatter_forcing(
        lambda m: box.box_forcing(m, t=0.0))
    for _ in range(n):
        state, _ = step(model.tensors, model.halo, state, forcing)
    return state


def test_sharded_checkpoint_roundtrip_bitwise(tmp_path):
    model, state, mesh = _sharded_model()
    state = _stepped_state(model, state, mesh)
    d = str(tmp_path)
    save_sharded_checkpoint(
        d, "restart", state, model.part, mesh.n_cells, mesh.n_vertices,
        clock_metadata={"step": 2})
    # one part per shard, no global file
    parts = [f for f in os.listdir(d) if ".part-" in f]
    assert len(parts) == model.n_shards

    loaded, clock = load_sharded_checkpoint(
        d, "restart", model.part, state)
    assert clock["step"] == 2
    # owned + HALO rows must round-trip bitwise (halo refilled from the
    # owner shards' parts, never written redundantly)
    for (a, b) in zip(jax.tree.leaves(state), jax.tree.leaves(loaded)):
        av, bv = np.asarray(a), np.asarray(b)
        # pad rows (global id < 0) are zeroed by the loader; compare on
        # real entities only
        assert av.shape == bv.shape
    for s, blk in enumerate(model.part.blocks):
        okc = blk.cell_global >= 0
        okv = blk.vertex_global >= 0
        for name, arr in state.tracers.items():
            got = np.asarray(loaded.tracers[name][s])
            want = np.asarray(arr[s])
            assert np.array_equal(got[okc], want[okc]), name
        for f in ("u_velocity", "v_velocity"):
            got = np.asarray(getattr(loaded.velocity, f)[s])
            want = np.asarray(getattr(state.velocity, f)[s])
            assert np.array_equal(got[okv], want[okv]), f


def test_sharded_checkpoint_resume_matches(tmp_path):
    """Restarting from per-shard parts continues the trajectory
    bitwise (the reference's restartability gate, run in parallel)."""
    model, state, mesh = _sharded_model()
    state = _stepped_state(model, state, mesh, n=2)
    d = str(tmp_path)
    save_sharded_checkpoint(d, "r", state, model.part,
                            mesh.n_cells, mesh.n_vertices)
    loaded, _ = load_sharded_checkpoint(d, "r", model.part, state)
    s_a = _stepped_state(model, state, mesh, n=1)
    s_b = _stepped_state(model, loaded, mesh, n=1)
    for blk, s in zip(model.part.blocks, range(model.n_shards)):
        okc = blk.cell_global >= 0
        for name in state.tracers:
            assert np.array_equal(
                np.asarray(s_a.tracers[name][s])[okc],
                np.asarray(s_b.tracers[name][s])[okc]), name


def test_assemble_matches_gather(tmp_path):
    model, state, mesh = _sharded_model()
    state = _stepped_state(model, state, mesh)
    d = str(tmp_path)
    save_sharded_checkpoint(d, "r", state, model.part,
                            mesh.n_cells, mesh.n_vertices)
    fields, _ = assemble_checkpoint(d, "r")
    gathered = model.gather_tracers(state)
    for name, g in gathered.items():
        assert np.array_equal(fields[f"tracers.{name}"], g), name
    gu, gv = model.gather_velocity(state)
    assert np.array_equal(fields["velocity.u_velocity"], gu)
    assert np.array_equal(fields["velocity.v_velocity"], gv)


def test_partial_shard_write(tmp_path):
    """Each 'process' writes a disjoint shard subset; the result is the
    same roster (multi-host write path)."""
    model, state, mesh = _sharded_model()
    d = str(tmp_path)
    save_sharded_checkpoint(d, "r", state, model.part,
                            mesh.n_cells, mesh.n_vertices,
                            shards=[0, 1])
    save_sharded_checkpoint(d, "r", state, model.part,
                            mesh.n_cells, mesh.n_vertices,
                            shards=[2, 3])
    loaded, _ = load_sharded_checkpoint(d, "r", model.part, state)
    for s, blk in enumerate(model.part.blocks):
        okc = blk.cell_global >= 0
        for name in state.tracers:
            assert np.array_equal(
                np.asarray(loaded.tracers[name][s])[okc],
                np.asarray(state.tracers[name][s])[okc])


def test_sharded_history_stream(tmp_path):
    model, state, mesh = _sharded_model()
    step = model.make_step()
    forcing = model.scatter_forcing(lambda m: box.box_forcing(m, t=0.0))
    stream = ShardedOutputStream(str(tmp_path), "hist", model.part,
                                 mesh.n_cells, mesh.n_vertices)
    times = []
    for i in range(3):
        state, _ = step(model.tensors, model.halo, state, forcing)
        stream.write(
            {"iceAreaCategory": state.tracers["iceAreaCategory"]},
            {"uVelocity": state.velocity.u_velocity},
            timestamp=f"t{i}")
        times.append((
            model.gather_tracers(state)["iceAreaCategory"].copy(),
            model.gather_velocity(state)[0].copy()))
    stream.flush()
    fields, xtime = assemble_history(str(tmp_path), "hist")
    assert xtime == ["t0", "t1", "t2"]
    for i, (area_g, u_g) in enumerate(times):
        assert np.array_equal(fields["iceAreaCategory"][i], area_g)
        assert np.array_equal(fields["uVelocity"][i], u_g)
