"""chip_smoke.py's served-path phases on the CPU at a small size: the
standalone runner with its streams and the coupled driver, on the
full-physics workload."""

import jax.numpy as jnp
import pytest

import bench_full
import chip_smoke


@pytest.fixture(scope="module")
def workload():
    with chip_smoke.precision(jnp.float32):
        model, state, _ = bench_full.build(subdiv=2, n_subcycles=2,
                                           mesh_kind="panel",
                                           dtype=jnp.float32)
    return model, state


def test_runner_phase(workload, tmp_path):
    rep = chip_smoke.Report("cpu")
    runner = chip_smoke.prepare_runner(rep, *workload,
                                       str(tmp_path / "run"))
    chip_smoke.phase_runner(rep, runner)
    assert rep.failures == []
    assert (tmp_path / "run" / "output.nc").stat().st_size > 0


def test_coupled_phase(workload):
    rep = chip_smoke.Report("cpu")
    chip_smoke.phase_coupled(rep, *workload)
    assert rep.failures == []
