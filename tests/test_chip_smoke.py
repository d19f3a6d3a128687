"""chip_smoke.py on the CPU: its refusal without a GPU, its parsing
and trace reduction, and the cheap phases at small sizes.  The phases
that compile the full-physics step are in test_chip_smoke_*.py."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from seaice_tpu.utils.device import parse_nvidia_smi


@pytest.mark.parametrize("argv", [[], ["--four-cards"]],
                         ids=["one-card", "four-cards"])
def test_main_refuses_without_gpu(argv, capsys):
    assert chip_smoke.main(argv) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out and "{" not in out


def test_parse_nvidia_smi():
    text = ("NVIDIA H100 80GB HBM3, 700.00 W\n"
            "NVIDIA H100 80GB HBM3, 500.00 W\n\n")
    assert parse_nvidia_smi(text) == [
        ("NVIDIA H100 80GB HBM3", "700.00 W"),
        ("NVIDIA H100 80GB HBM3", "500.00 W")]
    with pytest.raises(ValueError):
        parse_nvidia_smi("no separator here")


def test_scope_time_from_trace(tmp_path):
    """The named-scope reduction on a CPU trace: the ops under the scope
    are found through the compiled HLO's op_name metadata."""
    @jax.jit
    def f(x):
        with jax.named_scope("integrate_fluxes"):
            y = jnp.sin(x) @ x
        return y + 1.0

    x = jnp.ones((128, 128), jnp.float32)
    compiled = f.lower(x).compile()
    compiled(x).block_until_ready()
    with jax.profiler.trace(str(tmp_path)):
        compiled(x).block_until_ready()
    got = chip_smoke.scope_time_from_trace(
        str(tmp_path), compiled.as_text(), "integrate_fluxes",
        plane_prefix="/host:CPU")
    assert got.launches >= 1 and 0 < got.scope_ns <= got.busy_ns
    assert chip_smoke.scope_time_from_trace(
        str(tmp_path), compiled.as_text(), "integrate_fluxes") is None


def test_event_instruction():
    """Device events map to HLO instructions as a GPU trace names them
    (kernel named after its fusion, '.' and '-' sanitized, 'hlo_op' the
    CUDA graph; stats as in a trace of the full step on the H100) and as
    a CPU trace does ('hlo_op' the instruction)."""
    names = {chip_smoke.kernel_key(n) for n in (
        "loop_select_fusion.2", "input_reduce-fusion.12",
        "command_buffer", "fusion.3")}
    gpu = {"hlo_op": "command_buffer", "hlo_module": "jit_step",
           "tf_op": "XlaModule:"}
    assert chip_smoke.event_instruction(
        "loop_select_fusion_2", gpu, names) == "loop_select_fusion_2"
    assert chip_smoke.event_instruction(
        "input_reduce_fusion_12", gpu, names) == "input_reduce_fusion_12"
    assert chip_smoke.event_instruction(
        "fusion.3", {"hlo_op": "fusion.3"}, names) == "fusion_3"
    # library kernels (cuBLAS) name no instruction of their own
    assert chip_smoke.event_instruction(
        "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n", {}, names) is None


def test_pinned_phase_matches_stored_box_run(capsys):
    rep = chip_smoke.Report("cpu")
    chip_smoke.phase_pinned(rep, cases=("box_50min", "box"))
    assert rep.failures == []
    # on the CPU that wrote the pins, the reported 12 h run matches too
    assert "matches box: data_regression_box.npz" in capsys.readouterr().out


def test_compiles_on_a_pool():
    rep = chip_smoke.Report("cpu")
    pool = chip_smoke.Compiles(rep, workers=2)
    try:
        x = jnp.arange(4.0)
        futs = [pool.submit(f"toy {k}", jax.jit(
            lambda a, k=k: a * k).lower(x)) for k in (2.0, 3.0)]
        inline = chip_smoke.compile_now("inline", jax.jit(
            lambda a: a + 1).lower(x))
        pool.wait()
        assert [float(f.result()(x)[1]) for f in futs] == [2.0, 3.0]
        assert float(inline.result()(x)[0]) == 1.0
    finally:
        pool.shutdown()


def test_determinism_phase(capsys):
    from seaice_tpu.dynamics.evp import VelocitySolverState
    from seaice_tpu.model import State

    @jax.jit
    def step(x):
        vel = VelocitySolverState(*(jnp.sin(x * k) for k in range(6)))
        return State(velocity=vel, tracers={}, time=x.sum()), None

    rep = chip_smoke.Report("cpu")
    assert chip_smoke.phase_determinism(rep, "toy", step,
                                        (jnp.arange(8.0),), {})
    assert "bitwise equal" in capsys.readouterr().out
    assert chip_smoke.normwise_diff(np.array([1.0, 2.5]),
                                    np.array([1.0, 2.0])) == 0.25
