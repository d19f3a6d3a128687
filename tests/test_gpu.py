"""Tests that need a GPU.

They skip on any other platform; `chip_smoke.py` runs them on the card
(`pytest -m gpu`).  Whether a GPU is present is decided inside the
fixture, never while the module is imported.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX runs on {dev.platform})")
    return dev


def test_card_reported(gpu):
    from seaice_tpu.utils.device import card_line, require_gpu
    assert require_gpu()["kind"] == gpu.device_kind
    name, limit = card_line().rsplit(",", 1)
    assert name.strip() and limit.strip().endswith("W")


def test_highest_contraction_is_full_f32(gpu):
    """The precision the model's contractions ask for: an f32 einsum at
    HIGHEST agrees with float64 to f32 rounding, where TF32 would lose
    three decimal digits."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    a = rng.standard_normal((4096, 6)).astype(np.float32)
    b = rng.standard_normal((4096, 6, 6)).astype(np.float32)
    ref = np.einsum("cb,cbg->cg", a.astype(np.float64),
                    b.astype(np.float64))
    got = jax.jit(lambda x, y: jnp.einsum(
        "cb,cbg->cg", x, y, precision=jax.lax.Precision.HIGHEST))(
            jnp.asarray(a), jnp.asarray(b))
    err = np.abs(np.asarray(got, np.float64) - ref).max() / \
        np.abs(ref).max()
    assert err < 1e-6, err
