import os

# Tests run on the CPU with float64 enabled, on 8 virtual devices that
# stand in for the cards of a multi-device run (the analog of the
# reference's 16-vs-32-rank parallelism tests,
# testing_and_setup/testing/tests/parallelism.py).  Tests that need a
# GPU carry the `gpu` marker and decide inside a fixture whether one is
# present; `chip_smoke.py` runs them on the card.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

from seaice_tpu.compile_cache import enable_compile_cache  # noqa: E402

jax.config.update("jax_enable_x64", True)
# the EVP step takes minutes to compile on a small CI CPU
enable_compile_cache()
