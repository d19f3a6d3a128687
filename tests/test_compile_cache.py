"""Placement of the persistent compilation cache."""

import jax
import pytest

from seaice_tpu import compile_cache


@pytest.fixture
def restore_config():
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    yield
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      saved[1])


def test_env_var_is_used_and_nothing_else_set(monkeypatch, tmp_path,
                                              restore_config):
    jax.config.update("jax_compilation_cache_dir", "/untouched")
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the helper sets no other directory
    assert jax.config.jax_compilation_cache_dir == "/untouched"


def test_repo_cache_when_unset(monkeypatch, restore_config):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == compile_cache.REPO_CACHE
    assert path.endswith(".jax_cache") and not path.startswith("/tmp")
    assert jax.config.jax_compilation_cache_dir == path
