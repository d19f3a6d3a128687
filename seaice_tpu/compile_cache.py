"""Placement of JAX's persistent compilation cache.

A full-physics step takes minutes to compile, so every entry point
(tests, examples, benchmarks, the chip smoke test) keeps compiled
programs on disk.  The directory is part of each entry's key, so it is
fixed: `JAX_COMPILATION_CACHE_DIR` when the environment sets it (JAX
reads that variable itself), otherwise `.jax_cache` at the repository
root, which `.gitignore` lists.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def cache_dir() -> str:
    """The directory the persistent cache uses."""
    return os.environ.get(ENV_VAR) or REPO_CACHE


def enable_compile_cache(min_compile_secs: float = 1.0) -> str:
    """Turn on the persistent cache for programs that take at least
    `min_compile_secs` to compile; returns its directory."""
    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      min_compile_secs)
    return path
