"""The persistent XLA compile cache of the bench and smoke scripts."""

from __future__ import annotations

import os
from pathlib import Path

import jax

__all__ = ["enable_compile_cache"]

_CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    this sets nothing.  Otherwise the cache is ``<checkout>/.jax_cache``,
    resolved from this file's location (the directory is gitignored), so
    every script of one checkout shares it whatever its working
    directory.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(_CHECKOUT_CACHE))
    return str(_CHECKOUT_CACHE)
