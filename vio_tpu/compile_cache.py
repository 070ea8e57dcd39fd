"""Where JAX keeps its persistent compilation cache.

The solver and tracker programs take minutes to compile cold; cached they
load in seconds.  The cache directory is part of every entry's key, so it
must not move between runs: ``JAX_COMPILATION_CACHE_DIR`` decides it when it
is set (JAX reads that variable itself), and otherwise it is the fixed
``.jax_cache`` directory at the root of the checkout.
"""
from __future__ import annotations

import os

import jax

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable() -> str:
    """Turn the persistent compilation cache on; returns its directory."""
    env_dir = os.environ.get(ENV)
    if env_dir:
        return env_dir
    os.makedirs(DEFAULT_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return DEFAULT_DIR
