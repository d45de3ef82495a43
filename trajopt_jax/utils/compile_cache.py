"""Placement of JAX's persistent compilation cache.

Compiling the solvers for the GPU takes tens of seconds; the persistent cache
keeps the result across processes.  The cache key includes its directory, so
the directory is fixed: ``$JAX_COMPILATION_CACHE_DIR`` when it is set (JAX
reads it itself, and no other directory is set here), otherwise ``.jax_cache/``
at the root of the checkout.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its fixed directory and
    return that directory."""
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE))
    return str(CHECKOUT_CACHE)
