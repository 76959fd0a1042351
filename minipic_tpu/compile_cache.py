"""JAX's persistent compilation cache, kept at one fixed place.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
nothing is set here.  Otherwise the cache lives in ``.jax_cache/`` at the
root of this checkout: a fixed path (the path is part of the cache key),
so a later process in the same checkout finds what an earlier one
compiled.
"""
from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def enable_compile_cache() -> str:
    """Point JAX's compilation cache at its directory; returns the path."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
