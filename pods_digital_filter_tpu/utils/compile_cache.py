"""JAX's persistent compilation cache at one fixed place.

The cache's location is part of its key, so it only pays when every run
finds the same directory: the one ``JAX_COMPILATION_CACHE_DIR`` names when
that variable is set (JAX reads it itself), and otherwise ``.jax_cache`` at
the root of this checkout.
"""

from __future__ import annotations

import os

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir_to_set(environ=os.environ) -> str | None:
    """The directory to configure, or None when ``JAX_COMPILATION_CACHE_DIR``
    already names one (JAX then uses it and nothing is set in code)."""
    if environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return DEFAULT_CACHE_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its fixed directory
    before the first compilation; returns the directory in use."""
    import jax

    path = cache_dir_to_set()
    if path is not None:
        jax.config.update("jax_compilation_cache_dir", path)
    return jax.config.jax_compilation_cache_dir
