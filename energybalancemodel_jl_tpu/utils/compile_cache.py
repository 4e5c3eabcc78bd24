"""The persistent compilation cache, configured in one place.

``chip_smoke.py`` and ``bench.py`` call :func:`enable_compile_cache` before
their first compilation so repeated runs reuse compiled programs.
"""
from __future__ import annotations

import os

__all__ = ["enable_compile_cache"]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it from
    the environment and nothing else is set here; otherwise the cache lives
    in ``<repo>/.jax_cache`` (listed in ``.gitignore``)."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    import jax

    path = os.path.join(_REPO, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
