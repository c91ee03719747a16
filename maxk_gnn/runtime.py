"""Process-wide JAX settings shared by every entry point."""

from __future__ import annotations

import os

import jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    `$JAX_COMPILATION_CACHE_DIR` when set; otherwise `.jax_cache/` at the
    root of this checkout (a fixed path, so repeated runs hit the cache).
    """
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        REPO_ROOT, ".jax_cache"
    )
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
