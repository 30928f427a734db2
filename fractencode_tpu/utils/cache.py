"""Placement of JAX's persistent compilation cache for the entry points.

``JAX_COMPILATION_CACHE_DIR``, when set, is honoured as JAX reads it and no
other cache is set here.  Otherwise the cache goes to the fixed path
``<checkout>/.jax_cache`` (listed in .gitignore): the path is part of what
makes a later run find its entries, so it is never derived from a temporary
name, a process id or the time.
"""
from __future__ import annotations

import os

__all__ = ["CACHE_DIR", "setup_compile_cache"]

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory; returns
    the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    return CACHE_DIR
