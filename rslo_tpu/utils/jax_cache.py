"""Enable JAX's persistent compilation cache.

Import for side effect, or call :func:`enable`.  Where
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this module
sets no directory; otherwise the cache lives in ``<repo>/.jax_cache``
(gitignored), a fixed path, so that runs from one checkout share it.
"""
from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
REPO_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), ".jax_cache")


def cache_dir() -> str:
    """The directory the cache is kept in."""
    return os.environ.get(ENV) or REPO_DIR


def enable() -> None:
    import jax

    if not os.environ.get(ENV):
        os.makedirs(REPO_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", REPO_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)


enable()
