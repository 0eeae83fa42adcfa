"""Process-wide JAX configuration for the device compute path.

Every module that jits (ops/*, genotyping/batched.py, parallel/*) calls
``configure()`` at import. It sets the persistent compilation cache, so
that the graph-SW fill compiled for a shape bucket is reused by later
runs:

- if ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no
  other directory is set here;
- otherwise the cache is ``<repo>/.jax_cache`` (listed in .gitignore),
  one fixed path, since the path is part of the cache key.

``PARAGRAPH_TPU_NO_CACHE=1`` turns the cache off (test runs on the CPU
use it, so their executables never land in the checkout).
"""
from __future__ import annotations

import os

#: the checkout's own cache directory
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")

_configured = False


def cache_dir() -> str:
    """The compile-cache directory this process uses ("" = none)."""
    if os.environ.get("PARAGRAPH_TPU_NO_CACHE"):
        return ""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR


def configure() -> None:
    global _configured
    if _configured:
        return
    _configured = True
    path = cache_dir()
    if not path or os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1)
