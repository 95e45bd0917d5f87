"""Persistent XLA compilation cache placement.

Called by the entry points (CLI, ``bench.py``, ``chip_smoke.py``), never at
import time. The cache key includes the directory, so the directory is
fixed: ``JAX_COMPILATION_CACHE_DIR`` when set (JAX reads it itself), else
``<repo>/.jax_cache``.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its fixed directory and
    return that directory. With ``JAX_COMPILATION_CACHE_DIR`` set, nothing
    is changed."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    return str(DEFAULT_CACHE_DIR)
