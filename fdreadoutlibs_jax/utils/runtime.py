"""Process-level JAX settings shared by the entry points (apps, cli,
bench, chip_smoke.py)."""

from __future__ import annotations

import os
from pathlib import Path

# a fixed path inside the checkout (listed in .gitignore): the cache key
# includes the directory, so a cache that moves never hits
CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its
    directory.  When JAX_COMPILATION_CACHE_DIR is set, JAX already uses it
    and nothing is changed; otherwise the cache goes to CACHE_DIR."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)
