"""Persistent XLA compilation cache at a fixed, per-checkout location.

Scripts that compile full-size programs (chip_smoke.py, bench.py's group
processes, benchmarks/) call `enable_compile_cache()` before their first
compile so that a second run of the same checkout skips compilation:

- if JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing is
  changed here;
- otherwise the cache goes to `.jax_cache/` at the checkout root (listed in
  .gitignore).
"""

from __future__ import annotations

import os

import jax

__all__ = ["enable_compile_cache", "CHECKOUT_ROOT"]

CHECKOUT_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns its directory."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(CHECKOUT_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
