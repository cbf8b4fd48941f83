"""Numerical sanitization hooks (SURVEY §5.2).

The reference's only sanitization is valgrind in CI (test/run_tests.sh:74-78)
and -Werror; nothing numerical. This build's obligations are NaN
propagation checks inside jit-compiled code and cross-run determinism:

- `debug_nans()`: context manager flipping `jax_debug_nans` — every jit in
  scope re-runs op-by-op on a NaN and raises at the producing op,
- `checked(fn)`: checkify wrapper adding in-graph NaN/div guards to a
  jittable function (works under jit/scan/while_loop, where debug_nans
  cannot see intermediate values),
- `assert_all_finite(tree)`: eager pytree barrier for host-side call sites
  (e.g. after a solve, before writing a checkpoint).

Solver-level guards live in linear_algebra/solvers.py (residual isfinite
checks mark converged=False instead of looping forever); these utilities
are the debugging layer above them.
"""

from __future__ import annotations

from contextlib import contextmanager

import jax
import jax.numpy as jnp

__all__ = ["debug_nans", "checked", "assert_all_finite"]


@contextmanager
def debug_nans(enable: bool = True):
    """Scoped `jax_debug_nans` toggle."""
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", enable)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


def checked(fn):
    """Return a version of `fn` that raises on NaN/inf produced anywhere in
    its jit-compiled body (checkify float checks; survives scan/while)."""
    from jax.experimental import checkify

    cfn = checkify.checkify(fn, errors=checkify.float_checks)

    def wrapper(*args, **kwargs):
        err, out = cfn(*args, **kwargs)
        checkify.check_error(err)
        return out

    return wrapper


def assert_all_finite(tree, name: str = "value"):
    """Raise FloatingPointError if any floating leaf has NaN/inf; returns
    the tree unchanged (usable as a pass-through barrier)."""
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        if hasattr(leaf, "dtype") and jnp.issubdtype(leaf.dtype, jnp.floating):
            if not bool(jnp.isfinite(leaf).all()):
                loc = jax.tree_util.keystr(path)
                raise FloatingPointError(f"non-finite values in {name}{loc}")
    return tree
