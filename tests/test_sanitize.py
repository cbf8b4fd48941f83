"""Sanitizer hooks (utils/sanitize.py) and cross-run determinism — SURVEY
§5.2 obligations for this build."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from fdapde_core_tpu.utils.sanitize import assert_all_finite, checked, debug_nans


def test_checked_catches_nan_inside_jit_scan():
    def bad(x):
        def step(c, _):
            return c / (c - c), None  # 0/0 on the second iteration

        out, _ = jax.lax.scan(step, x, None, length=2)
        return out

    with pytest.raises(Exception, match="nan"):
        checked(jax.jit(bad))(jnp.float64(1.0))


def test_checked_passes_clean_code():
    f = checked(jax.jit(lambda x: jnp.sqrt(x) + 1.0))
    assert float(f(jnp.float64(4.0))) == 3.0


def test_debug_nans_scope():
    assert not jax.config.jax_debug_nans
    with debug_nans():
        assert jax.config.jax_debug_nans
        with pytest.raises(FloatingPointError):
            jnp.log(jnp.float64(-1.0)).block_until_ready()
    assert not jax.config.jax_debug_nans


def test_assert_all_finite():
    ok = {"a": jnp.ones(3), "b": np.arange(3)}
    assert_all_finite(ok)
    bad = {"a": jnp.array([1.0, jnp.nan])}
    with pytest.raises(FloatingPointError, match="a"):
        assert_all_finite(bad, "state")


def test_solve_is_deterministic_across_runs():
    """Same PDE solved through two fresh jit traces gives BITWISE-identical
    results (golden-determinism, SURVEY §5.2)."""
    import fdapde_core_tpu as fdm
    from tests.conftest import load_mesh

    mesh = load_mesh("unit_square_32")

    def run():
        pde = fdm.PDE(mesh, -fdm.laplacian(), forcing=lambda x: -4.0, order=1)
        g = (pde.dof_coords() ** 2).sum(axis=1)
        pde.set_dirichlet_bc(g)
        pde.solve()
        return np.asarray(pde.solution())

    a, b = run(), run()
    np.testing.assert_array_equal(a, b)
