"""Unit tests for utils: combinatorics, quadrature exactness, IO."""

import numpy as np
import pytest

from fdapde_core_tpu.utils import combinatorics, quadrature


def test_combinations_lexicographic():
    # order is load-bearing (edge patterns): must be lexicographic
    np.testing.assert_array_equal(
        combinatorics.combinations(2, 3), [[0, 1], [0, 2], [1, 2]]
    )
    np.testing.assert_array_equal(
        combinatorics.combinations(2, 4),
        [[0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]],
    )
    np.testing.assert_array_equal(
        combinatorics.combinations(3, 4), [[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]]
    )


def test_binomial_factorial():
    assert combinatorics.factorial(5) == 120
    assert combinatorics.binomial(6, 2) == 15


def _monomial_integral_simplex(alpha):
    """Exact integral of x^alpha over the unit simplex: prod(a_i!)*1 / (|a|+d)!"""
    from math import factorial

    d = len(alpha)
    num = 1
    for a in alpha:
        num *= factorial(a)
    return num / factorial(sum(alpha) + d)


DEGREE = {  # polynomial exactness degree of each tabulated rule
    (1, 2): 3,
    (1, 3): 5,
    (2, 1): 1,
    (2, 3): 2,
    (2, 6): 4,
    (2, 7): 5,
    (2, 12): 6,
    (3, 1): 1,
    (3, 4): 2,
    (3, 5): 3,
    (3, 11): 4,
}


@pytest.mark.parametrize("dim,npts", sorted(DEGREE))
def test_quadrature_polynomial_exactness(dim, npts):
    """Each rule integrates polynomials up to its design degree exactly.

    Simplex volume normalization: sum_q w_q f(x_q) * vol must match the exact
    monomial integral (vol of unit simplex = 1/d!).
    """
    from itertools import product
    from math import factorial

    rule = quadrature.simplex_quadrature(dim, npts)
    vol = 1.0 / factorial(dim)
    deg = DEGREE[(dim, npts)]
    for alpha in product(range(deg + 1), repeat=dim):
        if sum(alpha) > deg:
            continue
        approx = vol * np.sum(
            rule.weights * np.prod(rule.nodes ** np.array(alpha), axis=1)
        )
        exact = _monomial_integral_simplex(alpha)
        assert abs(approx - exact) < 1e-14, (alpha, approx, exact)


def test_weights_sum_to_one():
    for dim, table in [(1, [2, 3]), (2, [1, 3, 6, 7, 12]), (3, [1, 4, 5, 11])]:
        for npts in table:
            rule = quadrature.simplex_quadrature(dim, npts)
            assert abs(rule.weights.sum() - 1.0) < 1e-14


def test_standard_rule_selection():
    # integrator_tables.h:24-54
    assert quadrature.standard_fem_quadrature(2, 1).num_nodes == 3
    assert quadrature.standard_fem_quadrature(2, 2).num_nodes == 6
    assert quadrature.standard_fem_quadrature(1, 1).num_nodes == 2
    assert quadrature.standard_fem_quadrature(3, 1).num_nodes == 4
    assert quadrature.standard_fem_quadrature(3, 2).num_nodes == 5


def test_gauss_legendre():
    n, w = quadrature.gauss_legendre_1d(3)
    assert abs(n[2] - 0.774596669241483) < 1e-12
    assert abs(w[1] - 8 / 9) < 1e-14


def test_read_reference_csv():
    from fdapde_core_tpu.utils.io import read_csv

    from tests.conftest import reference_path

    pts = read_csv(reference_path("mesh", "unit_square", "points.csv"))
    assert pts.shape == (3600, 2)
    assert pts[1, 0] == pytest.approx(0.01694915254237288)


def test_almost_equal_and_log1pexp():
    """Scalar helpers from utils/symbols.h:167-185: absolute-or-relative
    closeness and the 4-branch stable log(1+exp)."""
    import numpy as np
    from fdapde_core_tpu.utils import almost_equal, log1pexp

    assert almost_equal(1.0, 1.0 + 1e-15)
    assert not almost_equal(1.0, 1.0 + 1e-10)
    # relative branch: large magnitudes compare relatively
    assert almost_equal(1e10, 1e10 * (1 + 1e-15))
    assert almost_equal(np.ones(3), np.ones(3) + 1e-15)

    xs = np.array([-100.0, -37.5, -5.0, 0.0, 10.0, 20.0, 33.0, 40.0, 700.0])
    got = np.asarray(log1pexp(xs), dtype=float)
    want = np.array([np.exp(x) if x <= -37 else np.log1p(np.exp(min(x, 700)))
                     if x <= 18 else (x + np.exp(-x) if x <= 33.3 else x)
                     for x in xs])
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert np.isfinite(float(log1pexp(1e6)))
