"""Golden-matrix parity tests for basis evaluation.

Mirrors fdaPDE-core's test/src/lagrangian_basis_test.cpp:200-238: the Psi
matrices computed on the reference meshes must match the stored MatrixMarket
goldens entrywise. These check dof-numbering parity end-to-end — in
particular the P2 edge-dof numbering must reproduce the reference's
first-encounter edge order.
"""

import numpy as np
import pytest

from fdapde_core_tpu.fem import FEMSpace, eval_basis_areal, eval_basis_pointwise
from fdapde_core_tpu.utils.io import read_csv, read_mtx

from tests.conftest import golden_mesh, reference_path

TOL = 50 * np.finfo(np.float64).eps


@pytest.fixture(scope="module")
def c_shaped():
    return golden_mesh("c_shaped")


@pytest.fixture(scope="module")
def quasi_circle():
    return golden_mesh("quasi_circle")


@pytest.mark.parametrize("order", [1, 2])
def test_pointwise_evaluation_golden(c_shaped, order):
    locs = read_csv(reference_path("mesh", "c_shaped", "locs.csv"))
    space = FEMSpace(c_shaped, order)
    Psi, D = eval_basis_pointwise(space, locs)
    golden = read_mtx(
        reference_path("mtx", f"lagrangian_pointwise_eval_order{order}.mtx")
    )
    got = Psi.toarray()
    assert got.shape == golden.shape
    assert np.abs(got - golden).max() < TOL
    np.testing.assert_array_equal(D, np.ones(locs.shape[0]))


@pytest.mark.parametrize("order", [1, 2])
def test_areal_evaluation_golden(quasi_circle, order):
    incidence = read_csv(
        reference_path("mesh", "quasi_circle", "incidence_matrix.csv")
    )
    space = FEMSpace(quasi_circle, order)
    Psi, D = eval_basis_areal(space, incidence)
    golden = read_mtx(
        reference_path("mtx", f"lagrangian_areal_eval_order{order}.mtx")
    )
    got = Psi.toarray()
    assert got.shape == golden.shape
    assert np.abs(got - golden).max() < TOL
