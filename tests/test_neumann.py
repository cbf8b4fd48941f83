"""Mixed Dirichlet/Neumann boundary conditions (new capability of this
build; the reference core is Dirichlet-only)."""

import numpy as np
import pytest

import fdapde_core_tpu as fdm
from fdapde_core_tpu.fem import FEMSpace
from fdapde_core_tpu.fem.neumann import assemble_neumann, boundary_facet_selector
from fdapde_core_tpu.fem.solvers import solve_elliptic
from fdapde_core_tpu.geometry.structured import unit_square_mesh
from fdapde_core_tpu.fem.assembler import assemble_forcing, assemble_matrix

import jax.numpy as jnp


@pytest.mark.parametrize("order", [1, 2])
def test_mixed_bc_quadratic_solution(order):
    """u = x^2: -Lap u = -2, du/dn = 2 on {x=1}, Dirichlet elsewhere.

    For P2 the solution is in the FE space: error at solver tolerance.
    """
    mesh = unit_square_mesh(16)
    space = FEMSpace(mesh, order)
    A = assemble_matrix(space, -fdm.laplacian())
    F = assemble_forcing(space, lambda x: -2.0)

    neumann_mask = boundary_facet_selector(
        mesh, lambda p: p[:, 0] > 1.0 - 1e-9
    )
    F = F + jnp.asarray(assemble_neumann(space, 2.0, neumann_mask))

    coords = space.dof_coords
    exact = coords[:, 0] ** 2
    # Dirichlet everywhere on the boundary EXCEPT the x=1 side
    dmask = space.boundary_dofs.copy()
    on_neumann_side = coords[:, 0] > 1.0 - 1e-9
    corner = (coords[:, 1] < 1e-9) | (coords[:, 1] > 1 - 1e-9)
    dmask &= ~(on_neumann_side & ~corner)

    x, info = solve_elliptic(
        A, F, jnp.asarray(dmask), jnp.asarray(exact), rtol=1e-13
    )
    err = np.abs(np.asarray(x) - exact).max()
    if order == 2:
        assert err < 1e-9
    else:
        assert err < 5e-3


def test_neumann_zero_is_noop():
    mesh = unit_square_mesh(8)
    space = FEMSpace(mesh, 1)
    mask = boundary_facet_selector(mesh, lambda p: p[:, 0] > 0.5)
    v = assemble_neumann(space, 0.0, mask)
    assert np.abs(v).max() == 0.0


def test_neumann_constant_integrates_to_boundary_length():
    """int_Gamma 1 * sum_i psi_i = |Gamma| (partition of unity)."""
    mesh = unit_square_mesh(10)
    space = FEMSpace(mesh, 2)
    mask = boundary_facet_selector(mesh, lambda p: p[:, 1] < 1e-9)  # bottom
    v = assemble_neumann(space, 1.0, mask)
    assert v.sum() == pytest.approx(1.0, rel=1e-12)
