"""Smoothed-aggregation AMG (linear_algebra/amg.py).

Acceptance from VERDICT r1 item 2: h-independent preconditioned-CG iteration
counts across the unit_square_{16,32,64,128} refinement family, and the
product path (PDE.solve with solver_preconditioner="amg") solving an
unstructured Poisson problem. Capability anchor: Eigen SparseLU on any mesh
(fem_linear_elliptic_solver.h:38-47).
"""

import numpy as np
import jax.numpy as jnp
import pytest

import fdapde_core_tpu as fdm
from fdapde_core_tpu.fem.assembler import assemble_forcing, assemble_matrix
from fdapde_core_tpu.fem.solvers import masked_matrix
from fdapde_core_tpu.fem.space import FEMSpace
from fdapde_core_tpu.linear_algebra.amg import AMG, aggregate, amg_preconditioned_cg
from fdapde_core_tpu.linear_algebra.solvers import cg
from fdapde_core_tpu.geometry.structured import unit_square_mesh
from tests.conftest import load_mesh


def _masked_poisson(name, order=1):
    mesh = load_mesh(name)
    space = FEMSpace(mesh, order)
    A = assemble_matrix(space, -fdm.laplacian())
    b = assemble_forcing(space, lambda x: 1.0)
    mask = jnp.asarray(space.boundary_dofs)
    Am = masked_matrix(A, mask)
    bm = jnp.where(mask, 0.0, b)
    return Am, bm


def test_aggregate_covers_all_nodes():
    # path graph of 10 nodes
    r = np.array([0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9])
    c = np.array([1, 0, 2, 1, 3, 2, 4, 3, 5, 4, 6, 5, 7, 6, 8, 7, 9, 8])
    agg = aggregate(10, r, c)
    assert agg.shape == (10,)
    assert (agg >= 0).all()
    nc = agg.max() + 1
    assert 1 < nc < 10  # genuine coarsening
    # every aggregate non-empty
    assert (np.bincount(agg, minlength=nc) > 0).all()


def test_v_cycle_is_spd():
    """<x, M z> == <z, M x> and <x, M x> > 0 for the V-cycle operator M."""
    Am, _ = _masked_poisson("unit_square_16")
    mg = AMG.build(Am, seed=3)
    rng = np.random.default_rng(0)
    n = Am.shape[0]
    x = jnp.asarray(rng.standard_normal(n))
    z = jnp.asarray(rng.standard_normal(n))
    Mx, Mz = mg.v_cycle(x), mg.v_cycle(z)
    sym_gap = abs(float(x @ Mz) - float(z @ Mx)) / max(1.0, abs(float(x @ Mz)))
    assert sym_gap < 1e-12
    assert float(x @ Mx) > 0


def test_amg_cg_matches_dense_solution():
    Am, bm = _masked_poisson("unit_square_32")
    x, info = amg_preconditioned_cg(Am, bm, rtol=1e-12, maxiter=100)
    assert bool(info.converged)
    ref = np.linalg.solve(Am.toarray(), np.asarray(bm))
    np.testing.assert_allclose(np.asarray(x), ref, rtol=1e-8, atol=1e-12)


@pytest.mark.slow
def test_h_independent_iterations():
    """Iteration counts must stay O(1) under refinement (the point of MG)."""
    iters = {}
    for name in ["unit_square_16", "unit_square_32", "unit_square_64",
                 "unit_square_128"]:
        Am, bm = _masked_poisson(name)
        # coarse_max=60 so even the 289-dof mesh is genuinely multilevel
        mg = AMG.build(Am, coarse_max=60)
        _, info = cg(Am, bm, M_inv=mg.v_cycle, rtol=1e-10, maxiter=100)
        assert bool(info.converged), name
        iters[name] = int(info.iterations)
    counts = list(iters.values())
    assert max(counts) <= 25, iters
    # flat growth: 16 -> 128 (8x refinement, 64x dofs) grows by < 2x
    assert counts[-1] <= 2 * counts[0] + 2, iters


def test_jacobi_cg_is_not_h_independent_but_amg_is():
    """Control: the plain-Jacobi iteration count grows with refinement —
    the AMG gain is real, not an artifact of easy problems."""
    Am16, b16 = _masked_poisson("unit_square_16")
    Am128, b128 = _masked_poisson("unit_square_128")
    from fdapde_core_tpu.linear_algebra.solvers import jacobi_preconditioner

    _, i16 = cg(Am16, b16, M_inv=jacobi_preconditioner(Am16.diagonal()),
                rtol=1e-10, maxiter=5000)
    _, i128 = cg(Am128, b128, M_inv=jacobi_preconditioner(Am128.diagonal()),
                 rtol=1e-10, maxiter=5000)
    assert int(i128.iterations) > 3 * int(i16.iterations)


def test_operator_complexity_bounded():
    Am, _ = _masked_poisson("unit_square_64")
    mg = AMG.build(Am)
    assert mg.n_levels >= 3
    assert mg.operator_complexity() < 2.5


def test_amg_on_p2_and_anisotropic():
    """Generality: order-2 elements and anisotropic diffusion."""
    mesh = load_mesh("unit_square_32")
    space = FEMSpace(mesh, 2)
    K = np.array([[10.0, 0.0], [0.0, 0.1]])
    A = assemble_matrix(space, -fdm.diffusion(K))
    b = assemble_forcing(space, lambda x: 1.0)
    mask = jnp.asarray(space.boundary_dofs)
    Am = masked_matrix(A, mask)
    bm = jnp.where(mask, 0.0, b)
    x, info = amg_preconditioned_cg(Am, bm, rtol=1e-10, maxiter=150)
    assert bool(info.converged)
    res = np.linalg.norm(np.asarray(Am @ x - bm)) / np.linalg.norm(np.asarray(bm))
    assert res < 1e-9


def test_pde_product_path_with_amg():
    """solver_preconditioner='amg' through the public PDE API."""
    mesh = load_mesh("unit_square_64")
    pde = fdm.PDE(
        mesh, -fdm.laplacian(), forcing=lambda x: -4.0, order=1,
        solver_preconditioner="amg", solver_maxiter=60,
    )
    g = (pde.dof_coords() ** 2).sum(axis=1)  # u = x^2 + y^2
    pde.set_dirichlet_bc(g)
    pde.solve()
    assert pde.success
    assert pde.report()["solver_iterations"] <= 30
    assert pde.l2_error(g) < 1.1e-14  # reference 50*eps class tolerance


def test_amg_checkpoint_roundtrip(tmp_path):
    """AMG hierarchies persist losslessly (SURVEY §5.4: host setup is the
    expensive part at scale — checkpoint it)."""
    from fdapde_core_tpu.utils.checkpoint import load_amg, save_amg

    Am, bm = _masked_poisson("unit_square_32")
    mg = AMG.build(Am)
    path = str(tmp_path / "hier.npz")
    save_amg(path, mg)
    mg2 = load_amg(path)
    assert mg2.n_levels == mg.n_levels
    r = jnp.asarray(np.random.default_rng(1).standard_normal(Am.shape[0]))
    np.testing.assert_array_equal(
        np.asarray(mg.v_cycle(r)), np.asarray(mg2.v_cycle(r))
    )
    _, info = cg(Am, bm, M_inv=mg2.v_cycle, rtol=1e-10, maxiter=60)
    assert bool(info.converged)


@pytest.mark.parametrize(
    "domain, expect",
    [("interval", "amg"), ("square", "auxgrid")],
)
def test_auto_preconditioner_choice(domain, expect):
    """solver_preconditioner="auto": the aux-grid build is tried first and
    only its own failure (a mesh it cannot cover, here 1D dof coordinates)
    selects SA-AMG; the solve itself is not wrapped."""
    from fdapde_core_tpu.geometry import Interval

    mesh = (Interval(0.0, 1.0, 64) if domain == "interval"
            else unit_square_mesh(16))
    pde = fdm.PDE(mesh, -fdm.laplacian(), order=1,
                  solver_preconditioner="auto")
    g = pde.dof_coords().sum(axis=1)
    pde.set_dirichlet_bc(g)
    pde.set_forcing(np.zeros((pde.quadrature_nodes().shape[0], 1)))
    pde.init()
    pde.solve()
    assert pde.solve_preconditioner == expect
    assert pde.success and pde.l2_error(g) < 1e-18


def test_auto_preconditioner_does_not_hide_solve_errors(monkeypatch):
    import fdapde_core_tpu.fem.solvers as fem_solvers

    def broken(*a, **k):
        raise RuntimeError("device failure")

    monkeypatch.setattr(fem_solvers, "solve_elliptic", broken)
    pde = fdm.PDE(unit_square_mesh(8), -fdm.laplacian(), order=1,
                  solver_preconditioner="auto")
    pde.set_dirichlet_bc(np.zeros(pde.n_dofs))
    pde.init()
    with pytest.raises(RuntimeError, match="device failure"):
        pde.solve()
