"""Multi-chip tests on the 8-device virtual CPU mesh.

The correctness contract (SURVEY.md §4): the same solve on 1 device and on N
devices must agree to solver tolerance, and must match the single-chip
reference path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fdapde_core_tpu.geometry.structured import unit_square_mesh
from fdapde_core_tpu.parallel import ShardedPoisson, make_device_mesh, morton_order, partition_elements


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_morton_order_is_permutation():
    mesh = unit_square_mesh(8)
    order = morton_order(mesh.cell_barycenters)
    assert sorted(order) == list(range(mesh.n_cells))


def test_partition_padding():
    mesh = unit_square_mesh(5)  # 50 cells over 8 shards -> block 7, pad 6
    perm, live, block = partition_elements(mesh, 8)
    assert perm.size == 8 * block
    assert live.sum() == mesh.n_cells


def _solve_both_ways(n, order):
    mesh = unit_square_mesh(n)
    import fdapde_core_tpu as fdm

    # single-chip reference path
    pde = fdm.PDE(mesh, -fdm.laplacian(), forcing=lambda x: 4.0, order=order)
    coords = pde.dof_coords()
    g = 1.0 - coords[:, 0] ** 2 - coords[:, 1] ** 2
    pde.set_dirichlet_bc(g)
    pde.init()
    pde.solve()

    # sharded path (same forcing vector, same boundary data)
    for n_dev in (1, 8):
        sp = ShardedPoisson(mesh, order, make_device_mesh(n_dev))
        b = pde.force()
        x, res, iters = sp.solve(b, jnp.asarray(g), rtol=1e-12, maxiter=2000)
        yield pde, np.asarray(pde.solution()), np.asarray(x), n_dev


@pytest.mark.parametrize("order", [1, 2])
@pytest.mark.slow
def test_sharded_matches_single_chip(order):
    for pde, ref, got, n_dev in _solve_both_ways(12, order):
        assert np.abs(ref - got).max() < 1e-8, (order, n_dev)


def test_sharded_1_vs_8_devices_identical():
    mesh = unit_square_mesh(16)
    import fdapde_core_tpu as fdm

    pde = fdm.PDE(mesh, -fdm.laplacian(), forcing=lambda x: 1.0, order=1)
    pde.init()
    b = pde.force()
    g = jnp.zeros(pde.n_dofs)
    sols = []
    for n_dev in (1, 8):
        sp = ShardedPoisson(mesh, 1, make_device_mesh(n_dev))
        x, _, _ = sp.solve(b, g, rtol=1e-13, maxiter=3000)
        sols.append(np.asarray(x))
    assert np.abs(sols[0] - sols[1]).max() < 1e-10


@pytest.mark.slow
def test_sharded_ell_spmv_matches_segment():
    """Scatter-free per-shard ELL combine == segment_sum combine, on 1 and
    8 devices (same solutions to solver tolerance)."""
    mesh = unit_square_mesh(14)
    import fdapde_core_tpu as fdm

    pde = fdm.PDE(mesh, -fdm.laplacian(), forcing=lambda x: 2.0, order=1)
    pde.init()
    b = pde.force()
    g = jnp.zeros(pde.n_dofs)
    sols = []
    for n_dev in (1, 8):
        for spmv in ("segment", "ell"):
            sp = ShardedPoisson(mesh, 1, make_device_mesh(n_dev), spmv=spmv)
            x, _, _ = sp.solve(b, g, rtol=1e-13, maxiter=3000)
            sols.append(np.asarray(x))
    for s in sols[1:]:
        assert np.abs(sols[0] - s).max() < 1e-10


@pytest.mark.slow
def test_sharded_space_varying_coefficients():
    """Callable (space-varying) reaction + advection coefficients shard with
    the cells and reproduce the single-chip PDE solution."""
    mesh = unit_square_mesh(10)
    import fdapde_core_tpu as fdm

    c = lambda x: 1.0 + x[..., 0] + 0.5 * x[..., 1]  # noqa: E731
    op = -fdm.laplacian() + fdm.reaction(c)
    pde = fdm.PDE(mesh, op, forcing=lambda x: 3.0, order=1)
    g = jnp.zeros(pde.n_dofs)
    pde.set_dirichlet_bc(np.zeros(pde.n_dofs))
    pde.init()
    pde.solve()
    b = pde.force()

    for n_dev in (1, 8):
        sp = ShardedPoisson(mesh, 1, make_device_mesh(n_dev), operator=op)
        x, _, _ = sp.solve(b, g, rtol=1e-13, maxiter=3000)
        assert np.abs(np.asarray(x) - np.asarray(pde.solution())).max() < 1e-9


def test_sharded_assembly_matches_sparse():
    """Sharded local matrices scatter-summed == single-chip global matrix."""
    mesh = unit_square_mesh(6)
    import fdapde_core_tpu as fdm
    from fdapde_core_tpu.fem import FEMSpace, assemble_matrix

    space = FEMSpace(mesh, 1)
    A = assemble_matrix(space, -fdm.laplacian()).toarray()

    sp = ShardedPoisson(mesh, 1, make_device_mesh(8))
    A_loc = np.asarray(sp.assemble())
    dofs = sp._dofs
    dense = np.zeros((space.n_dofs, space.n_dofs))
    for c in range(A_loc.shape[0]):
        for i in range(3):
            for j in range(3):
                dense[dofs[c, i], dofs[c, j]] += A_loc[c, i, j]
    assert np.abs(dense - A).max() < 1e-12


@pytest.mark.slow
def test_halo_dia_solver_matches_single_chip():
    """Halo-exchange DIA CG on 8 devices == single-chip masked solve."""
    import fdapde_core_tpu as fdm
    from fdapde_core_tpu.fem import FEMSpace
    from fdapde_core_tpu.fem.assembler import assemble_forcing, assemble_matrix
    from fdapde_core_tpu.fem.solvers import DirichletSystem, solve_elliptic
    from fdapde_core_tpu.linear_algebra.dia import dia_from_coo, unique_offsets
    from fdapde_core_tpu.parallel.halo import HaloDIASolver

    mesh = unit_square_mesh(24)
    space = FEMSpace(mesh, 1)
    A = assemble_matrix(space, -fdm.laplacian())
    F = assemble_forcing(space, lambda x: 4.0)
    coords = space.dof_coords
    g = jnp.asarray(1 - coords[:, 0] ** 2 - coords[:, 1] ** 2)
    mask = jnp.asarray(space.boundary_dofs)

    ref, info = solve_elliptic(A, F, mask, g, rtol=1e-12)

    offs = unique_offsets(space.dofs)
    D = dia_from_coo(A.rows, A.cols, A.vals, space.n_dofs, offs)
    sys = DirichletSystem(A, mask)
    b_mod = sys.rhs(F, g)
    for n_dev in (1, 8):
        solver = HaloDIASolver(D, make_device_mesh(n_dev))
        x, res, k = solver.solve(b_mod, (~mask).astype(jnp.float64), rtol=1e-12)
        assert np.abs(np.asarray(x) - np.asarray(ref)).max() < 1e-8, n_dev


@pytest.mark.slow
def test_models_sharded_driver():
    """High-level driver: halo-DIA strategy on a structured mesh, 8 devices,
    matches the single-chip PDE solve."""
    import fdapde_core_tpu as fdm
    from fdapde_core_tpu.models import solve_elliptic_sharded

    mesh = unit_square_mesh(20)
    pde = fdm.PDE(mesh, -fdm.laplacian(), forcing=lambda x: 4.0, order=1)
    coords = pde.dof_coords()
    g = 1 - coords[:, 0] ** 2 - coords[:, 1] ** 2
    pde.set_dirichlet_bc(g)
    pde.init()
    pde.solve()

    x, info = solve_elliptic_sharded(
        mesh, -fdm.laplacian(), lambda p: 4.0, g,
        device_mesh=make_device_mesh(8), rtol=1e-12,
    )
    assert info["strategy"] == "halo_dia"
    assert np.abs(np.asarray(x) - np.asarray(pde.solution())).max() < 1e-8


@pytest.mark.slow
def test_halo_parabolic_matches_single_chip():
    """Distributed implicit Euler (scan inside shard_map) == single-chip
    parabolic solver, 8 devices."""
    import fdapde_core_tpu as fdm
    from fdapde_core_tpu.fem import FEMSpace
    from fdapde_core_tpu.fem.assembler import assemble_forcing, assemble_matrix
    from fdapde_core_tpu.fem.solvers import solve_parabolic
    from fdapde_core_tpu.linear_algebra.dia import dia_from_coo, unique_offsets
    from fdapde_core_tpu.parallel.halo import HaloDIAParabolic

    mesh = unit_square_mesh(12)
    space = FEMSpace(mesh, 1)
    A = assemble_matrix(space, -fdm.laplacian())
    M = assemble_matrix(space, fdm.reaction(1.0))
    coords = space.dof_coords
    times = np.linspace(0.0, 0.2, 9)
    dt = float(times[1] - times[0])

    def exact(x, t):
        return np.sin(np.pi * x[..., 0]) * np.sin(np.pi * x[..., 1]) * np.exp(-t)

    g = jnp.asarray(exact(coords[:, None, :], times[None, :]))
    u0 = jnp.asarray(exact(coords, 0.0))
    qn = space.quadrature_nodes
    f = (2 * np.pi**2 - 1.0) * exact(qn[:, None, :], times[None, :])
    F = assemble_forcing(space, f)
    mask = jnp.asarray(space.boundary_dofs)

    ref = solve_parabolic(A, M, F, mask, g, u0, jnp.asarray(times), rtol=1e-12)

    offs = unique_offsets(space.dofs)
    Ad = dia_from_coo(A.rows, A.cols, A.vals, space.n_dofs, offs)
    Md = dia_from_coo(M.rows, M.cols, M.vals, space.n_dofs, offs)
    solver = HaloDIAParabolic(Ad, Md, dt, make_device_mesh(8))
    us = solver.solve(
        F[:, 1:], g[:, 1:], u0, (~mask).astype(jnp.float64), rtol=1e-12
    )
    got = np.concatenate([np.asarray(u0)[:, None], np.asarray(us)], axis=1)
    assert np.abs(got - np.asarray(ref)).max() < 1e-8


@pytest.mark.slow
def test_halo_grid_dia_matches_single_chip():
    """Row-sharded 2D-stencil CG on 8 devices == single-chip masked solve."""
    import fdapde_core_tpu as fdm
    from fdapde_core_tpu.fem import FEMSpace
    from fdapde_core_tpu.fem.assembler import assemble_forcing, assemble_matrix
    from fdapde_core_tpu.fem.solvers import DirichletSystem, solve_elliptic
    from fdapde_core_tpu.linear_algebra.dia import dia_from_coo, unique_offsets
    from fdapde_core_tpu.ops.grid_dia import GridDIAMatrix
    from fdapde_core_tpu.parallel import HaloGridDIASolver

    mesh = unit_square_mesh(31)  # mx = 32 rows over 8 shards -> Rb = 4
    space = FEMSpace(mesh, 1)
    A = assemble_matrix(space, -fdm.laplacian())
    F = assemble_forcing(space, lambda x: 4.0)
    coords = space.dof_coords
    g = jnp.asarray(1 - coords[:, 0] ** 2 - coords[:, 1] ** 2)
    mask = jnp.asarray(space.boundary_dofs)
    ref, _ = solve_elliptic(A, F, mask, g, rtol=1e-12)

    offs = unique_offsets(space.dofs)
    G = GridDIAMatrix.from_dia(
        dia_from_coo(A.rows, A.cols, A.vals, space.n_dofs, offs), (32, 32)
    )
    free = (~mask).astype(jnp.float64)
    b_mod = DirichletSystem(A, mask).rhs(F, g)
    for n_dev in (1, 8):
        solver = HaloGridDIASolver(G, free, make_device_mesh(n_dev))
        x, res, k = solver.solve(b_mod, rtol=1e-12)
        # solver returns interior solution + g on pinned dofs via identity rows
        assert np.abs(np.asarray(x) - np.asarray(ref)).max() < 1e-8, n_dev


@pytest.mark.slow
def test_halo_dia_p2_via_rcm_matches_single_chip():
    """Sharded P2 elliptic solve: RCM dof reordering restores DIA locality
    (parity numbering has H ~ n_dofs; RCM gives H = O(bandwidth)), then the
    halo CG on 8 devices matches the single-chip reference solve."""
    import fdapde_core_tpu as fdm
    from fdapde_core_tpu.fem import FEMSpace
    from fdapde_core_tpu.fem.assembler import assemble_forcing, assemble_matrix
    from fdapde_core_tpu.fem.solvers import DirichletSystem, solve_elliptic
    from fdapde_core_tpu.linear_algebra.dia import dia_from_coo, unique_offsets
    from fdapde_core_tpu.parallel.halo import HaloDIASolver
    from fdapde_core_tpu.parallel.reorder import permute_system, rcm_permutation

    mesh = unit_square_mesh(16)
    space = FEMSpace(mesh, 2)
    A = assemble_matrix(space, -fdm.laplacian())
    F = assemble_forcing(space, lambda x: 4.0)
    coords = space.dof_coords
    g = jnp.asarray(1 - coords[:, 0] ** 2 - coords[:, 1] ** 2)
    mask = jnp.asarray(space.boundary_dofs)

    ref, info = solve_elliptic(A, F, mask, g, rtol=1e-12)

    n = space.n_dofs
    perm, inv = rcm_permutation(np.asarray(A.rows), np.asarray(A.cols), n)
    offs_raw = unique_offsets(space.dofs)
    offs = unique_offsets(inv[space.dofs])
    assert max(abs(o) for o in offs) < max(abs(o) for o in offs_raw) // 4

    rp, cp, vp = permute_system(perm, inv, A.rows, A.cols, A.vals)
    D = dia_from_coo(jnp.asarray(rp), jnp.asarray(cp), vp, n, offs)
    sys = DirichletSystem(A, mask)
    b_mod = np.asarray(sys.rhs(F, g))
    free = (~np.asarray(mask)).astype(np.float64)
    for n_dev in (1, 8):
        solver = HaloDIASolver(D, make_device_mesh(n_dev))
        xp, res, k = solver.solve(
            jnp.asarray(b_mod[perm]), jnp.asarray(free[perm]), rtol=1e-12
        )
        x = np.asarray(xp)[inv]
        assert np.abs(x - np.asarray(ref)).max() < 1e-8, n_dev


@pytest.mark.slow
def test_sharded_multigrid_matches_single_chip():
    """Row-sharded V-cycle MG-CG == replicated MG-CG == long Jacobi-CG, on
    1 and 8 virtual devices, with >= 2 sharded levels exercised."""
    import fdapde_core_tpu as fdm
    from fdapde_core_tpu.fem import FEMSpace
    from fdapde_core_tpu.fem.assembler import assemble_forcing, assemble_matrix
    from fdapde_core_tpu.linear_algebra.dia import dia_from_coo, unique_offsets
    from fdapde_core_tpu.ops.grid_cg import grid_cg
    from fdapde_core_tpu.ops.grid_dia import (
        GridDIAMatrix,
        prune_zero_offsets_grid,
    )
    from fdapde_core_tpu.ops.grid_mg import mg_preconditioned_cg
    from fdapde_core_tpu.parallel.mg import ShardedGridMG

    n = 64
    mesh = unit_square_mesh(n)
    space = FEMSpace(mesh, 1)
    A = assemble_matrix(space, -fdm.laplacian())
    offs = unique_offsets(space.dofs)
    D = dia_from_coo(A.rows, A.cols, A.vals, space.n_dofs, offs)
    free = jnp.asarray(~mesh.boundary_nodes, jnp.float64)
    G = prune_zero_offsets_grid(
        GridDIAMatrix.from_dia(D, (n + 1, n + 1)).with_dirichlet_identity(free)
    )
    b = jnp.asarray(assemble_forcing(space, lambda x: 1.0)).reshape(-1) * free

    ref, _ = grid_cg(G, b, 20000)
    x1, rel1, k1 = mg_preconditioned_cg(G, b, rtol=1e-10, maxiter=60,
                                        coarse_n=8)
    assert np.abs(np.asarray(x1) - np.asarray(ref)).max() < 1e-9

    for n_dev in (1, 8):
        smg = ShardedGridMG(G, make_device_mesh(n_dev), repl_rows=16,
                            coarse_n=8)
        assert smg.T >= 2  # at least two sharded levels in this config
        xs, rel, k = smg.solve(b, rtol=1e-10, maxiter=60)
        assert np.abs(np.asarray(xs) - np.asarray(ref)).max() < 1e-9, n_dev
        assert int(k) <= int(k1) + 3, (int(k), int(k1))


def test_rcm_native_matches_python():
    """Native C++ RCM == NumPy BFS bit-for-bit (same tie-breaking), and
    measurably faster at moderate sizes."""
    import time

    import fdapde_core_tpu as fdm
    from fdapde_core_tpu.fem import FEMSpace
    from fdapde_core_tpu.fem.assembler import assemble_matrix
    from fdapde_core_tpu.native.build import native_available
    from fdapde_core_tpu.parallel import reorder

    if not native_available():
        import pytest

        pytest.skip("native library unavailable")

    mesh = unit_square_mesh(48)
    space = FEMSpace(mesh, 2)
    A = assemble_matrix(space, -fdm.laplacian())
    n = space.n_dofs
    rows, cols = np.asarray(A.rows), np.asarray(A.cols)

    indptr, adj = reorder._adjacency_csr(rows, cols, n)
    native = reorder._rcm_native(indptr, adj, n)
    assert native is not None

    # python fallback (forced)
    orig = reorder._rcm_native
    try:
        reorder._rcm_native = lambda *a: None
        perm_py, inv_py = reorder.rcm_permutation(rows, cols, n)
    finally:
        reorder._rcm_native = orig
    perm_nat, inv_nat = reorder.rcm_permutation(rows, cols, n)
    np.testing.assert_array_equal(perm_nat, perm_py)
    np.testing.assert_array_equal(inv_nat, inv_py)


@pytest.mark.slow
def test_time_sharded_space_time_matches_single_chip():
    """Time-sharded Kronecker CG (SURVEY SS5.7) == unsharded SeparableOperator
    solve: banded spline-like time factors, sparse FEM space factors."""
    import fdapde_core_tpu as fdm
    from fdapde_core_tpu.fem import FEMSpace, assemble_matrix
    from fdapde_core_tpu.models.space_time import (
        SeparableOperator,
        solve_space_time,
    )
    from fdapde_core_tpu.parallel.space_time import ShardedSpaceTime

    mesh = unit_square_mesh(5)
    space = FEMSpace(mesh, 1)
    S_stiff = assemble_matrix(space, -fdm.laplacian())
    S_mass = assemble_matrix(space, fdm.reaction(1.0))

    n_t = 19  # not divisible by 8: exercises time padding
    # banded SPD time factors (tridiagonal stiffness + mass, bandwidth 1 —
    # the cubic-spline case has bandwidth 3, same code path)
    main = 2.0 * np.ones(n_t)
    off = -1.0 * np.ones(n_t - 1)
    T_stiff = np.diag(main) + np.diag(off, 1) + np.diag(off, -1)
    T_mass = (
        np.diag(4.0 * np.ones(n_t))
        + np.diag(np.ones(n_t - 1), 1)
        + np.diag(np.ones(n_t - 1), -1)
    ) / 6.0

    terms = [(T_mass, S_stiff), (T_stiff, S_mass)]
    rng = np.random.default_rng(11)
    b = rng.normal(size=n_t * space.n_dofs)

    op = SeparableOperator(terms)
    x_ref, info = solve_space_time(op, jnp.asarray(b), rtol=1e-12)

    solver = ShardedSpaceTime(terms, make_device_mesh(8))
    assert solver.H == 1
    x_sh, res, iters = solver.solve(jnp.asarray(b), rtol=1e-12)
    assert int(iters) > 0
    np.testing.assert_allclose(
        np.asarray(x_sh), np.asarray(x_ref), rtol=0, atol=1e-8
    )


@pytest.mark.slow
def test_sharded_auxgrid_preconditioner_matches_and_accelerates():
    """ShardedPoisson(preconditioner='auxgrid'): replicated aux-grid apply +
    sharded SpMV — same solution as the Jacobi path, fewer iterations, and
    1-vs-8-device agreement."""
    import fdapde_core_tpu as fdm
    from fdapde_core_tpu.parallel import ShardedPoisson
    from fdapde_core_tpu.parallel.sharded import make_device_mesh

    mesh = unit_square_mesh(24)
    b = None
    sp_jac = ShardedPoisson(mesh, order=1, device_mesh=make_device_mesh(8))
    sp_aux = ShardedPoisson(
        mesh, order=1, device_mesh=make_device_mesh(8),
        preconditioner="auxgrid",
    )
    n = sp_aux.n_dofs
    b = jnp.ones(n, sp_aux.dtype)
    g = jnp.zeros(n, sp_aux.dtype)
    xj, rj, kj = sp_jac.solve(b, g, rtol=1e-10, maxiter=2000)
    xa, ra, ka = sp_aux.solve(b, g, rtol=1e-10, maxiter=2000)
    assert int(ka) * 2 < int(kj), (int(ka), int(kj))
    np.testing.assert_allclose(np.asarray(xa), np.asarray(xj), atol=1e-8)

    # 1-device == 8-device
    sp1 = ShardedPoisson(
        mesh, order=1, device_mesh=make_device_mesh(1),
        preconditioner="auxgrid",
    )
    x1, r1, k1 = sp1.solve(b, g, rtol=1e-10, maxiter=2000)
    np.testing.assert_allclose(np.asarray(xa), np.asarray(x1), atol=1e-10)


@pytest.mark.slow
def test_halo_ell_general_path_matches_single_chip():
    """Sharded GENERAL gather path (parallel/halo_ell.py): halo-exchange CG
    over an assembled ELLSoA matches the single-device DirichletSystem CG
    solve, and 1-vs-8 devices agree to f64 round-off."""
    import jax.numpy as jnp

    from fdapde_core_tpu.fem.solvers import DirichletSystem
    from fdapde_core_tpu.geometry.structured import irregular_mesh_device_soa
    from fdapde_core_tpu.linear_algebra.solvers import cg
    from fdapde_core_tpu.ops.matfree_soa import MatrixFreeSoA
    from fdapde_core_tpu.parallel.halo_ell import HaloELLSolver
    from fdapde_core_tpu.parallel.sharded import make_device_mesh

    n = 24
    x, y, c0, c1, c2, bnd = irregular_mesh_device_soa(n, 0.2,
                                                      dtype=jnp.float64)
    n_dofs = (n + 1) ** 2
    soa, over = MatrixFreeSoA.build(x, y, c0, c1, c2, n_dofs, 8)
    assert not bool(over)
    E, overc = soa.to_ell(9)
    assert not bool(overc)

    free = ~bnd
    b = jnp.where(bnd, 0.0, 1.0) / (n * n)

    sys_ = DirichletSystem(E, bnd)
    x_ref, info = cg(sys_, b, rtol=1e-11, maxiter=2000)
    assert bool(info.converged)

    s8 = HaloELLSolver(E, make_device_mesh(8))
    x8, r8, k8 = s8.solve(b, free.astype(jnp.float64), rtol=1e-11,
                          maxiter=2000)
    np.testing.assert_allclose(np.asarray(x8), np.asarray(x_ref), atol=1e-9)

    s1 = HaloELLSolver(E, make_device_mesh(1))
    x1, r1, k1 = s1.solve(b, free.astype(jnp.float64), rtol=1e-11,
                          maxiter=2000)
    assert int(k1) == int(k8)
    np.testing.assert_allclose(np.asarray(x8), np.asarray(x1), atol=1e-12)


@pytest.mark.slow
def test_sharded_banded_general_path():
    """The banded DIA-split of a GENERAL (arbitrary-topology) operator is a
    (R, W) grid stencil — so the row-sharded HaloGridDIASolver runs the
    general path at stencil speed across devices, halo = one ppermute row
    strip. 8-device vs single-device parity."""
    import jax
    import jax.numpy as jnp

    from fdapde_core_tpu.fem.solvers import DirichletSystem
    from fdapde_core_tpu.geometry.structured import irregular_mesh_device_soa
    from fdapde_core_tpu.linear_algebra.solvers import cg
    from fdapde_core_tpu.ops.dia_split import (
        build_banded_split,
        plan_split_width,
    )
    from fdapde_core_tpu.ops.matfree_soa import MatrixFreeSoA
    from fdapde_core_tpu.parallel import HaloGridDIASolver
    from fdapde_core_tpu.parallel.sharded import make_device_mesh

    n = 32
    x, y, c0, c1, c2, bnd = irregular_mesh_device_soa(n, 0.2,
                                                      dtype=jnp.float64)
    nd = (n + 1) ** 2
    op, _ = MatrixFreeSoA.build(x, y, c0, c1, c2, nd, 8)
    E, _ = jax.jit(lambda o: o.to_ell(9))(op)
    W, amax = plan_split_width(E)
    assert W is not None
    S, _ = jax.jit(lambda E_: build_banded_split(E_, W, amax=amax))(E)
    R, Wd = S.G.shape2d

    free_flat = jnp.pad((~bnd).astype(jnp.float64), (0, R * Wd - nd))
    b = jnp.where(bnd, 0.0, 1.0) / (n * n)
    b_pad = jnp.pad(b, (0, R * Wd - nd))

    solver8 = HaloGridDIASolver(S.G, free_flat, make_device_mesh(8))
    x8, r8, k8 = solver8.solve(b_pad, rtol=1e-11, maxiter=3000)

    # single-chip reference on the unsplit operator
    sys_ = DirichletSystem(E, bnd)
    x_ref, info = cg(sys_, b, rtol=1e-11, maxiter=3000)
    assert bool(info.converged)
    np.testing.assert_allclose(np.asarray(x8).reshape(-1)[:nd],
                               np.asarray(x_ref), atol=1e-8)

    solver1 = HaloGridDIASolver(S.G, free_flat, make_device_mesh(1))
    x1, r1, k1 = solver1.solve(b_pad, rtol=1e-11, maxiter=3000)
    assert int(k1) == int(k8)
    np.testing.assert_allclose(np.asarray(x8), np.asarray(x1), atol=1e-12)


def test_sharded_banded_mg_matches_single_chip():
    """Round-4 item: the flagship BandedMGPreconditioner, sharded.

    The general-path banded split solved over 1 and 8 devices must match
    the single-chip BandedMG-CG solution, converge in a comparable
    iteration count (<= 2x), and beat Jacobi-CG's count by far — the r03
    sharded general path was Jacobi-only (correctness-only at scale)."""
    import jax
    import jax.numpy as jnp

    from fdapde_core_tpu.geometry.structured import irregular_mesh_device_soa
    from fdapde_core_tpu.linear_algebra.solvers import cg
    from fdapde_core_tpu.ops.dia_split import (
        BandedMGPreconditioner,
        build_banded_split,
        plan_split_width,
    )
    from fdapde_core_tpu.ops.matfree_soa import MatrixFreeSoA
    from fdapde_core_tpu.parallel.banded import ShardedBandedMGSolver
    from fdapde_core_tpu.parallel.sharded import make_device_mesh

    n = 48
    nd = (n + 1) ** 2
    x, y, c0, c1, c2, bnd = irregular_mesh_device_soa(n, 0.2,
                                                     dtype=jnp.float64)
    op, _ = MatrixFreeSoA.build(x, y, c0, c1, c2, nd, 8)
    E, _ = jax.jit(lambda o: o.to_ell(9))(op)
    W, amax = plan_split_width(E)
    assert W is not None and amax == 1
    S, over = build_banded_split(E, W, amax=amax)
    assert not bool(over)
    F = S.fold_dirichlet(bnd)
    assert int(jnp.sum(F.rem.vals != 0.0)) == 0
    F = F.drop_empty_remainder()

    b = jnp.where(bnd, 0.0, 1.0) / (n * n)

    # single-chip reference: BandedMG-preconditioned CG
    bmg = BandedMGPreconditioner.build(F, dtype=jnp.float64, coarse_n=8)
    x1, info1 = cg(F, b, M_inv=lambda r: bmg(r), rtol=1e-10, maxiter=60)
    k1 = int(info1.iterations)
    assert k1 <= 25
    # Jacobi-CG control: the preconditioner must be doing real work
    xj, infoj = cg(F, b, rtol=1e-10, maxiter=500)
    assert int(infoj.iterations) > 3 * k1

    for n_dev in (1, 8):
        solver = ShardedBandedMGSolver(F, make_device_mesh(n_dev),
                                       repl_rows=16, coarse_n=8)
        xs, rel, k = solver.solve(b, rtol=1e-10, maxiter=60)
        assert np.abs(np.asarray(xs) - np.asarray(x1)).max() < 1e-8, n_dev
        assert int(k) <= 2 * k1, (int(k), k1, n_dev)


def test_sharded_banded_mg_guards():
    """Live-remainder and wide-window splits are routed away loudly."""
    import jax.numpy as jnp
    import pytest as _pytest

    from fdapde_core_tpu.ops.dia_split import BandedSplit
    from fdapde_core_tpu.ops.grid_dia import GridDIAMatrix
    from fdapde_core_tpu.ops.matfree_soa import ELLSoA
    from fdapde_core_tpu.parallel.banded import ShardedBandedMGSolver
    from fdapde_core_tpu.parallel.sharded import make_device_mesh

    n, W = 64, 8
    offs = tuple((a, b) for a in (-1, 0, 1) for b in (-1, 0, 1))
    data = jnp.zeros((9, 8, 8)).at[offs.index((0, 0))].set(1.0)
    G = GridDIAMatrix(data, offs, (8, 8))
    rem = ELLSoA(jnp.ones((1, n)), jnp.zeros((1, n), jnp.int32), (n, n))
    with _pytest.raises(ValueError, match="remainder-free"):
        ShardedBandedMGSolver(BandedSplit(G, rem, n), make_device_mesh(1))


def test_halo_ell_scattered_path_matches_single_chip():
    """Sharded GENERAL path on a block-scrambled numbering (the bench's
    genscat permutation, which the banded split plan rejects): halo-ELL CG
    over 8 devices matches the single-device DirichletSystem CG and the
    1-device halo solve."""
    import jax.numpy as jnp

    from fdapde_core_tpu.fem.solvers import DirichletSystem
    from fdapde_core_tpu.geometry.structured import irregular_mesh_device_soa
    from fdapde_core_tpu.linear_algebra.solvers import cg
    from fdapde_core_tpu.ops.dia_split import plan_split_width
    from fdapde_core_tpu.ops.matfree_soa import ELLSoA, MatrixFreeSoA
    from fdapde_core_tpu.parallel.halo_ell import HaloELLSolver
    from fdapde_core_tpu.parallel.sharded import make_device_mesh

    n = 40
    x, y, c0, c1, c2, bnd = irregular_mesh_device_soa(n, 0.2,
                                                      dtype=jnp.float64)
    n_dofs = (n + 1) ** 2
    soa, over = MatrixFreeSoA.build(x, y, c0, c1, c2, n_dofs, 8)
    assert not bool(over)
    E0, overc = soa.to_ell(9)
    assert not bool(overc)

    # block-local multiplicative scramble: a symmetric permutation
    # similarity the split plan rejects
    S, G = 64, 19
    GI = pow(G, -1, S)
    nfull = (n_dofs // S) * S
    i = jnp.arange(n_dofs, dtype=jnp.int32)
    pm = jnp.where(i < nfull, (i // S) * S + (G * (i % S)) % S, i)
    pinv = jnp.where(i < nfull, (i // S) * S + (GI * (i % S)) % S, i)
    E = ELLSoA(E0.vals[:, pinv], pm[E0.cols[:, pinv]], (n_dofs, n_dofs))
    bnd_s = bnd[pinv]
    assert plan_split_width(E)[0] is None

    free = (~bnd_s).astype(jnp.float64)
    b = jnp.where(bnd_s, 0.0, 1.0) / (n * n)
    x_ref, info = cg(DirichletSystem(E, bnd_s), b, rtol=1e-11, maxiter=4000)
    assert bool(info.converged)

    x8, r8, k8 = HaloELLSolver(E, make_device_mesh(8)).solve(
        b, free, rtol=1e-11, maxiter=4000)
    np.testing.assert_allclose(np.asarray(x8), np.asarray(x_ref), atol=1e-9)
    x1, r1, k1 = HaloELLSolver(E, make_device_mesh(1)).solve(
        b, free, rtol=1e-11, maxiter=4000)
    assert int(k1) == int(k8)
    np.testing.assert_allclose(np.asarray(x8), np.asarray(x1), atol=1e-12)
