"""Parity of the device-scale general operators (ops/matfree_soa.py) vs the
full host assembler (fem/assembler.py) — the fem_assembler.h:63-118
capability envelope on the gather pipeline: tensor diffusion, advection,
reaction, and P2, each as matrix-free SoA and assembled ELLSoA."""

import jax.numpy as jnp
import numpy as np
import pytest

from fdapde_core_tpu.fem.assembler import assemble_matrix
from fdapde_core_tpu.fem.solvers import DirichletSystem
from fdapde_core_tpu.fem.space import FEMSpace
from fdapde_core_tpu.linear_algebra.solvers import bicgstab, cg
from fdapde_core_tpu.ops.matfree_soa import (
    MatrixFreeP2SoA,
    MatrixFreeSoA,
)
from fdapde_core_tpu.pde.operators import (
    advection,
    diffusion,
    laplacian,
    reaction,
)

from tests.conftest import load_mesh

K_TENSOR = np.array([[2.0, 0.3], [0.3, 1.5]])
B_VEC = np.array([1.0, 0.5])
C_REACT = 0.7


@pytest.fixture(scope="module")
def mesh():
    return load_mesh("unit_square_16")


def _soa_arrays(mesh):
    x = jnp.asarray(mesh.nodes[:, 0])
    y = jnp.asarray(mesh.nodes[:, 1])
    c = jnp.asarray(mesh.cells.T.astype(np.int32))
    return x, y, c


def _assembled_action(space, op, v):
    A = assemble_matrix(space, op)
    return np.asarray(A @ jnp.asarray(v))


@pytest.mark.slow
def test_p1_general_matches_assembler(mesh):
    space = FEMSpace(mesh, order=1)
    x, y, c = _soa_arrays(mesh)
    C = mesh.n_cells
    op, over = MatrixFreeSoA.build_general(
        x, y, c[0], c[1], c[2], space.n_dofs, 8,
        kxx=jnp.full((C,), K_TENSOR[0, 0]),
        kxy=jnp.full((C,), K_TENSOR[0, 1]),
        kyy=jnp.full((C,), K_TENSOR[1, 1]),
        bx=jnp.full((C,), B_VEC[0]),
        by=jnp.full((C,), B_VEC[1]),
        react=jnp.full((C,), C_REACT),
    )
    assert not bool(over)
    L = -diffusion(K_TENSOR) + advection(B_VEC) + reaction(C_REACT)
    rng = np.random.default_rng(0)
    v = rng.standard_normal(space.n_dofs)
    ref = _assembled_action(space, L, v)
    got = np.asarray(op @ jnp.asarray(v))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)

    # assembled ELL of the same operator
    E, overc = op.to_ell(9)
    assert not bool(overc)
    np.testing.assert_allclose(
        np.asarray(E @ jnp.asarray(v)), ref, rtol=1e-12, atol=1e-12
    )
    # diagonals
    A = assemble_matrix(space, L)
    np.testing.assert_allclose(
        np.asarray(op.diagonal()), np.asarray(A.diagonal()),
        rtol=1e-12, atol=1e-12,
    )


def test_p1_isotropic_kappa_equivalence(mesh):
    """build_general(kxx=kappa) == build(kappa) (scalar-diffusivity path)."""
    space = FEMSpace(mesh, order=1)
    x, y, c = _soa_arrays(mesh)
    C = mesh.n_cells
    kap = jnp.asarray(1.0 + 0.5 * np.random.default_rng(1).random(C))
    op_g, _ = MatrixFreeSoA.build_general(
        x, y, c[0], c[1], c[2], space.n_dofs, 8, kxx=kap
    )
    op_k, _ = MatrixFreeSoA.build(
        x, y, c[0], c[1], c[2], space.n_dofs, 8, kappa=kap
    )
    v = jnp.asarray(np.random.default_rng(2).standard_normal(space.n_dofs))
    np.testing.assert_allclose(
        np.asarray(op_g @ v), np.asarray(op_k @ v), rtol=1e-13, atol=1e-13
    )


def test_p2_diffusion_matches_assembler(mesh):
    space = FEMSpace(mesh, order=2)
    x, y, _ = _soa_arrays(mesh)
    dofs = jnp.asarray(space.dofs.T)  # (6, C)
    C = mesh.n_cells
    op, over = MatrixFreeP2SoA.build(
        x, y, dofs, space.n_dofs, 8,
        kxx=jnp.full((C,), K_TENSOR[0, 0]),
        kxy=jnp.full((C,), K_TENSOR[0, 1]),
        kyy=jnp.full((C,), K_TENSOR[1, 1]),
    )
    assert not bool(over)
    rng = np.random.default_rng(3)
    v = rng.standard_normal(space.n_dofs)
    ref = _assembled_action(space, -diffusion(K_TENSOR), v)
    got = np.asarray(op @ jnp.asarray(v))
    np.testing.assert_allclose(got, ref, rtol=1e-11, atol=1e-12)


@pytest.mark.slow
def test_p2_full_operator_matches_assembler(mesh):
    space = FEMSpace(mesh, order=2)
    x, y, _ = _soa_arrays(mesh)
    dofs = jnp.asarray(space.dofs.T)
    C = mesh.n_cells
    op, over = MatrixFreeP2SoA.build(
        x, y, dofs, space.n_dofs, 8,
        kxx=jnp.full((C,), 1.0),
        bx=jnp.full((C,), B_VEC[0]),
        by=jnp.full((C,), B_VEC[1]),
        react=jnp.full((C,), C_REACT),
    )
    assert not bool(over)
    L = -laplacian() + advection(B_VEC) + reaction(C_REACT)
    rng = np.random.default_rng(4)
    v = rng.standard_normal(space.n_dofs)
    ref = _assembled_action(space, L, v)
    np.testing.assert_allclose(
        np.asarray(op @ jnp.asarray(v)), ref, rtol=1e-11, atol=1e-12
    )
    A = assemble_matrix(space, L)
    np.testing.assert_allclose(
        np.asarray(op.diagonal()), np.asarray(A.diagonal()),
        rtol=1e-11, atol=1e-12,
    )
    # assembled P2 ELL: vertex rows reach 1 + deg + 2*deg columns
    E, overc = op.to_ell(25)
    assert not bool(overc)
    np.testing.assert_allclose(
        np.asarray(E @ jnp.asarray(v)), ref, rtol=1e-11, atol=1e-12
    )


def test_advection_diffusion_bicgstab_device_solve(mesh):
    """Non-symmetric device solve (BiCGStab on the gather operator) against
    the manufactured solution u = x + y with -lap u + b.grad u = bx + by."""
    space = FEMSpace(mesh, order=1)
    x, y, c = _soa_arrays(mesh)
    C = mesh.n_cells
    op, _ = MatrixFreeSoA.build_general(
        x, y, c[0], c[1], c[2], space.n_dofs, 8,
        kxx=jnp.full((C,), 1.0),
        bx=jnp.full((C,), B_VEC[0]),
        by=jnp.full((C,), B_VEC[1]),
    )
    bnd = jnp.asarray(space.boundary_dofs)
    g = x + y
    sys_ = DirichletSystem(op, bnd)
    # forcing f = b . grad u (constant): P1 load vector rides the assembler
    from fdapde_core_tpu.fem.assembler import assemble_forcing

    f = float(B_VEC.sum())
    b_vec = jnp.asarray(assemble_forcing(space, lambda p: f))
    b_mod = sys_.rhs(b_vec, g)
    xh, info = bicgstab(sys_, b_mod, rtol=1e-12, maxiter=500)
    err = np.asarray(xh - g)
    assert np.max(np.abs(err)) < 1e-9


def test_sym_general_reaction_cg_spd(mesh):
    """Diffusion + reaction (no advection) stays SPD: CG converges."""
    space = FEMSpace(mesh, order=1)
    x, y, c = _soa_arrays(mesh)
    C = mesh.n_cells
    op, _ = MatrixFreeSoA.build_general(
        x, y, c[0], c[1], c[2], space.n_dofs, 8,
        kxx=jnp.full((C,), 1.0), react=jnp.full((C,), 1.0),
    )
    bnd = jnp.asarray(space.boundary_dofs)
    sys_ = DirichletSystem(op, bnd)
    b = jnp.where(bnd, 0.0, 1.0)
    xh, info = cg(sys_, b, rtol=1e-12, maxiter=2000)
    res = np.asarray(b - sys_(xh) )
    bn = float(jnp.linalg.norm(b))
    assert float(np.linalg.norm(res)) / bn < 1e-10


@pytest.mark.slow
def test_matrixfree_elliptic_model_p1_advection(mesh):
    """Product API: non-symmetric device solve vs manufactured u = x + y."""
    from fdapde_core_tpu.models import MatrixFreeElliptic

    nodes = jnp.asarray(mesh.nodes)
    cells = jnp.asarray(mesh.cells.astype(np.int32))
    bnd = jnp.asarray(mesh.boundary_node_markers())
    m = MatrixFreeElliptic(nodes, cells, bnd, K=1.0, b=tuple(B_VEC))
    g = nodes[:, 0] + nodes[:, 1]
    C = mesh.n_cells
    f = m.load_vector(jnp.full((C,), float(B_VEC.sum())))
    xh, iters, rel = m.solve(f, g=g, rtol=1e-12, maxiter=400)
    assert float(rel) < 1e-10
    np.testing.assert_allclose(np.asarray(xh), np.asarray(g), atol=1e-8)


@pytest.mark.slow
def test_matrixfree_elliptic_model_p2(mesh):
    """P2 from_space: symmetric reaction-diffusion solve parity vs the host
    assembled path on u = x + y (-lap u + u = x + y manufactured)."""
    from fdapde_core_tpu.models import MatrixFreeElliptic
    from fdapde_core_tpu.fem.assembler import assemble_forcing

    space = FEMSpace(mesh, order=2)
    m = MatrixFreeElliptic.from_space(space, K=1.0, c=1.0)
    g = m.dof_x + m.dof_y
    # forcing f = u (since -lap u = 0): exact quadrature via the host path
    b = jnp.asarray(assemble_forcing(space, lambda p: p[..., 0] + p[..., 1]))
    xh, iters, rel = m.solve(b, g=g, rtol=1e-12, maxiter=400)
    assert float(rel) < 1e-10
    # u = x + y is in the P2 space and the forcing is exact -> near-exact
    np.testing.assert_allclose(np.asarray(xh), np.asarray(g), atol=1e-7)


@pytest.mark.slow
def test_model_chunked_solve_identical():
    """chunk= splits the model solve into bounded device programs with
    bit-identical iterates (CG for symmetric, BiCGStab otherwise)."""
    import jax.numpy as jnp

    from fdapde_core_tpu.geometry.structured import irregular_mesh_device
    from fdapde_core_tpu.models.matfree import (
        MatrixFreeElliptic,
        MatrixFreePoisson,
    )

    nodes, cells, bnd = irregular_mesh_device(16, 0.2, dtype=jnp.float64)
    # auxgrid: enough iterations that chunk=5 actually crosses chunks
    # (the banded-MG auto path converges in ~2)
    m = MatrixFreePoisson(nodes, cells, bnd, preconditioner="auxgrid")
    b = m.load_vector(jnp.ones(cells.shape[0], jnp.float64))
    x, it, rel = m.solve(b, rtol=1e-10, maxiter=200)
    seen = []
    xc, itc, relc = m.solve(b, rtol=1e-10, maxiter=200, chunk=5,
                            on_chunk=lambda k, r: seen.append((k, r)))
    assert int(it) == int(itc) and len(seen) >= 2
    assert float(jnp.max(jnp.abs(x - xc))) == 0.0

    e = MatrixFreeElliptic((nodes[:, 0], nodes[:, 1]), cells, bnd,
                           b=(1.0, 0.5), c=0.3)
    be = e.load_vector(jnp.ones(cells.shape[0], jnp.float64))
    x2, it2, rel2 = e.solve(be, rtol=1e-10, maxiter=300)
    xc2, itc2, relc2 = e.solve(be, rtol=1e-10, maxiter=300, chunk=7)
    assert int(it2) == int(itc2)
    assert float(jnp.max(jnp.abs(x2 - xc2))) == 0.0


@pytest.mark.slow
def test_auto_banded_upgrade_matches_auxgrid():
    """preconditioner='auto' detects the band-concentrated operator and
    swaps in the DIA-split + BandedMG pair; solutions match the aux-grid
    path, incl. nonzero Dirichlet data through the rhs reduction (the
    operator stays UNFOLDED so -A@g boundary coupling survives)."""
    import jax
    import jax.numpy as jnp

    from fdapde_core_tpu.geometry.structured import irregular_mesh_device
    from fdapde_core_tpu.models.matfree import MatrixFreePoisson

    nodes, cells, bnd = jax.jit(
        lambda a: irregular_mesh_device(20, a, dtype=jnp.float64)
    )(0.2)
    m_auto = MatrixFreePoisson(nodes, cells, bnd)
    m_aux = MatrixFreePoisson(nodes, cells, bnd, preconditioner="auxgrid")
    assert m_auto.preconditioner == "banded_mg"
    assert m_aux.preconditioner == "auxgrid"

    b = m_aux.load_vector(jnp.ones(cells.shape[0], jnp.float64))
    x1, i1, r1 = m_auto.solve(b, rtol=1e-10, maxiter=200)
    x2, i2, r2 = m_aux.solve(b, rtol=1e-10, maxiter=200)
    assert int(i1) <= int(i2)
    np.testing.assert_allclose(np.asarray(x1), np.asarray(x2), atol=1e-9)

    g = jnp.asarray(nodes[:, 0] + nodes[:, 1])  # harmonic: u == g
    x3, i3, r3 = m_auto.solve(jnp.zeros_like(b), g=g, rtol=1e-10,
                              maxiter=200)
    np.testing.assert_allclose(np.asarray(x3), np.asarray(g), atol=1e-9)


@pytest.mark.slow
def test_matrixfree_parabolic_matches_host_lumped():
    """Device-scale implicit-Euler stepping (MatrixFreeParabolic, banded
    auto path) reproduces the host solve_parabolic(lumped=True) trajectory
    on the same mesh."""
    import jax
    import jax.numpy as jnp

    from fdapde_core_tpu.fem.assembler import assemble_matrix
    from fdapde_core_tpu.fem.solvers import solve_parabolic
    from fdapde_core_tpu.fem.space import FEMSpace
    from fdapde_core_tpu.geometry.structured import irregular_mesh_device
    from fdapde_core_tpu.geometry.triangulation import Triangulation
    from fdapde_core_tpu.models.matfree import MatrixFreeParabolic
    from fdapde_core_tpu.pde.operators import laplacian, reaction

    n = 12
    nodes, cells, bnd = jax.jit(
        lambda a: irregular_mesh_device(n, a, dtype=jnp.float64)
    )(0.2)
    dt = 0.01
    mp = MatrixFreeParabolic(nodes, cells, bnd, dt)
    assert mp.preconditioner == "banded_mg"
    u0 = jnp.sin(np.pi * nodes[:, 0]) * jnp.sin(np.pi * nodes[:, 1])
    u, info = mp.solve(u0, n_steps=4, rtol=1e-11, maxiter=200)
    assert max(info["rel_residuals"]) < 1e-10

    mesh = Triangulation(np.asarray(nodes), np.asarray(cells),
                         np.asarray(bnd))
    space = FEMSpace(mesh, 1)
    A = assemble_matrix(space, -laplacian())
    M = assemble_matrix(space, reaction(1.0))
    times = np.arange(5) * dt
    F = jnp.zeros((space.n_dofs, 5))
    G = jnp.zeros((space.n_dofs, 5))
    us = solve_parabolic(A, M, F, jnp.asarray(bnd), G, u0, times,
                         rtol=1e-11, lumped=True)
    np.testing.assert_allclose(np.asarray(u), np.asarray(us[:, -1]),
                               atol=1e-10)

    # chunked stepping is identical
    uc, infoc = mp.solve(u0, n_steps=4, rtol=1e-11, maxiter=200, chunk=5)
    np.testing.assert_array_equal(np.asarray(u), np.asarray(uc))


@pytest.mark.slow
def test_matfree_elliptic_3d():
    """3D general elliptic model on a jittered tet mesh: a linear
    manufactured solution of the pure advection-diffusion operator is
    reproduced exactly (P1 contains it and centroid sampling is exact for
    constant coefficients); with reaction, solve vs a scipy reference."""
    import jax
    import numpy as np
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    from fdapde_core_tpu.geometry.structured import cube_mesh_device
    from fdapde_core_tpu.models.matfree import MatrixFreeElliptic

    n = 6
    nodes, cells, bnd = jax.jit(
        lambda a: cube_mesh_device(n, a, dtype=jnp.float64)
    )(0.2)
    model = MatrixFreeElliptic(
        nodes, cells, bnd,
        K=(1.3, 0.2, -0.1, 0.9, 0.15, 1.1), b=(0.8, -0.4, 0.3), c=0.5,
        grid_n=n,
    )
    assert model.dim == 3 and not model.is_symmetric

    # reference dense solve of the SAME operator (entries from the op)
    nd = model.n_dofs
    ent = model.system  # DirichletSystem
    A = np.zeros((nd, nd))
    eye = np.eye(nd)
    for k0 in range(0, nd, 64):  # apply to basis blocks
        blk = jnp.asarray(eye[:, k0:k0 + 64])
        cols = np.stack([np.asarray(ent(blk[:, j]))
                         for j in range(blk.shape[1])], axis=1)
        A[:, k0:k0 + 64] = cols
    rng = np.random.default_rng(5)
    f = rng.standard_normal(cells.shape[0])
    b_load = model.load_vector(jnp.asarray(f))
    bnd_np = np.asarray(bnd)
    b_mod = np.where(bnd_np, 0.0, np.asarray(b_load))
    x_ref = spla.spsolve(sp.csr_matrix(A), b_mod)
    x, it, rel = model.solve(b_load, rtol=1e-11, maxiter=400)
    assert float(rel) < 1e-10
    np.testing.assert_allclose(np.asarray(x), x_ref, atol=1e-8)


@pytest.mark.slow
def test_matfree_parabolic_3d():
    """Implicit-Euler stepping on a 3D tet mesh through the SoA base:
    zero forcing with harmonic Dirichlet data relaxes to the harmonic
    steady state (u = x + 2y - z is in P1, exact at convergence)."""
    import jax

    from fdapde_core_tpu.geometry.structured import cube_mesh_device
    from fdapde_core_tpu.models.matfree import MatrixFreeParabolic

    n = 6
    nodes, cells, bnd = jax.jit(
        lambda a: cube_mesh_device(n, a, dtype=jnp.float64)
    )(0.2)
    g = nodes[:, 0] + 2 * nodes[:, 1] - nodes[:, 2]
    mp = MatrixFreeParabolic(nodes, cells, bnd, dt=0.5, grid_n=n)
    u = jnp.where(bnd, g, 0.0)
    u, info = mp.solve(u, 40, g=g, rtol=1e-11, maxiter=200)
    assert max(info["rel_residuals"]) < 1e-10
    err = float(jnp.max(jnp.abs(u - g)))
    assert err < 5e-3  # 40 steps at dt=0.5: relaxed to the steady state


@pytest.mark.parametrize("n, S, G", [(20, 64, 13), (32, 128, 45)])
def test_scrambled_ell_auxgrid_solve_matches_dense(n, S, G):
    """General path on a block-scrambled numbering (the banded split plan
    rejects it): the assembled ELL SpMV equals the matrix-free apply, and
    the aux-grid preconditioned CG of MatrixFreeElliptic converges to the
    dense f64 solution of the same Dirichlet system."""
    import chip_smoke
    from fdapde_core_tpu.models.matfree import MatrixFreeElliptic

    x, y, c0, c1, c2, bnd = chip_smoke.scrambled_mesh(n, S=S, G=G)
    nd = (n + 1) ** 2
    model = MatrixFreeElliptic((x, y), jnp.stack([c0, c1, c2], axis=1), bnd,
                               format="ell")
    assert model.preconditioner == "auxgrid"

    mf, over = MatrixFreeSoA.build(x, y, c0, c1, c2, nd, 8)
    assert not bool(over)
    v = jnp.asarray(np.random.default_rng(n).normal(size=nd))
    np.testing.assert_allclose(np.asarray(model.op @ v), np.asarray(mf @ v),
                               rtol=0, atol=1e-12)

    b = jnp.where(bnd, 0.0, 1.0) / (n * n)
    u, it, rel = model.solve(b, rtol=1e-11, maxiter=200)
    assert float(rel) <= 1e-11 and int(it) < 200

    # dense reference: A with Dirichlet rows/cols replaced by identity
    import jax

    A = np.asarray(jax.vmap(lambda e: mf @ e)(jnp.eye(nd))).T
    free = ~np.asarray(bnd)
    Ad = np.where(free[:, None] & free[None, :], A, 0.0) + np.diag(~free * 1.0)
    u_ref = np.linalg.solve(Ad, np.where(free, np.asarray(b), 0.0))
    np.testing.assert_allclose(np.asarray(u), u_ref, rtol=0,
                               atol=1e-9 * np.abs(u_ref).max())
