"""Tests for the scatter-free ELL SpMV against the sparse reference path."""

import jax.numpy as jnp
import pytest
import numpy as np

import fdapde_core_tpu as fdm
from fdapde_core_tpu.fem import FEMSpace, assemble_matrix
from fdapde_core_tpu.fem.assembler import local_matrices
from fdapde_core_tpu.geometry.structured import unit_square_mesh
from fdapde_core_tpu.ops import build_ell_adjacency, ell_spmv


@pytest.mark.slow
def test_ell_spmv_matches_sparse():
    mesh = unit_square_mesh(12)
    space = FEMSpace(mesh, 1)
    A = assemble_matrix(space, -fdm.laplacian())

    from fdapde_core_tpu.geometry.affine import affine_maps

    _, invJ, measure = affine_maps(
        jnp.asarray(mesh.nodes), jnp.asarray(mesh.cells)
    )
    # -laplacian: negate the raw weak form (operators/laplacian.h:37-44 has
    # the leading minus inside; the operator expression contributes the -1)
    A_loc = -local_matrices(
        "laplacian", None, False,
        jnp.asarray(space.phi_tab), jnp.asarray(space.grad_tab),
        jnp.asarray(space.quad.weights), invJ, measure,
    )
    dofs = jnp.asarray(space.dofs)
    adj, mask, overflow = build_ell_adjacency(dofs, space.n_dofs, 16)
    assert not bool(overflow)

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=space.n_dofs))
    np.testing.assert_allclose(
        np.asarray(ell_spmv(A_loc, dofs, adj, mask, x)),
        np.asarray(A @ x),
        atol=1e-12,
    )


def test_ell_overflow_detection():
    mesh = unit_square_mesh(4)
    space = FEMSpace(mesh, 1)
    dofs = jnp.asarray(space.dofs)
    _, _, overflow = build_ell_adjacency(dofs, space.n_dofs, 2)
    assert bool(overflow)


@pytest.mark.slow
def test_soa_assembly_matches_aos():
    """C-last assembly equals the standard path for a composed operator."""
    from fdapde_core_tpu.ops.soa_assembly import assemble_soa_values
    from fdapde_core_tpu.linear_algebra.sparse import SparseMatrix

    mesh = unit_square_mesh(10)
    for order in (1, 2):
        space = FEMSpace(mesh, order)
        op = -fdm.laplacian() + fdm.advection(np.array([1.5, -0.5])) + fdm.reaction(2.0)
        A = assemble_matrix(space, op)
        vals = assemble_soa_values(space, op)
        rows, cols, _ = space.scatter
        B = SparseMatrix(jnp.asarray(rows), jnp.asarray(cols), vals, A.shape)
        assert np.abs(A.toarray() - B.toarray()).max() < 1e-12


def test_soa_assembly_diffusion_tensor():
    from fdapde_core_tpu.ops.soa_assembly import assemble_soa_values
    from fdapde_core_tpu.linear_algebra.sparse import SparseMatrix

    mesh = unit_square_mesh(8)
    space = FEMSpace(mesh, 1)
    K = np.array([[2.0, 0.5], [0.5, 1.0]])
    op = -fdm.diffusion(K)
    A = assemble_matrix(space, op)
    vals = assemble_soa_values(space, op)
    rows, cols, _ = space.scatter
    B = SparseMatrix(jnp.asarray(rows), jnp.asarray(cols), vals, A.shape)
    assert np.abs(A.toarray() - B.toarray()).max() < 1e-12


def test_grid_dia_matches_flat_dia():
    from fdapde_core_tpu.linear_algebra.dia import dia_from_coo, unique_offsets
    from fdapde_core_tpu.ops.grid_dia import GridDIAMatrix

    mesh = unit_square_mesh(12)
    space = FEMSpace(mesh, 1)
    A = assemble_matrix(space, -fdm.laplacian())
    offs = unique_offsets(space.dofs)
    D = dia_from_coo(A.rows, A.cols, A.vals, space.n_dofs, offs)
    G = GridDIAMatrix.from_dia(D, (13, 13))
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=space.n_dofs))
    np.testing.assert_allclose(np.asarray(G @ x), np.asarray(D @ x), atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(G.diagonal()), np.asarray(D.diagonal()), atol=1e-14
    )


def test_soa_assembly_space_varying_and_manifold(surface):
    """SoA path: space-varying coefficients and 2.5D manifold meshes match
    the standard path."""
    # space-varying composed operator on a 2D mesh
    mesh = unit_square_mesh(8)
    space = FEMSpace(mesh, 1)
    K = lambda x: (1 + x[0] ** 2) * np.eye(2)
    b = lambda x: np.array([x[1], -x[0]])
    c = lambda x: 1.0 + x[0] * x[1]
    op = -fdm.diffusion(K) + fdm.advection(b) + fdm.reaction(c)
    A = assemble_matrix(space, op)
    B = assemble_matrix(space, op, layout="soa")
    assert np.abs(A.toarray() - B.toarray()).max() < 1e-12

    # Laplace-Beltrami stiffness on the 2.5D surface fixture
    sspace = FEMSpace(surface, 1)
    As = assemble_matrix(sspace, -fdm.laplacian())
    Bs = assemble_matrix(sspace, -fdm.laplacian(), layout="soa")
    assert np.abs(As.toarray() - Bs.toarray()).max() < 1e-12


def test_closed_form_sym_matches_einsum():
    """XLA closed-form packed-symmetric kernel == quadrature einsum path."""
    from fdapde_core_tpu.geometry.affine import affine_maps
    from fdapde_core_tpu.ops.closed_form import (
        SYM_TO_FULL,
        p1_stiffness_2d_sym,
        pack_cell_axis,
    )

    mesh = unit_square_mesh(16)
    space = FEMSpace(mesh, 1)
    _, invJ, measure = affine_maps(
        jnp.asarray(mesh.nodes), jnp.asarray(mesh.cells)
    )
    ref = -local_matrices(
        "laplacian", None, False,
        jnp.asarray(space.phi_tab), jnp.asarray(space.grad_tab),
        jnp.asarray(space.quad.weights), invJ, measure,
    )
    coords = mesh.nodes[mesh.cells].reshape(mesh.n_cells, 6).T  # (6, C)
    C = mesh.n_cells
    pad = (-C) % 128
    fill = np.tile(coords[:, :1], (1, pad)) + np.array(
        [[0], [0], [1], [0], [0], [1]]
    )
    coords = np.concatenate([coords, fill], axis=1)
    out6 = p1_stiffness_2d_sym(pack_cell_axis(jnp.asarray(coords)))
    flat = np.asarray(out6).reshape(6, -1)[:, :C]
    got = flat[list(SYM_TO_FULL)].T.reshape(C, 3, 3)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-12, atol=1e-13)


def test_grid_cg_padded_and_pruning():
    """Padded-state grid CG == reference CG solution; pruning + Dirichlet
    identity fold preserve the operator."""
    from fdapde_core_tpu.linear_algebra.dia import dia_from_coo, unique_offsets
    from fdapde_core_tpu.ops.grid_cg import grid_cg
    from fdapde_core_tpu.ops.grid_dia import (
        GridDIAMatrix,
        prune_zero_offsets_grid,
    )

    mesh = unit_square_mesh(16)
    space = FEMSpace(mesh, 1)
    A = assemble_matrix(space, -fdm.laplacian())
    offs = unique_offsets(space.dofs)
    D = dia_from_coo(A.rows, A.cols, A.vals, space.n_dofs, offs)
    G = GridDIAMatrix.from_dia(D, (17, 17))

    free = jnp.asarray(~mesh.boundary_nodes, jnp.float64)
    Gm = G.with_dirichlet_identity(free)
    # identity fold == with_dirichlet + (1-free) on the diagonal
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.normal(size=space.n_dofs))
    ref_mv = np.asarray(G.with_dirichlet(free) @ x) + np.asarray(
        (1 - free) * x
    )
    np.testing.assert_allclose(np.asarray(Gm @ x), ref_mv, atol=1e-13)

    # pruning drops the exact-zero hypotenuse layers and preserves matvecs
    Gp = prune_zero_offsets_grid(Gm)
    assert len(Gp.offsets2d) < len(Gm.offsets2d)
    np.testing.assert_allclose(np.asarray(Gp @ x), ref_mv, atol=1e-13)

    # padded-state CG solves the Dirichlet problem
    b = jnp.asarray(free)  # f = 1 on interior, u = 0 on boundary
    xs, res = grid_cg(Gp, b, 400)
    assert float(res) < 1e-10
    # against a dense solve
    import numpy.linalg as npl

    dense = np.asarray(Gp.data)
    n = space.n_dofs
    M = np.zeros((n, n))
    mx, my = Gp.shape2d
    for k, (di, dj) in enumerate(Gp.offsets2d):
        for i in range(mx):
            for j in range(my):
                ii, jj = i + di, j + dj
                if 0 <= ii < mx and 0 <= jj < my:
                    M[i * my + j, ii * my + jj] = dense[k, i, j]
    ref = npl.solve(M, np.asarray(b))
    np.testing.assert_allclose(np.asarray(xs), ref, atol=1e-8)


def test_dia_prune_zero_offsets():
    from fdapde_core_tpu.linear_algebra.dia import (
        DIAMatrix,
        prune_zero_offsets,
    )

    data = jnp.asarray(
        [[0.0, 0.0, 0.0], [1.0, 2.0, 3.0], [4.0, 5.0, 0.0]]
    )
    D = DIAMatrix(data, (-1, 0, 1), 3)
    P = prune_zero_offsets(D)
    assert P.offsets == (0, 1)
    x = jnp.asarray([1.0, 2.0, 3.0])
    np.testing.assert_allclose(np.asarray(P @ x), np.asarray(D @ x))


def test_p1_grid_stencil_matches_dia_from_coo():
    """Scatter-free structured stencil conversion == generic segment-sum DIA."""
    from fdapde_core_tpu.geometry.affine import affine_maps
    from fdapde_core_tpu.linear_algebra.dia import dia_from_coo, unique_offsets
    from fdapde_core_tpu.ops.closed_form import p1_stiffness_2d_sym
    from fdapde_core_tpu.ops.grid_assembly import p1_grid_stencil
    from fdapde_core_tpu.ops.grid_dia import GridDIAMatrix

    n = 12
    mesh = unit_square_mesh(n)
    space = FEMSpace(mesh, 1)
    A = assemble_matrix(space, -fdm.laplacian())
    offs = unique_offsets(space.dofs)
    D = dia_from_coo(A.rows, A.cols, A.vals, space.n_dofs, offs)
    G_ref = GridDIAMatrix.from_dia(D, (n + 1, n + 1))

    coords = mesh.nodes[mesh.cells].reshape(mesh.n_cells, 6).T  # (6, C)
    A6 = p1_stiffness_2d_sym(jnp.asarray(coords))
    G = p1_grid_stencil(A6, n)

    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.normal(size=space.n_dofs))
    np.testing.assert_allclose(
        np.asarray(G @ x), np.asarray(G_ref @ x), atol=1e-12
    )
    # layer-by-layer equality (align offset orderings)
    for k, o in enumerate(G.offsets2d):
        kr = G_ref.offsets2d.index(o)
        np.testing.assert_allclose(
            np.asarray(G.data[k]), np.asarray(G_ref.data[kr]), atol=1e-13
        )


def test_grid_cg_refined_mixed_precision():
    """bf16-inner iterative refinement reaches f32-grade residuals.

    The inner CG runs every vector in bfloat16 (half the HBM traffic of
    the f32 body); the outer loop recomputes the residual in f32 and
    accumulates corrections there, so bf16's 8-bit mantissa only limits
    per-cycle progress, not the attainable accuracy."""
    from fdapde_core_tpu.linear_algebra.dia import dia_from_coo, unique_offsets
    from fdapde_core_tpu.ops.grid_cg import grid_cg, grid_cg_refined
    from fdapde_core_tpu.ops.grid_dia import (
        GridDIAMatrix,
        prune_zero_offsets_grid,
    )

    mesh = unit_square_mesh(16)
    space = FEMSpace(mesh, 1)
    A = assemble_matrix(space, -fdm.laplacian())
    offs = unique_offsets(space.dofs)
    D = dia_from_coo(A.rows, A.cols, A.vals, space.n_dofs, offs)
    G = GridDIAMatrix.from_dia(D, (17, 17))
    free = jnp.asarray(~mesh.boundary_nodes, jnp.float64)
    Gp = prune_zero_offsets_grid(G.with_dirichlet_identity(free))

    b = jnp.asarray(free)
    x_ref, res_ref = grid_cg(Gp, b, 400)
    x_mix, res_mix = grid_cg_refined(Gp, b, n_outer=10, n_inner=40)
    assert float(res_mix) < 1e-5 * float(jnp.linalg.norm(b))
    np.testing.assert_allclose(
        np.asarray(x_mix), np.asarray(x_ref), atol=5e-5
    )


def _criss_cross(n, amp, seed, pad_to=None):
    """Node coordinate planes of the criss-cross n x n grid, interior nodes
    displaced by up to +-amp/2 cells, padded with junk to pad_to columns
    and n + 8 rows (extra rows and columns must be ignored)."""
    m = n + 1
    rng = np.random.default_rng(seed)
    gi, gj = np.meshgrid(np.arange(m), np.arange(m), indexing="ij")
    nodes2d = np.stack([gi.astype(np.float64), gj.astype(np.float64)], -1)
    interior = (gi > 0) & (gi < n) & (gj > 0) & (gj < n)
    nodes2d[interior] += rng.uniform(-amp / 2, amp / 2,
                                     size=(interior.sum(), 2))
    nodes2d /= n
    W = pad_to or m
    X = np.full((n + 8, W), 3.0)
    Y = np.full((n + 8, W), 3.0)
    X[:m, :m] = nodes2d[..., 0]
    Y[:m, :m] = nodes2d[..., 1]
    return nodes2d, X, Y


def test_stencil_from_coords_matches_full_path():
    """Coords->stencil assembly == closed-form packed local matrices +
    slice-add conversion, perturbed geometry (the structured case hides
    anti-diagonal bugs: its hypotenuse coupling is exactly zero)."""
    from fdapde_core_tpu.ops.closed_form import p1_stiffness_2d_sym
    from fdapde_core_tpu.ops.grid_assembly import (
        p1_grid_stencil,
        stencil_from_coords,
    )

    n = 16
    mref = n + 1
    nodes2d, X, Y = _criss_cross(n, 0.24, 13, pad_to=128)
    G_new = stencil_from_coords(jnp.asarray(X), jnp.asarray(Y), n)

    # type-A cells first, then type-B (the p1_grid_stencil convention)
    ij = np.arange(n * n)
    a = (ij // n) * mref + ij % n
    b = a + mref
    cells = np.concatenate(
        [np.stack([a, b, a + 1], 1), np.stack([b, b + 1, a + 1], 1)], axis=0
    )
    coords = nodes2d.reshape(-1, 2)[cells].reshape(-1, 6).T  # (6, C)
    G_ref = p1_grid_stencil(p1_stiffness_2d_sym(jnp.asarray(coords)), n)

    assert G_new.offsets2d == G_ref.offsets2d
    np.testing.assert_allclose(
        np.asarray(G_new.data), np.asarray(G_ref.data), rtol=0, atol=1e-12
    )
    k = G_ref.offsets2d.index((-1, 1))
    assert float(np.abs(np.asarray(G_ref.data[k])).max()) > 1e-3


@pytest.mark.parametrize(
    "n, amp, pad_to",
    [(4, 0.0, None), (12, 0.2, None), (12, 0.2, 128), (31, 0.1, 128),
     (40, 0.2, None)],
)
def test_stencil_from_coords_matches_coo_assembler(n, amp, pad_to):
    """Coords->stencil operator == the fem/ COO assembler on the same
    triangulation, for plain and perturbed geometry and for coordinate
    planes padded to lane-aligned widths (extra columns ignored)."""
    from fdapde_core_tpu.geometry.triangulation import Triangulation
    from fdapde_core_tpu.ops.grid_assembly import stencil_from_coords

    nodes2d, X, Y = _criss_cross(n, amp, n, pad_to=pad_to)
    base = unit_square_mesh(n)  # node (i, j) = i*(n+1) + j, same cells
    mesh = Triangulation(nodes2d.reshape(-1, 2), base.cells,
                         base.boundary_nodes)
    A = assemble_matrix(FEMSpace(mesh, 1), -fdm.laplacian())
    G = stencil_from_coords(jnp.asarray(X), jnp.asarray(Y), n)
    assert G.data.shape == (7, n + 1, n + 1)
    v = jnp.asarray(np.random.default_rng(1).normal(size=(n + 1) ** 2))
    np.testing.assert_allclose(np.asarray(G @ v), np.asarray(A @ v),
                               rtol=0, atol=1e-12 * n * n)
