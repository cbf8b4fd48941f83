"""Matrix-free general FEM operator: element-local matrices + ELL combine.

The general (unstructured-topology) counterpart of the reference's assembled
SparseLU system (fem_linear_elliptic_solver.h:38-47) at sizes where the
matrix cannot be shipped from the host: the operator action

    y = A x  =  scatter( A_loc[c] @ x[dofs[c]] )

is evaluated element-locally with the scatter re-expressed as a gather
through a precomputed ELL incidence table (ops/ell.py). Every ingredient —
the local matrices, the adjacency build (one device argsort), and the SpMV —
runs on device, so a multi-million-dof problem never crosses to the
host.

The class satisfies the operator protocol of `fem/solvers.DirichletSystem`
(`@` and `diagonal()`), so Dirichlet masking, CG/BiCGStab and the
preconditioners (Jacobi, aux-grid) apply unchanged.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .ell import build_ell_adjacency, ell_spmv

# operators are built in full precision: an f32 contraction must not run
# in a reduced-precision matmul mode (e.g. TF32 on NVIDIA tensor cores)
_HIGHEST = jax.lax.Precision.HIGHEST

__all__ = ["MatrixFreeLocal", "p1_local_stiffness", "p1_local_stiffness_3d"]


def p1_local_stiffness(nodes, cells, kappa=None):
    """Batched P1 stiffness matrices (C, 3, 3) from device arrays.

    Closed-form physical gradients (adjugate of the affine map, matching
    simplex.h:184-195) contracted with the reference's -laplacian weak form
    sign convention (operators/laplacian.h:37-44: the leading minus lives in
    the leaf, so the assembled entries are +grad.grad). jit-traceable; the
    only gather is the (C, 3) coordinate lookup.

    kappa: optional per-cell scalar diffusivity (C,) — the piecewise-
    constant form of the reference's space-varying Diffusion coefficient
    (operators/diffusion.h:32-55) evaluated at cell centroids.
    """
    p = nodes[cells]  # (C, 3, 2)
    e0 = p[:, 1] - p[:, 0]
    e1 = p[:, 2] - p[:, 0]
    det = e0[:, 0] * e1[:, 1] - e0[:, 1] * e1[:, 0]
    inv_det = 1.0 / det
    # physical gradients of the three hat functions: g1 = invJ^T e_x, ...
    g1 = jnp.stack([e1[:, 1], -e1[:, 0]], axis=1) * inv_det[:, None]
    g2 = jnp.stack([-e0[:, 1], e0[:, 0]], axis=1) * inv_det[:, None]
    g0 = -(g1 + g2)
    g = jnp.stack([g0, g1, g2], axis=1)  # (C, 3, 2)
    area = 0.5 * jnp.abs(det)
    if kappa is not None:
        area = area * kappa
    return jnp.einsum("cin,cjn->cij", g, g, precision=_HIGHEST) * area[:, None, None]


def p1_local_stiffness_3d(nodes, cells, kappa=None):
    """Batched P1 tetrahedral stiffness matrices (C, 4, 4).

    Hat-function gradients in closed form (cross products of the edge
    vectors — the 3x3 adjugate of simplex.h:184-195's affine map):
    grad(lam_1) = (c x d)/det, cyclic, grad(lam_0) = -sum. Volume |det|/6.
    Sign convention as in p1_local_stiffness.
    """
    p = nodes[cells]  # (C, 4, 3)
    b = p[:, 1] - p[:, 0]
    c = p[:, 2] - p[:, 0]
    d = p[:, 3] - p[:, 0]

    def cross(u, v):
        return jnp.stack(
            [
                u[:, 1] * v[:, 2] - u[:, 2] * v[:, 1],
                u[:, 2] * v[:, 0] - u[:, 0] * v[:, 2],
                u[:, 0] * v[:, 1] - u[:, 1] * v[:, 0],
            ],
            axis=1,
        )

    cxd = cross(c, d)
    det = (b * cxd).sum(axis=1)
    inv_det = 1.0 / det
    g1 = cxd * inv_det[:, None]
    g2 = cross(d, b) * inv_det[:, None]
    g3 = cross(b, c) * inv_det[:, None]
    g0 = -(g1 + g2 + g3)
    g = jnp.stack([g0, g1, g2, g3], axis=1)  # (C, 4, 3)
    vol = jnp.abs(det) / 6.0
    if kappa is not None:
        vol = vol * kappa
    return jnp.einsum("cin,cjn->cij", g, g, precision=_HIGHEST) * vol[:, None, None]


@jax.tree_util.register_pytree_node_class
class MatrixFreeLocal:
    """y = A @ x from element-local matrices; jittable pytree operator.

    Fields: A_loc (C, nb, nb) local matrices, dofs (C, nb) int32 dof table,
    adj/adj_mask (n, K) the ELL incidence table of `dofs` (flat indices into
    the (C*nb,) element-local result vector and its validity mask).
    """

    def __init__(self, A_loc, dofs, adj, adj_mask, n_dofs: int):
        self.A_loc = A_loc
        self.dofs = dofs
        self.adj = adj
        self.adj_mask = adj_mask
        self.n_dofs = n_dofs

    def tree_flatten(self):
        return (self.A_loc, self.dofs, self.adj, self.adj_mask), (self.n_dofs,)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves, *aux)

    @classmethod
    def build(cls, A_loc, dofs, n_dofs: int, max_degree: int):
        """Device-side construction (one argsort + searchsorted).

        max_degree bounds the number of (cell, slot) incidences per dof
        (e.g. 8 for a 2D P1 node of a quad-split triangulation, 6 for the
        classic uniform split). Returns (operator, overflowed) where
        `overflowed` is a traced bool — True means some dof exceeded
        max_degree and the caller must rebuild with a larger bound.
        """
        dofs = jnp.asarray(dofs)
        adj, mask, overflowed = build_ell_adjacency(dofs, n_dofs, max_degree)
        return cls(jnp.asarray(A_loc), dofs, adj, mask, n_dofs), overflowed

    @property
    def shape(self):
        return (self.n_dofs, self.n_dofs)

    def __matmul__(self, x):
        return ell_spmv(self.A_loc, self.dofs, self.adj, self.adj_mask, x)

    def diagonal(self):
        """diag(A): the (c, i, i) local entries combined through the same
        ELL table (position cell*nb + slot holds that slot's diagonal)."""
        nb = self.A_loc.shape[1]
        k = jnp.arange(nb)
        dloc = self.A_loc[:, k, k].reshape(-1)  # (C*nb,)
        gathered = dloc[self.adj] * self.adj_mask.astype(dloc.dtype)
        return gathered.sum(axis=1)

    def astype(self, dtype):
        """Same adjacency, local matrices stored in `dtype` (e.g. an f32
        operator for the preconditioned inner iteration alongside an f64
        one for true residuals — the two share dofs/adj/adj_mask)."""
        return MatrixFreeLocal(
            self.A_loc.astype(dtype), self.dofs, self.adj, self.adj_mask,
            self.n_dofs,
        )
