"""Spline assembly: weighted Gram matmuls over all Gauss points.

Counterpart of /root/reference/fdaPDE/splines/spline_assembler.h:30-79. The
reference loops basis pairs (i, j) and integrates the weak form span-by-span
over the support intersection; summing Gauss-Legendre contributions over ALL
spans gives identical values (the integrand vanishes outside the support),
and becomes two dense matmuls

    A = B_i^T diag(w) B_j

with B the (n_gauss_total, n_basis) basis (or derivative) tabulation — an
matmul-shaped contraction instead of a nested scalar loop.

Weak forms:
- Reaction<SPLINE>: c * psi_i * psi_j            (splines/operators/reaction.h:31-53)
- BiLaplacian<SPLINE>: -psi_i'' * psi_j''        (splines/operators/bilaplacian.h:30-41)
- dt: zero spatial contribution (parabolic trait only)
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..linear_algebra.sparse import SparseMatrix
from ..pde.operators import BiLaplacian, Dt, Reaction

__all__ = ["assemble_operator", "assemble_mass", "assemble_forcing"]


def _gram(space, di: int, dj: int, weight=None) -> np.ndarray:
    Bi = space.basis.eval(space.quad_points, deriv=di)
    Bj = Bi if dj == di else space.basis.eval(space.quad_points, deriv=dj)
    w = space.quad_weights if weight is None else space.quad_weights * weight
    return jnp.asarray(Bi).T @ (jnp.asarray(w)[:, None] * jnp.asarray(Bj))


def assemble_operator(space, op) -> SparseMatrix:
    """Discretize a DifferentialOp in the spline basis -> sparse matrix."""
    n = space.n_dofs
    acc = jnp.zeros((n, n))
    for scale, leaf in op.terms:
        if isinstance(leaf, Dt):
            continue  # spatial weak form is zero (operators/dt.h:28-37)
        if isinstance(leaf, Reaction):
            c = leaf.c
            if callable(c):
                from ..utils.callables import eval_at_points

                cvals = eval_at_points(
                    c, np.asarray(space.quad_points).reshape(-1, 1)
                )
                acc = acc + scale * _gram(space, 0, 0, weight=cvals)
            else:
                acc = acc + scale * float(c) * _gram(space, 0, 0)
        elif isinstance(leaf, BiLaplacian):
            acc = acc - scale * _gram(space, 2, 2)  # leading minus (bilaplacian.h:37-40)
        else:
            raise ValueError(
                f"operator {leaf!r} has no SPLINE weak form (the reference "
                "supports Reaction and BiLaplacian: splines/operators/)"
            )
    return SparseMatrix.from_dense(np.asarray(acc))


def assemble_mass(space) -> SparseMatrix:
    """[R0]_ij = int phi_i phi_j (spline_solver_base.h:75-77)."""
    return SparseMatrix.from_dense(np.asarray(_gram(space, 0, 0)))


def assemble_forcing(space, f) -> jnp.ndarray:
    """F_i = int f phi_i.

    The reference leaves spline forcing discretization as a TODO
    (spline_solver_base.h:72); implemented here with the same quadrature as
    the operators. `f` may be a callable or values at `space.quad_points`.
    """
    if callable(f):
        from ..utils.callables import eval_at_points

        fv = eval_at_points(f, np.asarray(space.quad_points).reshape(-1, 1))
    else:
        fv = np.asarray(f, dtype=np.float64).reshape(-1)
    B = jnp.asarray(space.basis.eval(space.quad_points))
    return B.T @ (jnp.asarray(space.quad_weights) * jnp.asarray(fv))
