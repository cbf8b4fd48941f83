"""Kronecker products: dense, sparse, and matrix-free structured matvecs.

Counterpart of /root/reference/fdaPDE/linear_algebra/kronecker_product.h
(Eigen expression-template Kronecker, dense x dense and sparse x sparse).
The accelerator-idiomatic form for space-time problems is the *matrix-free* identity

    (A (x) B) vec(X) = vec(B X A^T)

which turns the Kronecker matvec into two batched matmuls (matrix-unit friendly),
never materializing the n_a*n_b square operator.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .sparse import SparseMatrix

__all__ = ["kron", "kron_matvec", "KroneckerOperator"]


def kron(A, B):
    """Explicit Kronecker product.

    dense x dense -> dense (jnp.kron); SparseMatrix x SparseMatrix -> sparse
    (kronecker_product.h:27-80 semantics).
    """
    if isinstance(A, SparseMatrix) != isinstance(B, SparseMatrix):
        raise TypeError(
            "kron needs both operands sparse or both dense "
            "(kronecker_product.h supports dense x dense and sparse x sparse); "
            "densify one side or use kron_matvec for the matrix-free product"
        )
    if isinstance(A, SparseMatrix) and isinstance(B, SparseMatrix):
        ra, ca, va = np.asarray(A.rows), np.asarray(A.cols), A.vals
        rb, cb, vb = np.asarray(B.rows), np.asarray(B.cols), B.vals
        nb_r, nb_c = B.shape
        rows = (ra[:, None].astype(np.int64) * nb_r + rb[None, :]).reshape(-1)
        cols = (ca[:, None].astype(np.int64) * nb_c + cb[None, :]).reshape(-1)
        vals = (va[:, None] * vb[None, :]).reshape(-1)
        return SparseMatrix.from_coo(
            rows, cols, vals, (A.shape[0] * nb_r, A.shape[1] * nb_c)
        )
    return jnp.kron(jnp.asarray(A), jnp.asarray(B))


def kron_matvec(A, B, x):
    """(A (x) B) @ x without forming the product; A: (m,n), B: (p,q), x: (n*q,)."""
    n = A.shape[1]
    q = B.shape[1] if not isinstance(B, SparseMatrix) else B.shape[1]
    X = jnp.asarray(x).reshape(n, q)
    BX = (B @ X.T).T if isinstance(B, SparseMatrix) else X @ jnp.asarray(B).T
    out = (A @ BX) if isinstance(A, SparseMatrix) else jnp.asarray(A) @ BX
    return out.reshape(-1)


class KroneckerOperator:
    """Matrix-free linear operator for A (x) B, usable by the Krylov solvers."""

    def __init__(self, A, B):
        self.A, self.B = A, B
        ar = A.shape[0]
        br = B.shape[0]
        self.shape = (ar * br, A.shape[1] * B.shape[1])

    def __matmul__(self, x):
        return kron_matvec(self.A, self.B, x)

    def __call__(self, x):
        return kron_matvec(self.A, self.B, x)
