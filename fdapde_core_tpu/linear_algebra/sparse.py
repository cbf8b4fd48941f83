"""Sparse matrices as JAX pytrees with scatter-add SpMV.

The device replacement for Eigen's `SpMatrix` (utils/symbols.h:33): entries are
stored in (row, col)-sorted COO order with static shape; products are a
gather (`x[cols]`) followed by `segment_sum` — both XLA-native. The
structure (rows/cols) is typically precomputed host-side once per mesh and
reused across assemblies, so only `vals` changes under jit.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["SparseMatrix", "coo_sum_duplicates"]


def coo_sum_duplicates(rows, cols, n_rows, n_cols):
    """Host-side: dedupe & sort (row, col) pairs.

    Returns (rows_u, cols_u, inverse) with inverse mapping each input entry to
    its slot — the device analogue of Eigen `setFromTriplets` scatter-add
    semantics (fem_assembler.h:99-112): values are later combined with
    `segment_sum(vals, inverse, nnz)`.
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    keys = rows * np.int64(n_cols) + cols
    uniq, inverse = np.unique(keys, return_inverse=True)
    return (
        (uniq // n_cols).astype(np.int32),
        (uniq % n_cols).astype(np.int32),
        inverse.reshape(-1).astype(np.int32),
    )


@jax.tree_util.register_pytree_node_class
@dataclass
class SparseMatrix:
    """Sorted-COO sparse matrix; a pytree whose leaves are (rows, cols, vals)."""

    rows: jnp.ndarray  # (nnz,) int32, sorted
    cols: jnp.ndarray  # (nnz,) int32, sorted within each row
    vals: jnp.ndarray  # (nnz,)
    shape: tuple[int, int]

    # -- pytree protocol ----------------------------------------------------
    def tree_flatten(self):
        return (self.rows, self.cols, self.vals), self.shape

    @classmethod
    def tree_unflatten(cls, shape, leaves):
        return cls(*leaves, shape=shape)

    # -- construction -------------------------------------------------------
    @classmethod
    def from_coo(cls, rows, cols, vals, shape):
        """Build from possibly-duplicated COO triplets (duplicates summed)."""
        r, c, inv = coo_sum_duplicates(rows, cols, *shape)
        v = jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(inv), r.shape[0])
        return cls(jnp.asarray(r), jnp.asarray(c), v, shape)

    @classmethod
    def from_scipy(cls, m):
        m = m.tocoo()
        return cls.from_coo(m.row, m.col, m.data, m.shape)

    @classmethod
    def from_dense(cls, a, tol: float = 0.0):
        a = np.asarray(a)
        r, c = np.nonzero(np.abs(a) > tol)
        return cls.from_coo(r, c, jnp.asarray(a[r, c]), a.shape)

    # -- algebra ------------------------------------------------------------
    @property
    def nnz(self) -> int:
        return self.vals.shape[0]

    @property
    def dtype(self):
        return self.vals.dtype

    def __matmul__(self, x):
        x = jnp.asarray(x)
        gathered = self.vals[:, None] * x[self.cols] if x.ndim == 2 else self.vals * x[self.cols]
        return jax.ops.segment_sum(gathered, self.rows, self.shape[0])

    def rmatvec(self, x):
        """x @ A, i.e. A^T applied to x."""
        x = jnp.asarray(x)
        gathered = self.vals[:, None] * x[self.rows] if x.ndim == 2 else self.vals * x[self.rows]
        return jax.ops.segment_sum(gathered, self.cols, self.shape[1])

    @property
    def T(self) -> "SparseMatrix":
        # re-sort by (col, row); host-side ordering with device values
        order = np.lexsort(
            (np.asarray(self.rows), np.asarray(self.cols))
        ).astype(np.int32)
        return SparseMatrix(
            jnp.asarray(np.asarray(self.cols)[order]),
            jnp.asarray(np.asarray(self.rows)[order]),
            self.vals[jnp.asarray(order)],
            (self.shape[1], self.shape[0]),
        )

    def diagonal(self):
        mask = self.rows == self.cols
        return jax.ops.segment_sum(
            jnp.where(mask, self.vals, 0.0), self.rows, self.shape[0]
        )

    def with_vals(self, vals) -> "SparseMatrix":
        return SparseMatrix(self.rows, self.cols, vals, self.shape)

    def __add__(self, other: "SparseMatrix") -> "SparseMatrix":
        assert self.shape == other.shape
        return SparseMatrix.from_coo(
            jnp.concatenate([self.rows, other.rows]),
            jnp.concatenate([self.cols, other.cols]),
            jnp.concatenate([self.vals, other.vals]),
            self.shape,
        )

    def __sub__(self, other: "SparseMatrix") -> "SparseMatrix":
        return self + (other * -1.0)

    def __mul__(self, s) -> "SparseMatrix":
        return self.with_vals(self.vals * s)

    __rmul__ = __mul__

    def scale_rows(self, d) -> "SparseMatrix":
        return self.with_vals(self.vals * jnp.asarray(d)[self.rows])

    def scale_cols(self, d) -> "SparseMatrix":
        return self.with_vals(self.vals * jnp.asarray(d)[self.cols])

    # -- export -------------------------------------------------------------
    def toarray(self) -> np.ndarray:
        out = np.zeros(self.shape, dtype=np.asarray(self.vals).dtype)
        np.add.at(out, (np.asarray(self.rows), np.asarray(self.cols)), np.asarray(self.vals))
        return out

    def to_scipy(self):
        from scipy.sparse import coo_matrix

        return coo_matrix(
            (np.asarray(self.vals), (np.asarray(self.rows), np.asarray(self.cols))),
            shape=self.shape,
        ).tocsr()

    def __repr__(self):
        return f"SparseMatrix(shape={self.shape}, nnz={self.nnz}, dtype={self.dtype})"
