"""Binary (boolean) matrices with expression-style operations.

Counterpart of /root/reference/fdaPDE/linear_algebra/binary_matrix.h:32-667.
The reference bit-packs into uintmax_t words with an expression-template
layer; XLA's native i1/int8 mask vectors make packing a pessimization
(masks fuse into `select` ops directly), so `BinaryMatrix` is a thin wrapper
over a boolean ndarray providing the reference's API surface: logical ops,
blocks, repeat/reshape, visitors (all/any/count), and `select` masking of
dense or sparse operands.
"""

from __future__ import annotations

import numpy as np

__all__ = ["BinaryMatrix", "BinaryVector"]


class BinaryMatrix:
    """Dense boolean matrix with the reference's operation surface."""

    def __init__(self, data):
        self.data = np.asarray(data).astype(bool)

    # -- constructors (binary_matrix.h Ones/Zeros) ----------------------------
    @classmethod
    def ones(cls, *shape):
        return cls(np.ones(shape, dtype=bool))

    @classmethod
    def zeros(cls, *shape):
        return cls(np.zeros(shape, dtype=bool))

    @property
    def shape(self):
        return self.data.shape

    # -- bitwise expression ops ----------------------------------------------
    def __and__(self, o):
        return BinaryMatrix(self.data & o.data)

    def __or__(self, o):
        return BinaryMatrix(self.data | o.data)

    def __xor__(self, o):
        return BinaryMatrix(self.data ^ o.data)

    def __invert__(self):
        return BinaryMatrix(~self.data)

    def __getitem__(self, idx):
        out = self.data[idx]
        return BinaryMatrix(out) if isinstance(out, np.ndarray) else bool(out)

    def set(self, idx, value=True):
        self.data[idx] = value
        return self

    # -- views ----------------------------------------------------------------
    def block(self, i, j, rows, cols):
        return BinaryMatrix(self.data[i : i + rows, j : j + cols])

    def repeat(self, r, c):
        return BinaryMatrix(np.tile(self.data, (r, c)))

    def reshape(self, *shape):
        return BinaryMatrix(self.data.reshape(shape))

    # -- visitors (binary_matrix.h:238-270) ------------------------------------
    def all(self) -> bool:
        return bool(self.data.all())

    def any(self) -> bool:
        return bool(self.data.any())

    def count(self) -> int:
        return int(self.data.sum())

    # -- masking (binary_matrix.h:549-599 select) ------------------------------
    def select(self, M):
        """Zero the entries of M where the mask is false."""
        from .sparse import SparseMatrix

        if isinstance(M, SparseMatrix):
            import jax.numpy as jnp

            keep = self.data[np.asarray(M.rows), np.asarray(M.cols)]
            return M.with_vals(jnp.where(jnp.asarray(keep), M.vals, 0.0))
        return np.where(self.data, np.asarray(M), 0)

    def __repr__(self):
        return f"BinaryMatrix({self.data.shape}, count={self.count()})"


def BinaryVector(data) -> BinaryMatrix:
    """1D convenience alias (binary_matrix.h BinaryVector = Nx1)."""
    return BinaryMatrix(np.asarray(data).reshape(-1))
