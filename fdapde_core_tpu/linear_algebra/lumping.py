"""Row-sum mass lumping.

Counterpart of /root/reference/fdaPDE/linear_algebra/lumping.h:30-51: replace
a (mass) matrix by the diagonal of its row sums. Returns the diagonal as a
vector — the natural device representation of a diagonal operator (elementwise
multiply instead of SpMV).
"""

from __future__ import annotations

import jax.numpy as jnp

from .sparse import SparseMatrix

__all__ = ["lump"]


def lump(M):
    """Diagonal (as a vector) of the row-sum lumped matrix."""
    if isinstance(M, SparseMatrix):
        assert M.shape[0] == M.shape[1], "lumping requires a square matrix"
        import jax

        return jax.ops.segment_sum(M.vals, M.rows, M.shape[0])
    M = jnp.asarray(M)
    assert M.shape[0] == M.shape[1]
    return M.sum(axis=1)
