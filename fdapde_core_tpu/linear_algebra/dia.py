"""DIA (offset-diagonal) sparse format: SpMV as shifts + multiply-adds.

Rationale: a generic gather SpMV reads an index per entry, while *static
shifts* of a vector need no index arrays at all. A matrix whose
nonzero (col - row) offsets form a small static set — banded systems, and
any FEM matrix on a (block-)structured or well-ordered mesh — supports

    y = sum_k data[k, :] * shift(x, offsets[k])

with data[k, i] = A[i, i + offsets[k]]: one fused multiply-add per offset,
running at memory bandwidth. This is the format behind the benchmark's CG
throughput; the general unstructured path falls back to gather/segment-sum
(ops/ell.py).

Construction from COO entries is a one-time per-offset segment-sum (device)
or a scipy conversion (host).
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["DIAMatrix", "dia_from_coo", "unique_offsets"]


def unique_offsets(dofs: np.ndarray) -> tuple[int, ...]:
    """All (col - row) offsets generated by a dof table (host, static)."""
    d = np.asarray(dofs, dtype=np.int64)
    nb = d.shape[1]
    offs = (d[:, None, :] - d[:, :, None]).reshape(-1)
    return tuple(int(o) for o in np.unique(offs))


def _shift(x, d: int):
    """shifted(x, d)[i] = x[i + d], zero padded; d static."""
    n = x.shape[0]
    if d == 0:
        return x
    if d > 0:
        return jnp.concatenate([x[d:], jnp.zeros(d, x.dtype)])
    return jnp.concatenate([jnp.zeros(-d, x.dtype), x[:d]])


@jax.tree_util.register_pytree_node_class
@dataclass
class DIAMatrix:
    """Square sparse matrix in diagonal storage; offsets are static."""

    data: jnp.ndarray  # (n_offsets, n); data[k, i] = A[i, i + offsets[k]]
    offsets: tuple[int, ...]
    n: int

    def tree_flatten(self):
        return (self.data,), (self.offsets, self.n)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(leaves[0], *aux)

    @property
    def shape(self):
        return (self.n, self.n)

    def __matmul__(self, x):
        x = jnp.asarray(x)
        out = jnp.zeros_like(x)
        for k, d in enumerate(self.offsets):
            out = out + self.data[k] * _shift(x, d)
        return out

    def diagonal(self):
        k = self.offsets.index(0)
        return self.data[k]

    def to_sparse(self):
        from .sparse import SparseMatrix

        rows, cols, vals = [], [], []
        data = np.asarray(self.data)
        for k, d in enumerate(self.offsets):
            i = np.arange(max(0, -d), min(self.n, self.n - d))
            rows.append(i)
            cols.append(i + d)
            vals.append(data[k, i])
        return SparseMatrix.from_coo(
            np.concatenate(rows),
            np.concatenate(cols),
            jnp.asarray(np.concatenate(vals)),
            (self.n, self.n),
        )


def dia_from_coo(rows, cols, vals, n: int, offsets: tuple[int, ...]) -> DIAMatrix:
    """Build DIA storage from (possibly duplicated) COO entries, on device.

    `offsets` is the static SORTED offset set (e.g.
    `unique_offsets(space.dofs)`). Entries whose offset is not listed are
    dropped — callers must pass a complete set. Single fused segment-sum
    (segment id = offset_layer * n + row); one-time cost at assembly.
    """
    assert tuple(offsets) == tuple(sorted(offsets)), "offsets must be sorted"
    rows = jnp.asarray(rows)
    cols = jnp.asarray(cols)
    vals = jnp.asarray(vals)
    d = cols.astype(jnp.int32) - rows.astype(jnp.int32)
    # one fused scatter: segment id = offset_layer * n + row
    off_arr = jnp.asarray(np.asarray(offsets, dtype=np.int32))
    k = jnp.searchsorted(off_arr, d)
    k = jnp.clip(k, 0, len(offsets) - 1)
    valid = off_arr[k] == d
    seg = k * n + rows
    data = jax.ops.segment_sum(
        jnp.where(valid, vals, 0.0), seg, len(offsets) * n
    ).reshape(len(offsets), n)
    return DIAMatrix(data, tuple(offsets), n)


def prune_zero_offsets(D: DIAMatrix, tol: float = 0.0) -> DIAMatrix:
    """Drop all-zero diagonals (host round-trip for the static offset set).

    FEM stencils routinely contain structurally-present but numerically-zero
    diagonals (e.g. the hypotenuse coupling of right-triangle P1 meshes is
    exactly 0), and each DIA layer costs a full n-vector read per SpMV.
    `tol` is an absolute threshold on the layer's max |entry|; the default 0
    only drops exact zeros (no approximation).
    """
    absmax = np.asarray(jnp.max(jnp.abs(D.data), axis=1))
    keep = [k for k in range(len(D.offsets)) if absmax[k] > tol]
    if len(keep) == len(D.offsets):
        return D
    return DIAMatrix(
        D.data[jnp.asarray(keep)], tuple(D.offsets[k] for k in keep), D.n
    )
