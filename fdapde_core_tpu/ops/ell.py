"""Scatter-free matrix-free SpMV via ELL dof adjacency.

The matrix-free FEM SpMV has three stages:

    gather   xe = x[dofs]                  (C, nb)
    contract ye = A_loc @ xe               (C, nb)   batched 3x3/6x6 matvecs
    combine  y[d] = sum of ye over all (cell, slot) incident to dof d

The reference does stage 3 with Eigen's scatter (setFromTriplets semantics);
the straightforward XLA form is `segment_sum` — a scatter-add, which
serializes on duplicate indices. Here stage 3 is re-expressed as a GATHER:
a precomputed ELL table `adj[d, k]` lists the flat (cell*nb + slot) incident
positions of dof d (padded to the max vertex degree), so

    y = (ye.flat[adj] * mask).sum(axis=1)

is a dense gather + reduction over a tiny axis — fully vectorizable on the
device. The adjacency build itself is one device `argsort` + `searchsorted`,
so the whole pipeline (build + iterate) runs on-chip with no host transfer.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "ELLMatrix",
    "build_ell_adjacency",
    "ell_spmv",
    "local_matvec",
]


def build_ell_adjacency(dofs, n_dofs: int, max_degree: int):
    """ELL incidence table of a dof table.

    dofs: (C, nb) int32. Returns (adj (n_dofs, max_degree) int32 flat indices
    into the flattened (C*nb,) element-local vector, mask (n_dofs,
    max_degree) dtype-bool, overflowed: scalar bool — true if any dof has
    degree > max_degree (caller should rebuild with a larger bound).
    """
    flat = dofs.reshape(-1)
    order = jnp.argsort(flat, stable=True).astype(jnp.int32)
    sorted_d = flat[order]
    ids = jnp.arange(n_dofs, dtype=dofs.dtype)
    starts = jnp.searchsorted(sorted_d, ids)
    ends = jnp.searchsorted(sorted_d, ids + 1)
    counts = ends - starts
    k = jnp.arange(max_degree, dtype=jnp.int32)
    idx = starts[:, None] + k[None, :]
    mask = k[None, :] < counts[:, None]
    adj = order[jnp.clip(idx, 0, flat.shape[0] - 1)]
    return adj, mask, jnp.any(counts > max_degree)


def local_matvec(A_loc, dofs, x):
    """Stages 1+2: per-element products ye = A_loc @ x[dofs], (C, nb)."""
    xe = x[dofs]
    return jnp.einsum("cij,cj->ci", A_loc, xe)


def ell_spmv(A_loc, dofs, adj, mask, x):
    """Full scatter-free SpMV: y = A @ x with A given element-locally."""
    ye = local_matvec(A_loc, dofs, x).reshape(-1)
    gathered = ye[adj] * mask.astype(ye.dtype)
    return gathered.sum(axis=1)


@jax.tree_util.register_pytree_node_class
class ELLMatrix:
    """Assembled row-ELL sparse matrix: vals/cols (n, K), padded rows.

    The ASSEMBLED counterpart of the matrix-free pipeline above: one
    gathered element per nonzero per SpMV (vs one per incident (cell, slot)
    PLUS one per element-local entry for the matrix-free form — ~1.6x fewer
    gathers for P1 meshes, the dominant cost of the general path).
    Padding entries carry col = row index and val = 0, so no mask is needed
    in the SpMV. Duplicate (row, col) pairs are NOT allowed (from_local
    merges them).
    """

    def __init__(self, vals, cols, shape):
        self.vals = vals  # (n, K)
        self.cols = cols  # (n, K) int32
        self.shape = shape

    def tree_flatten(self):
        return (self.vals, self.cols), (self.shape,)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves, *aux)

    def __matmul__(self, x):
        return (self.vals * x[self.cols]).sum(axis=1)

    def diagonal(self):
        n = self.shape[0]
        rows = jnp.arange(n, dtype=self.cols.dtype)[:, None]
        return jnp.where(self.cols == rows, self.vals, 0.0).sum(axis=1)

    def astype(self, dtype):
        return ELLMatrix(self.vals.astype(dtype), self.cols, self.shape)

    def with_added_diagonal(self, d):
        """A + diag(d) — the diagonal is always present in FEM sparsity, so
        only existing (row == col) slots change (first match per row:
        duplicates are merged by construction)."""
        n = self.shape[0]
        rows = jnp.arange(n, dtype=self.cols.dtype)[:, None]
        isdiag = self.cols == rows
        first = isdiag & (jnp.cumsum(isdiag, axis=1) == 1)
        vals = self.vals + jnp.where(first, jnp.asarray(d)[:, None], 0.0)
        return ELLMatrix(vals, self.cols, self.shape)

    @classmethod
    def from_local(cls, A_loc, dofs, adj, adj_mask, max_cols: int):
        """Assemble on device from element-local matrices + ELL adjacency.

        For each dof d, the incident positions adj[d] = cell*nb + slot
        contribute the local-matrix rows A_loc[cell, slot, :] with columns
        dofs[cell, :]; entries sharing a column are merged by an in-row
        sort + one flat segment-sum (Eigen setFromTriplets semantics,
        fem_assembler.h:99-112, re-expressed as sorted reduction).

        max_cols bounds the number of DISTINCT columns per row (e.g. 9 for
        a 2D P1 node of degree <= 8). Returns (ELLMatrix, overflowed) —
        `overflowed` True means some row exceeded max_cols and the result
        row is truncated (rebuild with a larger bound).
        """
        n, D = adj.shape
        nb = dofs.shape[1]
        K = max_cols
        c = adj // nb  # (n, D) incident cells
        i = adj % nb  # (n, D) incident slots
        cols_all = dofs[c]  # (n, D, nb)
        vals_all = A_loc[c, i]  # (n, D, nb): local rows
        valid = adj_mask[:, :, None]
        vals_all = jnp.where(valid, vals_all, 0.0)
        # sentinel column n sorts after every real column
        cols_all = jnp.where(valid, cols_all, n).astype(jnp.int32)

        E = D * nb
        cols_f = cols_all.reshape(n, E)
        vals_f = vals_all.reshape(n, E)
        order = jnp.argsort(cols_f, axis=1)
        cols_s = jnp.take_along_axis(cols_f, order, axis=1)
        vals_s = jnp.take_along_axis(vals_f, order, axis=1)
        first = jnp.concatenate(
            [
                jnp.ones((n, 1), bool),
                cols_s[:, 1:] != cols_s[:, :-1],
            ],
            axis=1,
        )
        real = cols_s < n
        uidx = jnp.cumsum(first.astype(jnp.int32), axis=1) - 1  # 0..E-1
        overflowed = jnp.any(real & (uidx >= K))
        slot = jnp.where(real & (uidx < K), uidx, K)  # K = trash slot
        rows = jnp.arange(n, dtype=jnp.int32)[:, None]
        seg = (rows * (K + 1) + slot).reshape(-1)
        vals = jax.ops.segment_sum(
            vals_s.reshape(-1), seg, n * (K + 1)
        ).reshape(n, K + 1)[:, :K]
        cols = jax.ops.segment_max(
            jnp.where(slot < K, cols_s, -1).reshape(-1), seg, n * (K + 1)
        ).reshape(n, K + 1)[:, :K]
        cols = jnp.where(cols < 0, rows, cols).astype(jnp.int32)
        return cls(vals, cols, (n, n)), overflowed
