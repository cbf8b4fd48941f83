"""Windowed-ELL SpMV for scattered-banded operators.

The banded DIA split (ops/dia_split.py) serves matrices whose RCM offset
histogram CONCENTRATES on a few offsets; genuinely scattered bands —
imported Delaunay meshes after RCM, P2 numberings — are rejected by
`plan_split_width` and otherwise fall back to raw ELL gathers over the
full (n,) vector (the reference's SparseLU solves on any mesh,
fem_linear_elliptic_solver.h:38-47).

Design: rows in static blocks of R; after RCM every column of block i
lies in [i*R - B, i*R + R + B) (B = matrix bandwidth, host-checked at
construction), so the SpMV gathers from per-block WINDOWS of R + 2B
contiguous x values instead of the whole vector:

    windows = stack_i x[i*R - B : i*R + R + B]        (static slices)
    y_blk   = sum_k vals[blk, k, :] * windows[blk, idx_local[blk, k, :]]

One batched take_along_axis over (NB, Wwin) operands replaces the flat
(n,)-operand gather. The index arrays are rebased ONCE at construction
(device, jittable); the matvec itself is gather + fused multiply-sum.
Whether the small-operand batched gather beats the flat gather is a
hardware question measured by benchmarks/micro_scatter_spmv.py — the
class exists so either formulation can serve the operator protocol
(@ / diagonal / astype — DirichletSystem, cg_chunked, bicgstab_chunked).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .matfree_soa import ELLSoA

__all__ = ["WindowedELL", "window_bandwidth"]


@jax.jit
def window_bandwidth(cols):
    """max |col - row| over the ELL table (one tiny device program)."""
    n = cols.shape[1]
    rows = jnp.arange(n, dtype=cols.dtype)[None, :]
    return jnp.max(jnp.abs(cols - rows))


@jax.tree_util.register_pytree_node_class
class WindowedELL:
    """Block-windowed view of an ELLSoA for scattered-banded matrices.

    vals (NB, K, R); idx (NB, K*R) int32 window-local columns; rows
    beyond n are padding (val 0, idx clamped in range). Static metadata:
    n, R (block rows), B (window halo = bandwidth, 128-aligned).
    """

    def __init__(self, vals, idx, n: int, R: int, B: int):
        self.vals = vals
        self.idx = idx
        self.n = n
        self.R = R
        self.B = B

    def tree_flatten(self):
        return (self.vals, self.idx), (self.n, self.R, self.B)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves, *aux)

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def nb(self):
        return -(-self.n // self.R)

    @property
    def wwin(self):
        return self.R + 2 * self.B

    @classmethod
    def from_ell(cls, E: ELLSoA, block_rows: int = 65536,
                 bandwidth: int | None = None):
        """Rebase an ELLSoA into block-window layout (jittable given a
        STATIC bandwidth; pass bandwidth=None to host-fetch it here).
        Raises when the matrix bandwidth exceeds the given bound."""
        K, n = E.vals.shape
        if bandwidth is None:
            bandwidth = int(window_bandwidth(E.cols))
        B = -(-max(int(bandwidth), 1) // 128) * 128  # lane-align the halo
        R = block_rows
        NB = -(-n // R)
        vals, idx = _rebase(E.vals, E.cols, n, R, B, NB, K)
        return cls(vals, idx, n, R, B)

    def __matmul__(self, v):
        n, R, B, NB, K = self.n, self.R, self.B, self.nb, self.vals.shape[1]
        wwin = self.wwin
        npad = NB * R + 2 * B
        xp = jnp.pad(v, (B, npad - n - B))
        wins = jnp.stack([
            jax.lax.slice(xp, (i * R,), (i * R + wwin,)) for i in range(NB)
        ])
        g = jnp.take_along_axis(wins, self.idx, axis=1)
        y = jnp.sum(self.vals * g.reshape(NB, K, R), axis=1)
        return y.reshape(-1)[: n]

    def diagonal(self):
        """Diagonal via the rebased index: entry (blk, k, r) is on the
        diagonal iff its window-local column equals B + r."""
        NB, K, R = self.vals.shape
        r = jnp.arange(R, dtype=self.idx.dtype)[None, None, :]
        isdiag = self.idx.reshape(NB, K, R) == (self.B + r)
        d = jnp.sum(jnp.where(isdiag, self.vals, 0.0), axis=1)
        return d.reshape(-1)[: self.n]

    def astype(self, dtype):
        return WindowedELL(self.vals.astype(dtype), self.idx, self.n,
                           self.R, self.B)


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5, 6))
def _rebase(vals, cols, n, R, B, NB, K):
    padn = NB * R - n
    # padding rows: col = row would fall outside the last window only via
    # the pad tail; clamp keeps every index in [0, wwin)
    colsp = jnp.pad(cols, ((0, 0), (0, padn)))
    valsp = jnp.pad(vals, ((0, 0), (0, padn)))
    colsb = colsp.reshape(K, NB, R).transpose(1, 0, 2)
    valsb = valsp.reshape(K, NB, R).transpose(1, 0, 2)
    base = jnp.arange(NB, dtype=cols.dtype) * R - B
    loc = jnp.clip(colsb - base[:, None, None], 0, R + 2 * B - 1)
    return valsb, loc.reshape(NB, K * R).astype(jnp.int32)
