"""2D-grid stencil operators: DIA specialized to tensor-product dof layouts.

When dofs live on an (mx, my) grid (structured meshes; also the natural
layout for space-time tensor products), every (col - row) offset decomposes
as (di, dj) grid displacements and the SpMV becomes a 2D stencil:

    y = sum_k data[k] * padded(x)[1+di_k : 1+di_k+mx, 1+dj_k : 1+dj_k+my]

2D slices keep the lane dimension contiguous — friendlier to the device memory
system than 1D concatenate-shifts for row-crossing offsets.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp

__all__ = ["GridDIAMatrix", "grid_offsets_from_flat"]


def grid_offsets_from_flat(offsets: tuple[int, ...], my: int):
    """Decompose flat offsets d = di * my + dj (|dj| < my) into 2D pairs."""
    out = []
    for d in offsets:
        di = round(d / my)
        dj = d - di * my
        assert abs(dj) < my
        out.append((di, dj))
    return tuple(out)


@jax.tree_util.register_pytree_node_class
@dataclass
class GridDIAMatrix:
    """Stencil matrix over an (mx, my) dof grid."""

    data: jnp.ndarray  # (K, mx, my): data[k, i, j] = A[row, row + offset_k]
    offsets2d: tuple[tuple[int, int], ...]
    shape2d: tuple[int, int]

    def tree_flatten(self):
        return (self.data,), (self.offsets2d, self.shape2d)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(leaves[0], *aux)

    @classmethod
    def from_dia(cls, dia, shape2d):
        """Reshape a flat DIAMatrix onto an (mx, my) grid layout."""
        mx, my = shape2d
        assert mx * my == dia.n
        off2d = grid_offsets_from_flat(dia.offsets, my)
        data = dia.data.reshape(len(dia.offsets), mx, my)
        return cls(data, off2d, shape2d)

    @property
    def n(self):
        return self.shape2d[0] * self.shape2d[1]

    def __matmul__(self, x):
        mx, my = self.shape2d
        xg = jnp.asarray(x).reshape(mx, my)
        H = max(max(abs(a), abs(b)) for a, b in self.offsets2d)
        xp = jnp.pad(xg, H)
        y = jnp.zeros_like(xg)
        for k, (di, dj) in enumerate(self.offsets2d):
            y = y + self.data[k] * jax.lax.dynamic_slice(
                xp, (H + di, H + dj), (mx, my)
            )
        return y.reshape(-1)

    def matvec_batch(self, X):
        """Batched stencil apply: X (B, n) flat rows -> (B, n).

        One padded slice per layer serves ALL B slices (vs B separate
        matvecs) — the space-factor hook for separable space-time
        operators (models/space_time.SeparableOperator)."""
        mx, my = self.shape2d
        B = X.shape[0]
        Xg = jnp.asarray(X).reshape(B, mx, my)
        H = max(max(abs(a), abs(b)) for a, b in self.offsets2d)
        xp = jnp.pad(Xg, ((0, 0), (H, H), (H, H)))
        y = jnp.zeros_like(Xg)
        for k, (di, dj) in enumerate(self.offsets2d):
            y = y + self.data[k][None] * jax.lax.slice(
                xp, (0, H + di, H + dj), (B, H + di + mx, H + dj + my)
            )
        return y.reshape(B, -1)

    def diagonal(self):
        k = self.offsets2d.index((0, 0))
        return self.data[k].reshape(-1)

    def with_dirichlet(self, free_flat):
        """Fold Dirichlet masking into the data: A' = F A F.

        free_flat: (n,) 1.0 on free dofs, 0.0 on pinned ones. The masked
        operator satisfies  A' x + x * (1 - free) == F(A(Fx)) + pinned rows
        as identity — so solvers need no per-iteration mask multiplies
        (two fewer full passes per CG iteration; see bench.py)."""
        mx, my = self.shape2d
        freeg = jnp.asarray(free_flat).reshape(mx, my)
        H = max(max(abs(a), abs(b)) for a, b in self.offsets2d)
        fp = jnp.pad(freeg, H)
        layers = []
        for k, (di, dj) in enumerate(self.offsets2d):
            shifted = jax.lax.dynamic_slice(fp, (H + di, H + dj), (mx, my))
            layers.append(self.data[k] * freeg * shifted)
        return GridDIAMatrix(jnp.stack(layers), self.offsets2d, self.shape2d)

    def with_dirichlet_identity(self, free_flat):
        """A' = F A F + (I - F): masked operator WITH identity on pinned dofs
        folded into the center layer, so solvers need neither per-iteration
        mask multiplies nor the `+ x * (1 - free)` term (one less full grid
        read per SpMV vs with_dirichlet). Same solutions as the reference's
        row surgery (fem_solver_base.h:144-155) for rhs with bc values."""
        masked = self.with_dirichlet(free_flat)
        mx, my = self.shape2d
        pinned = 1.0 - jnp.asarray(free_flat).reshape(mx, my)
        k0 = masked.offsets2d.index((0, 0))
        data = masked.data.at[k0].add(pinned)
        return GridDIAMatrix(data, masked.offsets2d, masked.shape2d)


def prune_zero_offsets_grid(G: GridDIAMatrix, tol: float = 0.0) -> GridDIAMatrix:
    """Drop all-zero stencil layers (see linear_algebra.dia.prune_zero_offsets).

    Exact-zero layers are common: right-triangle P1 meshes have zero
    hypotenuse coupling, so the structurally-7-point stencil is numerically
    5-point — each dropped layer saves a full grid read per SpMV.
    """
    import numpy as np

    absmax = np.asarray(jnp.max(jnp.abs(G.data), axis=(1, 2)))
    keep = [k for k in range(len(G.offsets2d)) if absmax[k] > tol]
    if len(keep) == len(G.offsets2d):
        return G
    return GridDIAMatrix(
        G.data[jnp.asarray(keep)],
        tuple(G.offsets2d[k] for k in keep),
        G.shape2d,
    )
