"""Batched affine maps reference-simplex -> physical cell.

Counterpart of `Simplex::initialize` (/root/reference/fdaPDE/geometry/simplex.h:184-195),
vectorized over all cells:

- J[c]    (N, M): columns are node(j+1) - node(0),
- invJ[c] (M, N): exact inverse when M == N, Moore–Penrose pseudo-inverse
  (J^T J)^{-1} J^T on manifolds (2.5D / 1.5D),
- measure[c]: |det J| / M! when M == N, Gram form on manifolds
  (0.5 ||J_0 x J_1|| for M=2,N=3; ||J_0|| for M=1).

Both a NumPy (host preprocessing) and a JAX (jit-traceable, device) variant
are provided; shapes are static so the JAX path fuses into the assembly
kernels.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["affine_maps", "affine_maps_np"]


def _det_small(xp, A):
    """Batched determinant of (C, k, k) for k in {1,2,3}, closed form.

    Generic `linalg.det`/`inv` lower to a serial LU decomposition per
    matrix; cofactor formulas are fused elementwise ops.
    """
    k = A.shape[-1]
    if k == 1:
        return A[:, 0, 0]
    if k == 2:
        return A[:, 0, 0] * A[:, 1, 1] - A[:, 0, 1] * A[:, 1, 0]
    if k == 3:
        return (
            A[:, 0, 0] * (A[:, 1, 1] * A[:, 2, 2] - A[:, 1, 2] * A[:, 2, 1])
            - A[:, 0, 1] * (A[:, 1, 0] * A[:, 2, 2] - A[:, 1, 2] * A[:, 2, 0])
            + A[:, 0, 2] * (A[:, 1, 0] * A[:, 2, 1] - A[:, 1, 1] * A[:, 2, 0])
        )
    raise ValueError(k)


def _inv_small(xp, A, det):
    """Batched inverse of (C, k, k) for k in {1,2,3} via adjugate / det."""
    k = A.shape[-1]
    d = det[:, None, None]
    if k == 1:
        return 1.0 / A
    if k == 2:
        adj = xp.stack(
            [
                xp.stack([A[:, 1, 1], -A[:, 0, 1]], axis=-1),
                xp.stack([-A[:, 1, 0], A[:, 0, 0]], axis=-1),
            ],
            axis=-2,
        )
        return adj / d
    if k == 3:
        c = lambda i1, j1, i2, j2: A[:, i1, j1] * A[:, i2, j2] - A[:, i1, j2] * A[:, i2, j1]
        adj = xp.stack(
            [
                xp.stack([c(1, 1, 2, 2), -c(0, 1, 2, 2), c(0, 1, 1, 2)], axis=-1),
                xp.stack([-c(1, 0, 2, 2), c(0, 0, 2, 2), -c(0, 0, 1, 2)], axis=-1),
                xp.stack([c(1, 0, 2, 1), -c(0, 0, 2, 1), c(0, 0, 1, 1)], axis=-1),
            ],
            axis=-2,
        )
        return adj / d
    raise ValueError(k)


def _affine_maps(xp, nodes, cells):
    coords = nodes[cells]  # (C, M+1, N)
    M = cells.shape[1] - 1
    N = nodes.shape[1]
    J = xp.swapaxes(coords[:, 1:, :] - coords[:, :1, :], 1, 2)  # (C, N, M)
    if M == N:
        detJ = _det_small(xp, J)
        invJ = _inv_small(xp, J, detJ)
        measure = xp.abs(detJ) / math.factorial(M)
    else:
        Jt = xp.swapaxes(J, 1, 2)  # (C, M, N)
        G = Jt @ J  # (C, M, M) Gram matrix
        detG = _det_small(xp, G)
        invJ = _inv_small(xp, G, detG) @ Jt  # pseudo-inverse (simplex.h:190)
        if M == 2:  # 2.5D surface: cross-product area (simplex.h:191)
            a, b = J[:, :, 0], J[:, :, 1]
            cr = xp.stack(
                [
                    a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                    a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                    a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0],
                ],
                axis=-1,
            )
            measure = 0.5 * xp.sqrt((cr * cr).sum(axis=1))
        elif M == 1:  # 1.5D network: segment length (simplex.h:192)
            measure = xp.sqrt((J[:, :, 0] * J[:, :, 0]).sum(axis=1))
        else:
            measure = xp.sqrt(xp.abs(detG)) / math.factorial(M)
    return J, invJ, measure


def affine_maps_np(nodes: np.ndarray, cells: np.ndarray):
    """Host (NumPy) batched affine maps: returns (J, invJ, measure)."""
    return _affine_maps(np, np.asarray(nodes, np.float64), np.asarray(cells))


def affine_maps(nodes, cells):
    """Device (JAX) batched affine maps: returns (J, invJ, measure).

    Traceable under jit; `cells` may be any integer array, `nodes` any float
    array, so the call fuses with downstream quadrature contractions.
    """
    import jax.numpy as jnp

    return _affine_maps(jnp, nodes, cells)
