"""Scatter-free stencil conversion for tensor-product (structured) meshes.

The generic DIA conversion (linear_algebra.dia.dia_from_coo) is a
segment-sum: 9 x n_cells scatter-adds. On a structured criss-cross mesh the
scatter is statically resolvable: cell (i, j) of each triangle type touches
dofs at FIXED grid displacements, so every (type, local_row, local_col)
combination maps to

  - one static stencil layer (the dof-index offset is the same for every
    cell of that type), and
  - one contiguous (n, n) block of that layer (rows are affine in (i, j)).

Conversion therefore becomes slice-adds over (n, n) grids: pure memory
passes. Valid for any coordinates (curvilinear tensor-product grids
included): only the CONNECTIVITY is structured, the local matrices are
arbitrary. `stencil_from_coords` goes one step further and computes the
stencil straight from the node coordinates in one elementwise expression.

Mesh convention (geometry/structured.py, bench.py): quad (i, j), i, j in
[0, n), lower-left node a = i*m + j with m = n+1 nodes per side, split into
type-A (a, b, a+1) and type-B (b, b+1, a+1), b = a + m. Cell arrays list
all n^2 type-A cells first, then all n^2 type-B cells.
"""

from __future__ import annotations

import jax.numpy as jnp

from .closed_form import SYM_TO_FULL
from .grid_dia import GridDIAMatrix

__all__ = [
    "p1_grid_stencil",
    "stencil_from_coords",
    "GRID_OFFSETS2D",
]

# local-dof grid positions relative to the quad's lower-left node
_POS_A = ((0, 0), (1, 0), (0, 1))  # a, b, a+1
_POS_B = ((1, 0), (1, 1), (0, 1))  # b, b+1, a+1

# the 7 stencil offsets generated by the criss-cross split
GRID_OFFSETS2D = (
    (-1, 0), (-1, 1), (0, -1), (0, 0), (0, 1), (1, -1), (1, 0),
)


def p1_grid_stencil(A6, n: int) -> GridDIAMatrix:
    """GridDIAMatrix of the P1 operator from packed local matrices.

    A6: (6, >= 2 n^2) packed-symmetric local matrices (rows
    [a11,a12,a13,a22,a23,a33], ops/closed_form.SYM_TO_FULL expansion),
    cell axis ordered type-A block then type-B block (padding beyond
    2 n^2 ignored). Returns the (m, m)-grid stencil, m = n + 1.
    """
    m = n + 1
    A = A6.reshape(6, -1)
    vals = {
        "A": A[:, : n * n].reshape(6, n, n),
        "B": A[:, n * n : 2 * n * n].reshape(6, n, n),
    }
    layers = {o: jnp.zeros((m, m), A6.dtype) for o in GRID_OFFSETS2D}
    for t, pos in (("A", _POS_A), ("B", _POS_B)):
        for p in range(3):
            for q in range(3):
                o = (pos[q][0] - pos[p][0], pos[q][1] - pos[p][1])
                di, dj = pos[p]
                layers[o] = layers[o].at[di : di + n, dj : dj + n].add(
                    vals[t][SYM_TO_FULL[3 * p + q]]
                )
    data = jnp.stack([layers[o] for o in GRID_OFFSETS2D])
    return GridDIAMatrix(data, GRID_OFFSETS2D, (m, m))


def _coords_offdiag_planes(X, Y, n: int):
    """Off-diagonal local stiffness entries of every cell, on the quad grid.

    X, Y: node coordinate planes, node (i, j) at [i, j] (at least (n+1,
    n+1); rows and columns beyond n are ignored). Returns six (n, n) planes
    (a12, a13, a23, b12, b13, b23): the [p, q] entries of the type-A cell
    (a, b, a+1) and of the type-B cell (b, b+1, a+1) of quad (i, j).

    The P1 stiffness of int grad.grad from edge vectors u = p2 - p1,
    v = p3 - p1 is (b b^T + c c^T) / (2 |det|) with b = (uy-vy, vy, -uy),
    c = (vx-ux, -vx, ux) and det = ux vy - vx uy (ops/closed_form).
    """
    x0, y0 = X[:n, :n], Y[:n, :n]  # a = (i, j)
    xd, yd = X[1 : n + 1, :n], Y[1 : n + 1, :n]  # b = (i+1, j)
    xr, yr = X[:n, 1 : n + 1], Y[:n, 1 : n + 1]  # a+1 = (i, j+1)
    xdr, ydr = X[1 : n + 1, 1 : n + 1], Y[1 : n + 1, 1 : n + 1]  # b+1

    def offdiag(ux, uy, vx, vy):
        inv = 1.0 / (2.0 * jnp.abs(ux * vy - vx * uy))
        b1, b2, b3 = uy - vy, vy, -uy
        c1, c2, c3 = vx - ux, -vx, ux
        return (
            (b1 * b2 + c1 * c2) * inv,
            (b1 * b3 + c1 * c3) * inv,
            (b2 * b3 + c2 * c3) * inv,
        )

    # type A (a, b, a+1): u = b - a, v = (a+1) - a
    pa = offdiag(xd - x0, yd - y0, xr - x0, yr - y0)
    # type B (b, b+1, a+1): u = (b+1) - b, v = (a+1) - b
    pb = offdiag(xdr - xd, ydr - yd, xr - xd, yr - yd)
    return pa + pb


def _stencil_rows_from_planes(planes):
    """The 7 stencil layers, in GRID_OFFSETS2D order, from the six (n, n)
    off-diagonal planes. Each off-center layer at node (I, J) is the sum of
    two plane values at quads (I - di, J - dj), di, dj in {0, 1}; the
    center layer is -(sum of the six others), exact for gradient-form
    stiffness (every row sums to zero). Returns (7, n + 1, n + 1)."""
    # pad one zero quad row above and below, one zero quad column on the
    # right: row r of a padded plane is quad row r - 1
    pa12, pa13, pa23, pb12, pb13, pb23 = (
        jnp.pad(p, ((1, 1), (0, 1))) for p in planes
    )

    def rshift(p):  # p[:, J] <- p[:, J - 1], zero into column 0
        return jnp.pad(p, ((0, 0), (1, 0)))[:, :-1]

    by_off = {
        (1, 0): pa12[1:] + rshift(pb23)[1:],
        (-1, 0): pa12[:-1] + rshift(pb23)[:-1],
        (0, 1): pa13[1:] + pb12[:-1],
        (0, -1): rshift(pa13)[1:] + rshift(pb12)[:-1],
        (-1, 1): pa23[:-1] + pb13[:-1],
        (1, -1): rshift(pa23)[1:] + rshift(pb13)[1:],
    }
    by_off[(0, 0)] = -sum(by_off.values())
    return jnp.stack([by_off[o] for o in GRID_OFFSETS2D])


def stencil_from_coords(X, Y, n: int) -> GridDIAMatrix:
    """GridDIAMatrix of the P1 -laplacian operator straight from node
    coordinate planes: local assembly and the global stencil scatter as
    one elementwise XLA expression (no per-cell arrays are materialized).

    X, Y: (>= n + 1, >= n + 1) planes, node (i, j) at [i, j]; any extra
    rows or columns are ignored. Matches p1_grid_stencil of the packed
    local matrices up to rounding (tests/test_ops.py).
    """
    m = n + 1
    data = _stencil_rows_from_planes(_coords_offdiag_planes(X, Y, n))
    return GridDIAMatrix(data, GRID_OFFSETS2D, (m, m))
