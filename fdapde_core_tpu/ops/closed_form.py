"""Closed-form P1 local assembly on a padding-free 3D layout (pure XLA).

The P1/2D stiffness has the closed form

    A = (b b^T + c c^T) / (4 area),  b = (y2-y3, y3-y1, y1-y2),
                                     c = (x3-x2, x1-x3, x2-x1)

(the reference evaluates the same bilinear form by quadrature per cell,
fem_assembler.h:79-110; for P1 the integrand is piecewise constant).

Layout: coordinates arrive as ``(6, ...)`` — the row index first, any
trailing cell-axis shape (e.g. ``(6, C)`` or ``(6, C/128, 128)``) after it,
so every row is a contiguous stream and the op is one fused elementwise
pass.

Only the 6 unique entries of the symmetric 3x3 local matrix are produced;
``SYM_TO_FULL`` expands row-major (i, j) -> packed index.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["p1_stiffness_2d_sym", "SYM_TO_FULL", "pack_cell_axis"]

# row-major (3,3) index -> packed symmetric index [a11,a12,a13,a22,a23,a33]
SYM_TO_FULL = (0, 1, 2, 1, 3, 4, 2, 4, 5)


def pack_cell_axis(arr2d: jnp.ndarray) -> jnp.ndarray:
    """(rows, C) -> (rows, C/128, 128); C must be a multiple of 128."""
    rows, C = arr2d.shape
    assert C % 128 == 0, "pad the cell axis to a multiple of 128"
    return arr2d.reshape(rows, C // 128, 128)


def p1_stiffness_2d_sym(coords: jnp.ndarray) -> jnp.ndarray:
    """Packed symmetric local stiffness of the (positive) form int grad.grad.

    coords: (6, ...) rows are x1,y1,x2,y2,x3,y3 over any trailing cell-axis
    shape. Returns
    (6, ...) packed rows [a11, a12, a13, a22, a23, a33].
    """
    x1, y1, x2, y2, x3, y3 = (coords[i] for i in range(6))
    b1, b2, b3 = y2 - y3, y3 - y1, y1 - y2
    c1, c2, c3 = x3 - x2, x1 - x3, x2 - x1
    det = (x2 - x1) * (y3 - y1) - (x3 - x1) * (y2 - y1)
    inv = 1.0 / (2.0 * jnp.abs(det))
    return jnp.stack(
        [
            (b1 * b1 + c1 * c1) * inv,
            (b1 * b2 + c1 * c2) * inv,
            (b1 * b3 + c1 * c3) * inv,
            (b2 * b2 + c2 * c2) * inv,
            (b2 * b3 + c2 * c3) * inv,
            (b3 * b3 + c3 * c3) * inv,
        ]
    )


# -- 3D (P1 tetrahedra) ------------------------------------------------------

# row-major (4,4) index -> packed symmetric index
# [a00,a01,a02,a03,a11,a12,a13,a22,a23,a33]
SYM4_TO_FULL = (0, 1, 2, 3, 1, 4, 5, 6, 2, 5, 7, 8, 3, 6, 8, 9)


def p1_stiffness_3d_sym(edges: "jnp.ndarray") -> "jnp.ndarray":
    """Packed symmetric P1 tet stiffness of int grad.grad from edge vectors.

    edges: (9, ...) rows (ux,uy,uz, vx,vy,vz, wx,wy,wz) with u = p1-p0,
    v = p2-p0, w = p3-p0. Closed form: with c1 = v x w, c2 = w x u,
    c3 = u x v and c0 = -(c1+c2+c3), A_ij = (c_i . c_j) / (6 |det|),
    det = u . (v x w) (the reference evaluates the same form by quadrature,
    fem_assembler.h:79-110). Returns (10, ...) packed rows; expand with
    SYM4_TO_FULL.
    """
    u = edges[0:3]
    v = edges[3:6]
    w = edges[6:9]

    def cross(a, b):
        return (
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        )

    c1 = cross(v, w)
    c2 = cross(w, u)
    c3 = cross(u, v)
    c0 = tuple(-(c1[d] + c2[d] + c3[d]) for d in range(3))
    det = u[0] * c1[0] + u[1] * c1[1] + u[2] * c1[2]
    inv = 1.0 / (6.0 * jnp.abs(det))

    def dot(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    cs = (c0, c1, c2, c3)
    rows = []
    for i in range(4):
        for j in range(i, 4):
            rows.append(dot(cs[i], cs[j]) * inv)
    return jnp.stack(rows)
