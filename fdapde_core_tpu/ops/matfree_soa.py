"""SoA (cell-axis-LAST) general gather pipeline: the device-scale layouts.

The AoS forms in ops/matfree.py ((C, 3, 3) local matrices, (C, 3) dof
tables, (n, K) adjacency) are correct everywhere but put a tiny axis
minor-most, which device layouts may pad and which turns every access
into a short strided read. This module re-expresses the same pipeline
with the large axis LAST everywhere: per-corner (C,) gathers, symmetric
rank-deficient stencil storage (s01, s02, s12; diagonals from the zero row
sums), (D, n) adjacency tables and (K, n) assembled ELL.

Same math as ops/matfree.py / ops/ell.py; parity-tested against them.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "p1_offdiag_soa",
    "p1_general_soa",
    "p1_general_soa_3d",
    "build_adjacency_soa",
    "MatrixFreeSoA",
    "MatrixFreeSoA3D",
    "MatrixFreeP2SoA",
    "ELLSoA",
    "ell_from_op_blocked",
]


def p1_offdiag_soa(x, y, c0, c1, c2, kappa=None):
    """Off-diagonal P1 stiffness entries (s01, s02, s12), each (C,).

    x, y: (N,) node coordinate arrays; c0, c1, c2: (C,) corner indices.
    The symmetric local matrix is fully determined: a_ii = -(s_ij + s_ik)
    (zero row sums of the pure-diffusion stiffness). Same closed form as
    ops/matfree.p1_local_stiffness (simplex.h:184-195 adjugate gradients;
    +grad.grad sign per operators/laplacian.h:37-44).
    """
    x0, x1, x2 = x[c0], x[c1], x[c2]
    y0, y1, y2 = y[c0], y[c1], y[c2]
    e0x, e0y = x1 - x0, y1 - y0
    e1x, e1y = x2 - x0, y2 - y0
    det = e0x * e1y - e0y * e1x
    scale = 0.5 * jnp.sign(det) / det  # area / det^2
    if kappa is not None:
        scale = scale * kappa
    # g1 = (e1y, -e1x)/det, g2 = (-e0y, e0x)/det, g0 = -(g1 + g2)
    g12 = -(e1y * e0y + e1x * e0x)  # det^2 * (g1 . g2)
    g11 = e1y * e1y + e1x * e1x
    g22 = e0y * e0y + e0x * e0x
    s12 = scale * g12
    s01 = scale * (-(g11 + g12))  # g0 . g1 = -(g1.g1 + g2.g1)
    s02 = scale * (-(g12 + g22))
    return s01, s02, s12


def p1_general_soa(x, y, c0, c1, c2, kxx=None, kxy=None, kyy=None,
                   bx=None, by=None, react=None):
    """Per-cell primitives of the general P1 advection-diffusion-reaction
    local matrix, all SoA (cell axis last).

    Weak form (reference sign conventions, operators/{diffusion,advection,
    reaction}.h:32-56 with the leading minus inside the diffusion leaf):

        A_ij = area * (g_i . K g_j)  +  (area/3) * (b . g_j)  +
               c * area/12 * (1 + delta_ij)

    g_i = P1 barycentric gradients (constant per cell), K the (symmetric)
    diffusion tensor, b the advection vector, c the reaction coefficient —
    each a per-cell (C,) array (midpoint/centroid coefficient sampling) or
    None. kxx alone = isotropic scalar diffusivity.

    Returns (sd, w, r): sd (3, C) diffusion off-diagonals (s01, s02, s12;
    diagonals from zero row sums), w (3, C) advection row-constant column
    weights w_j = (area/3)(b . g_j) or None, r (C,) reaction weight
    c*area/12 or None. Closed forms exact for per-cell-constant
    coefficients (P1 integrands are degree <= 2; cf. the 3-pt rule the
    host assembler uses, integrator_tables.h 2D order-1).
    """
    x0, x1, x2 = x[c0], x[c1], x[c2]
    y0, y1, y2 = y[c0], y[c1], y[c2]
    e0x, e0y = x1 - x0, y1 - y0
    e1x, e1y = x2 - x0, y2 - y0
    det = e0x * e1y - e0y * e1x
    sgn = jnp.sign(det)
    scale = 0.5 * sgn / det  # area / det^2
    # det * gradients: G1 = (e1y, -e1x), G2 = (-e0y, e0x), G0 = -(G1 + G2)
    g1x, g1y = e1y, -e1x
    g2x, g2y = -e0y, e0x
    g0x, g0y = -(g1x + g2x), -(g1y + g2y)
    if kxx is None:
        kxx = 1.0
    if kyy is None:
        kyy = kxx  # isotropic when only kxx given
    if kxy is None:
        kxy = 0.0
    # K G_j (times det)
    def KG(gx, gy):
        return kxx * gx + kxy * gy, kxy * gx + kyy * gy

    k1x, k1y = KG(g1x, g1y)
    k2x, k2y = KG(g2x, g2y)
    s01 = scale * (g0x * k1x + g0y * k1y)
    s02 = scale * (g0x * k2x + g0y * k2y)
    s12 = scale * (g1x * k2x + g1y * k2y)
    sd = jnp.stack([s01, s02, s12])

    w = None
    if bx is not None or by is not None:
        bx = 0.0 if bx is None else bx
        by = 0.0 if by is None else by
        # (area/3)(b . g_j) = sgn/6 * (b . G_j)
        w = jnp.stack([
            (sgn / 6.0) * (bx * g0x + by * g0y),
            (sgn / 6.0) * (bx * g1x + by * g1y),
            (sgn / 6.0) * (bx * g2x + by * g2y),
        ])

    r = None
    if react is not None:
        area = 0.5 * sgn * det
        r = react * area / 12.0
    return sd, w, r


def build_adjacency_soa(flat, n_dofs: int, max_degree: int):
    """(D, n) ELL incidence table of a flat slot-major position array.

    flat: (P,) dof id of each element-local position (P = nb * C,
    position p = slot * C + cell). Returns adj (D, n) int32 indices into
    (P,), mask (D, n) bool, overflowed (traced bool).
    """
    order = jnp.argsort(flat, stable=True).astype(jnp.int32)
    sorted_d = flat[order]
    ids = jnp.arange(n_dofs, dtype=flat.dtype)
    starts = jnp.searchsorted(sorted_d, ids)
    ends = jnp.searchsorted(sorted_d, ids + 1)
    counts = ends - starts
    k = jnp.arange(max_degree, dtype=jnp.int32)[:, None]
    idx = starts[None, :] + k
    mask = k < counts[None, :]
    adj = order[jnp.clip(idx, 0, flat.shape[0] - 1)]
    return adj, mask, jnp.any(counts > max_degree)


@jax.tree_util.register_pytree_node_class
class MatrixFreeSoA:
    """Matrix-free P1 diffusion operator in SoA layout.

    s: (3, C) off-diagonals (s01, s02, s12); c: (3, C) corner indices;
    adj/adj_mask: (D, n) slot-major incidence table. Operator protocol
    (@, diagonal) compatible with fem/solvers.DirichletSystem.
    """

    def __init__(self, s, c, adj, adj_mask, n_dofs: int, w=None, r=None):
        self.s = s
        self.c = c
        self.adj = adj
        self.adj_mask = adj_mask
        self.n_dofs = n_dofs
        self.w = w  # (3, C) advection column weights or None
        self.r = r  # (C,) reaction weight or None

    def tree_flatten(self):
        return (self.s, self.c, self.adj, self.adj_mask, self.w,
                self.r), (self.n_dofs,)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        s, c, adj, adj_mask, w, r = leaves
        return cls(s, c, adj, adj_mask, *aux, w=w, r=r)

    @classmethod
    def build(cls, x, y, c0, c1, c2, n_dofs: int, max_degree: int,
              kappa=None):
        s01, s02, s12 = p1_offdiag_soa(x, y, c0, c1, c2, kappa)
        s = jnp.stack([s01, s02, s12])
        c = jnp.stack([c0, c1, c2])
        flat = c.reshape(-1)  # slot-major: position = slot * C + cell
        adj, mask, over = build_adjacency_soa(flat, n_dofs, max_degree)
        return cls(s, c, adj, mask, n_dofs), over

    @classmethod
    def build_general(cls, x, y, c0, c1, c2, n_dofs: int, max_degree: int,
                      kxx=None, kxy=None, kyy=None, bx=None, by=None,
                      react=None):
        """General advection-diffusion-reaction P1 operator (the
        fem_assembler.h:63-118 capability envelope at device scale);
        non-symmetric when b is given — solve with bicgstab/gmres."""
        sd, w, r = p1_general_soa(x, y, c0, c1, c2, kxx, kxy, kyy,
                                  bx, by, react)
        c = jnp.stack([c0, c1, c2])
        flat = c.reshape(-1)
        adj, mask, over = build_adjacency_soa(flat, n_dofs, max_degree)
        return cls(sd, c, adj, mask, n_dofs, w=w, r=r), over

    @property
    def is_symmetric(self):
        return self.w is None

    @property
    def shape(self):
        return (self.n_dofs, self.n_dofs)

    def _entries(self):
        """The 9 local-matrix entry arrays, (3, 3) of (C,), incl. the
        advection/reaction contributions when present."""
        s01, s02, s12 = self.s[0], self.s[1], self.s[2]
        a00 = -(s01 + s02)
        a11 = -(s01 + s12)
        a22 = -(s02 + s12)
        A = [[a00, s01, s02], [s01, a11, s12], [s02, s12, a22]]
        if self.w is not None:
            for i in range(3):
                for j in range(3):
                    A[i][j] = A[i][j] + self.w[j]
        if self.r is not None:
            for i in range(3):
                for j in range(3):
                    A[i][j] = A[i][j] + (2.0 if i == j else 1.0) * self.r
        return A

    def __matmul__(self, v):
        xe = [v[self.c[j]] for j in range(3)]  # three (C,) gathers
        s01, s02, s12 = self.s[0], self.s[1], self.s[2]
        ye = [
            -(s01 + s02) * xe[0] + s01 * xe[1] + s02 * xe[2],
            s01 * xe[0] - (s01 + s12) * xe[1] + s12 * xe[2],
            s02 * xe[0] + s12 * xe[1] - (s02 + s12) * xe[2],
        ]
        if self.w is not None:  # row-constant: one shared dot per cell
            adv = (self.w[0] * xe[0] + self.w[1] * xe[1]
                   + self.w[2] * xe[2])
            ye = [y + adv for y in ye]
        if self.r is not None:
            sx = xe[0] + xe[1] + xe[2]
            ye = [y + self.r * (sx + xe[i]) for i, y in enumerate(ye)]
        flat = jnp.concatenate(ye)  # slot-major (3C,)
        gat = flat[self.adj] * self.adj_mask.astype(flat.dtype)
        return gat.sum(axis=0)

    def diagonal(self):
        s01, s02, s12 = self.s[0], self.s[1], self.s[2]
        d = [-(s01 + s02), -(s01 + s12), -(s02 + s12)]
        if self.w is not None:
            d = [d[i] + self.w[i] for i in range(3)]
        if self.r is not None:
            d = [di + 2.0 * self.r for di in d]
        dloc = jnp.concatenate(d)
        gat = dloc[self.adj] * self.adj_mask.astype(dloc.dtype)
        return gat.sum(axis=0)

    def astype(self, dtype):
        return MatrixFreeSoA(
            self.s.astype(dtype), self.c, self.adj, self.adj_mask,
            self.n_dofs,
            w=None if self.w is None else self.w.astype(dtype),
            r=None if self.r is None else self.r.astype(dtype),
        )

    def to_ell(self, max_cols: int):
        """Assembled (K, n) row-ELL (see ops/ell.ELLMatrix.from_local; same
        sorted-merge, SoA layout: every transient is (nb*D, n))."""
        return _ell_from_entries(self._entries(), self.c, self.adj,
                                 self.adj_mask, self.n_dofs, max_cols)


def _compact_sorted(cols_all, vals_all, row_ids, n_sentinel: int,
                    max_cols: int):
    """Compact (M, B) column-duplicated candidates into (K, B) ELL rows.

    SCATTER-FREE: a multi-operand `lax.sort` co-sorts (cols, vals) along
    the candidate axis (a compare-exchange network — no argsort + gather,
    which ran near-scalar and dominated the 10M-row conversion at ~64 s),
    then K masked reductions over the size-M axis replace the old
    segment_sum/segment_max scatters (the other near-scalar half).
    Padding carries col = n_sentinel; empty slots fall back to
    (col=row_ids, val=0). Returns (vals (K,B), cols (K,B), overflowed).
    """
    K = max_cols
    cols_s, vals_s = jax.lax.sort(
        (cols_all, vals_all), dimension=0, num_keys=1
    )
    first = jnp.concatenate(
        [jnp.ones((1, cols_s.shape[1]), bool), cols_s[1:] != cols_s[:-1]],
        axis=0,
    )
    real = cols_s < n_sentinel
    uidx = jnp.cumsum(first.astype(jnp.int32), axis=0) - 1
    overflowed = jnp.any(real & (uidx >= K))
    vals_rows, cols_rows = [], []
    for k in range(K):
        mk = real & (uidx == k)
        vals_rows.append(jnp.sum(jnp.where(mk, vals_s, 0.0), axis=0))
        ck = jnp.max(jnp.where(mk, cols_s, -1), axis=0)
        cols_rows.append(jnp.where(ck < 0, row_ids, ck).astype(jnp.int32))
    return jnp.stack(vals_rows), jnp.stack(cols_rows), overflowed


def _ell_from_entries(A, dofs, adj, adj_mask, n_dofs: int, max_cols: int):
    """Assemble an ELLSoA from nb x nb local-entry arrays.

    A: nested list, A[i][j] the (C,) local entry (row slot i, col slot j);
    dofs: (nb, C) global dof id per slot; adj/adj_mask: (D, n) slot-major
    incidence (positions p = slot * C + cell). Sorted-merge per row:
    transients are (nb*D, n). Returns (ELLSoA, overflowed).
    """
    nb = len(A)
    n = n_dofs
    C = dofs.shape[1]
    cell = adj % C  # (D, n)
    slot = adj // C
    aflat = jnp.concatenate(
        [A[i][j] for i in range(nb) for j in range(nb)]
    )  # (nb*nb*C,) entry (i, j) at offset (nb*i + j) * C
    cols_b, vals_b = [], []
    for j in range(nb):
        cols_b.append(jnp.where(adj_mask, dofs[j][cell], n))
        vals_b.append(
            jnp.where(adj_mask, aflat[(slot * nb + j) * C + cell], 0.0)
        )
    cols_all = jnp.concatenate(cols_b, axis=0)  # (nb*D, n)
    vals_all = jnp.concatenate(vals_b, axis=0)
    col_ids = jnp.arange(n, dtype=jnp.int32)
    vals, cols, overflowed = _compact_sorted(
        cols_all, vals_all, col_ids, n, max_cols
    )
    return ELLSoA(vals, cols, (n, n)), overflowed


@jax.tree_util.register_pytree_node_class
class ELLSoA:
    """Assembled row-ELL in SoA layout: vals/cols (K, n), padded entries
    carry col = row id and val = 0 (no mask needed in the SpMV)."""

    def __init__(self, vals, cols, shape):
        self.vals = vals
        self.cols = cols
        self.shape = shape

    def tree_flatten(self):
        return (self.vals, self.cols), (self.shape,)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves, *aux)

    def __matmul__(self, v):
        acc = None
        for k in range(self.vals.shape[0]):  # K slices of 1-D gathers
            t = self.vals[k] * v[self.cols[k]]
            acc = t if acc is None else acc + t
        return acc

    def diagonal(self):
        rows = jnp.arange(self.shape[0], dtype=self.cols.dtype)[None, :]
        return jnp.where(self.cols == rows, self.vals, 0.0).sum(axis=0)

    def astype(self, dtype):
        return ELLSoA(self.vals.astype(dtype), self.cols, self.shape)

    def with_added_diagonal(self, d):
        """A + diag(d): only the first (row == col) slot per row changes
        (padding also carries col = row but with val 0 AFTER real entries;
        the conversion sorts real columns first, and the diagonal is
        always structurally present in FEM operators)."""
        n = self.shape[0]
        rows = jnp.arange(n, dtype=self.cols.dtype)[None, :]
        isdiag = self.cols == rows
        first = isdiag & (jnp.cumsum(isdiag, axis=0) == 1)
        vals = self.vals + jnp.where(first, jnp.asarray(d)[None, :], 0.0)
        return ELLSoA(vals, self.cols, self.shape)


# ---------------------------------------------------------------------------
# P2 at device scale: universal coefficient tables
# ---------------------------------------------------------------------------
#
# On an affine triangle every P2 weak-form integral reduces to per-cell
# SCALARS times universal rational tables: with S_pq = area * (g_p . K g_q)
# (zero row sums since sum_p g_p = 0), the 6x6 diffusion matrix is
# A = sum_e S_e * T_e over the three off-diagonal directions e; advection
# is A = sum_q w_q * E_q with w_q = area * (b . g_q); mass is c*area * M.
# The tables come from the exact barycentric monomial integral
# int_T l0^a l1^b l2^c = 2|T| a! b! c! / (a+b+c+2)!  — so the P2 operator
# stores the SAME 3 per-cell scalars as P1 (plus dof ids), and the local
# 6x6 is reconstructed in-register during the SpMV.
# (Replaces the reference's per-element Vandermonde basis + quadrature
# loop, lagrangian_basis.h:65-91 + fem_assembler.h:79-110, for order 2.)
# Local dof order: vertices 0,1,2 then edges (0,1),(0,2),(1,2) — the lex
# `combinations` parity order (geometry conventions, CLAUDE.md).


def _p2_tables():
    import numpy as np
    from math import factorial

    basis = []
    for a in range(3):  # vertex a: l_a (2 l_a - 1)
        e1 = [0, 0, 0]
        e1[a] = 1
        e2 = [0, 0, 0]
        e2[a] = 2
        basis.append({tuple(e2): 2.0, tuple(e1): -1.0})
    for a, b in ((0, 1), (0, 2), (1, 2)):  # edge {a,b}: 4 l_a l_b
        e = [0, 0, 0]
        e[a] += 1
        e[b] += 1
        basis.append({tuple(e): 4.0})

    def dpoly(p, k):
        out = {}
        for m, c in p.items():
            if m[k]:
                m2 = list(m)
                m2[k] -= 1
                key = tuple(m2)
                out[key] = out.get(key, 0.0) + c * m[k]
        return out

    def pmul(p, q):
        out = {}
        for m1, c1 in p.items():
            for m2, c2 in q.items():
                m = (m1[0] + m2[0], m1[1] + m2[1], m1[2] + m2[2])
                out[m] = out.get(m, 0.0) + c1 * c2
        return out

    def pint(p):  # integral over the cell / area
        return sum(
            c * 2.0 * factorial(m[0]) * factorial(m[1]) * factorial(m[2])
            / factorial(m[0] + m[1] + m[2] + 2)
            for m, c in p.items()
        )

    D = np.zeros((3, 3, 6, 6))
    grads = [[dpoly(basis[a], p) for p in range(3)] for a in range(6)]
    for p in range(3):
        for q in range(3):
            for a in range(6):
                for b in range(6):
                    D[p, q, a, b] = pint(pmul(grads[a][p], grads[b][q]))
    T = np.stack([
        D[p, q] + D[q, p] - D[p, p] - D[q, q]
        for p, q in ((0, 1), (0, 2), (1, 2))
    ])
    E = np.zeros((3, 6, 6))
    for q in range(3):
        for a in range(6):
            for b in range(6):
                E[q, a, b] = pint(pmul(basis[a], grads[b][q]))
    M = np.zeros((6, 6))
    for a in range(6):
        for b in range(6):
            M[a, b] = pint(pmul(basis[a], basis[b]))
    return T, E, M


_P2_T, _P2_E, _P2_M = _p2_tables()


def p2_primitives_soa(x, y, c0, c1, c2, kxx=None, kxy=None, kyy=None,
                      bx=None, by=None, react=None):
    """Per-cell P2 primitives: (s (3,C), wq (3,C) or None, r (C,) or None).

    s_e = area * (g_p . K g_q) for e = (0,1),(0,2),(1,2) — identical to the
    P1 off-diagonals; wq_q = area * (b . g_q); r = c * area.
    """
    sd, _, _ = p1_general_soa(x, y, c0, c1, c2, kxx, kxy, kyy)
    x0, x1, x2 = x[c0], x[c1], x[c2]
    y0, y1, y2 = y[c0], y[c1], y[c2]
    e0x, e0y = x1 - x0, y1 - y0
    e1x, e1y = x2 - x0, y2 - y0
    det = e0x * e1y - e0y * e1x
    sgn = jnp.sign(det)
    wq = None
    if bx is not None or by is not None:
        bx = 0.0 if bx is None else bx
        by = 0.0 if by is None else by
        g1x, g1y = e1y, -e1x
        g2x, g2y = -e0y, e0x
        g0x, g0y = -(g1x + g2x), -(g1y + g2y)
        # area * (b . g_q) = sgn/2 * (b . G_q)
        wq = jnp.stack([
            (sgn / 2.0) * (bx * g0x + by * g0y),
            (sgn / 2.0) * (bx * g1x + by * g1y),
            (sgn / 2.0) * (bx * g2x + by * g2y),
        ])
    r = None
    if react is not None:
        r = react * (0.5 * sgn * det)
    return sd, wq, r


@jax.tree_util.register_pytree_node_class
class MatrixFreeP2SoA:
    """Matrix-free P2 advection-diffusion-reaction operator, SoA layout.

    s: (3, C) diffusion primitives; dofs: (6, C) global dof ids (vertices
    then lex edges — fem/space.FEMSpace order-2 cell_dofs transposed);
    adj/adj_mask: (D, n) slot-major incidence over the (6C,) positions;
    wq: (3, C) advection primitives or None; r: (C,) reaction primitive or
    None. The 6x6 local matrix is reconstructed from universal tables
    during each SpMV — same storage as P1.
    """

    NB = 6

    def __init__(self, s, dofs, adj, adj_mask, n_dofs: int, wq=None,
                 r=None):
        self.s = s
        self.dofs = dofs
        self.adj = adj
        self.adj_mask = adj_mask
        self.n_dofs = n_dofs
        self.wq = wq
        self.r = r

    def tree_flatten(self):
        return (self.s, self.dofs, self.adj, self.adj_mask, self.wq,
                self.r), (self.n_dofs,)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        s, dofs, adj, adj_mask, wq, r = leaves
        return cls(s, dofs, adj, adj_mask, *aux, wq=wq, r=r)

    @classmethod
    def build(cls, x, y, dofs, n_dofs: int, max_degree: int,
              kxx=None, kxy=None, kyy=None, bx=None, by=None, react=None):
        """dofs: (6, C) int32; vertex coordinate lookups use rows 0..2
        (vertex dof id == node id, FEMSpace P1-node-first enumeration)."""
        sd, wq, r = p2_primitives_soa(x, y, dofs[0], dofs[1], dofs[2],
                                      kxx, kxy, kyy, bx, by, react)
        flat = dofs.reshape(-1)  # slot-major: position = slot * C + cell
        adj, mask, over = build_adjacency_soa(flat, n_dofs, max_degree)
        return cls(sd, dofs, adj, mask, n_dofs, wq=wq, r=r), over

    @property
    def shape(self):
        return (self.n_dofs, self.n_dofs)

    @property
    def is_symmetric(self):
        return self.wq is None

    def _entry(self, a, b):
        ent = None
        for e in range(3):
            cf = float(_P2_T[e, a, b])
            if abs(cf) > 1e-14:
                t = cf * self.s[e]
                ent = t if ent is None else ent + t
        if self.wq is not None:
            for q in range(3):
                cf = float(_P2_E[q, a, b])
                if abs(cf) > 1e-14:
                    ent = (ent if ent is not None else 0.0) \
                        + cf * self.wq[q]
        if self.r is not None:
            cf = float(_P2_M[a, b])
            if abs(cf) > 1e-14:
                ent = (ent if ent is not None else 0.0) + cf * self.r
        if ent is None:
            ent = jnp.zeros_like(self.s[0])
        return ent

    def _entries(self):
        return [[self._entry(a, b) for b in range(6)] for a in range(6)]

    def __matmul__(self, v):
        xe = [v[self.dofs[b]] for b in range(6)]  # six (C,) gathers
        ye = []
        for a in range(6):
            acc = None
            for b in range(6):
                t = self._entry(a, b) * xe[b]
                acc = t if acc is None else acc + t
            ye.append(acc)
        flat = jnp.concatenate(ye)  # slot-major (6C,)
        gat = flat[self.adj] * self.adj_mask.astype(flat.dtype)
        return gat.sum(axis=0)

    def diagonal(self):
        dloc = jnp.concatenate([self._entry(a, a) for a in range(6)])
        gat = dloc[self.adj] * self.adj_mask.astype(dloc.dtype)
        return gat.sum(axis=0)

    def astype(self, dtype):
        return MatrixFreeP2SoA(
            self.s.astype(dtype), self.dofs, self.adj, self.adj_mask,
            self.n_dofs,
            wq=None if self.wq is None else self.wq.astype(dtype),
            r=None if self.r is None else self.r.astype(dtype),
        )

    def to_ell(self, max_cols: int):
        return _ell_from_entries(self._entries(), self.dofs, self.adj,
                                 self.adj_mask, self.n_dofs, max_cols)


# ---------------------------------------------------------------------------
# blocked ELL conversion: bounded device programs
# ---------------------------------------------------------------------------
#
# The fused _ell_from_entries program at 10M+ rows holds (nb*D, n)
# transients (a 246M-element gather + scatter cascade). Rows are
# INDEPENDENT in the conversion, so it blocks cleanly: one compiled
# per-block program executed `blocks` times + one concat, with transients
# bounded by the block size.

import functools as _functools


@_functools.partial(jax.jit, static_argnums=(4, 5, 6))
def _ell_block_core(aflat, dofs, adj_pad, mask_pad, B, K, n_dofs, s0):
    """ELL conversion of rows [s0, s0+B) (same math as _ell_from_entries)."""
    nb = dofs.shape[0]
    C = dofs.shape[1]
    n = n_dofs
    adj = jax.lax.dynamic_slice_in_dim(adj_pad, s0, B, axis=1)
    mask = jax.lax.dynamic_slice_in_dim(mask_pad, s0, B, axis=1)
    cell = adj % C
    slot = adj // C
    cols_b, vals_b = [], []
    for j in range(nb):
        cols_b.append(jnp.where(mask, dofs[j][cell], n))
        vals_b.append(
            jnp.where(mask, aflat[(slot * nb + j) * C + cell], 0.0)
        )
    cols_all = jnp.concatenate(cols_b, axis=0)  # (nb*D, B)
    vals_all = jnp.concatenate(vals_b, axis=0)
    col_global = s0 + jnp.arange(B, dtype=jnp.int32)
    vals, cols, overflowed = _compact_sorted(
        cols_all, vals_all, col_global, n, K
    )
    return vals, cols, overflowed


@jax.jit
def _ell_aflat(op):
    A = op._entries()
    nb = len(A)
    return jnp.concatenate([A[i][j] for i in range(nb) for j in range(nb)])


@_functools.partial(jax.jit, static_argnums=(0,))
def _ell_concat(n, vals_list, cols_list, over_list):
    vals = jnp.concatenate(vals_list, axis=1)[:, :n]
    cols = jnp.concatenate(cols_list, axis=1)[:, :n]
    cols = jnp.minimum(cols, n - 1)  # padded-block fallback ids clamp
    over = jnp.stack(over_list).any()
    return vals, cols, over


def ell_from_op_blocked(op, max_cols: int, blocks: int = 8):
    """Host-staged `to_ell`: identical result, split into `blocks` bounded
    device programs over independent row blocks. NOT for use inside jit —
    this is the bounded-memory path for 10M+-row conversions; use
    `op.to_ell(max_cols)` inside jitted pipelines at moderate sizes.
    Returns (ELLSoA, overflowed bool array).
    """
    n = op.n_dofs
    dofs = op.c if hasattr(op, "c") else op.dofs
    D = op.adj.shape[0]
    B = -(-n // blocks)
    pad = blocks * B - n

    @jax.jit
    def pad_adj(adj, mask):
        return (
            jnp.pad(adj, ((0, 0), (0, pad))),
            jnp.pad(mask, ((0, 0), (0, pad))),
        )

    adj_pad, mask_pad = pad_adj(op.adj, op.adj_mask)
    aflat = _ell_aflat(op)
    vals_l, cols_l, over_l = [], [], []
    for kblk in range(blocks):
        v, c, o = _ell_block_core(
            aflat, dofs, adj_pad, mask_pad, B, int(max_cols), int(n),
            jnp.int32(kblk * B),
        )
        vals_l.append(v)
        cols_l.append(c)
        over_l.append(o)
    vals, cols, over = _ell_concat(
        int(n), tuple(vals_l), tuple(cols_l), tuple(over_l)
    )
    return ELLSoA(vals, cols, (n, n)), over


# ---------------------------------------------------------------------------
# 3D SoA: the tet general path in device-scale layouts
# ---------------------------------------------------------------------------
#
# The AoS tet forms (ops/matfree.p1_local_stiffness_3d: (C, 4, 4) local
# matrices, (C, 4) dof tables) hit the same HBM tiling wall as the 2D AoS
# pipeline, only worse: a minor axis of 4 pads 8x128/4 = 64x, so a 12M-tet
# local-stiffness array alone would claim ~50 GB. Everything below keeps
# the cell axis LAST: per-corner (C,) gathers, six off-diagonal stencil
# arrays (diagonals from the zero row sums of the diffusion part), the
# shared (D, n) slot-major incidence table, assembled (K, n) ELL.


def p1_general_soa_3d(x, y, z, c0, c1, c2, c3, kxx=None, kxy=None, kxz=None,
                      kyy=None, kyz=None, kzz=None, bx=None, by=None,
                      bz=None, react=None):
    """Per-cell primitives of the general P1 tet advection-diffusion-
    reaction local matrix, all SoA (cell axis last).

    Weak form (reference sign conventions, operators/{diffusion,advection,
    reaction}.h:32-56):

        A_ij = vol * (g_i . K g_j) + (vol/4) * (b . g_j)
             + c * vol/20 * (1 + delta_ij)

    g_i = P1 barycentric gradients (constant per tet): with edge vectors
    e_k = p_k - p_0 and det = e1 . (e2 x e3), the scaled gradients are
    G1 = e2 x e3, G2 = e3 x e1, G3 = e1 x e2, G0 = -(G1 + G2 + G3), and
    g_i = G_i / det (rows of the inverse Jacobian, simplex.h:184-195).
    The reaction table is the exact tet mass integral
    int_T l_i l_j = vol/20 (i != j), vol/10 (i = i).

    Returns (sd, w, r): sd (6, C) diffusion off-diagonals in pair order
    (01, 02, 03, 12, 13, 23); w (4, C) advection row-constant column
    weights w_j = (vol/4)(b . g_j) or None; r (C,) reaction weight
    c*vol/20 or None. Closed forms exact for per-cell-constant
    coefficients (cf. integrator_tables.h 3D order-1 centroid rule).
    """
    x0, x1, x2, x3 = x[c0], x[c1], x[c2], x[c3]
    y0, y1, y2, y3 = y[c0], y[c1], y[c2], y[c3]
    z0, z1, z2, z3 = z[c0], z[c1], z[c2], z[c3]
    e1 = (x1 - x0, y1 - y0, z1 - z0)
    e2 = (x2 - x0, y2 - y0, z2 - z0)
    e3 = (x3 - x0, y3 - y0, z3 - z0)

    def cross(a, b):
        return (a[1] * b[2] - a[2] * b[1],
                a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0])

    def dot(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    G1 = cross(e2, e3)
    G2 = cross(e3, e1)
    G3 = cross(e1, e2)
    det = dot(e1, G1)  # 6 * signed volume
    sgn = jnp.sign(det)
    scale = sgn / (6.0 * det)  # vol / det^2

    if kxx is None:
        kxx = 1.0
    if kyy is None:
        kyy = kxx  # isotropic when only kxx given
    if kzz is None:
        kzz = kxx
    if kxy is None:
        kxy = 0.0
    if kxz is None:
        kxz = 0.0
    if kyz is None:
        kyz = 0.0

    def KG(g):
        return (kxx * g[0] + kxy * g[1] + kxz * g[2],
                kxy * g[0] + kyy * g[1] + kyz * g[2],
                kxz * g[0] + kyz * g[1] + kzz * g[2])

    K1, K2, K3 = KG(G1), KG(G2), KG(G3)
    K0 = tuple(-(a + b + c) for a, b, c in zip(K1, K2, K3))
    G0 = tuple(-(a + b + c) for a, b, c in zip(G1, G2, G3))
    sd = jnp.stack([
        scale * dot(G0, K1), scale * dot(G0, K2), scale * dot(G0, K3),
        scale * dot(G1, K2), scale * dot(G1, K3), scale * dot(G2, K3),
    ])
    del K0

    w = None
    if bx is not None or by is not None or bz is not None:
        bx = 0.0 if bx is None else bx
        by = 0.0 if by is None else by
        bz = 0.0 if bz is None else bz
        bvec = (bx, by, bz)
        # (vol/4)(b . g_j) = sgn/24 * (b . G_j)
        w = jnp.stack([(sgn / 24.0) * dot(bvec, G)
                       for G in (G0, G1, G2, G3)])

    r = None
    if react is not None:
        vol = sgn * det / 6.0
        r = react * vol / 20.0
    return sd, w, r


# pair order of the six off-diagonals and the three incident pairs per row
_TET_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


@jax.tree_util.register_pytree_node_class
class MatrixFreeSoA3D:
    """Matrix-free P1 tet operator in SoA layout (3D MatrixFreeSoA).

    s: (6, C) off-diagonals in _TET_PAIRS order; c: (4, C) corner indices;
    adj/adj_mask: (D, n) slot-major incidence table; w: (4, C) advection
    column weights or None; r: (C,) reaction weight or None. Operator
    protocol (@, diagonal, astype) compatible with
    fem/solvers.DirichletSystem and ops/ell_from_op_blocked.
    """

    def __init__(self, s, c, adj, adj_mask, n_dofs: int, w=None, r=None):
        self.s = s
        self.c = c
        self.adj = adj
        self.adj_mask = adj_mask
        self.n_dofs = n_dofs
        self.w = w
        self.r = r

    def tree_flatten(self):
        return (self.s, self.c, self.adj, self.adj_mask, self.w,
                self.r), (self.n_dofs,)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        s, c, adj, adj_mask, w, r = leaves
        return cls(s, c, adj, adj_mask, *aux, w=w, r=r)

    @classmethod
    def build(cls, x, y, z, c0, c1, c2, c3, n_dofs: int, max_degree: int,
              kappa=None):
        sd, _, _ = p1_general_soa_3d(x, y, z, c0, c1, c2, c3, kxx=kappa)
        c = jnp.stack([c0, c1, c2, c3])
        flat = c.reshape(-1)  # slot-major: position = slot * C + cell
        adj, mask, over = build_adjacency_soa(flat, n_dofs, max_degree)
        return cls(sd, c, adj, mask, n_dofs), over

    @classmethod
    def build_general(cls, x, y, z, c0, c1, c2, c3, n_dofs: int,
                      max_degree: int, kxx=None, kxy=None, kxz=None,
                      kyy=None, kyz=None, kzz=None, bx=None, by=None,
                      bz=None, react=None):
        """General tet advection-diffusion-reaction operator
        (fem_assembler.h:63-118 envelope in 3D at device scale);
        non-symmetric when b is given — solve with bicgstab/gmres."""
        sd, w, r = p1_general_soa_3d(x, y, z, c0, c1, c2, c3, kxx, kxy,
                                     kxz, kyy, kyz, kzz, bx, by, bz, react)
        c = jnp.stack([c0, c1, c2, c3])
        flat = c.reshape(-1)
        adj, mask, over = build_adjacency_soa(flat, n_dofs, max_degree)
        return cls(sd, c, adj, mask, n_dofs, w=w, r=r), over

    @property
    def is_symmetric(self):
        return self.w is None

    @property
    def shape(self):
        return (self.n_dofs, self.n_dofs)

    def _offdiag(self, i, j):
        return self.s[_TET_PAIRS.index((min(i, j), max(i, j)))]

    def _entries(self):
        """The 16 local-matrix entry arrays, (4, 4) of (C,)."""
        A = [[None] * 4 for _ in range(4)]
        for i in range(4):
            for j in range(4):
                if i != j:
                    A[i][j] = self._offdiag(i, j)
        for i in range(4):
            A[i][i] = -sum(A[i][j] for j in range(4) if j != i)
        if self.w is not None:
            for i in range(4):
                for j in range(4):
                    A[i][j] = A[i][j] + self.w[j]
        if self.r is not None:
            for i in range(4):
                for j in range(4):
                    A[i][j] = A[i][j] + (2.0 if i == j else 1.0) * self.r
        return A

    def __matmul__(self, v):
        xe = [v[self.c[j]] for j in range(4)]  # four (C,) gathers
        ye = []
        for i in range(4):
            off = [self._offdiag(i, j) for j in range(4) if j != i]
            xs = [xe[j] for j in range(4) if j != i]
            acc = -(off[0] + off[1] + off[2]) * xe[i]
            for sij, xj in zip(off, xs):
                acc = acc + sij * xj
            ye.append(acc)
        if self.w is not None:  # row-constant: one shared dot per cell
            adv = sum(self.w[j] * xe[j] for j in range(4))
            ye = [yi + adv for yi in ye]
        if self.r is not None:
            sx = xe[0] + xe[1] + xe[2] + xe[3]
            ye = [yi + self.r * (sx + xe[i]) for i, yi in enumerate(ye)]
        flat = jnp.concatenate(ye)  # slot-major (4C,)
        gat = flat[self.adj] * self.adj_mask.astype(flat.dtype)
        return gat.sum(axis=0)

    def diagonal(self):
        d = []
        for i in range(4):
            off = [self._offdiag(i, j) for j in range(4) if j != i]
            di = -(off[0] + off[1] + off[2])
            if self.w is not None:
                di = di + self.w[i]
            if self.r is not None:
                di = di + 2.0 * self.r
            d.append(di)
        dloc = jnp.concatenate(d)
        gat = dloc[self.adj] * self.adj_mask.astype(dloc.dtype)
        return gat.sum(axis=0)

    def astype(self, dtype):
        return MatrixFreeSoA3D(
            self.s.astype(dtype), self.c, self.adj, self.adj_mask,
            self.n_dofs,
            w=None if self.w is None else self.w.astype(dtype),
            r=None if self.r is None else self.r.astype(dtype),
        )

    def to_ell(self, max_cols: int):
        """Assembled (K, n) row-ELL (sorted-merge; transients (4*D, n))."""
        return _ell_from_entries(self._entries(), self.c, self.adj,
                                 self.adj_mask, self.n_dofs, max_cols)
