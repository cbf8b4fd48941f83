"""Banded-DIA + ELL-remainder split of assembled general sparse operators.

A gather SpMV reads a column index for every entry and gathers x through
it, while static 2D-grid stencil shifts stream the operator and x with no
index arrays at all. This module moves the general path onto stencil
shifts for BANDED matrices (any matrix after RCM reordering, parallel/reorder.py)
without assuming anything about the mesh:

1. Measure the flat offset histogram d = col - row of an assembled ELLSoA.
2. Pick a reshape width W = the dominant |offset| beyond the lane range.
   Viewing x as an (R, W) grid (R = ceil(n/W)), every flat offset
   d = a*W + b with small (a, b) becomes a STATIC 2D stencil shift —
   exactly the GridDIAMatrix form, served by slices at memory bandwidth.
3. Entries whose (a, b) fall outside the chosen stencil window, or whose
   lane position wraps (j + b outside [0, W)), stay in a small ELL
   REMAINDER evaluated by gathers.

For an RCM-banded FEM matrix the dominant offsets hug the bandwidth, so
the stencil window captures ~all entries and the remainder is O(R) lane-
wrap entries per layer. The split is exact: DIA part + remainder == the
input operator, verified by `tests/test_dia_split.py`.

Reference anchor: this is the index-free replacement for the assembled
CSR SpMV feeding Eigen's iterative solvers on arbitrary meshes
(fem_assembler.h:99-118 assembled operator; SpMV is the CG hot loop that
replaces SparseLU, fem_linear_elliptic_solver.h:38-47).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .grid_dia import GridDIAMatrix
from .grid_cg import stencil_matvec_padded
from .matfree_soa import ELLSoA

__all__ = ["BandedSplit", "BandedMGPreconditioner", "plan_split_width",
           "build_banded_split", "banded_cg"]


@jax.jit
def _bandwidth_jit(cols):
    n = cols.shape[1]
    rows = jnp.arange(n, dtype=cols.dtype)[None, :]
    return jnp.max(jnp.abs(cols - rows))


@functools.partial(jax.jit, static_argnums=(2,))
def _band_hist_jit(cols, vals, B):
    """Offset histogram of REAL entries (padding carries col = row)."""
    n = cols.shape[1]
    rows = jnp.arange(n, dtype=cols.dtype)[None, :]
    d = cols - rows
    dreal = jnp.where(vals != 0.0, d, B + 1 + B)  # park padding out of range
    return jnp.bincount(
        jnp.clip(dreal + B, 0, 2 * B + 1).reshape(-1), length=2 * B + 2
    )


@functools.partial(jax.jit, static_argnums=(2,))
def _band_probe_jit(cols, vals, Bcap):
    """Fused bandwidth + capped histogram: ONE device program. Valid
    when the returned B <= Bcap; the caller falls back to the exact
    two-program path otherwise."""
    n = cols.shape[1]
    rows = jnp.arange(n, dtype=cols.dtype)[None, :]
    d = cols - rows
    B = jnp.max(jnp.abs(d))
    dreal = jnp.where(vals != 0.0, d, Bcap + 1 + Bcap)
    hist = jnp.bincount(
        jnp.clip(dreal + Bcap, 0, 2 * Bcap + 1).reshape(-1),
        length=2 * Bcap + 2,
    )
    return B, hist


def plan_split_width(E: ELLSoA, bmax: int = 1, min_frac: float = 0.02,
                     max_hist: int = 1 << 24, max_amax: int = 2,
                     min_cover: float = 0.98, bcap: int = 8192):
    """Choose the reshape width W from the offset histogram (host fetch).

    Returns (W, amax) or (None, 0) when the matrix has no dominant band
    (stay with plain ELL). ONE device program + host fetch in the common
    B <= bcap case (a fused bandwidth+capped-histogram probe); wide bands
    fall back to the exact two-program path.

    The plan is only accepted when the {a*W + b : |a| <= amax, |b| <= bmax}
    window COVERS >= min_cover of the real entries: a scattered RCM band
    (e.g. genuine Delaunay, where every offset in [-B, B] appears a
    little) would otherwise yield an absurd window (hundreds of layers =
    hundreds of full grid passes per SpMV). Concentrated histograms —
    quasi-uniform meshes, tensor grids, extruded meshes — pass; for the
    rest the assembled-ELL / aux-grid path stays the answer.
    """
    import numpy as np

    n = E.shape[0]
    Bd, hist_cap = _band_probe_jit(E.cols, E.vals, bcap)
    B = int(Bd)
    if B <= bmax or 2 * B + 1 > max_hist:
        return None, 0
    if B <= bcap:
        hist = np.array(hist_cap)[bcap - B: bcap + B + 1]
    else:
        hist = np.array(_band_hist_jit(E.cols, E.vals, B))[: 2 * B + 1]
    total = hist.sum()
    center = hist[B]
    hist[B] = 0  # the main diagonal is always captured; never a W
    offs = np.nonzero(hist >= max(1, int(min_frac * n)))[0] - B
    offs = offs[np.abs(offs) > bmax]
    if offs.size == 0 or total == 0:
        return None, 0
    W = int(np.abs(offs[np.argmax(hist[offs + B])]))
    amax = max(1, int(round(B / W)))
    if amax > max_amax:
        return None, 0
    window = [a * W + b
              for a in range(-amax, amax + 1) for b in range(-bmax, bmax + 1)]
    cover = center + sum(
        hist[dd + B] for dd in window if -B <= dd <= B and dd != 0
    )
    if cover < min_cover * total:
        return None, 0
    return W, amax


def build_banded_split(E: ELLSoA, W: int, amax: int = 1, bmax: int = 1,
                       max_rem: int = 2):
    """Split an assembled ELLSoA into GridDIA((R, W)) + ELL remainder.

    Jittable for a STATIC (W, amax, bmax, max_rem). Returns
    (BandedSplit, rem_overflowed) — overflow means some row has more than
    `max_rem` unclaimed entries (rebuild with a larger bound; the result's
    remainder is truncated).
    """
    K, n = E.vals.shape
    R = -(-n // W)
    rows = jnp.arange(n, dtype=E.cols.dtype)[None, :]
    d = E.cols - rows
    j = rows % W  # lane position of each row
    offsets2d = tuple(
        (a, b) for a in range(-amax, amax + 1) for b in range(-bmax, bmax + 1)
    )
    layers = []
    claimed = jnp.zeros_like(E.cols, dtype=bool)
    for (a, b) in offsets2d:
        delta = a * W + b
        m = (d == delta) & (j + b >= 0) & (j + b < W)
        layer = jnp.where(m, E.vals, 0.0).sum(axis=0)  # <=1 match per row
        claimed = claimed | m
        layers.append(jnp.pad(layer, (0, R * W - n)).reshape(R, W))
    G = GridDIAMatrix(jnp.stack(layers), offsets2d, (R, W))

    # remainder compaction: unclaimed real entries -> first max_rem slots
    # (ELLSoA padding convention: col = row, val = 0)
    drop = claimed | (E.vals == 0.0)
    rc = jnp.where(drop, n, E.cols)
    rv = jnp.where(drop, 0.0, E.vals)
    order = jnp.argsort(rc, axis=0)
    rc = jnp.take_along_axis(rc, order, axis=0)
    rv = jnp.take_along_axis(rv, order, axis=0)
    overflowed = jnp.any(rc[max_rem:] < n) if max_rem < K else jnp.array(False)
    rc = rc[:max_rem]
    rv = rv[:max_rem]
    rows1 = jnp.broadcast_to(rows.astype(jnp.int32), rc.shape)
    rem = ELLSoA(rv, jnp.where(rc == n, rows1, rc).astype(jnp.int32),
                 (n, n))
    return BandedSplit(G, rem, n), overflowed


@jax.tree_util.register_pytree_node_class
class BandedSplit:
    """y = (GridDIA over the (R, W) reshape) x + (ELL remainder) x.

    Satisfies the operator protocol (@, diagonal, astype) of
    fem/solvers.DirichletSystem; `fold_dirichlet` bakes the masking into
    the stencil data so the CG hot loop (banded_cg) touches no masks.
    """

    def __init__(self, G: GridDIAMatrix, rem: ELLSoA | None, n: int):
        self.G = G
        self.rem = rem  # None: band captured every entry (rem_nnz == 0)
        self.n = n

    def tree_flatten(self):
        return (self.G, self.rem), (self.n,)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves, *aux)

    @property
    def shape(self):
        return (self.n, self.n)

    def drop_empty_remainder(self):
        """Band-only operator (host decision after checking rem_nnz == 0):
        the remainder's gathers are the SpMV's dominant cost at 10M rows
        (~2n gathered elements vs pure static slices) — never pay them to
        multiply zeros."""
        return BandedSplit(self.G, None, self.n)

    def __matmul__(self, v):
        R, W = self.G.shape2d
        vg = jnp.pad(v, (0, R * W - self.n))
        y = (self.G @ vg)[: self.n]
        return y if self.rem is None else y + self.rem @ v

    def diagonal(self):
        k0 = self.G.offsets2d.index((0, 0))
        d = self.G.data[k0].reshape(-1)[: self.n]
        return d if self.rem is None else d + self.rem.diagonal()

    def astype(self, dtype):
        return BandedSplit(
            GridDIAMatrix(self.G.data.astype(dtype), self.G.offsets2d,
                          self.G.shape2d),
            None if self.rem is None else self.rem.astype(dtype), self.n,
        )

    def with_added_diagonal(self, d):
        """A + diag(d) — the implicit-Euler shift (A + M_lumped/dt) stays a
        BandedSplit: only the center layer changes."""
        R, W = self.G.shape2d
        k0 = self.G.offsets2d.index((0, 0))
        dg = jnp.pad(jnp.asarray(d, self.G.data.dtype),
                     (0, R * W - self.n)).reshape(R, W)
        data = self.G.data.at[k0].add(dg)
        return BandedSplit(GridDIAMatrix(data, self.G.offsets2d,
                                         self.G.shape2d), self.rem, self.n)

    def fold_dirichlet(self, mask):
        """A' = F A F + (I - F) with F = diag(~mask): the stencil layers are
        masked via GridDIA.with_dirichlet_identity (tail rows beyond n stay
        identity), remainder entries via val *= free[row] * free[col]."""
        R, W = self.G.shape2d
        free = jnp.pad((~mask).astype(self.G.data.dtype), (0, R * W - self.n))
        Gm = self.G.with_dirichlet_identity(free)
        if self.rem is None:
            return BandedSplit(Gm, None, self.n)
        fr = free[: self.n]
        rv = self.rem.vals * fr[None, :] * fr[self.rem.cols]
        return BandedSplit(Gm, ELLSoA(rv, self.rem.cols, self.rem.shape),
                           self.n)


@jax.tree_util.register_pytree_node_class
class BandedMGPreconditioner:
    """Geometric-algebraic multigrid ON the (R, W) banded-split grid.

    The banded split already views the RCM/quasi-structured operator as a
    9-point stencil on an (R, W) index grid; for such operators consecutive
    row indices are spatially adjacent (that is what a concentrated offset
    histogram MEANS), so the index grid is an approximate geometric
    embedding — bilinear Galerkin coarsening on it (ops/grid_mg.GridMG)
    yields an SPD V-cycle with ZERO gathers at every level. Measured: PCG
    on the jittered-quad mesh converges in 8 iterations (vs 12 for the
    aux-grid preconditioner, whose fine level costs ~8n gathered
    elements); every V-cycle here is static slices at memory bandwidth.
    Returns None from `build` when the split is not 9-point or the grid
    cannot coarsen. Apply: callable/`@`, vector arithmetic in the
    caller's dtype (mixed precision like GridMG).
    """

    def __init__(self, mg, shape2d, n, m):
        self.mg = mg
        self.shape2d = shape2d
        self.n = n
        self.m = m

    def tree_flatten(self):
        return (self.mg,), (self.shape2d, self.n, self.m)

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(leaves[0], *aux)

    @staticmethod
    def static_plan(offsets2d, shape2d, coarse_n: int = 32):
        """Host-side level plan from STATIC split metadata: (m, shapes,
        offsets) or None when the split is not 9-point. Splitting the plan
        from the tracing lets callers fuse the coarsening chain into a
        larger program (models/matfree._try_banded_upgrade runs split +
        fold + chain as ONE program)."""
        if any(abs(a) > 1 or abs(b) > 1 for a, b in offsets2d):
            return None  # galerkin_coarsen needs a 9-point window
        R, W = shape2d
        m0 = max(R, W)
        m = m0 + ((-(m0 - 1)) % 8)
        shapes = [m]
        offsets = [tuple(offsets2d)]
        while True:
            nn = shapes[-1] - 1
            if nn % 2 != 0 or nn // 2 < coarse_n:
                break
            shapes.append(nn // 2 + 1)
            offsets.append(
                tuple((a, b) for a in (-1, 0, 1) for b in (-1, 0, 1))
            )
        return m, tuple(shapes), tuple(offsets)

    @staticmethod
    def coarsen_levels(data, shape2d, offsets2d, plan, dtype=jnp.float32):
        """TRACEABLE embed + full Galerkin chain (call under jit)."""
        from .grid_dia import GridDIAMatrix as _G
        from .grid_mg import galerkin_coarsen

        m, shapes, _ = plan
        R, W = shape2d
        k0 = tuple(offsets2d).index((0, 0))
        K = data.shape[0]
        out = jnp.zeros((K, m, m), dtype)
        out = out.at[:, :R, :W].set(data.astype(dtype))
        ii = jnp.arange(m)
        padmask = (ii[:, None] >= R) | (ii[None, :] >= W)
        out = out.at[k0].set(jnp.where(padmask, 1.0, out[k0]))
        levels = [out]
        lvl = _G(out, tuple(offsets2d), (m, m))
        for _ in range(len(shapes) - 1):
            lvl = galerkin_coarsen(lvl)
            levels.append(lvl.data)
        return tuple(levels)

    @classmethod
    def from_levels(cls, datas, shape2d, n, plan, omega: float = 0.8,
                    nu: int = 2, coarse_iters: int = 64):
        from .grid_mg import GridMG

        m, shapes, offsets = plan
        mg = GridMG(list(datas), offsets, shapes, omega, nu, coarse_iters)
        return cls(mg, tuple(shape2d), n, m)

    @classmethod
    def build(cls, F: BandedSplit, dtype=jnp.float32, coarse_n: int = 32,
              omega: float = 0.8, nu: int = 2, coarse_iters: int = 64):
        """F: Dirichlet-folded BandedSplit (fold_dirichlet already applied).
        The (R, W) grid is embedded into the next (m, m) with
        (m - 1) % 8 == 0 (three guaranteed coarsenings), identity on the
        padding. The hierarchy is built in one jitted program."""
        plan = cls.static_plan(F.G.offsets2d, F.G.shape2d, coarse_n)
        if plan is None:
            return None

        chain = jax.jit(functools.partial(
            cls.coarsen_levels, shape2d=F.G.shape2d,
            offsets2d=F.G.offsets2d, plan=plan, dtype=dtype,
        ))
        datas = list(chain(F.G.data))
        return cls.from_levels(datas, F.G.shape2d, F.n, plan, omega, nu,
                               coarse_iters)

    def __call__(self, r):
        R, W = self.shape2d
        m, n = self.m, self.n
        rp = jnp.pad(r, (0, R * W - n)).reshape(R, W)
        rp = jnp.pad(rp, ((0, m - R), (0, m - W)))
        z = self.mg.v_cycle(rp)
        return z[:R, :W].reshape(-1)[:n]

    __matmul__ = __call__


def banded_cg(op: BandedSplit, b, n_iter: int, inv_diag=None):
    """Fixed-count Jacobi-CG on a Dirichlet-folded BandedSplit; the search
    direction lives in a zero-border (R+2H, W+2H) frame so the stencil part
    is pure static slices (grid_cg design), the remainder rides flat
    gathers. Returns (x, |r|, ok): ok=False flags a breakdown (pAp <= 0 or
    rz <= 0 at some iteration — the guarded loop then freezes the iterate
    instead of corrupting it, and this flag is how the caller learns the
    returned x is stale; SURVEY §5.3 stall observability)."""
    R, W = op.G.shape2d
    n = op.n
    H = max(max(abs(a), abs(c)) for a, c in op.G.offsets2d)
    data = op.G.data
    tail = R * W - n

    b = jnp.asarray(b)
    if inv_diag is None:
        inv_diag = 1.0 / op.diagonal()

    def apply_pad(p_pad, p_flat):
        Ap = stencil_matvec_padded(data, op.G.offsets2d, p_pad, H)
        Ap = Ap.reshape(-1)[:n]
        return Ap if op.rem is None else Ap + op.rem @ p_flat

    def to_pad(v_flat):
        return jnp.pad(jnp.pad(v_flat, (0, tail)).reshape(R, W), H)

    def body(_, state):
        x, r, p, p_pad, rz, ok = state
        Ap = apply_pad(p_pad, p)
        pAp = jnp.sum(p * Ap)
        # a zero RHS (rz == 0 at entry) is convergence, not breakdown
        ok = ok & ((pAp > 0) | (rz == 0))
        alpha = jnp.where(pAp > 0, rz / jnp.where(pAp == 0, 1.0, pAp), 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = inv_diag * r
        rz_new = jnp.sum(r * z)
        beta = jnp.where(rz > 0, rz_new / jnp.where(rz == 0, 1.0, rz), 0.0)
        p = z + beta * p
        return (x, r, p, to_pad(p), rz_new, ok)

    z0 = inv_diag * b
    state = (jnp.zeros_like(b), b, z0, to_pad(z0), jnp.sum(b * z0),
             jnp.bool_(True))
    x, r, _, _, _, ok = jax.lax.fori_loop(0, n_iter, body, state)
    return x, jnp.sqrt(jnp.sum(r * r)), ok
