"""Geometric multigrid on 3D grid stencils: Galerkin coarsening + V-cycle.

3D counterpart of ops/grid_mg.py for the Freudenthal structured tet path
(ops/grid3d.py). Jacobi-CG iteration counts on the 7-point cube Laplacian
grow like O(1/h); the trilinear Galerkin V-cycle makes the preconditioned
condition number O(1) — tens of iterations at any size. Every ingredient is
static strided slices + elementwise (memory-bound, accelerator-friendly), per-level
cost falling 8x per level.

Components (dtype-generic, jittable; level shapes static):

- Galerkin coarse operators A_c = P^T A_f P computed directly on the
  stencil layers (variable coefficients and folded Dirichlet boundaries
  coarsen correctly automatically); fine offsets in {-1,0,1}^3 stay
  27-point under coarsening,
- trilinear prolongation P / full-weighting restriction P^T over the node
  lattice (coarse (I,J,K) = fine (2I,2J,2K)),
- weighted-Jacobi smoothing (symmetric pre/post => SPD preconditioner),
- fixed unpreconditioned CG at the coarsest level.

Reference anchor: replaces Eigen SparseLU (fem_linear_elliptic_solver.h:34-50)
as the convergent large-scale 3D solve.
"""

from __future__ import annotations

import itertools

import jax
import jax.numpy as jnp

from .grid3d import GridDIA3D

__all__ = ["GridMG3D", "mg_preconditioned_cg3d", "galerkin_coarsen3d"]

_W = {-1: 0.5, 0: 1.0, 1: 0.5}  # per-axis linear interpolation weights


def _sampled3(layer_padded, a: int, b: int, c: int, mc: int):
    """layer_padded[(1+2I+a, 1+2J+b, 1+2K+c)] for coarse (I,J,K) in [0,mc)^3."""
    e = 2 * (mc - 1) + 1
    return jax.lax.slice(
        layer_padded,
        (1 + a, 1 + b, 1 + c),
        (1 + a + e, 1 + b + e, 1 + c + e),
        (2, 2, 2),
    )


def galerkin_coarsen3d(G: GridDIA3D) -> GridDIA3D:
    """A_c = P^T A_f P on an (m, m, m) lattice, m odd, coarse mc = (m+1)//2.

    Fine offsets must satisfy |d| <= 1 per axis (true for the Freudenthal
    P1 15-point stencil and for its Galerkin coarsenings, which stay
    27-point).
    """
    m = G.shape3d[0]
    assert G.shape3d[0] == G.shape3d[1] == G.shape3d[2], "cubic lattices only"
    assert m % 2 == 1, "node count must be odd (cell count even)"
    mc = (m + 1) // 2
    assert all(all(abs(d) <= 1 for d in o) for o in G.offsets3d)
    fine = {o: jnp.pad(G.data[k], 1) for k, o in enumerate(G.offsets3d)}
    dtype = G.data.dtype

    coarse_offsets = tuple(itertools.product((-1, 0, 1), repeat=3))
    layers = {}
    for dO in coarse_offsets:
        acc = jnp.zeros((mc, mc, mc), dtype)
        for a in (-1, 0, 1):
            for b in (-1, 0, 1):
                for c in (-1, 0, 1):
                    for (di, dj, dk), lay in fine.items():
                        ap = a + di - 2 * dO[0]
                        bp = b + dj - 2 * dO[1]
                        cp = c + dk - 2 * dO[2]
                        if ap in _W and bp in _W and cp in _W:
                            w = (_W[a] * _W[b] * _W[c]
                                 * _W[ap] * _W[bp] * _W[cp])
                            acc = acc + w * _sampled3(lay, a, b, c, mc)
                            # fine row (2I+a, 2J+b, 2K+c) may fall outside
                            # the lattice; the zero padding kills those terms
        layers[dO] = acc
    data = jnp.stack([layers[o] for o in coarse_offsets])
    return GridDIA3D(data, coarse_offsets, (mc, mc, mc))


def _stencil3(data, offsets3d, x, m):
    # layers cast up to the vector dtype: bf16 storage streams half the
    # bytes, the convert fuses into the multiply (see 2D grid_mg.astype)
    xp = jnp.pad(x, 1)
    acc = None
    for k, (di, dj, dk) in enumerate(offsets3d):
        t = data[k].astype(x.dtype) * jax.lax.slice(
            xp, (1 + di, 1 + dj, 1 + dk), (1 + di + m, 1 + dj + m, 1 + dk + m)
        )
        acc = t if acc is None else acc + t
    return acc


def _restrict3(r, mc):
    """Full weighting r_c = P^T r_f (coarse (I,J,K) <- fine (2I,2J,2K))."""
    rp = jnp.pad(r, 1)
    acc = None
    for a in (-1, 0, 1):
        for b in (-1, 0, 1):
            for c in (-1, 0, 1):
                t = _W[a] * _W[b] * _W[c] * _sampled3(rp, a, b, c, mc)
                acc = t if acc is None else acc + t
    return acc


def _prolong3(e, m):
    """Trilinear e_f = P e_c onto the (m, m, m) fine lattice."""
    mc = e.shape[0]
    up = jnp.zeros((m + 2, m + 2, m + 2), e.dtype)
    hi = 2 * (mc - 1) + 2
    up = up.at[1:hi:2, 1:hi:2, 1:hi:2].set(e)
    acc = None
    for a in (-1, 0, 1):
        for b in (-1, 0, 1):
            for c in (-1, 0, 1):
                t = _W[a] * _W[b] * _W[c] * jax.lax.slice(
                    up, (1 + a, 1 + b, 1 + c), (1 + a + m, 1 + b + m, 1 + c + m)
                )
                acc = t if acc is None else acc + t
    return acc


@jax.tree_util.register_pytree_node_class
class GridMG3D:
    """V-cycle hierarchy over a GridDIA3D (boundary treatment folded).

    Usage: mg = GridMG3D.build(G); z = mg.v_cycle(r) — an SPD operation
    approximating A^{-1} r (CG preconditioner, or stand-alone by iterating
    x += v_cycle(b - A x)).
    """

    def __init__(self, datas, offsets, shapes, omega, nu, coarse_iters):
        self.datas = datas  # list of (K_l, m_l, m_l, m_l)
        self.offsets = offsets
        self.shapes = shapes
        self.omega = omega
        self.nu = nu
        self.coarse_iters = coarse_iters

    def tree_flatten(self):
        return tuple(self.datas), (
            self.offsets, self.shapes, self.omega, self.nu, self.coarse_iters
        )

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(list(leaves), *aux)

    def astype(self, dtype):
        """Hierarchy with stencil layers STORED in `dtype` (bf16 halves
        smoother/residual layer traffic); vector arithmetic keeps the
        caller's precision — see ops/grid_mg.GridMG.astype."""
        return GridMG3D(
            [d.astype(dtype) for d in self.datas],
            self.offsets, self.shapes, self.omega, self.nu,
            self.coarse_iters,
        )

    @classmethod
    def build(cls, G: GridDIA3D, coarse_n: int = 8, omega: float = 0.8,
              nu: int = 2, coarse_iters: int = 64):
        """Coarsen while the cell count n = m-1 is even and > coarse_n.

        The whole hierarchy is computed inside ONE jitted program."""
        shapes = [G.shape3d[0]]
        offsets = [G.offsets3d]
        while True:
            n = shapes[-1] - 1
            if n % 2 != 0 or n // 2 < coarse_n:
                break
            shapes.append(n // 2 + 1)
            offsets.append(tuple(itertools.product((-1, 0, 1), repeat=3)))

        @jax.jit
        def all_levels(data0):
            out = [data0]
            lvl = GridDIA3D(data0, G.offsets3d, G.shape3d)
            for _ in range(len(shapes) - 1):
                lvl = galerkin_coarsen3d(lvl)
                out.append(lvl.data)
            return tuple(out)

        datas = list(all_levels(G.data))
        return cls(
            datas, tuple(offsets), tuple(shapes), omega, nu, coarse_iters
        )

    @property
    def n_levels(self):
        return len(self.shapes)

    def _smooth(self, lvl, x, b):
        data, offs, m = self.datas[lvl], self.offsets[lvl], self.shapes[lvl]
        inv_diag = 1.0 / data[offs.index((0, 0, 0))].astype(b.dtype)
        for _ in range(self.nu):
            x = x + self.omega * inv_diag * (b - _stencil3(data, offs, x, m))
        return x

    def _coarse_solve(self, b):
        lvl = self.n_levels - 1
        data, offs, m = self.datas[lvl], self.offsets[lvl], self.shapes[lvl]

        def body(_, s):
            x, r, p, rr = s
            Ap = _stencil3(data, offs, p, m)
            pAp = jnp.sum(p * Ap)
            alpha = jnp.where(pAp > 0, rr / jnp.where(pAp == 0, 1.0, pAp), 0.0)
            x = x + alpha * p
            r = r - alpha * Ap
            rr_new = jnp.sum(r * r)
            beta = jnp.where(rr > 0, rr_new / jnp.where(rr == 0, 1.0, rr), 0.0)
            return (x, r, p * beta + r, rr_new)

        s = (jnp.zeros_like(b), b, b, jnp.sum(b * b))
        x, *_ = jax.lax.fori_loop(0, self.coarse_iters, body, s)
        return x

    def _v(self, lvl, b):
        if lvl == self.n_levels - 1:
            return self._coarse_solve(b)
        data, offs, m = self.datas[lvl], self.offsets[lvl], self.shapes[lvl]
        x = self._smooth(lvl, jnp.zeros_like(b), b)
        r = b - _stencil3(data, offs, x, m)
        e = self._v(lvl + 1, _restrict3(r, self.shapes[lvl + 1]))
        x = x + _prolong3(e, m)
        return self._smooth(lvl, x, b)

    def v_cycle(self, r):
        """Apply one V-cycle to a (flat or (m,m,m)) residual; same shape out."""
        m = self.shapes[0]
        flat = r.ndim == 1
        z = self._v(0, r.reshape(m, m, m))
        return z.reshape(-1) if flat else z


def mg_preconditioned_cg3d(G: GridDIA3D, b, rtol=1e-6, maxiter=100,
                           mg: GridMG3D | None = None, **build_kwargs):
    """CG on G with a 3D V-cycle preconditioner; returns (x, rel_res, iters).

    G must carry its boundary treatment (with_dirichlet_identity). The
    rz-recurrence stop is backed by a true-residual evaluation at the end.
    """
    if mg is None:
        mg = GridMG3D.build(G, **build_kwargs)
    m = G.shape3d[0]
    data, offs = G.data, G.offsets3d
    b = jnp.asarray(b).reshape(m, m, m)
    bn2 = jnp.sum(b * b)
    tol2 = (rtol * rtol) * bn2

    z0 = mg.v_cycle(b)
    rz0 = jnp.sum(b * z0)

    def cond(s):
        x, r, p, rz, rr, k = s
        return (rr > tol2) & (k < maxiter) & jnp.isfinite(rr)

    def body(s):
        x, r, p, rz, rr, k = s
        Ap = _stencil3(data, offs, p, m)
        pAp = jnp.sum(p * Ap)
        alpha = jnp.where(pAp > 0, rz / jnp.where(pAp == 0, 1.0, pAp), 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = mg.v_cycle(r)
        rz_new = jnp.sum(r * z)
        beta = jnp.where(rz > 0, rz_new / jnp.where(rz == 0, 1.0, rz), 0.0)
        return (x, r, z + beta * p, rz_new, jnp.sum(r * r), k + 1)

    s = (jnp.zeros_like(b), b, z0, rz0, bn2, 0)
    x, r, p, rz, rr, k = jax.lax.while_loop(cond, body, s)
    true_r = b - _stencil3(data, offs, x, m)
    rel = jnp.sqrt(jnp.sum(true_r * true_r) / bn2)
    return x.reshape(-1), rel, k
