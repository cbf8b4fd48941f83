"""Padded-state Jacobi-preconditioned CG on 2D grid stencils (the fast path).

Design (benchmarks/micro_cg.py times the variants):

- the search direction p lives in an (mx+2H, my+2H) zero-border frame, so
  the per-iteration SpMV is pure STATIC slices (no jnp.pad materialization,
  no dynamic_slice),
- exact-zero stencil layers are pruned beforehand
  (ops/grid_dia.prune_zero_offsets_grid): 7 -> 5 layers on right-triangle
  P1 meshes,
- optional reduced-precision stencil storage (``data_dtype=jnp.bfloat16``,
  f32 vector arithmetic) halves the operator bytes. On uniform structured
  meshes the P1 stencil entries are small exact binary fractions, so bf16
  storage is LOSSLESS there; on general meshes it perturbs the operator by
  ~4e-3 relative — use inside an iterative-refinement outer loop
  (linear_algebra.solvers mixed-precision) or keep f32.

The operator must already carry the boundary treatment:
``G.with_dirichlet_identity(free)`` folds F A F + (I-F) into the stencil
data, so the CG body touches no masks at all.

Reference anchor: replaces Eigen SparseLU (fem_linear_elliptic_solver.h:34-50)
at the 10M-dof scale where factorization fill-in is hostile to accelerators.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .grid_dia import GridDIAMatrix

__all__ = ["grid_cg", "grid_cg_refined", "stencil_matvec_padded"]


def stencil_matvec_padded(data, offsets2d, x_pad, H: int):
    """y = A x from a zero-border padded operand; static slices only.

    data: (K, mx, my) stencil layers (any float dtype; accumulation happens
    in the x_pad dtype). x_pad: (mx + 2H, my + 2H) with zero borders.
    """
    mx, my = data.shape[1], data.shape[2]
    acc = None
    for k, (di, dj) in enumerate(offsets2d):
        term = data[k].astype(x_pad.dtype) * jax.lax.slice(
            x_pad, (H + di, H + dj), (H + di + mx, H + dj + my)
        )
        acc = term if acc is None else acc + term
    return acc


def grid_cg(
    G: GridDIAMatrix,
    b,
    n_iter: int,
    inv_diag=None,
    data_dtype=None,
):
    """Run `n_iter` Jacobi-CG iterations; returns (x, |r|).

    G: stencil operator, boundary treatment folded in
       (with_dirichlet_identity). b: (mx, my) or flat rhs (bc values on
       pinned entries). inv_diag: optional (mx, my) Jacobi preconditioner
       (defaults to 1/diag(G)). data_dtype: optional storage dtype for the
       stencil layers (see module docstring).
    """
    mx, my = G.shape2d
    H = max((max(abs(a), abs(b_)) for a, b_ in G.offsets2d), default=1)
    data = G.data if data_dtype is None else G.data.astype(data_dtype)
    b = jnp.asarray(b).reshape(mx, my)
    if inv_diag is None:
        inv_diag = 1.0 / G.diagonal().reshape(mx, my)
    else:
        inv_diag = jnp.asarray(inv_diag).reshape(mx, my)

    def body(_, state):
        # guarded divisions: after exact convergence (rz = pAp = 0) the
        # fixed-iteration loop must idle at the solution, not produce NaN
        x, r, p_pad, rz = state
        Ap = stencil_matvec_padded(data, G.offsets2d, p_pad, H)
        p_c = jax.lax.slice(p_pad, (H, H), (H + mx, H + my))
        pAp = jnp.sum(p_c * Ap)
        alpha = jnp.where(pAp > 0, rz / jnp.where(pAp == 0, 1.0, pAp), 0.0)
        x = x + alpha * p_c
        r = r - alpha * Ap
        z = inv_diag * r
        rz_new = jnp.sum(r * z)
        beta = jnp.where(rz > 0, rz_new / jnp.where(rz == 0, 1.0, rz), 0.0)
        p_pad = jnp.pad(z + beta * p_c, H)
        return (x, r, p_pad, rz_new)

    z0 = inv_diag * b
    state = (jnp.zeros_like(b), b, jnp.pad(z0, H), jnp.sum(b * z0))
    x, r, *_ = jax.lax.fori_loop(0, n_iter, body, state)
    return x.reshape(-1), jnp.linalg.norm(r)


def _cg_cycle_lowp(data, offsets2d, inv_diag, r0, n_iter, H, vdt):
    """Fixed-count Jacobi-CG on A d = r0 with ALL vectors in `vdt`
    (bfloat16): half the memory traffic of the f32 body. Dot products
    accumulate in f32 (a bf16 10M-term reduction carries ~no signal).

    Attainable residual reduction in bf16 is only O(1e-2) — callers wrap
    this in an f32/f64 refinement loop (grid_cg_refined)."""
    mx, my = data.shape[1], data.shape[2]

    def fdot(a, c):
        return jnp.sum(a.astype(jnp.float32) * c.astype(jnp.float32))

    r0 = r0.astype(vdt)
    invd = inv_diag.astype(vdt)

    def body(_, state):
        d, r, p_pad, rz = state
        Ap = stencil_matvec_padded(data, offsets2d, p_pad, H)
        p_c = jax.lax.slice(p_pad, (H, H), (H + mx, H + my))
        pAp = fdot(p_c, Ap)
        alpha = jnp.where(pAp > 0, rz / jnp.where(pAp == 0, 1.0, pAp), 0.0)
        a16 = alpha.astype(vdt)
        d = d + a16 * p_c
        r = r - a16 * Ap
        z = invd * r
        rz_new = fdot(r, z)
        beta = jnp.where(rz > 0, rz_new / jnp.where(rz == 0, 1.0, rz), 0.0)
        p_pad = jnp.pad(z + beta.astype(vdt) * p_c, H)
        return (d, r, p_pad, rz_new)

    z0 = invd * r0
    state = (jnp.zeros_like(r0), r0, jnp.pad(z0, H), fdot(r0, z0))
    d, *_ = jax.lax.fori_loop(0, n_iter, body, state)
    return d


def grid_cg_refined(
    G: GridDIAMatrix,
    b,
    n_outer: int,
    n_inner: int,
    inv_diag=None,
    inner_dtype=jnp.bfloat16,
):
    """Iterative refinement: f32 outer residual, `inner_dtype` inner CG.

    Each outer cycle computes r = b - A x in f32 (one SpMV), runs
    ``n_inner`` CG iterations entirely in ``inner_dtype`` on A d = r
    (vectors AND stencil data at half traffic), and accumulates
    x += d in f32. The inner cycle is scaled by 1/|r|_inf so bf16's
    8-bit mantissa spends itself on the correction's leading digits.

    Replaces: the reference's Eigen SparseLU exact solve
    (fem_linear_elliptic_solver.h:34-50) in the large-scale regime; same
    role as grid_cg but trades precision bookkeeping for bandwidth.
    Returns (x, |r|) with r the true f32 residual.

    CONDITIONING CAVEAT (measured, benchmarks/micro_cg_mixed.py, 10M dofs,
    kappa ~ 4e6): unpreconditioned bf16-inner cycles DIVERGE on ill-
    conditioned Laplacians — bf16's 8-bit mantissa destroys CG's conjugacy
    long before the cycle ends, and the "correction" can be worse than
    nothing. Use this only on well-conditioned systems (mass matrices,
    shifted/parabolic steps, kappa <~ 1e3) or behind a strong
    preconditioner; at high kappa use ops/grid_mg.py (MG-preconditioned
    CG + f64 refinement), where reduced precision belongs in the stencil
    STORAGE, not the iteration arithmetic.
    """
    mx, my = G.shape2d
    H = max((max(abs(a), abs(o)) for a, o in G.offsets2d), default=1)
    data32 = G.data.astype(jnp.float32)
    data16 = G.data.astype(inner_dtype)
    b = jnp.asarray(b, jnp.float32).reshape(mx, my)
    if inv_diag is None:
        inv_diag = 1.0 / G.diagonal().reshape(mx, my)
    else:
        inv_diag = jnp.asarray(inv_diag, jnp.float32).reshape(mx, my)

    def outer(_, state):
        x, _ = state
        r = b - stencil_matvec_padded(data32, G.offsets2d, jnp.pad(x, H), H)
        # scale so the correction enters bf16 near O(1)
        s = jnp.max(jnp.abs(r))
        sc = jnp.where(s > 0, 1.0 / jnp.where(s == 0, 1.0, s), 0.0)
        d = _cg_cycle_lowp(
            data16, G.offsets2d, inv_diag, r * sc, n_inner, H, inner_dtype
        )
        x = x + d.astype(jnp.float32) / jnp.where(sc == 0, 1.0, sc)
        return (x, jnp.sum(r * r))

    x, rn2 = jax.lax.fori_loop(
        0, n_outer, outer, (jnp.zeros_like(b), jnp.sum(b * b))
    )
    r_final = b - stencil_matvec_padded(data32, G.offsets2d, jnp.pad(x, H), H)
    return x.reshape(-1), jnp.linalg.norm(r_final)
