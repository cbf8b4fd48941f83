"""Matrix-free Krylov solvers under `jax.lax.while_loop`.

The accelerator replacement for Eigen's SparseLU direct factorization
(fem_linear_elliptic_solver.h:38-47): sparse LU fill-in is hostile to
accelerators, while CG/BiCGStab are pure SpMV + dot products — gathers,
segment-sums and reductions that XLA fuses, with `psum`-able dot products
for the multi-chip path (see `parallel/`).

- `cg`: preconditioned conjugate gradients for SPD systems,
- `bicgstab`: for the non-symmetric systems produced by advection terms
  (the reference switches to SparseLU regardless; we need a Krylov method
  robust to asymmetry).

All loops have static shapes; convergence is `||r|| <= max(rtol*||b||, atol)`
with an iteration cap. Divergence detection (NaN residual guard, §5.3 of
SURVEY.md) marks `converged=False` without crashing.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["cg", "cg_chunked", "cg_split_programs", "bicgstab",
           "bicgstab_chunked", "gmres", "cg_differentiable", "SolveInfo"]


class SolveInfo(NamedTuple):
    iterations: jnp.ndarray
    residual: jnp.ndarray  # final ||r||
    converged: jnp.ndarray


def _as_operator(A) -> Callable:
    return A if callable(A) else lambda x: A @ x


def _identity(x):
    return x


def cg(A, b, M_inv=None, x0=None, rtol=1e-12, atol=0.0, maxiter=None):
    """Preconditioned conjugate gradients. A SPD (callable or SparseMatrix)."""
    op = _as_operator(A)
    pre = M_inv if M_inv is not None else _identity
    pre = _as_operator(pre)
    b = jnp.asarray(b)
    n = b.shape[0]
    if maxiter is None:
        maxiter = 10 * n
    x0 = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)

    bnorm = jnp.linalg.norm(b)
    tol = jnp.maximum(rtol * bnorm, atol)

    r0 = b - op(x0)
    z0 = pre(r0)
    p0 = z0
    rz0 = jnp.vdot(r0, z0)

    def cond(state):
        x, r, z, p, rz, k = state
        rnorm = jnp.linalg.norm(r)
        return (rnorm > tol) & (k < maxiter) & jnp.isfinite(rnorm)

    def body(state):
        x, r, z, p, rz, k = state
        Ap = op(p)
        alpha = rz / jnp.vdot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = pre(r)
        rz_new = jnp.vdot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        return (x, r, z, p, rz_new, k + 1)

    x, r, *_, k = jax.lax.while_loop(cond, body, (x0, r0, z0, p0, rz0, 0))
    rnorm = jnp.linalg.norm(r)
    return x, SolveInfo(k, rnorm, (rnorm <= tol) & jnp.isfinite(rnorm))


def _cg_chunk_fn(chunk: int, has_pre: bool):
    """Jitted `chunk`-iteration CG step carrying full Krylov state.

    Module-level cache (keyed on the static chunk size / preconditioner
    presence): one compile serves every chunk of every same-shaped solve.
    """

    @jax.jit
    def step(A, M_inv, state, tol, maxiter):
        op = _as_operator(A)
        pre = _as_operator(M_inv) if has_pre else _identity
        k0 = state[-1]

        def cond(s):
            x, r, z, p, rz, k = s
            rnorm = jnp.linalg.norm(r)
            return ((rnorm > tol) & (k < maxiter) & (k < k0 + chunk)
                    & jnp.isfinite(rnorm))

        def body(s):
            x, r, z, p, rz, k = s
            Ap = op(p)
            alpha = rz / jnp.vdot(p, Ap)
            x = x + alpha * p
            r = r - alpha * Ap
            z = pre(r)
            rz_new = jnp.vdot(r, z)
            beta = rz_new / rz
            p = z + beta * p
            return (x, r, z, p, rz_new, k + 1)

        state = jax.lax.while_loop(cond, body, state)
        return state, jnp.linalg.norm(state[1])

    return step


def _cg_setup_fn(has_pre: bool, has_x0: bool):
    """Jitted Krylov-state initialization (cached like the chunk step):
    keeps every per-solve device op inside one compiled program."""

    @jax.jit
    def setup(A, M_inv, b, x0, rtol, atol):
        op = _as_operator(A)
        pre = _as_operator(M_inv) if has_pre else _identity
        x0_ = x0 if has_x0 else jnp.zeros_like(b)
        r0 = b - op(x0_)
        z0 = pre(r0)
        tol = jnp.maximum(rtol * jnp.linalg.norm(b), atol)
        state = (x0_, r0, z0, z0, jnp.vdot(r0, z0), jnp.array(0, jnp.int32))
        return state, tol

    return setup


_CG_CHUNK_CACHE: dict = {}
_CG_SETUP_CACHE: dict = {}


def _as_chunk_operand(A):
    """Make `A` a valid jit argument: pytree operators (registered classes,
    arrays) pass through; bare Python callables are wrapped in
    `jax.tree_util.Partial` (function identity lands in the treedef, so a
    new function triggers the one retrace it needs)."""
    if A is None or isinstance(A, jax.Array):
        return A
    leaves = jax.tree_util.tree_leaves(A)
    if callable(A) and len(leaves) == 1 and leaves[0] is A:
        return jax.tree_util.Partial(A)
    return A


def cg_chunked(A, b, M_inv=None, x0=None, rtol=1e-12, atol=0.0,
               maxiter=200, chunk=10, on_chunk=None):
    """Exact preconditioned CG split into `chunk`-iteration device programs.

    Mathematically identical to `cg` — the full Krylov state (x, r, z, p,
    rho) crosses the program boundary, so there is no restart penalty; the
    host fetches ||r|| between chunks (one sync each). Use it where
    between-chunk observability is wanted (SURVEY §5.3: stall detection
    hooks) or a single device program must stay short. A and M_inv must be
    pytree operators (callable or `@`, e.g. DirichletSystem /
    AuxGridPreconditioner / BandedSplit) so the chunk program compiles
    once per shape, not once per solve.

    on_chunk: optional host callback (k_iterations, rnorm) -> None after
    every chunk. Returns (x, SolveInfo) like `cg`.
    """
    b = jnp.asarray(b)
    A = _as_chunk_operand(A)
    M_inv = _as_chunk_operand(M_inv)
    has_pre = M_inv is not None
    has_x0 = x0 is not None
    key = (int(chunk), has_pre)
    step = _CG_CHUNK_CACHE.get(key)
    if step is None:
        step = _CG_CHUNK_CACHE[key] = _cg_chunk_fn(int(chunk), has_pre)
    skey = (has_pre, has_x0)
    setup = _CG_SETUP_CACHE.get(skey)
    if setup is None:
        setup = _CG_SETUP_CACHE[skey] = _cg_setup_fn(has_pre, has_x0)

    dummy = b[:0] if not has_pre else M_inv
    state, tol = setup(A, dummy, b, x0 if has_x0 else b[:0],
                       jnp.asarray(rtol, b.dtype), jnp.asarray(atol, b.dtype))
    tolf = float(tol)  # one host fence
    maxiter_dev = jnp.asarray(maxiter, jnp.int32)
    rnorm = float("inf")
    while True:
        k_before = int(state[-1])
        state, rnorm_dev = step(A, dummy, state, tol, maxiter_dev)
        k = int(state[-1])  # host fence per chunk (fetches rnorm too)
        rnorm = float(rnorm_dev)
        if on_chunk is not None:
            on_chunk(k, rnorm)
        if (rnorm <= tolf or k >= maxiter or k == k_before
                or not math.isfinite(rnorm)):
            break
    x = state[0]
    k = state[-1]
    return x, SolveInfo(k, jnp.asarray(rnorm),
                        jnp.asarray(rnorm <= tolf))


def bicgstab(A, b, M_inv=None, x0=None, rtol=1e-12, atol=0.0, maxiter=None):
    """Preconditioned BiCGStab for general (non-symmetric) systems."""
    op = _as_operator(A)
    pre = M_inv if M_inv is not None else _identity
    pre = _as_operator(pre)
    b = jnp.asarray(b)
    n = b.shape[0]
    if maxiter is None:
        maxiter = 20 * n
    x0 = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)

    bnorm = jnp.linalg.norm(b)
    tol = jnp.maximum(rtol * bnorm, atol)

    r0 = b - op(x0)
    rhat = r0  # shadow residual
    one = jnp.array(1.0, b.dtype)
    state0 = (x0, r0, jnp.zeros_like(b), one, one, one, jnp.zeros_like(b), 0)
    # state: x, r, p, rho, alpha, omega, v, k
    # (p = v = 0, rho = alpha = omega = 1 makes the first body evaluation
    # reduce to the standard p_1 = r_0 initialization)

    def cond(state):
        x, r, p, rho, alpha, omega, v, k = state
        rnorm = jnp.linalg.norm(r)
        return (rnorm > tol) & (k < maxiter) & jnp.isfinite(rnorm)

    def body(state):
        x, r, p, rho, alpha, omega, v, k = state
        rho_new = jnp.vdot(rhat, r)
        beta = (rho_new / rho) * (alpha / omega)
        p = r + beta * (p - omega * v)
        phat = pre(p)
        v = op(phat)
        alpha = rho_new / jnp.vdot(rhat, v)
        s = r - alpha * v
        shat = pre(s)
        t = op(shat)
        tt = jnp.vdot(t, t)
        omega = jnp.where(tt > 0, jnp.vdot(t, s) / tt, 0.0)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        return (x, r, p, rho_new, alpha, omega, v, k + 1)

    out = jax.lax.while_loop(cond, body, state0)
    x, r = out[0], out[1]
    k = out[-1]
    rnorm = jnp.linalg.norm(r)
    return x, SolveInfo(k, rnorm, (rnorm <= tol) & jnp.isfinite(rnorm))


def _bicgstab_chunk_fns(chunk: int, has_pre: bool, has_x0: bool):
    """Cached (setup, step) programs for chunked BiCGStab — same recurrence
    as `bicgstab`, full state (incl. the shadow residual) crossing the
    program boundary."""

    @jax.jit
    def setup(A, M_inv, b, x0, rtol, atol):
        op = _as_operator(A)
        x0 = x0 if has_x0 else jnp.zeros_like(b)
        r0 = b - op(x0)
        one = jnp.array(1.0, b.dtype)
        state = (x0, r0, r0, jnp.zeros_like(b), one, one, one,
                 jnp.zeros_like(b), jnp.array(0, jnp.int32))
        tol = jnp.maximum(rtol * jnp.linalg.norm(b), atol)
        return state, tol

    @jax.jit
    def step(A, M_inv, state, tol, maxiter):
        op = _as_operator(A)
        pre = _as_operator(M_inv) if has_pre else _identity
        k0 = state[-1]

        def cond(s):
            rnorm = jnp.linalg.norm(s[1])
            return ((rnorm > tol) & (s[-1] < maxiter)
                    & (s[-1] < k0 + chunk) & jnp.isfinite(rnorm))

        def body(s):
            x, r, rhat, p, rho, alpha, omega, v, k = s
            rho_new = jnp.vdot(rhat, r)
            beta = (rho_new / rho) * (alpha / omega)
            p = r + beta * (p - omega * v)
            phat = pre(p)
            v = op(phat)
            alpha = rho_new / jnp.vdot(rhat, v)
            s_ = r - alpha * v
            shat = pre(s_)
            t = op(shat)
            tt = jnp.vdot(t, t)
            omega = jnp.where(tt > 0, jnp.vdot(t, s_) / tt, 0.0)
            x = x + alpha * phat + omega * shat
            r = s_ - omega * t
            return (x, r, rhat, p, rho_new, alpha, omega, v, k + 1)

        state = jax.lax.while_loop(cond, body, state)
        return state, jnp.linalg.norm(state[1])

    return setup, step


_BICGSTAB_CHUNK_CACHE: dict = {}


def bicgstab_chunked(A, b, M_inv=None, x0=None, rtol=1e-12, atol=0.0,
                     maxiter=200, chunk=10, on_chunk=None):
    """`bicgstab` split into bounded device programs — see `cg_chunked`
    for why (between-chunk observability, bounded programs).
    Iterates are bit-identical to the single-program form."""
    b = jnp.asarray(b)
    A = _as_chunk_operand(A)
    M_inv = _as_chunk_operand(M_inv)
    has_pre = M_inv is not None
    has_x0 = x0 is not None
    key = (int(chunk), has_pre, has_x0)
    fns = _BICGSTAB_CHUNK_CACHE.get(key)
    if fns is None:
        fns = _BICGSTAB_CHUNK_CACHE[key] = _bicgstab_chunk_fns(
            int(chunk), has_pre, has_x0)
    setup, step = fns

    dummy = b[:0] if not has_pre else M_inv
    state, tol = setup(A, dummy, b, x0 if has_x0 else b[:0],
                       jnp.asarray(rtol, b.dtype), jnp.asarray(atol, b.dtype))
    tolf = float(tol)
    maxiter_dev = jnp.asarray(maxiter, jnp.int32)
    rnorm = float("inf")
    while True:
        k_before = int(state[-1])
        state, rnorm_dev = step(A, dummy, state, tol, maxiter_dev)
        k = int(state[-1])
        rnorm = float(rnorm_dev)
        if on_chunk is not None:
            on_chunk(k, rnorm)
        if (rnorm <= tolf or k >= maxiter or k == k_before
                or not math.isfinite(rnorm)):
            break
    return state[0], SolveInfo(state[-1], jnp.asarray(rnorm),
                               jnp.asarray(rnorm <= tolf))


def gmres(A, b, M_inv=None, x0=None, rtol=1e-12, atol=0.0, maxiter=None, restart=20):
    """Restarted GMRES(m) for general systems (SURVEY.md §7.3: the
    memory-heavier alternative to BiCGStab for advection-dominated problems).

    Native implementation (right-preconditioned, so residual norms refer to
    the ORIGINAL system): per cycle, `restart` Arnoldi steps with twice-
    iterated classical Gram-Schmidt (CGS2 — two (m+1, n) matvecs per step,
    dense and batch-friendly, orthogonality loss of MGS without its serial inner
    loop) and Givens-rotation least squares. All control flow is
    lax.while_loop/fori_loop; breakdown and post-convergence steps are
    guarded (safe divisions), so fixed-shape cycles never produce NaN.
    Reports iterations = completed cycles x restart.
    """
    op = _as_operator(A)
    pre = _as_operator(M_inv) if M_inv is not None else _identity
    b = jnp.asarray(b)
    n = b.shape[0]
    m = min(restart, n)
    if maxiter is None:
        maxiter = 20 * n
    max_cycles = max(1, -(-maxiter // m))
    x0 = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0)
    bnorm = jnp.linalg.norm(b)
    tol = jnp.maximum(rtol * bnorm, atol)

    def _safe(z):
        return jnp.where(z == 0, jnp.ones_like(z), z)

    def cycle(x):
        r = b - op(x)
        beta = jnp.linalg.norm(r)
        V = jnp.zeros((m + 1, n), b.dtype).at[0].set(r / _safe(beta))
        R = jnp.zeros((m + 1, m), b.dtype)
        g = jnp.zeros(m + 1, b.dtype).at[0].set(beta)
        cs = jnp.zeros(m, b.dtype)
        sn = jnp.zeros(m, b.dtype)

        def inner(j, carry):
            V, R, g, cs, sn = carry
            w = op(pre(V[j]))
            mask = (jnp.arange(m + 1) <= j).astype(b.dtype)
            h1 = (V @ w) * mask
            w = w - V.T @ h1
            h2 = (V @ w) * mask  # CGS2 re-orthogonalization
            w = w - V.T @ h2
            h = h1 + h2
            hnext = jnp.linalg.norm(w)
            V = V.at[j + 1].set(w / _safe(hnext))
            hcol = h.at[j + 1].set(hnext)

            def rot(i, hv):
                hi, hi1 = hv[i], hv[i + 1]
                return hv.at[i].set(cs[i] * hi + sn[i] * hi1).at[i + 1].set(
                    -sn[i] * hi + cs[i] * hi1
                )

            hcol = jax.lax.fori_loop(0, j, rot, hcol)
            denom = jnp.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
            c_new = jnp.where(denom == 0, 1.0, hcol[j] / _safe(denom))
            s_new = jnp.where(denom == 0, 0.0, hcol[j + 1] / _safe(denom))
            hcol = hcol.at[j].set(denom).at[j + 1].set(0.0)
            cs = cs.at[j].set(c_new)
            sn = sn.at[j].set(s_new)
            gj = g[j]
            g = g.at[j].set(c_new * gj).at[j + 1].set(-s_new * gj)
            R = R.at[:, j].set(hcol)
            return V, R, g, cs, sn

        V, R, g, cs, sn = jax.lax.fori_loop(
            0, m, inner, (V, R, g, cs, sn)
        )

        def back(i_rev, y):
            i = m - 1 - i_rev
            yi = (g[i] - R[i, :] @ y) / _safe(R[i, i])
            yi = jnp.where(R[i, i] == 0, 0.0, yi)
            return y.at[i].set(yi)

        y = jax.lax.fori_loop(0, m, back, jnp.zeros(m, b.dtype))
        return x + pre(V[:m].T @ y)

    def cond(state):
        x, k, rnorm = state
        return (rnorm > tol) & (k < max_cycles) & jnp.isfinite(rnorm)

    def body(state):
        x, k, _ = state
        x = cycle(x)
        return x, k + 1, jnp.linalg.norm(b - op(x))

    x, k, rnorm = jax.lax.while_loop(
        cond, body, (x0, 0, jnp.linalg.norm(b - op(x0)))
    )
    return x, SolveInfo(k * m, rnorm, (rnorm <= tol) & jnp.isfinite(rnorm))


def dense_solve(A, b):
    """Dense solve via Gauss–Jordan elimination with partial pivoting.

    Pure-jnp replacement for `jnp.linalg.solve`, whose LU lowering is not
    available in every dtype on every backend; this elimination runs in
    any dtype on any backend. Intended for the small dense systems of the
    framework (Newton hessians, SMW capacitance matrices), O(n^3) fori_loop.
    Supports b of shape (n,) or (n, k).
    """
    A = jnp.asarray(A)
    b = jnp.asarray(b)
    vec = b.ndim == 1
    bb = b[:, None] if vec else b
    n = A.shape[0]
    Ab = jnp.concatenate([A, bb.astype(A.dtype)], axis=1)

    def elim(i, Ab):
        col = jnp.abs(Ab[:, i])
        col = jnp.where(jnp.arange(n) < i, -jnp.inf, col)
        p = jnp.argmax(col)
        ri, rp = Ab[i], Ab[p]
        Ab = Ab.at[i].set(rp).at[p].set(ri)
        row = Ab[i] / Ab[i, i]
        Ab = Ab.at[i].set(row)
        factors = jnp.where(jnp.arange(n) == i, 0.0, Ab[:, i])
        return Ab - factors[:, None] * row[None, :]

    Ab = jax.lax.fori_loop(0, n, elim, Ab)
    x = Ab[:, n:]
    return x[:, 0] if vec else x


def cg_differentiable(matvec, b, M_inv=None, rtol=1e-12, maxiter=None, symmetric=True):
    """CG solve with implicit differentiation (lax.custom_linear_solve).

    Gradients of the solution w.r.t. any parameter closed over by `matvec`
    or entering `b` are computed by ADJOINT SOLVES instead of differentiating
    through the Krylov iterations — the JAX-native enabler for
    PDE-constrained optimization / parameter estimation (e.g. fitting
    diffusion coefficients to data), which the reference cannot express.

    matvec must be a jax-traceable linear callable; for symmetric systems the
    transpose solve reuses the same operator.
    """

    def solve(mv, rhs):
        x, _ = cg(mv, rhs, M_inv=M_inv, rtol=rtol, maxiter=maxiter)
        return x

    return jax.lax.custom_linear_solve(
        matvec, jnp.asarray(b), solve=solve, symmetric=symmetric
    )


@functools.lru_cache(maxsize=None)
def _cg_split_progs():
    """The two alternating PCG half-step programs of cg_split_programs.
    Each holds only ONE heavyweight component — the operator or the
    preconditioner (e.g. a deep multigrid V-cycle) — so each compiles on
    its own."""

    @jax.jit
    def step_a(A, x, r, p, rz):
        op = _as_operator(A)
        Ap = op(p)
        pAp = jnp.vdot(p, Ap)
        # breakdown guard: iterations past convergence (the host only
        # checks every `check_every`) become exact no-ops instead of 0/0
        alpha = jnp.where(pAp == 0, 0.0, rz / jnp.where(pAp == 0, 1.0,
                                                        pAp))
        x = x + alpha * p
        r = r - alpha * Ap
        return x, r, jnp.vdot(r, r)

    @jax.jit
    def step_b(M, r, p, rz):
        op = _as_operator(M)
        z = op(r)
        rz_new = jnp.vdot(r, z)
        beta = jnp.where(rz == 0, 0.0, rz_new / jnp.where(rz == 0, 1.0,
                                                          rz))
        p = z + beta * p
        return p, rz_new

    return step_a, step_b


def cg_split_programs(A, b, M_inv, rtol=1e-12, maxiter=200,
                      check_every=10, on_check=None):
    """Host-driven preconditioned CG from x0 = 0: TWO small device
    programs per iteration (operator half-step / preconditioner
    half-step), dispatched asynchronously with a residual fetch every
    `check_every` iterations. Mathematically standard PCG — use where a
    fused chunk program (cg_chunked) holding the operator and a deep
    V-cycle together compiles slowly. Returns (x, SolveInfo)."""
    A = _as_chunk_operand(A)
    M_inv = _as_chunk_operand(M_inv)
    step_a, step_b = _cg_split_progs()

    def apply_pre(r, p, rz):
        return step_b(M_inv, r, p, rz)

    b = jnp.asarray(b)
    bn2 = float(jnp.vdot(b, b))
    tol2 = (rtol * rtol) * bn2
    one = jnp.asarray(1.0, b.dtype)
    # init: r0 = b (x0 = 0); z0/p0 via apply_pre with p = 0, rz = 1
    p, rz = apply_pre(b, jnp.zeros_like(b), one)
    x = jnp.zeros_like(b)
    r = b
    k = 0
    rn2 = jnp.vdot(b, b)
    while k < maxiter:
        x, r, rn2 = step_a(A, x, r, p, rz)
        p, rz = apply_pre(r, p, rz)
        k += 1
        if k % check_every == 0 or k == maxiter:
            v = float(rn2)
            if on_check is not None:
                on_check(k, v)  # host hook: stall/budget observability
            if not (v > tol2):  # converged or non-finite: stop
                break
    rn = jnp.sqrt(rn2)
    return x, SolveInfo(k, rn, (float(rn2) <= tol2))


def iterative_refinement(A, b, inner_solve, n_refine: int = 3):
    """Mixed-precision refinement (SURVEY.md §7.3 risk 4).

    Solve A x = b accurately while running the Krylov iteration in a lower
    precision: residuals are computed with `A`/`b` in their (high) precision,
    corrections come from `inner_solve(residual_lowp)` (e.g. an f32 CG).

    A: operator in working (high) precision; b: high-precision RHS;
    inner_solve: callable r32 -> dx32.
    Returns (x, final_residual_norm).
    """
    op = _as_operator(A)
    b = jnp.asarray(b)
    x = jnp.zeros_like(b)
    for _ in range(n_refine):
        r = b - op(x)
        dx = inner_solve(r.astype(jnp.float32))
        x = x + jnp.asarray(dx).astype(b.dtype)
    return x, jnp.linalg.norm(b - op(x))


def jacobi_preconditioner(diag):
    """M^{-1} = 1/diag, guarding zero entries."""
    d = jnp.where(jnp.abs(diag) > 0, diag, 1.0)
    inv = 1.0 / d

    def apply(x):
        return inv * x if x.ndim == 1 else inv[:, None] * x

    return apply
