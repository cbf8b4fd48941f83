"""Optimizers as jit-compiled JAX loops.

Semantics mirror the reference:

- `grid_search`: exhaustive minimization over an explicit grid (grid.h:28-71)
  — evaluated as one vmapped batch (embarrassingly parallel on device),
- `gradient_descent`: steepest descent, update = -step * grad, stop when
  ||grad|| < tol or max_iter (gradient_descent.h:27-75),
- `newton`: direction = -H^{-1} grad via dense solve (newton.h:28-101),
- `bfgs`: rank-2 inverse-hessian update, identity init, stationary-point
  early exit (bfgs.h:28-125),
- line searches: `backtracking` (Armijo, alpha *= beta while insufficient
  decrease; backtracking_line_search.h:26-49) and `wolfe` (weak-Wolfe
  bisection; wolfe_line_search.h:27-62).

Each returns an `OptimizeResult(x, value, n_iter)`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["OptimizeResult", "grid_search", "gradient_descent", "newton", "bfgs"]


class OptimizeResult(NamedTuple):
    x: jnp.ndarray
    value: jnp.ndarray
    n_iter: jnp.ndarray


def _as_fn(obj) -> Callable:
    return obj if callable(obj) else obj.__call__


def grid_search(objective, grid) -> OptimizeResult:
    """Minimize over explicit candidate points, one vmapped sweep (grid.h:46-66)."""
    f = _as_fn(objective)
    grid = jnp.atleast_2d(jnp.asarray(grid))
    vals = jax.vmap(f)(grid)
    i = jnp.argmin(vals)
    return OptimizeResult(grid[i], vals[i], jnp.asarray(grid.shape[0]))


# -- line searches ------------------------------------------------------------
def _fixed_step(f, grad_f, x, p, step0):
    return step0


def _backtracking(f, grad_f, x, p, step0, alpha=2.0, beta=0.5, gamma=0.5, max_iter=40):
    """Armijo backtracking (backtracking_line_search.h:37-48): shrink alpha
    until f(x) - f(x + alpha p) >= -gamma * alpha * grad.p."""
    fx = f(x)
    g = grad_f(x)
    gTp = jnp.vdot(g, p)

    def cond(state):
        a, k = state
        return (f(x + a * p) > fx + gamma * a * gTp) & (k < max_iter)

    def body(state):
        a, k = state
        return (a * beta, k + 1)

    a, _ = jax.lax.while_loop(cond, body, (jnp.asarray(alpha, x.dtype), 0))
    return a


def _wolfe(f, grad_f, x, p, step0, c1=1e-4, c2=0.9, max_iter=40):
    """Weak-Wolfe bisection (wolfe_line_search.h:27-62)."""
    fx = f(x)
    gTp = jnp.vdot(grad_f(x), p)

    def cond(state):
        a, lo, hi, k = state
        xa = x + a * p
        armijo = f(xa) <= fx + c1 * a * gTp
        curv = jnp.vdot(grad_f(xa), p) >= c2 * gTp
        return jnp.logical_not(armijo & curv) & (k < max_iter)

    def body(state):
        a, lo, hi, k = state
        xa = x + a * p
        armijo = f(xa) <= fx + c1 * a * gTp
        # if Armijo fails: shrink (hi = a); else curvature failed: grow (lo = a)
        hi = jnp.where(armijo, hi, a)
        lo = jnp.where(armijo, a, lo)
        a = jnp.where(jnp.isinf(hi), 2 * lo, 0.5 * (lo + hi))
        return (a, lo, hi, k + 1)

    a, *_ = jax.lax.while_loop(
        cond, body, (jnp.asarray(step0, x.dtype), jnp.asarray(0.0, x.dtype), jnp.asarray(jnp.inf, x.dtype), 0)
    )
    return a


def _get_ls(line_search):
    """Resolve a line-search spec: None, a named policy, or a custom callable
    with signature (f, grad_f, x, p, step0) -> step (the callback protocol of
    optimization/callbacks/callbacks.h:26-61, reduced to its one hook)."""
    if callable(line_search):
        return line_search
    return {None: _fixed_step, "backtracking": _backtracking, "wolfe": _wolfe}[
        line_search
    ]


# -- iterative optimizers -----------------------------------------------------
def _descent_loop(f, grad_f, direction_fn, x0, step, tol, max_iter, line_search):
    ls = _get_ls(line_search)
    x0 = jnp.asarray(x0, dtype=jnp.result_type(float))

    def cond(state):
        x, aux, g, k = state
        return (jnp.linalg.norm(g) > tol) & (k < max_iter)

    def body(state):
        x, aux, g, k = state
        p, aux = direction_fn(x, g, aux)
        a = ls(f, grad_f, x, p, step)
        x_new = x + a * p
        g_new = grad_f(x_new)
        aux = _post_update(aux, x_new - x, g_new - g)
        return (x_new, aux, g_new, k + 1)

    def _post_update(aux, s, y):
        if aux is None:
            return None
        # BFGS inverse-hessian update (bfgs.h:76-104)
        H = aux
        sy = jnp.vdot(s, y)
        safe = jnp.abs(sy) > 1e-30
        rho = jnp.where(safe, 1.0 / jnp.where(safe, sy, 1.0), 0.0)
        I = jnp.eye(s.shape[0], dtype=s.dtype)
        V = I - rho * jnp.outer(s, y)
        H_new = V @ H @ V.T + rho * jnp.outer(s, s)
        return jnp.where(safe, H_new, H)

    g0 = grad_f(x0)
    aux0 = direction_fn.init(x0) if hasattr(direction_fn, "init") else None
    x, aux, g, k = jax.lax.while_loop(cond, body, (x0, aux0, g0, 0))
    return OptimizeResult(x, f(x), k)


def gradient_descent(
    objective, x0, step=1e-2, tol=1e-6, max_iter=500, line_search=None
) -> OptimizeResult:
    f = _as_fn(objective)
    grad_f = jax.grad(f)

    def direction(x, g, aux):
        return -g, aux

    return _descent_loop(f, grad_f, direction, x0, step, tol, max_iter, line_search)


def newton(
    objective, x0, step=1.0, tol=1e-6, max_iter=100, line_search=None
) -> OptimizeResult:
    f = _as_fn(objective)
    grad_f = jax.grad(f)
    hess_f = jax.hessian(f)

    from ..linear_algebra.solvers import dense_solve

    def direction(x, g, aux):
        return -dense_solve(hess_f(x), g), aux  # newton.h:70-77

    return _descent_loop(f, grad_f, direction, x0, step, tol, max_iter, line_search)


def bfgs(
    objective, x0, step=1.0, tol=1e-6, max_iter=200, line_search=None
) -> OptimizeResult:
    f = _as_fn(objective)
    grad_f = jax.grad(f)
    n = jnp.asarray(x0).shape[0]

    def direction(x, g, H):
        return -(H @ g), H

    direction.init = lambda x0: jnp.eye(n, dtype=jnp.result_type(float))  # bfgs.h:52
    return _descent_loop(f, grad_f, direction, x0, step, tol, max_iter, line_search)
