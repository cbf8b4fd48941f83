"""FEM linear solvers: elliptic and parabolic, with Dirichlet conditions.

Counterpart of /root/reference/fdaPDE/finite_elements/solvers/. The
reference imposes Dirichlet conditions by row surgery (zero the row, 1 on the
diagonal, rhs = g; fem_solver_base.h:142-155) and then runs SparseLU. Here we
use the mathematically equivalent *symmetric masking* formulation — boundary
rows AND columns are masked, with the boundary coupling moved to the
right-hand side:

    A~ v = mask_d(v) + free(A @ free(v));   b~ = free(b - A (g . mask)) + g . mask

whose solution coincides with the reference's (u restricted to boundary dofs
equals g exactly; interior equations are unchanged). Masking keeps the
operator SPD so CG applies; advection systems use BiCGStab.

The parabolic solver is implicit Euler over a `lax.scan`
(fem_linear_parabolic_solver.h:37-72): K = M/dt + A, per-step rhs
(M/dt) u_i + F_{i+1}, per-step boundary values, CG warm-started from the
previous step (replacing the single sparse factorization + back-substitutions).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..linear_algebra.solvers import bicgstab, cg, gmres, jacobi_preconditioner

__all__ = ["DirichletSystem", "solve_elliptic", "solve_parabolic", "masked_matrix"]


class DirichletSystem(NamedTuple):
    """A linear operator with Dirichlet dofs pinned by masking."""

    A: object  # SparseMatrix
    mask: jnp.ndarray  # (n,) bool, True on Dirichlet dofs

    def __call__(self, v):
        free = ~self.mask
        if v.ndim == 2:
            fm = free[:, None]
            return (self.A @ (v * fm)) * fm + v * (~free)[:, None]
        w = (self.A @ (v * free)) * free
        return w + v * self.mask

    def rhs(self, b, g):
        """Move boundary data to the RHS: b~ as in the module docstring."""
        gm = jnp.where(self.mask, g, 0.0)
        b2 = (b - self.A @ gm) * (~self.mask)
        return b2 + gm

    def diagonal(self):
        d = self.A.diagonal()
        return jnp.where(self.mask, 1.0, d)


def masked_matrix(A, mask):
    """A with Dirichlet rows/cols dropped and 1 on masked diagonal entries.

    The explicit-sparse counterpart of DirichletSystem's on-the-fly masking;
    used when a preconditioner setup (FSPAI, AMG) needs the actual masked
    matrix entries. Assumes the diagonal is present in A's sparsity (always
    true for FEM operators).
    """
    mask = jnp.asarray(mask)
    keep = (~mask)[A.rows] & (~mask)[A.cols]
    vals = jnp.where(keep, A.vals, 0.0)
    vals = jnp.where((A.rows == A.cols) & mask[A.rows], 1.0, vals)
    return A.with_vals(vals)


def auxgrid_preconditioner(sys, coords):
    """Auxiliary structured-grid preconditioner (ops/auxgrid.py) of a
    DirichletSystem: h-independent like AMG, with an order of magnitude
    fewer gathers per application (4 interpolation weights per dof plus a
    stencil V-cycle). Raises ValueError for meshes it cannot cover."""
    from ..ops.auxgrid import AuxGridPreconditioner, AuxGridPreconditioner3D

    coords = np.asarray(coords)
    if coords.ndim != 2 or coords.shape[1] not in (2, 3):
        raise ValueError(
            f"aux-grid needs 2D or 3D dof coordinates, got {coords.shape}"
        )
    cls = AuxGridPreconditioner3D if coords.shape[1] == 3 else AuxGridPreconditioner
    return cls.build(coords, sys.diagonal())


def solve_elliptic(A, b, mask, g, symmetric=True, rtol=1e-12, maxiter=None,
                   recovery=True, preconditioner=None):
    """Solve A u = b with Dirichlet data g on `mask` dofs.

    Counterpart of FEMLinearEllipticSolver::solve
    (fem_linear_elliptic_solver.h:34-50) with CG/BiCGStab in place of
    SparseLU. Solver selection: CG when the operator is symmetric, BiCGStab
    otherwise; `preconditioner` overrides the default Jacobi (callable
    M_inv(r), e.g. an AMG V-cycle from linear_algebra/amg.py).

    Failure recovery (SURVEY §5.3 — the reference only sets success=false,
    fem_linear_elliptic_solver.h:42-45): when the base Krylov solve reports
    converged=False, escalate ONCE — GMRES(50) warm-started from the best
    finite iterate, with an FSPAI approximate-inverse preconditioner
    (linear_algebra/fspai.py) replacing Jacobi for symmetric systems small
    enough to factor host-side. Pass recovery=False to reproduce the bare
    reference behavior.
    """
    sys = DirichletSystem(A, mask)
    if preconditioner == "amg":
        # smoothed-aggregation AMG of the masked operator: h-independent
        # iteration counts on any (unstructured) mesh — the scalable
        # replacement for the reference's SparseLU on general meshes
        from ..linear_algebra.amg import AMG

        pre = AMG.build(masked_matrix(A, mask)).v_cycle
    elif isinstance(preconditioner, tuple) and preconditioner[0] == "auxgrid":
        # caller passes ("auxgrid", dof_coords)
        pre = auxgrid_preconditioner(sys, preconditioner[1])
    else:
        pre = preconditioner or jacobi_preconditioner(sys.diagonal())
    b_mod = sys.rhs(b, g)
    x0 = jnp.where(mask, g, 0.0)
    solver = cg if symmetric else bicgstab
    x, info = solver(sys, b_mod, M_inv=pre, x0=x0, rtol=rtol, maxiter=maxiter)
    # recovery needs a CONCRETE convergence flag: it runs on the eager path
    # (PDE.solve); inside a jit trace the escalation branch is unavailable
    if (
        recovery
        and not isinstance(info.converged, jax.core.Tracer)
        and not bool(info.converged)
    ):
        x, info = _recover_elliptic(
            A, sys, b_mod, x, x0, symmetric, rtol, maxiter, pre
        )
    return x, info


_FSPAI_RECOVERY_MAX_DOFS = 200_000  # host-side setup cost bound


def _recover_elliptic(A, sys, b_mod, x, x0, symmetric, rtol, maxiter, pre):
    """One escalation step: stronger solver (GMRES) and, when affordable,
    a stronger preconditioner (FSPAI of the masked operator)."""
    import warnings

    # restart from the stalled iterate unless it is poisoned (NaN/Inf from a
    # Krylov breakdown — e.g. BiCGStab alpha = rho / <rhat, v> with a zero
    # denominator)
    x_start = jnp.where(jnp.all(jnp.isfinite(x)), x, x0)
    pre_strong = pre
    if symmetric and sys.A.shape[0] <= _FSPAI_RECOVERY_MAX_DOFS:
        try:
            from ..linear_algebra.fspai import fspai

            L = fspai(masked_matrix(A, sys.mask), alpha=8, beta=8, epsilon=1e-4)

            def pre_strong(r):
                return L @ L.rmatvec(r)
        except Exception:  # keep Jacobi if the setup fails
            pre_strong = pre
    warnings.warn(
        "elliptic solve did not converge; escalating to GMRES(50) "
        f"({'FSPAI' if pre_strong is not pre else 'Jacobi'}-preconditioned)",
        stacklevel=3,
    )
    x2, info2 = gmres(
        sys, b_mod, M_inv=pre_strong, x0=x_start, rtol=rtol,
        maxiter=maxiter, restart=50,
    )
    return x2, info2


def solve_parabolic(
    A, Mass, F, mask, g, u0, times, rtol=1e-12, maxiter=None, lumped=False,
    symmetric=True, recovery=True, return_info=False,
):
    """Implicit-Euler time stepping (fem_linear_parabolic_solver.h:37-72).

    A: stiffness, Mass: mass matrix, F: (n, m) forcing per time instant,
    g: (n, m) Dirichlet data per time instant, u0: initial condition,
    times: (m,) uniform grid (dt taken from the first two entries, as
    upstream). With `lumped=True` the mass matrix is row-sum lumped
    (linear_algebra/lumping.h:30) making M/dt diagonal.

    Failure recovery (SURVEY §5.3): the scan collects per-step
    (converged, iterations); a silently stalled step inside lax.scan
    poisons every later step, so if ANY step failed the WHOLE trajectory
    is re-run once with GMRES(50) (lax-loop based, scan-safe). Eager path
    only — inside a jit trace the flags are tracers and escalation is
    unavailable (same contract as the elliptic recovery above).
    `return_info=True` additionally returns a dict with per-step
    iterations/converged arrays and the escalation flag.

    Returns (n, m) solution with column 0 = u0.
    """
    times = jnp.asarray(times).reshape(-1)
    dt = times[1] - times[0]
    if lumped:
        from ..linear_algebra.lumping import lump

        mdiag = lump(Mass) / dt

        def mass_apply(v):
            return mdiag * v

        K = A + _diag_sparse(mdiag)
    else:
        def mass_apply(v):
            return Mass @ v / dt

        K = A + Mass * (1.0 / dt)

    sys = DirichletSystem(K, mask)
    pre = jacobi_preconditioner(sys.diagonal())

    F = jnp.asarray(F)
    g = jnp.asarray(g)
    u0 = jnp.asarray(u0).reshape(-1)

    solver = cg if symmetric else bicgstab

    def make_step(krylov, **kw):
        def step(u_prev, inputs):
            f_next, g_next = inputs
            rhs = mass_apply(u_prev) + f_next
            b_mod = sys.rhs(rhs, g_next)
            x0 = jnp.where(mask, g_next, u_prev)
            u_next, info = krylov(sys, b_mod, M_inv=pre, x0=x0, rtol=rtol,
                                  maxiter=maxiter, **kw)
            return u_next, (u_next, info.converged, info.iterations)

        return step

    _, (us, conv, iters) = jax.lax.scan(
        make_step(solver), u0, (F[:, 1:].T, g[:, 1:].T)
    )
    escalated = False
    if (
        recovery
        and not isinstance(conv, jax.core.Tracer)
        and not bool(jnp.all(conv))
    ):
        import warnings

        first_bad = int(jnp.argmin(conv))
        warnings.warn(
            f"parabolic step {first_bad + 1} did not converge (and poisons "
            "every later step); re-running the trajectory with GMRES(50)",
            stacklevel=2,
        )
        escalated = True
        _, (us, conv, iters) = jax.lax.scan(
            make_step(gmres, restart=50), u0, (F[:, 1:].T, g[:, 1:].T)
        )
    out = jnp.concatenate([u0[:, None], us.T], axis=1)
    if return_info:
        return out, {"converged": conv, "iterations": iters,
                     "escalated": escalated}
    return out


def _diag_sparse(d):
    from ..linear_algebra.sparse import SparseMatrix

    n = d.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    return SparseMatrix(idx, idx, d, (n, n))
