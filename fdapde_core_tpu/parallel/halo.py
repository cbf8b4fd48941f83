"""Halo-exchange distributed CG over DIA (offset-diagonal) operators.

The owned-dof multi-chip design (SURVEY.md §5.7, §7 phase 5): the dof vector
is split into contiguous blocks, one per device; a DIA SpMV needs each
device's neighbors' edge strips of width H = max |offset| — exchanged with
`jax.lax.ppermute` (one hop left + one hop right per SpMV, riding ICI on
real hardware). Everything else is local shifts + fused multiply-adds; CG
dot products are `psum`s of local partials.

Compared to the replicated-vector design (sharded.py), per-iteration
communication drops from a full-vector psum to two H-wide strips.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["HaloDIASolver", "HaloDIAParabolic"]


def _maybe_escalate(solver, float_attrs, args, x, res, k, bnorm, rtol,
                    maxiter):
    """One-shot escalation for distributed Krylov solves (SURVEY §5.3).

    If the returned residual is non-finite or above tol: recast an f32
    operator to f64 and re-run (the usual distributed stall is the f32
    residual floor); an already-f64 solve gets a
    tripled iteration budget instead. Host-level, one retry, mirrors
    fem/solvers._recover_elliptic.
    """
    import copy
    import math
    import warnings

    resf, bnf = float(res), float(bnorm)
    if math.isfinite(resf) and resf <= rtol * bnf:
        return x, res, k
    if isinstance(float_attrs, str):
        float_attrs = (float_attrs,)
    dt = getattr(solver, float_attrs[0]).dtype
    if dt == jnp.float32:
        warnings.warn(
            "distributed CG stalled at f32 "
            f"(||r||/||b|| = {resf / max(bnf, 1e-300):.2e}); "
            "escalating to an f64 recast of the operator",
            stacklevel=3,
        )
        s2 = copy.copy(solver)
        for a in float_attrs:
            setattr(s2, a, getattr(solver, a).astype(jnp.float64))
        if hasattr(s2, "dtype"):
            s2.dtype = jnp.float64
        s2._solve_jit = jax.jit(s2._solve, static_argnames=("maxiter",))
        args64 = tuple(
            a.astype(jnp.float64) if a.dtype in (jnp.float32, jnp.bfloat16)
            else a
            for a in args
        )
        x, res, k, bnorm = s2._solve_jit(*args64, rtol, maxiter=maxiter)
    else:
        warnings.warn(
            "distributed CG stalled "
            f"(||r||/||b|| = {resf / max(bnf, 1e-300):.2e}); "
            "escalating with a 3x iteration budget",
            stacklevel=3,
        )
        x, res, k, bnorm = solver._solve_jit(
            *args, rtol, maxiter=3 * maxiter
        )
    return x, res, k


class HaloDIASolver:
    """Distributed Jacobi-CG for a DIAMatrix over a 1D device mesh."""

    def __init__(self, dia, device_mesh: Mesh):
        self.offsets = dia.offsets
        self.H = max(abs(d) for d in self.offsets)
        self.device_mesh = device_mesh
        self.P = device_mesh.devices.size
        n = dia.n
        self.n = n
        self.block = -(-n // self.P)
        self.n_pad = self.block * self.P
        pad = self.n_pad - n
        data = jnp.pad(dia.data, ((0, 0), (0, pad)))
        sh = NamedSharding(device_mesh, P(None, "shard"))
        self.data = jax.device_put(data, sh)
        assert self.H <= self.block, (
            f"halo width {self.H} exceeds block size {self.block}; "
            "use fewer devices or reorder dofs"
        )
        self._solve_jit = jax.jit(self._solve, static_argnames=("maxiter",))

    def _pad(self, v):
        return jnp.pad(jnp.asarray(v, self.data.dtype), (0, self.n_pad - self.n))

    def _solve(self, b, free, rtol, maxiter):
        mesh = self.device_mesh
        H = self.H
        offsets = self.offsets
        nloc = self.block
        nshards = self.P
        fwd = [(i, i + 1) for i in range(nshards - 1)]
        bwd = [(i + 1, i) for i in range(nshards - 1)]

        def shard_fn(data, b, free):
            def halo_extend(x):
                # strip from the LEFT neighbor (their rightmost H entries)
                left = jax.lax.ppermute(x[-H:], "shard", perm=fwd)
                right = jax.lax.ppermute(x[:H], "shard", perm=bwd)
                return jnp.concatenate([left, x, right])

            def Ax(x):
                xf = x * free
                ext = halo_extend(xf)
                y = jnp.zeros_like(x)
                for k, d in enumerate(offsets):
                    y = y + data[k] * jax.lax.dynamic_slice_in_dim(
                        ext, H + d, nloc
                    )
                return y * free + x * (1 - free)

            def dot(a, c):
                return jax.lax.psum(jnp.vdot(a, c), "shard")

            diag = data[offsets.index(0)]
            inv_diag = jnp.where(
                jnp.abs(diag) > 0, 1.0 / jnp.where(diag == 0, 1.0, diag), 1.0
            ) * free + (1 - free)

            bnorm = jnp.sqrt(dot(b, b))
            tol = rtol * bnorm
            r0 = b  # x0 = 0
            z0 = inv_diag * r0
            rz0 = dot(r0, z0)

            def cond(state):
                x, r, z, p, rz, k = state
                rn = jnp.sqrt(dot(r, r))
                return (rn > tol) & (k < maxiter) & jnp.isfinite(rn)

            def body(state):
                x, r, z, p, rz, k = state
                Ap = Ax(p)
                alpha = rz / dot(p, Ap)
                x = x + alpha * p
                r = r - alpha * Ap
                z = inv_diag * r
                rz_new = dot(r, z)
                p = z + (rz_new / rz) * p
                return (x, r, z, p, rz_new, k + 1)

            x, r, *_, k = jax.lax.while_loop(
                cond, body, (jnp.zeros_like(b), r0, z0, z0, rz0, 0)
            )
            return x, jnp.sqrt(dot(r, r)), k, bnorm

        return jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P(None, "shard"), P("shard"), P("shard")),
            out_specs=(P("shard"), P(), P(), P()),
        )(self.data, b, free)

    def solve(self, b, free_mask, rtol=1e-10, maxiter=1000, recovery=True):
        """Solve A x = b with Dirichlet dofs pinned where free_mask == 0.

        b must already carry boundary values at pinned dofs (see
        fem/solvers.py DirichletSystem.rhs for the reduction).
        Returns (x[:n], residual, iterations).

        Failure recovery (SURVEY §5.3): a distributed CG that stalls or
        goes non-finite gets ONE escalation — f32 operators are recast to
        f64 (the usual stall cause is the f32 residual floor),
        otherwise the iteration budget is tripled.
        """
        b = self._pad(b)
        free = self._pad(jnp.asarray(free_mask, self.data.dtype))
        x, res, k, bnorm = self._solve_jit(b, free, rtol, maxiter=maxiter)
        if recovery:
            x, res, k = _maybe_escalate(
                self, "data", (b, free), x, res, k, bnorm, rtol, maxiter,
            )
        return x[: self.n], res, k


class HaloDIAParabolic:
    """Distributed implicit-Euler stepping over DIA operators.

    K = M/dt + A (both DIA, same offset set); each step solves
    K u_{t+1} = (M/dt) u_t + F_{t+1} with boundary values pinned — the
    sharded counterpart of fem/solvers.solve_parabolic, with the entire
    `lax.scan` over time inside one shard_map region (per-step comm: the
    halo strips of the SpMVs + psum'd dot products).
    """

    def __init__(self, A_dia, M_dia, dt: float, device_mesh: Mesh):
        assert A_dia.offsets == M_dia.offsets, "operators must share offsets"
        self.K = HaloDIASolver(
            type(A_dia)(A_dia.data + M_dia.data / dt, A_dia.offsets, A_dia.n),
            device_mesh,
        )
        sh = NamedSharding(device_mesh, P(None, "shard"))
        pad = self.K.n_pad - M_dia.n
        self.Mdata = jax.device_put(
            jnp.pad(M_dia.data / dt, ((0, 0), (0, pad))), sh
        )
        self.device_mesh = device_mesh
        self._jit = jax.jit(self._run, static_argnames=("maxiter",))

    def _run(self, F, G, u0, free, rtol, maxiter):
        K = self.K
        H, nloc, nshards = K.H, K.block, K.P
        offsets = K.offsets
        fwd = [(i, i + 1) for i in range(nshards - 1)]
        bwd = [(i + 1, i) for i in range(nshards - 1)]

        def shard_fn(kdata, mdata, F, G, u0, free):
            def halo_extend(x):
                left = jax.lax.ppermute(x[-H:], "shard", perm=fwd)
                right = jax.lax.ppermute(x[:H], "shard", perm=bwd)
                return jnp.concatenate([left, x, right])

            def spmv(data, x):
                ext = halo_extend(x)
                y = jnp.zeros_like(x)
                for k, d in enumerate(offsets):
                    y = y + data[k] * jax.lax.dynamic_slice_in_dim(ext, H + d, nloc)
                return y

            def dot(a, c):
                return jax.lax.psum(jnp.vdot(a, c), "shard")

            diag = kdata[offsets.index(0)]
            inv_diag = jnp.where(
                jnp.abs(diag) > 0, 1.0 / jnp.where(diag == 0, 1.0, diag), 1.0
            ) * free + (1 - free)

            def Ax(x):
                y = spmv(kdata, x * free)
                return y * free + x * (1 - free)

            def cg(b, x0):
                r0 = b - Ax(x0)
                z0 = inv_diag * r0
                bnorm = jnp.sqrt(dot(b, b))
                tol = rtol * bnorm

                def cond(s):
                    x, r, z, p, rz, k = s
                    rn = jnp.sqrt(dot(r, r))
                    return (rn > tol) & (k < maxiter) & jnp.isfinite(rn)

                def body(s):
                    x, r, z, p, rz, k = s
                    Ap = Ax(p)
                    alpha = rz / dot(p, Ap)
                    x = x + alpha * p
                    r = r - alpha * Ap
                    z = inv_diag * r
                    rz_new = dot(r, z)
                    p = z + (rz_new / rz) * p
                    return (x, r, z, p, rz_new, k + 1)

                x, *_ = jax.lax.while_loop(
                    cond, body, (x0, r0, z0, z0, dot(r0, z0), 0)
                )
                return x

            def step(u, inputs):
                f_next, g_next = inputs
                gm = g_next * (1 - free)
                rhs = spmv(mdata, u) + f_next
                # move boundary columns to the RHS (unmasked K action on gm)
                col = spmv(kdata, gm)
                b_mod = (rhs - col) * free + gm
                u_next = cg(b_mod, jnp.where(free > 0, u, gm))
                return u_next, u_next

            _, us = jax.lax.scan(step, u0, (F, G))
            return us

        return jax.shard_map(
            shard_fn,
            mesh=self.device_mesh,
            in_specs=(
                P(None, "shard"),
                P(None, "shard"),
                P(None, "shard"),
                P(None, "shard"),
                P("shard"),
                P("shard"),
            ),
            out_specs=P(None, "shard"),
        )(self.K.data, self.Mdata, F, G, u0, free)

    def solve(self, F, G, u0, free_mask, rtol=1e-10, maxiter=500):
        """F, G: (n, m) forcing / Dirichlet data per time instant (columns
        AFTER the initial one, i.e. m = n_steps); u0: initial condition.
        Returns (n, m) trajectory (excluding u0)."""
        K = self.K
        pad = K.n_pad - K.n
        Fp = jnp.pad(jnp.asarray(F, K.data.dtype), ((0, pad), (0, 0))).T  # (m, n_pad)
        Gp = jnp.pad(jnp.asarray(G, K.data.dtype), ((0, pad), (0, 0))).T
        u0p = K._pad(u0)
        free = K._pad(jnp.asarray(free_mask, K.data.dtype))
        us = self._jit(Fp, Gp, u0p, free, rtol, maxiter=maxiter)
        return us[:, : K.n].T
