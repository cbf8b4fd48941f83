"""Structured-grid Poisson fast path: the full structured pipeline.

For tensor-product meshes (geometry/structured.py connectivity) this driver
composes every structured-grid acceleration in the framework into one
product-level API — the same capabilities as `PDE(mesh, -laplacian())` on a
general mesh, at the 10M-dof scale:

  device mesh synthesis -> coords->stencil assembly in one elementwise
  pass (ops/grid_assembly.stencil_from_coords: local assembly + global
  stencil scatter) -> Dirichlet identity fold + exact-zero layer pruning
  (ops/grid_dia) -> geometric-multigrid preconditioned CG (ops/grid_mg)
  with f64 Krylov vectors around the f32 operator and V-cycle (f32's
  attainable TRUE residual at kappa ~ 1/h^2 is O(eps32 * kappa); the f64
  vectors restore f64-grade residuals while the V-cycle stays f32).

Reference anchor: PDE + FEMLinearEllipticSolver (pde/pde.h:40-114,
fem_linear_elliptic_solver.h:34-50) specialized to structured geometry.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..ops.grid_assembly import stencil_from_coords
from ..ops.grid_dia import GridDIAMatrix, prune_zero_offsets_grid
from ..ops.grid_mg import GridMG, _stencil, mg_preconditioned_cg

__all__ = ["StructuredPoisson"]


class StructuredPoisson:
    """-Laplace u = f on the unit square, P1, n x n structured grid.

    Dirichlet data g on the boundary. `dtype` is the assembly/solve
    precision; `refine=True` adds an f64 outer refinement loop (requires
    x64 enabled). Use n divisible by a few powers of two for deep
    multigrid coarsening.
    """

    def __init__(self, n: int, dtype=jnp.float32, coarse_n: int = 32):
        self.n = n
        self.m = n + 1
        self.dtype = dtype
        self.coarse_n = coarse_n
        self._G = None
        self._mg = None

    # -- pipeline stages (all jitted, device-resident) ----------------------

    def _build(self):
        n, m, dtype = self.n, self.m, self.dtype

        @jax.jit
        def go(shift):
            # node coordinate PLANES (ops/grid_assembly.stencil_from_coords);
            # the traced `shift` keeps XLA from constant-folding the nullary
            # build into a large program literal
            gi = jnp.arange(m, dtype=dtype)[:, None] + shift
            gj = jnp.arange(m, dtype=dtype)[None, :]
            X = gi / n + 0.0 * gj
            Y = gj / n + 0.0 * gi
            ii = jnp.arange(m)
            interior = (ii > 0) & (ii < m - 1)
            free = (interior[:, None] & interior[None, :]).astype(dtype)
            return X, Y, free

        return go(dtype(0.0))

    def operator(self) -> GridDIAMatrix:
        """Assembled, Dirichlet-folded, pruned stencil operator."""
        if self._G is None:
            X, Y, free = self._build()
            self._free = free

            @jax.jit
            def assemble(X, Y, free):
                G = stencil_from_coords(X, Y, self.n)
                return G, G.with_dirichlet_identity(free.reshape(-1))

            G_raw, G = assemble(X, Y, free)
            # raw (unfolded) operator kept for boundary lifting in rhs():
            # the folded operator's boundary COLUMNS are zeroed, so lifting
            # must use the original column action
            self._G_raw = prune_zero_offsets_grid(G_raw)
            self._G = prune_zero_offsets_grid(G)
        return self._G

    def multigrid(self) -> GridMG:
        if self._mg is None:
            self._mg = GridMG.build(self.operator(), coarse_n=self.coarse_n)
        return self._mg

    def rhs(self, f_value: float = 1.0, g=None):
        """Load vector of a constant forcing (+ Dirichlet data g).

        For general forcings assemble with fem/assembler on the
        triangulation; constant forcing covers the classic benchmark and
        keeps everything on device.
        """
        self.operator()
        free = self._free
        m, dtype = self.m, self.dtype
        h2 = 1.0 / (self.n * self.n)
        b = free * (f_value * h2)
        if g is not None:
            g = jnp.asarray(g, dtype).reshape(m, m)
            glift = (1.0 - free) * g
            # lifting uses the RAW operator's column action (the folded
            # operator's boundary columns are zeroed)
            Gr = self._G_raw
            col = _stencil(Gr.data, Gr.offsets2d, glift, m)
            b = free * (b - col) + glift
        return b.reshape(-1)

    def solve(self, b=None, rtol: float = 1e-8, maxiter: int = 60,
              refine: bool | str = "auto", n_refine: int = 10):
        """MG-preconditioned CG; returns (x, true_rel_residual, iterations).

        refine=True (the DEFAULT whenever x64 is enabled, "auto"): MIXED-
        PRECISION CG — f64 vectors with the V-cycle preconditioner applied
        in the model dtype (f32): the f32 rounding perturbs the
        preconditioner, not the f64 Krylov recurrence. Plain f32 MG-CG
        stalls at a TRUE relative residual of O(eps32 * kappa), so pass
        refine=False only for the raw-f32 iteration engine. n_refine is
        retained for API compatibility (unused)."""
        if refine == "auto":
            refine = bool(jax.config.jax_enable_x64)
        G = self.operator()
        mg = self.multigrid()
        if b is None:
            b = self.rhs()
        if not refine:
            return _mg_cg_fn(float(rtol), int(maxiter), None)(G, mg, b)
        if not jax.config.jax_enable_x64:
            raise ValueError("refine=True needs x64 enabled")
        run = _mg_cg_fn(float(rtol), int(maxiter), jnp.dtype(self.dtype))
        return run(G, mg, jnp.asarray(b, jnp.float64))


@functools.lru_cache(maxsize=None)
def _mg_cg_fn(rtol: float, maxiter: int, prec_dtype):
    """One jitted MG-CG per (rtol, maxiter, V-cycle dtype): repeated
    solves reuse the compiled program."""
    return jax.jit(
        lambda G, mg, b: mg_preconditioned_cg(
            G, b, rtol=rtol, maxiter=maxiter, mg=mg, prec_dtype=prec_dtype
        )
    )
