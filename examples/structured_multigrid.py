"""Structured-grid fast path: multigrid-preconditioned Poisson at scale.

The StructuredPoisson model composes the framework's structured-grid
accelerations (coords->stencil assembly -> Dirichlet fold + layer pruning
-> Galerkin multigrid CG). Iteration counts are h-independent (~7-15 at
any size); with refine=True the CG vectors are f64 around an f32 operator
and V-cycle, which restores f64-grade true residuals.

Run on CPU:  JAX_PLATFORMS=cpu python examples/structured_multigrid.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import jax.numpy as jnp

from fdapde_core_tpu.models import StructuredPoisson

n = 64
model = StructuredPoisson(n, dtype=jnp.float64, coarse_n=8)

# -Laplace u = 1, u = 0 on the boundary
x, rel, iters = model.solve(rtol=1e-10)
print(f"f = 1 solve: {int(iters)} MG-CG iterations, true rel residual {float(rel):.2e}")
print(f"u(center) = {float(np.asarray(x).reshape(n + 1, n + 1)[n // 2, n // 2]):.6f}"
      "  (exact series value ~ 0.073671)")

# harmonic reproduction: f = 0, u = g = x + y on the boundary -> u == g
xs = np.linspace(0, 1, n + 1)
g = (xs[:, None] + xs[None, :]).reshape(-1)
b = model.rhs(0.0, g=jnp.asarray(g))
xh, relh, kh = model.solve(b=b, rtol=1e-10)
print(f"harmonic: {int(kh)} iterations, max |u - g| = "
      f"{np.abs(np.asarray(xh) - g).max():.2e}")
