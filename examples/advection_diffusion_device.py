"""General elliptic operators at device scale: the full assembler envelope.

-div(K grad u) + b . grad u + c u = f  on an arbitrary 2D triangulation,
with tensor/space-varying K, through the same gather pipeline as the 10M-dof
Poisson flagship (ops/matfree_soa.py). Non-symmetric => chunked BiCGStab
(bounded device programs; see linear_algebra/solvers.bicgstab_chunked)
preconditioned by the device-built auxiliary grid.

Mirrors the reference assembler's operator algebra
(fdaPDE/finite_elements/fem_assembler.h:63-118, operators/advection.h:33-56)
without leaving the device-scale path.

Run on CPU:  JAX_PLATFORMS=cpu python examples/advection_diffusion_device.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp

from fdapde_core_tpu.geometry.structured import irregular_mesh_device_soa
from fdapde_core_tpu.models.matfree import MatrixFreeElliptic

n = 96  # (n+1)^2 dofs; the benchmark runs n = 1024 (1.05M dofs)
x, y, c0, c1, c2, bnd = jax.jit(
    lambda amp: irregular_mesh_device_soa(n, amp, dtype=jnp.float64)
)(jnp.float64(0.2))
cells = jnp.stack([c0, c1, c2], axis=1)

model = MatrixFreeElliptic(
    (x, y), cells, bnd,
    K=(1.3, 0.2, 0.9),          # anisotropic tensor (kxx, kxy, kyy)
    b=(1.0, 0.5),               # advection field
    c=0.3,                      # reaction
)

f = jnp.ones(2 * n * n, jnp.float64)
rhs = model.load_vector(f)

# chunk= bounds every device program to <=8 Krylov iterations and reports
# progress between chunks
sol, iters, rel = model.solve(
    rhs, rtol=1e-9, maxiter=200, chunk=8,
    on_chunk=lambda k, r: print(f"  iter {k:3d}  ||r|| = {r:.3e}"),
)
print(f"dofs: {model.n_dofs}, BiCGStab iterations: {int(iters)}")
print(f"true relative residual: {float(rel):.2e}")
