"""Device-scale general-mesh Poisson: the flagship gather pipeline.

Everything stays on device — the irregular-topology mesh (hash-flipped quad
diagonals, node degrees 4..8, jittered coordinates), the element-local
stiffness, the assembled row-ELL operator, the auxiliary-grid
preconditioner, and the mixed-precision converged solve. This is how the
framework reaches 10M+ dofs without shipping a host mesh; on a GPU, raise
`n` to 3200 for the 10.25M-dof benchmark size (bench.py's gen10m group).

Run on CPU:  JAX_PLATFORMS=cpu python examples/device_scale_general.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from fdapde_core_tpu.geometry.structured import irregular_mesh_device
from fdapde_core_tpu.models import MatrixFreePoisson

n = 128  # (n+1)^2 nodes; the benchmark uses n = 3200
nodes, cells, bnd = jax.jit(lambda amp: irregular_mesh_device(n, amp))(0.2)

model = MatrixFreePoisson(nodes, cells, bnd, max_degree=8, grid_n=n)

# -laplace u = 2 pi^2 sin(pi x) sin(pi y), homogeneous Dirichlet
cen = nodes[cells].mean(axis=1)
f = 2 * np.pi**2 * jnp.sin(np.pi * cen[:, 0]) * jnp.sin(np.pi * cen[:, 1])
x, iters, rel = model.solve(model.load_vector(f), rtol=1e-10)

exact = np.sin(np.pi * np.asarray(nodes[:, 0])) * np.sin(
    np.pi * np.asarray(nodes[:, 1])
)
print(f"dofs: {model.n_dofs}, CG iterations: {int(iters)}")
print(f"true relative residual: {float(rel):.2e}")
print(f"max nodal error vs exact: {np.abs(np.asarray(x) - exact).max():.2e}")
