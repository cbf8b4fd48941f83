"""Poisson on a genuinely unstructured (jittered Delaunay) mesh, solved
with the smoothed-aggregation AMG preconditioner — the scalable replacement
for the reference's SparseLU on arbitrary meshes.

Run on CPU:  JAX_PLATFORMS=cpu python examples/unstructured_amg.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
from scipy.spatial import Delaunay

import fdapde_core_tpu as fdm

# jittered-grid Delaunay triangulation of the unit square
nx = 48
rng = np.random.default_rng(0)
ii, jj = np.meshgrid(np.arange(nx + 1), np.arange(nx + 1), indexing="ij")
pts = np.stack([ii, jj], axis=-1).reshape(-1, 2).astype(np.float64)
interior = (pts[:, 0] > 0) & (pts[:, 0] < nx) & (pts[:, 1] > 0) & (pts[:, 1] < nx)
pts[interior] += rng.uniform(-0.35, 0.35, size=(interior.sum(), 2))
pts /= nx
mesh = fdm.Triangulation(pts, Delaunay(pts).simplices.astype(np.int32))

# -laplacian u = f with exact solution u = sin(pi x) sin(pi y)
pde = fdm.PDE(
    mesh,
    -fdm.laplacian(),
    forcing=lambda x: 2 * np.pi**2 * np.sin(np.pi * x[0]) * np.sin(np.pi * x[1]),
    order=1,
    solver_preconditioner="amg",  # h-independent CG iteration counts
    solver_maxiter=60,
)
coords = pde.dof_coords()
exact = np.sin(np.pi * coords[:, 0]) * np.sin(np.pi * coords[:, 1])
pde.set_dirichlet_bc(np.zeros(pde.n_dofs))
pde.init()
pde.solve()
print(pde.report())
print("L2 error functional:", pde.l2_error(exact))  # O(h^4) class for P1
