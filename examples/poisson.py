"""Solve -Δu = 4 on the unit square with Dirichlet data (P2 elements).

Run on CPU:  JAX_PLATFORMS=cpu python examples/poisson.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import fdapde_core_tpu as fdm
from fdapde_core_tpu.geometry.structured import unit_square_mesh

mesh = unit_square_mesh(64)
pde = fdm.PDE(mesh, -fdm.laplacian(), forcing=lambda x: 4.0, order=2)
coords = pde.dof_coords()
exact = 1.0 - coords[:, 0] ** 2 - coords[:, 1] ** 2
pde.set_dirichlet_bc(exact)
pde.init()
pde.solve()
print(pde.report())
print("L2 error functional:", pde.l2_error(exact))
