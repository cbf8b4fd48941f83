"""Heat equation with implicit Euler (dt() - laplacian()), P1 elements.

Run on CPU:  JAX_PLATFORMS=cpu python examples/heat_equation.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import fdapde_core_tpu as fdm
from fdapde_core_tpu.geometry.structured import unit_square_mesh

PI = np.pi
mesh = unit_square_mesh(32)
times = np.linspace(0.0, 1.0, 51)


def exact(x, t):
    return np.sin(2 * PI * x[..., 0]) * np.sin(2 * PI * x[..., 1]) * np.exp(-t)


pde = fdm.PDE(mesh, fdm.dt() - fdm.laplacian(), times=times, order=1)
coords = pde.dof_coords()
pde.set_dirichlet_bc(exact(coords[:, None, :], times[None, :]))
pde.set_initial_condition(exact(coords, 0.0))
qn = pde.quadrature_nodes()
pde.set_forcing((8 * PI * PI - 1.0) * exact(qn[:, None, :], times[None, :]))
pde.init()
pde.solve()
g = exact(coords[:, None, :], times[None, :])
print("max-over-time L2 error functional:", pde.l2_error(g))
