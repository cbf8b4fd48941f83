"""fdapde-core: a JAX framework for physics-informed spatial and
functional data analysis.

A JAX/XLA re-design of the capabilities of fdaPDE-core (the reference:
C++20 header-only, Eigen-based):

- finite-element solvers for second-order linear elliptic and parabolic BVPs on
  1D/1.5D/2D/2.5D/3D simplicial meshes,
- B-spline discretizations (incl. 4th-order bilaplacian),
- symbolic differential-operator composition,
- nonlinear optimizers (grid / gradient descent / Newton / BFGS + line search),
- mesh geometry (triangulations, point location, Voronoi, projections),
- supporting linear algebra (Kronecker, sparse blocks, SMW, lumping, SPAI).

Architecture: meshes are struct-of-arrays, assembly is a batched quadrature
contraction over element blocks (einsum), global matrices are COO/CSR
with segment-sum scatter-add, linear solves are matrix-free preconditioned
Krylov iterations under `jax.jit`, multi-chip scaling uses `jax.sharding.Mesh`
+ `shard_map` with `psum`/halo collectives.

Precision: by default the package enables JAX x64 so that reference-parity
tests (f64 tolerances, see the reference's test/src/fem_pde_test.cpp) pass.
Set the environment variable FDAPDE_TPU_X64=0 *before* importing to keep f32
(the benchmark's structured group does).
"""

import os as _os

import jax as _jax

if _os.environ.get("FDAPDE_TPU_X64", "1") != "0":
    _jax.config.update("jax_enable_x64", True)

from . import (  # noqa: E402
    fem,
    fields,
    geometry,
    linear_algebra,
    models,
    ops,
    optimization,
    parallel,
    pde,
    splines,
    utils,
)
from .geometry import Interval, LinearNetwork, Triangulation  # noqa: E402
from .pde import (  # noqa: E402
    PDE,
    advection,
    bilaplacian,
    diffusion,
    dt,
    laplacian,
    reaction,
)

__version__ = "0.1.0"
