"""High-level problem drivers ("model families").

The reference's user-facing surface is the PDE descriptor plus its solver
selection (pde/pde.h + finite_elements/solvers/ + splines/solvers/); this
package collects the corresponding ready-to-use entry points of this build:

- `PDE` (re-export): elliptic / parabolic, FEM / SPLINE,
- `solve_semilinear`: Newton outer loop for semilinear problems,
- `SeparableOperator` / `solve_space_time`: Kronecker-structured space-time
  systems (spline-in-time x FEM-in-space), solved matrix-free,
- `ShardedPoisson` (re-export): the multi-chip pipeline,
- `StructuredPoisson`: the structured-grid fast path (coords->stencil
  assembly -> multigrid CG with f64 Krylov vectors).
"""

from ..fem.nonlinear import solve_semilinear
from ..parallel.sharded import ShardedPoisson
from ..pde import PDE
from .space_time import (
    ModeDiagPreconditioner,
    ModeMGPreconditioner,
    SeparableOperator,
    SpaceTimeSmoothing,
    solve_space_time,
    solve_space_time_fdm,
)
from .sharded_driver import solve_elliptic_sharded
from .structured import StructuredPoisson
from .regression import SmoothingRegression
from .matfree import (
    MatrixFreeElliptic,
    MatrixFreeParabolic,
    MatrixFreePoisson,
)

__all__ = [
    "PDE",
    "MatrixFreePoisson",
    "MatrixFreeElliptic",
    "MatrixFreeParabolic",
    "solve_semilinear",
    "SeparableOperator",
    "ModeDiagPreconditioner",
    "ModeMGPreconditioner",
    "solve_space_time",
    "solve_space_time_fdm",
    "SpaceTimeSmoothing",
    "ShardedPoisson",
    "solve_elliptic_sharded",
    "StructuredPoisson",
    "SmoothingRegression",
]
