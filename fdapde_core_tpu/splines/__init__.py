"""B-spline discretization (1D/time): basis, assembly, solvers.

JAX counterpart of `fdaPDE/splines/`. The reference's compile-time
Cox–de Boor expression recursion (splines/basis/spline.h) becomes a
vectorized de Boor triangle over (points x basis) arrays; the per-pair
knot-span assembly loop (spline_assembler.h:56-69) becomes two small dense
matmuls B^T W B over all Gauss–Legendre points at once (matrix-unit friendly).
"""

from .basis import SplineBasis, spline_basis_matrix
from .space import SplineSpace
from .assembler import assemble_operator, assemble_mass, assemble_forcing

__all__ = [
    "SplineBasis",
    "spline_basis_matrix",
    "SplineSpace",
    "assemble_operator",
    "assemble_mass",
    "assemble_forcing",
]
