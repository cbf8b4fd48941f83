"""Finite-element discretization: Lagrange bases, assembly, solvers.

JAX counterpart of `fdaPDE/finite_elements/`. The reference's serial
per-cell assembly loop (fem_assembler.h:79-110) becomes a batched quadrature
contraction over all cells at once (einsum) followed by a segment-sum
scatter-add into sorted COO (the `setFromTriplets` equivalent); the SparseLU
solve becomes matrix-free preconditioned CG/BiCGStab.
"""

from .reference_element import reference_nodes
from .basis import tabulate_basis, LagrangeBasis
from .space import FEMSpace
from .assembler import assemble_matrix, assemble_forcing
from .evaluation import eval_basis_pointwise, eval_basis_areal

__all__ = [
    "reference_nodes",
    "tabulate_basis",
    "LagrangeBasis",
    "FEMSpace",
    "assemble_matrix",
    "assemble_forcing",
    "eval_basis_pointwise",
    "eval_basis_areal",
]
