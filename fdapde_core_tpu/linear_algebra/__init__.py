"""Linear algebra: sparse operators, Krylov solvers, structured matrices.

JAX counterpart of `fdaPDE/linear_algebra/`. Eigen sparse storage +
SparseLU factorizations are replaced by:

- `SparseMatrix`: sorted-COO/CSR hybrid container as a JAX pytree; SpMV is a
  gather + segment-sum (XLA-native scatter-add),
- matrix-free preconditioned CG / BiCGStab under `lax.while_loop`
  (`solvers.py`) replacing Eigen::SparseLU (fem_linear_elliptic_solver.h:38-47),
- Kronecker products as structured matvecs (`kron.py`),
- Sherman–Morrison–Woodbury composed solves (`smw.py`),
- row-sum mass lumping (`lumping.py`),
- block-sparse assembly (`block.py`),
- FSPAI-style sparse approximate inverse preconditioner (`fspai.py`).
"""

from .sparse import SparseMatrix
from .solvers import cg, bicgstab, gmres, SolveInfo
from .kron import kron, kron_matvec
from .smw import smw_solve
from .lumping import lump
from .block import SparseBlockMatrix
from .fspai import fspai

__all__ = [
    "SparseMatrix",
    "cg",
    "bicgstab",
    "gmres",
    "SolveInfo",
    "kron",
    "kron_matvec",
    "smw_solve",
    "lump",
    "SparseBlockMatrix",
    "fspai",
]
