"""Performance-critical device ops: assembly contractions and SpMV variants.

The hot paths of the framework (SURVEY.md §2.10 mapping):

- closed-form and batched local-matrix assembly (XLA-fused elementwise),
- `ell.py`: scatter-free SpMV — the element-local products are combined per
  dof through a precomputed ELL adjacency (pure gathers + a small-axis
  reduction), avoiding `segment_sum`'s scatter-add.
"""

from .closed_form import SYM_TO_FULL, p1_stiffness_2d_sym, pack_cell_axis
from .dia_split import (
    BandedMGPreconditioner,
    BandedSplit,
    build_banded_split,
    plan_split_width,
)
from .dia_split3d import (
    BandedMGPreconditioner3D,
    BandedSplit3D,
    build_banded_split_3d,
    plan_split_3d,
)
from .ell import ELLMatrix, build_ell_adjacency, ell_spmv, local_matvec
from .matfree import MatrixFreeLocal, p1_local_stiffness
from .matfree_soa import (
    ELLSoA,
    MatrixFreeSoA,
    MatrixFreeSoA3D,
    ell_from_op_blocked,
)
from .window_spmv import WindowedELL

__all__ = [
    "ELLMatrix",
    "ELLSoA",
    "SYM_TO_FULL",
    "BandedMGPreconditioner",
    "BandedMGPreconditioner3D",
    "BandedSplit",
    "BandedSplit3D",
    "WindowedELL",
    "MatrixFreeLocal",
    "MatrixFreeSoA",
    "MatrixFreeSoA3D",
    "build_banded_split",
    "build_banded_split_3d",
    "build_ell_adjacency",
    "ell_from_op_blocked",
    "ell_spmv",
    "local_matvec",
    "p1_local_stiffness",
    "p1_stiffness_2d_sym",
    "pack_cell_axis",
    "plan_split_3d",
    "plan_split_width",
]
