"""Multi-chip execution: mesh partitioning + shard_map'ed assembly and CG.

This layer is a *new design obligation* of the JAX build (SURVEY.md §5.7-5.8):
the reference is single-threaded end-to-end (its ThreadPool is dead code,
multithreading.h is empty). Here:

- `partition.py`: space-filling-curve (Morton) element reordering and
  equal-size block partitioning with padding,
- `sharded.py`: `shard_map`ped element-local assembly (zero communication)
  and a conjugate-gradient iteration whose SpMV is
  "local partial products + psum" over the device mesh, with all dot
  products computed on replicated vectors.

The v1 strategy shards the *elements* (where all the FLOPs are) and
replicates the dof vector: assembly is embarrassingly parallel; each CG
SpMV costs one `psum` over the device interconnect. Owned-dof partitioning with halo
`ppermute` exchange is the planned v2 (SURVEY.md §7 phase 5).
"""

from .halo import HaloDIAParabolic, HaloDIASolver
from .halo_ell import HaloELLSolver
from .halo_grid import HaloGridDIASolver
from .partition import morton_order, partition_elements
from .sharded import ShardedPoisson, make_device_mesh
from .space_time import ShardedSpaceTime

__all__ = [
    "ShardedSpaceTime",
    "morton_order",
    "partition_elements",
    "ShardedPoisson",
    "make_device_mesh",
    "HaloDIASolver",
    "HaloDIAParabolic",
    "HaloELLSolver",
    "HaloGridDIASolver",
]
