"""Mesh geometry: triangulations, point location, search trees, projections.

JAX counterpart of the reference `fdaPDE/geometry/` layer. Meshes are
struct-of-arrays (nodes f64[n,N], cells i32[C,M+1], boolean boundary markers)
instead of per-cell view objects; per-cell quantities (affine maps J, invJ,
measures) are computed as batched device arrays by `affine_maps`.
"""

from .affine import affine_maps
from .interval import Interval
from .network import LinearNetwork
from .triangulation import Triangulation
from .kd_tree import KDTree
from .voronoi import Voronoi
from .projection import project
from .hyperplane import HyperPlane

__all__ = [
    "Triangulation",
    "Interval",
    "LinearNetwork",
    "affine_maps",
    "KDTree",
    "Voronoi",
    "project",
    "HyperPlane",
]
