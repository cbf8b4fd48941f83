"""Neumann boundary terms: surface load integrals over boundary facets.

The reference core supports Dirichlet conditions only (row surgery,
fem_solver_base.h:142-155); mixed Dirichlet/Neumann problems are a target
configuration of this build. The weak form picks
up the boundary integral

    F_i += int_{Gamma_N} h psi_i ds

computed with a (M-1)-dimensional quadrature over the selected boundary
facets. Facet-local dofs: facet vertices (P1) plus the facet's edge dofs
(P2), matching the volume dof tables.
"""

from __future__ import annotations

import numpy as np

from ..utils.quadrature import standard_fem_quadrature
from .basis import LagrangeBasis

__all__ = ["assemble_neumann", "boundary_facet_selector"]


def boundary_facet_selector(mesh, predicate) -> np.ndarray:
    """Boolean mask over facets: boundary facets whose barycenter satisfies
    `predicate(point) -> bool` (vectorized over points)."""
    facets = mesh.facets
    mask = mesh.boundary_facets.copy()
    centers = mesh.nodes[facets].mean(axis=1)
    sel = np.asarray(predicate(centers)).reshape(-1)
    return mask & sel


def _facet_dofs(mesh, space, facet_ids: np.ndarray) -> np.ndarray:
    """Dof table of the selected facets: (k, n_facet_dofs)."""
    facets = mesh.facets[facet_ids]  # (k, M) vertex ids
    if space.order == 1:
        return facets.astype(np.int64)
    # P2: add the edge dofs of each facet (facet IS an edge in 2D)
    if mesh.local_dim == 2:
        # facet id == edge id in 2D triangulations
        edge_dof = mesh.n_nodes + facet_ids
        return np.concatenate([facets, edge_dof[:, None]], axis=1)
    # 3D: each triangular face has 3 edges; look up their ids
    edge_lookup = {tuple(e): i for i, e in enumerate(map(tuple, mesh.edges))}
    out = np.zeros((facet_ids.size, 6), dtype=np.int64)
    out[:, :3] = facets
    pairs = [(0, 1), (0, 2), (1, 2)]  # lex order: matches reference_nodes
    for r, f in enumerate(facets):
        for c, (a, b) in enumerate(pairs):
            key = (min(f[a], f[b]), max(f[a], f[b]))
            out[r, 3 + c] = mesh.n_nodes + edge_lookup[key]
    return out


def assemble_neumann(space, h, facet_mask: np.ndarray) -> np.ndarray:
    """Boundary load vector from Neumann data `h` on the masked facets.

    h: callable h(x) evaluated at physical facet quadrature points, or a
    constant. Returns a dense (n_dofs,) vector to add to the forcing.
    """
    mesh = space.mesh
    d = mesh.local_dim - 1  # facet dimension
    facet_ids = np.nonzero(facet_mask)[0]
    if facet_ids.size == 0:
        return np.zeros(space.n_dofs)
    coords = mesh.nodes[mesh.facets[facet_ids]]  # (k, d+1, N)

    quad = standard_fem_quadrature(d, space.order)
    basis = LagrangeBasis(d, space.order)
    phi = basis.eval(quad.nodes)  # (nq, n_facet_dofs)

    # facet measures + physical quadrature points
    J = np.swapaxes(coords[:, 1:, :] - coords[:, :1, :], 1, 2)  # (k, N, d)
    if d == 1:
        measure = np.linalg.norm(J[:, :, 0], axis=1)
    else:
        cr = np.cross(J[:, :, 0], J[:, :, 1])
        measure = 0.5 * np.linalg.norm(cr, axis=1) if cr.ndim == 2 else 0.5 * np.abs(cr)
    phys = coords[:, None, 0, :] + np.einsum("knd,qd->kqn", J, quad.nodes)

    if callable(h):
        from ..utils.callables import eval_at_points

        hv = eval_at_points(h, phys.reshape(-1, mesh.embed_dim)).reshape(
            facet_ids.size, quad.num_nodes
        )
    else:
        hv = np.full((facet_ids.size, quad.num_nodes), float(h))

    loc = np.einsum("kq,qi,q->ki", hv, phi, quad.weights) * measure[:, None]
    dofs = _facet_dofs(mesh, space, facet_ids)
    out = np.zeros(space.n_dofs)
    np.add.at(out, dofs.reshape(-1), loc.reshape(-1))
    return out
