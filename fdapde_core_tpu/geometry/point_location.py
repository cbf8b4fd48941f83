"""Point location: which cell contains each query point.

Replaces the reference's pointer-chasing ADT search
(/root/reference/fdaPDE/geometry/tree_search.h) and barycentric walk
(walk_search.h) with a uniform-grid candidate filter + exact vectorized
barycentric `contains` test (semantics of simplex.h:115-127, including the
manifold supporting-plane distance check). The grid maps directly onto
gather patterns for a device implementation; here it runs host-side as
mesh preprocessing.
"""

from __future__ import annotations

import numpy as np

MACHINE_EPSILON = 10 * np.finfo(np.float64).eps  # utils/symbols.h:164

__all__ = ["CellLocator", "DeviceCellLocator", "contains"]


def contains(mesh, cell_ids: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Exact containment test of points[i] in cell cell_ids[i] (vectorized).

    Mirrors Simplex::contains (simplex.h:115-127): barycentric coordinates
    must all be >= -machine_epsilon; on manifolds the point must additionally
    lie on the supporting plane (distance <= machine_epsilon).
    """
    from .affine import affine_maps_np

    J, invJ, _ = affine_maps_np(mesh.nodes, mesh.cells)
    p0 = mesh.nodes[mesh.cells[cell_ids, 0]]  # (k, N)
    d = points - p0
    z = np.einsum("kmn,kn->km", invJ[cell_ids], d)  # (k, M)
    z0 = 1.0 - z.sum(axis=1)
    inside = (z >= -MACHINE_EPSILON).all(axis=1) & (z0 >= -MACHINE_EPSILON)
    if mesh.is_manifold:
        # distance from supporting plane: || p - (p0 + J z) ||
        proj = p0 + np.einsum("knm,km->kn", J[cell_ids], z)
        dist = np.linalg.norm(points - proj, axis=1)
        inside &= dist <= MACHINE_EPSILON
    return inside


class CellLocator:
    """Uniform-grid spatial index over cell bounding boxes."""

    def __init__(self, mesh, resolution: int | None = None):
        self.mesh = mesh
        coords = mesh.cell_coords  # (C, M+1, N)
        self.lo = coords.min(axis=1)  # (C, N)
        self.hi = coords.max(axis=1)
        self.gmin = mesh.range[0]
        self.gmax = mesh.range[1]
        N = mesh.embed_dim
        if resolution is None:
            resolution = max(1, int(np.ceil(mesh.n_cells ** (1.0 / N))))
        self.res = resolution
        span = np.where(self.gmax > self.gmin, self.gmax - self.gmin, 1.0)
        self.scale = self.res / span
        # bin ranges per cell; register each cell in all bins its bbox
        # overlaps — fully vectorized (ragged expansion over the span grid)
        lo_bin = self._bin(self.lo)  # (C, N)
        hi_bin = self._bin(self.hi)
        spans = hi_bin - lo_bin + 1
        counts = spans.prod(axis=1)
        total = int(counts.sum())
        cell_ids = np.repeat(np.arange(mesh.n_cells, dtype=np.int32), counts)
        resets = np.repeat(np.cumsum(counts) - counts, counts)
        local = np.arange(total, dtype=np.int64) - resets  # rank within cell
        spans_rep = spans[cell_ids]
        lo_rep = lo_bin[cell_ids]
        # decode row-major local rank into per-axis offsets
        bin_ids = np.zeros(total, dtype=np.int64)
        divisor = np.ones(total, dtype=np.int64)
        for d in range(N - 1, -1, -1):
            off = (local // divisor) % spans_rep[:, d]
            bin_ids += (lo_rep[:, d] + off) * self.res ** (N - 1 - d)
            divisor *= spans_rep[:, d]
        order = np.argsort(bin_ids, kind="stable")
        self.bin_cells = cell_ids[order]
        counts = np.bincount(bin_ids, minlength=self.res**N)
        self.bin_offsets = np.zeros(self.res**N + 1, dtype=np.int64)
        np.cumsum(counts, out=self.bin_offsets[1:])

    def _bin(self, pts):
        b = np.floor((pts - self.gmin) * self.scale).astype(np.int64)
        return np.clip(b, 0, self.res - 1)

    def padded_bin_table(self):
        """(n_bins, K) candidate table, -1 padded, K = max bin occupancy.

        The static-shape form of (bin_offsets, bin_cells) consumed by
        DeviceCellLocator."""
        counts = np.diff(self.bin_offsets)
        K = max(1, int(counts.max()))
        n_bins = counts.size
        table = np.full((n_bins, K), -1, dtype=np.int32)
        # ragged fill without a Python loop
        bins = np.repeat(np.arange(n_bins), counts)
        slot = np.arange(self.bin_cells.size) - np.repeat(
            self.bin_offsets[:-1], counts
        )
        table[bins, slot] = self.bin_cells
        return table

    def locate(self, points: np.ndarray) -> np.ndarray:
        points = np.atleast_2d(np.asarray(points, dtype=np.float64))
        n = points.shape[0]
        out = np.full(n, -1, dtype=np.int32)
        inside_box = np.logical_and(
            (points >= self.gmin - MACHINE_EPSILON).all(axis=1),
            (points <= self.gmax + MACHINE_EPSILON).all(axis=1),
        )
        bins = np.ravel_multi_index(
            self._bin(points).T, (self.res,) * self.mesh.embed_dim
        )
        # expand (point, candidate cell) pairs, then one vectorized contains()
        starts = self.bin_offsets[bins]
        ends = self.bin_offsets[bins + 1]
        counts = (ends - starts) * inside_box
        pt_idx = np.repeat(np.arange(n), counts)
        if pt_idx.size:
            # ragged arange: flat candidate positions without a Python loop
            total = int(counts.sum())
            resets = np.repeat(np.cumsum(counts) - counts, counts)
            pos = np.arange(total) - resets + np.repeat(starts, counts)
            cand = self.bin_cells[pos]
            hit = contains(self.mesh, cand, points[pt_idx])
            # keep first hit per point
            hp, hc = pt_idx[hit], cand[hit]
            # reverse so earlier candidates win after assignment
            out[hp[::-1]] = hc[::-1]
        return out


class DeviceCellLocator:
    """Point location ON DEVICE: uniform-grid bins as dense arrays + one
    vmapped exact containment test, all inside jit.

    The device-scale replacement of the reference's per-point ADT tree
    search (/root/reference/fdaPDE/geometry/tree_search.h:28-84): query
    batches of millions of observation points (the Psi matrix feed,
    lagrangian_basis.h:203-235) are located with O(K) static work per point
    — a bin-table gather, K candidate invJ gathers, and an argmax — instead
    of host pointer chasing. Exact semantics match CellLocator/`contains`
    (simplex.h:115-127), including the manifold supporting-plane test.
    """

    def __init__(self, mesh, resolution: int | None = None):
        import jax.numpy as jnp

        from .affine import affine_maps_np

        host = CellLocator(mesh, resolution)
        self.mesh = mesh
        self.res = host.res
        table = host.padded_bin_table()
        self.capacity = table.shape[1]
        J, invJ, _ = affine_maps_np(mesh.nodes, mesh.cells)
        self.table = jnp.asarray(table)  # (res^N, K)
        self.invJ = jnp.asarray(invJ)  # (C, M, N)
        self.J = jnp.asarray(J) if mesh.is_manifold else None
        self.p0 = jnp.asarray(mesh.nodes[mesh.cells[:, 0]])  # (C, N)
        self.gmin = jnp.asarray(host.gmin)
        self.gmax = jnp.asarray(host.gmax)
        self.scale = jnp.asarray(host.scale)
        self.is_manifold = mesh.is_manifold

    def locate(self, points):
        """points (n, N) device array -> (n,) int32 cell ids (-1 outside).

        Jit-safe: static shapes throughout; call under jax.jit for repeated
        query batches.
        """
        import jax.numpy as jnp

        points = jnp.atleast_2d(points)
        n, N = points.shape
        b = jnp.clip(
            jnp.floor((points - self.gmin) * self.scale).astype(jnp.int32),
            0,
            self.res - 1,
        )
        # row-major flat bin id (matches CellLocator's encoding)
        flat = b[:, 0]
        for d in range(1, N):
            flat = flat * self.res + b[:, d]
        cand = self.table[flat]  # (n, K)
        safe = jnp.maximum(cand, 0)
        d = points[:, None, :] - self.p0[safe]  # (n, K, N)
        z = jnp.einsum("nkmj,nkj->nkm", self.invJ[safe], d)  # (n, K, M)
        z0 = 1.0 - z.sum(axis=-1)
        eps = MACHINE_EPSILON
        inside = (z >= -eps).all(axis=-1) & (z0 >= -eps) & (cand >= 0)
        if self.is_manifold:
            proj = self.p0[safe] + jnp.einsum(
                "nkjm,nkm->nkj", self.J[safe], z
            )
            dist = jnp.linalg.norm(points[:, None, :] - proj, axis=-1)
            inside &= dist <= eps
        in_box = ((points >= self.gmin - eps) & (points <= self.gmax + eps)).all(
            axis=1
        )
        inside &= in_box[:, None]
        first = jnp.argmax(inside, axis=1)
        found = inside.any(axis=1)
        hit = jnp.take_along_axis(cand, first[:, None], axis=1)[:, 0]
        return jnp.where(found, hit, -1).astype(jnp.int32)
