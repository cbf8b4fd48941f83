"""Median-split KD-tree over points in R^K.

Counterpart of /root/reference/fdaPDE/geometry/kd_tree.h (array-backed rather
than pointer-based): O(n log n) construction by recursive median splitting on
cycling coordinates, nearest-neighbor search with backtracking pruning, and
rectangular range queries.
"""

from __future__ import annotations

import numpy as np

__all__ = ["KDTree"]


class KDTree:
    """Static KD-tree. Nodes stored in preorder arrays (flat arrays, vectorized queries)."""

    def __init__(self, points: np.ndarray):
        self.points = np.asarray(points, dtype=np.float64)
        n, k = self.points.shape
        self.k = k
        # arrays: for node slot i -> point index, split axis, left/right slots
        self.idx = np.full(2 * n, -1, dtype=np.int64)
        self.axis = np.zeros(2 * n, dtype=np.int64)
        self.left = np.full(2 * n, -1, dtype=np.int64)
        self.right = np.full(2 * n, -1, dtype=np.int64)
        self._n_slots = 0
        self.root = self._build(np.arange(n), 0)

    def _build(self, ids: np.ndarray, depth: int) -> int:
        if ids.size == 0:
            return -1
        ax = depth % self.k
        order = np.argsort(self.points[ids, ax], kind="stable")
        ids = ids[order]
        mid = ids.size // 2
        slot = self._n_slots
        self._n_slots += 1
        self.idx[slot] = ids[mid]
        self.axis[slot] = ax
        self.left[slot] = self._build(ids[:mid], depth + 1)
        self.right[slot] = self._build(ids[mid + 1 :], depth + 1)
        return slot

    def nn_search(self, query: np.ndarray) -> int:
        """Index of the nearest point to `query` (kd_tree.h:82-118)."""
        query = np.asarray(query, dtype=np.float64).reshape(-1)
        best = [-1, np.inf]

        def visit(slot):
            if slot < 0:
                return
            p = self.points[self.idx[slot]]
            d2 = float(((p - query) ** 2).sum())
            if d2 < best[1]:
                best[0], best[1] = self.idx[slot], d2
            ax = self.axis[slot]
            diff = query[ax] - p[ax]
            near, far = (
                (self.left[slot], self.right[slot])
                if diff < 0
                else (self.right[slot], self.left[slot])
            )
            visit(near)
            if diff * diff < best[1]:  # hypersphere crosses the splitting plane
                visit(far)

        import sys

        old = sys.getrecursionlimit()
        sys.setrecursionlimit(max(old, 4 * len(self.points) + 100))
        try:
            visit(self.root)
        finally:
            sys.setrecursionlimit(old)
        return int(best[0])

    def range_search(self, ll: np.ndarray, ur: np.ndarray) -> np.ndarray:
        """Indices of points inside the axis-aligned box [ll, ur]
        (kd_tree.h:125-150)."""
        ll = np.asarray(ll, dtype=np.float64).reshape(-1)
        ur = np.asarray(ur, dtype=np.float64).reshape(-1)
        out = []
        stack = [self.root]
        while stack:
            slot = stack.pop()
            if slot < 0:
                continue
            p = self.points[self.idx[slot]]
            if np.all(p >= ll) and np.all(p <= ur):
                out.append(int(self.idx[slot]))
            ax = self.axis[slot]
            if p[ax] >= ll[ax]:
                stack.append(int(self.left[slot]))
            if p[ax] <= ur[ax]:
                stack.append(int(self.right[slot]))
        return np.array(sorted(out), dtype=np.int64)
