"""Structured mesh generators (benchmarks, examples, sharding tests).

The reference ships static CSV meshes only; large-scale benchmarking needs
generated meshes. `unit_square_mesh(n)` reproduces the classic two-triangle
split of an n x n grid (same family as the reference's unit_square_{16..128}
fixtures).
"""

from __future__ import annotations

import numpy as np

from .triangulation import Triangulation

__all__ = [
    "unit_square_mesh",
    "unit_interval_mesh",
    "unit_cube_mesh",
    "irregular_mesh_device",
    "irregular_mesh_device_soa",
    "cube_mesh_device",
    "cube_mesh_device_soa",
]


def unit_square_mesh(n: int) -> Triangulation:
    """Uniform triangulation of [0,1]^2 with (n+1)^2 nodes, 2*n^2 cells."""
    xs = np.linspace(0.0, 1.0, n + 1)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    nodes = np.stack([X.reshape(-1), Y.reshape(-1)], axis=1)
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    a = (i * (n + 1) + j).reshape(-1)  # lower-left node of each quad
    b = a + (n + 1)  # lower-right (next row in x)
    lower = np.stack([a, b, a + 1], axis=1)
    upper = np.stack([b, b + 1, a + 1], axis=1)
    cells = np.concatenate([lower, upper], axis=0).astype(np.int32)
    boundary = (
        (nodes[:, 0] == 0.0)
        | (nodes[:, 0] == 1.0)
        | (nodes[:, 1] == 0.0)
        | (nodes[:, 1] == 1.0)
    )
    return Triangulation(nodes, cells, boundary)


def irregular_mesh_device(n: int, amp=0.2, dtype=None):
    """Irregular triangulation of [0,1]^2 generated ON DEVICE (jnp, jittable).

    Flagship-size unstructured problems need not ship a host mesh: this
    generator produces a GENUINELY irregular triangulation entirely on
    device: each grid quad's splitting diagonal is chosen by a deterministic
    hash (interior node degrees vary 4..8 — no solver downstream may assume
    a fixed stencil), and interior nodes are jittered by +-amp/2 cells per
    coordinate (amp <= 0.2 keeps every triangle non-degenerate). Both
    triangle orientations are positive.

    Returns (nodes (m^2, 2), cells (2 n^2, 3) int32, boundary (m^2,) bool)
    as jnp arrays, node (i, j) at id i*m + j (banded numbering — what RCM
    would produce on a mesh of this shape regularity). Cells are quad-major
    for gather locality.
    """
    import jax.numpy as jnp

    if dtype is None:
        dtype = jnp.asarray(1.0).dtype  # current x64 default
    m = n + 1
    gi = jnp.arange(m, dtype=dtype)[:, None]
    gj = jnp.arange(m, dtype=dtype)[None, :]
    interior = ((gi > 0) & (gi < n) & (gj > 0) & (gj < n)).astype(dtype)
    # shader-style hash: deterministic, no PRNG keys to ship
    hx = jnp.sin(gi * 12.9898 + gj * 78.233) * 43758.5453
    hy = jnp.sin(gi * 39.4250 + gj * 11.1350) * 27183.1415
    X = (gi + (hx - jnp.floor(hx) - 0.5) * amp * interior) / n
    Y = (gj + (hy - jnp.floor(hy) - 0.5) * amp * interior) / n + 0.0 * X
    nodes = jnp.stack([X.reshape(-1), Y.reshape(-1)], axis=1)

    qi = jnp.arange(n, dtype=dtype)[:, None]
    qj = jnp.arange(n, dtype=dtype)[None, :]
    hq = jnp.sin(qi * 7.1312 + qj * 3.7177) * 15731.7431
    flip = (hq - jnp.floor(hq)) < 0.5  # (n, n) per-quad diagonal choice
    a = (jnp.arange(n, dtype=jnp.int32)[:, None] * m
         + jnp.arange(n, dtype=jnp.int32)[None, :])  # corner (i, j)
    b = a + m  # corner (i+1, j)
    # standard diagonal a..b+1: (a, b, a+1), (b, b+1, a+1)
    # flipped diagonal  b..a+1 becomes a..? -> (a, b, b+1), (a, b+1, a+1)
    t0 = jnp.stack([a, b, jnp.where(flip, b + 1, a + 1)], axis=-1)
    t1 = jnp.where(
        flip[..., None],
        jnp.stack([a, b + 1, a + 1], axis=-1),
        jnp.stack([b, b + 1, a + 1], axis=-1),
    )
    cells = jnp.stack([t0, t1], axis=2).reshape(-1, 3)  # quad-major order
    on_bnd = (
        (nodes[:, 0] == 0.0) | (nodes[:, 0] == 1.0)
        | (nodes[:, 1] == 0.0) | (nodes[:, 1] == 1.0)
    )
    return nodes, cells, on_bnd


def irregular_mesh_device_soa(n: int, amp=0.2, dtype=None):
    """`irregular_mesh_device` in SoA layout — the device-SCALE form.

    Returns (x, y, c0, c1, c2, boundary): (N,) coordinate arrays and (C,)
    corner-index arrays: the large axis LAST/alone (no tiny minor axis
    for the device layout to pad). Same mesh (identical hashes/topology)
    as irregular_mesh_device.
    """
    import jax.numpy as jnp

    if dtype is None:
        dtype = jnp.asarray(1.0).dtype
    m = n + 1
    gi = jnp.arange(m, dtype=dtype)[:, None]
    gj = jnp.arange(m, dtype=dtype)[None, :]
    interior = ((gi > 0) & (gi < n) & (gj > 0) & (gj < n)).astype(dtype)
    hx = jnp.sin(gi * 12.9898 + gj * 78.233) * 43758.5453
    hy = jnp.sin(gi * 39.4250 + gj * 11.1350) * 27183.1415
    X = (gi + (hx - jnp.floor(hx) - 0.5) * amp * interior) / n
    Y = (gj + (hy - jnp.floor(hy) - 0.5) * amp * interior) / n + 0.0 * X
    x, y = X.reshape(-1), Y.reshape(-1)
    on_bnd = (x == 0.0) | (x == 1.0) | (y == 0.0) | (y == 1.0)

    qi = jnp.arange(n, dtype=dtype)[:, None]
    qj = jnp.arange(n, dtype=dtype)[None, :]
    hq = jnp.sin(qi * 7.1312 + qj * 3.7177) * 15731.7431
    flip = (hq - jnp.floor(hq)) < 0.5
    a = (jnp.arange(n, dtype=jnp.int32)[:, None] * m
         + jnp.arange(n, dtype=jnp.int32)[None, :])
    b = a + m
    # quad-major cell order t = 2*(i*n + j) + {0, 1}, matching
    # irregular_mesh_device's stack(..., axis=2) interleave
    t0 = (a, b, jnp.where(flip, b + 1, a + 1))
    t1 = (
        jnp.where(flip, a, b),
        b + 1,
        a + 1,
    )
    c0, c1, c2 = (
        jnp.stack([u, v], axis=2).reshape(-1) for u, v in zip(t0, t1)
    )
    return x, y, c0, c1, c2, on_bnd


def cube_mesh_device(n: int, amp=0.2, dtype=None):
    """Jittered Freudenthal tetrahedralization of [0,1]^3 ON DEVICE (jnp).

    The 3D counterpart of `irregular_mesh_device` for the device-scale
    general path: interior nodes displaced by +-amp/2 cells per coordinate
    (deterministic hash). Topology is the conforming 6-tets-per-cube Kuhn
    split of `unit_cube_mesh` (per-cube diagonal randomization would break
    face conformity in 3D); geometry is fully irregular. Node-tet incidence
    <= 24, node neighbors <= 14 (+self).

    Returns (nodes (m^3, 3), cells (6 n^3, 4) int32, boundary (m^3,) bool).
    """
    import itertools

    import jax.numpy as jnp

    if dtype is None:
        dtype = jnp.asarray(1.0).dtype
    m = n + 1
    gi = jnp.arange(m, dtype=dtype)[:, None, None]
    gj = jnp.arange(m, dtype=dtype)[None, :, None]
    gk = jnp.arange(m, dtype=dtype)[None, None, :]
    interior = (
        (gi > 0) & (gi < n) & (gj > 0) & (gj < n) & (gk > 0) & (gk < n)
    ).astype(dtype)

    def frac(h):
        return h - jnp.floor(h) - 0.5

    hx = jnp.sin(gi * 12.9898 + gj * 78.2330 + gk * 37.7190) * 43758.5453
    hy = jnp.sin(gi * 39.4250 + gj * 11.1350 + gk * 83.1550) * 27183.1415
    hz = jnp.sin(gi * 21.9898 + gj * 57.2330 + gk * 13.3730) * 31415.9265
    X = (gi + frac(hx) * amp * interior) / n
    Y = (gj + frac(hy) * amp * interior) / n + 0.0 * X
    Z = (gk + frac(hz) * amp * interior) / n + 0.0 * X
    nodes = jnp.stack([X.reshape(-1), Y.reshape(-1), Z.reshape(-1)], axis=1)

    ci = jnp.arange(n, dtype=jnp.int32)
    base = (
        ci[:, None, None] * (m * m) + ci[None, :, None] * m + ci[None, None, :]
    ).reshape(-1)
    step = (m * m, m, 1)

    def parity(p):
        return p in ((0, 1, 2), (1, 2, 0), (2, 0, 1))

    blocks = []
    for perm in itertools.permutations(range(3)):
        v0 = base
        v1 = v0 + step[perm[0]]
        v2 = v1 + step[perm[1]]
        v3 = v2 + step[perm[2]]
        if parity(perm):
            blocks.append(jnp.stack([v0, v1, v2, v3], axis=1))
        else:  # odd permutation: swap two vertices -> positive orientation
            blocks.append(jnp.stack([v0, v2, v1, v3], axis=1))
    # cube-major interleave for gather locality
    cells = jnp.stack(blocks, axis=1).reshape(-1, 4)

    on_bnd = ((nodes == 0.0) | (nodes == 1.0)).any(axis=1)
    return nodes, cells, on_bnd


def unit_interval_mesh(n: int):
    from .interval import Interval

    return Interval(0.0, 1.0, n)


def unit_cube_mesh(n: int) -> Triangulation:
    """Freudenthal (Kuhn) triangulation of [0,1]^3: (n+1)^3 nodes, 6 n^3 tets.

    Each cube (i, j, k) splits into the 6 tets tracing monotone lattice
    paths from corner (0,0,0) to (1,1,1) — one per permutation of the axis
    order, all positively oriented and face-to-face conforming. Node id of
    lattice point (i, j, k) is i m^2 + j m + k, m = n + 1. Cells are listed
    grouped by permutation type (all n^3 type-0 cubes first, ...), which
    the structured 3D stencil conversion (ops/grid3d.py) relies on.
    """
    import itertools

    m = n + 1
    xs = np.linspace(0.0, 1.0, m)
    X, Y, Z = np.meshgrid(xs, xs, xs, indexing="ij")
    nodes = np.stack([X.reshape(-1), Y.reshape(-1), Z.reshape(-1)], axis=1)

    i, j, k = np.meshgrid(
        np.arange(n), np.arange(n), np.arange(n), indexing="ij"
    )
    base = (i * m * m + j * m + k).reshape(-1)  # corner (0,0,0) of each cube
    step = np.array([m * m, m, 1])  # node-id increment per +1 in (i, j, k)

    def parity(p):
        return (p in ((0, 1, 2), (1, 2, 0), (2, 0, 1)))

    blocks = []
    for perm in itertools.permutations(range(3)):
        v0 = base
        v1 = v0 + step[perm[0]]
        v2 = v1 + step[perm[1]]
        v3 = v2 + step[perm[2]]
        if parity(perm):
            blocks.append(np.stack([v0, v1, v2, v3], axis=1))
        else:  # odd permutation: swap two vertices -> positive orientation
            blocks.append(np.stack([v0, v2, v1, v3], axis=1))
    cells = np.concatenate(blocks, axis=0).astype(np.int32)

    on_bnd = (
        (nodes == 0.0) | (nodes == 1.0)
    ).any(axis=1)
    return Triangulation(nodes, cells, on_bnd)


def cube_mesh_device_soa(n: int, amp=0.2, dtype=None):
    """`cube_mesh_device` in SoA layout — the 3D device-SCALE form.

    Returns (x, y, z, c0, c1, c2, c3, boundary): (N,) coordinate arrays
    and (C,) corner-index arrays (C = 6 n^3): the large axis LAST/alone.
    Same mesh (identical hashes/topology/cell order) as
    cube_mesh_device.
    """
    import itertools

    import jax.numpy as jnp

    if dtype is None:
        dtype = jnp.asarray(1.0).dtype
    m = n + 1
    gi = jnp.arange(m, dtype=dtype)[:, None, None]
    gj = jnp.arange(m, dtype=dtype)[None, :, None]
    gk = jnp.arange(m, dtype=dtype)[None, None, :]
    interior = (
        (gi > 0) & (gi < n) & (gj > 0) & (gj < n) & (gk > 0) & (gk < n)
    ).astype(dtype)

    def frac(h):
        return h - jnp.floor(h) - 0.5

    hx = jnp.sin(gi * 12.9898 + gj * 78.2330 + gk * 37.7190) * 43758.5453
    hy = jnp.sin(gi * 39.4250 + gj * 11.1350 + gk * 83.1550) * 27183.1415
    hz = jnp.sin(gi * 21.9898 + gj * 57.2330 + gk * 13.3730) * 31415.9265
    X = (gi + frac(hx) * amp * interior) / n
    Y = (gj + frac(hy) * amp * interior) / n + 0.0 * X
    Z = (gk + frac(hz) * amp * interior) / n + 0.0 * X
    x, y, z = X.reshape(-1), Y.reshape(-1), Z.reshape(-1)
    on_bnd = (
        (x == 0.0) | (x == 1.0) | (y == 0.0) | (y == 1.0)
        | (z == 0.0) | (z == 1.0)
    )

    ci = jnp.arange(n, dtype=jnp.int32)
    base = (
        ci[:, None, None] * (m * m) + ci[None, :, None] * m + ci[None, None, :]
    ).reshape(-1)
    step = (m * m, m, 1)

    def parity(p):
        return p in ((0, 1, 2), (1, 2, 0), (2, 0, 1))

    slots = ([], [], [], [])  # per-corner lists over the 6 permutations
    for perm in itertools.permutations(range(3)):
        v0 = base
        v1 = v0 + step[perm[0]]
        v2 = v1 + step[perm[1]]
        v3 = v2 + step[perm[2]]
        tet = (v0, v1, v2, v3) if parity(perm) else (v0, v2, v1, v3)
        for j in range(4):
            slots[j].append(tet[j])
    # cube-major interleave: cell index = cube * 6 + permutation
    c0, c1, c2, c3 = (
        jnp.stack(sj, axis=1).reshape(-1) for sj in slots
    )
    return x, y, z, c0, c1, c2, c3, on_bnd
