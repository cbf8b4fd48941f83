"""Test configuration: force CPU with 8 virtual devices (sharding tests) and
f64 (reference-parity tolerances).

The CPU re-exec lives in tests/force_cpu.py (loaded via addopts before
pytest's capture starts); here we only finish the env setup for direct runs.

Meshes: the fixtures below are generated in the repo (geometry/structured.py
families). Tests that compare against fdaPDE-core's golden CSV/MTX data read
it from the directory named by FDAPDE_REFERENCE_DATA (fdaPDE-core's
`test/data`) and skip, inside the test, when it is not there.
"""

import os
import re

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("FDAPDE_TPU_X64", "1")

import numpy as np
import pytest


def reference_path(*parts: str) -> str:
    """Path under fdaPDE-core's golden test data; skips the calling test
    when FDAPDE_REFERENCE_DATA does not name an existing directory."""
    root = os.environ.get("FDAPDE_REFERENCE_DATA", "")
    if not root or not os.path.isdir(root):
        pytest.skip(
            "golden fdaPDE-core test data not available "
            "(set FDAPDE_REFERENCE_DATA to fdaPDE-core's test/data)"
        )
    return os.path.join(root, *parts)


def golden_mesh(name: str):
    """A reference test mesh from the golden data (MeshLoader equivalent)."""
    from fdapde_core_tpu.geometry import LinearNetwork, Triangulation
    from fdapde_core_tpu.utils.io import load_mesh_csv

    points, elements, boundary = load_mesh_csv(reference_path("mesh", name))
    if name == "network":
        return LinearNetwork(points, elements, boundary)
    return Triangulation(points, elements, boundary)


def _ball_mesh(n: int):
    """Tetrahedral unit ball: the Freudenthal cube [-1, 1]^3 mapped
    radially (p -> p * |p|_inf / |p|_2), cube boundary onto the sphere."""
    from fdapde_core_tpu.geometry import Triangulation
    from fdapde_core_tpu.geometry.structured import unit_cube_mesh

    cube = unit_cube_mesh(n)
    p = 2.0 * cube.nodes - 1.0
    r2 = np.linalg.norm(p, axis=1)
    scale = np.abs(p).max(axis=1) / np.where(r2 > 0, r2, 1.0)
    return Triangulation(p * scale[:, None], cube.cells, cube.boundary_nodes)


def _graph_surface(n: int):
    """2.5D open surface z = 0.3 sin(pi x) sin(pi y) over the unit square."""
    from fdapde_core_tpu.geometry import Triangulation
    from fdapde_core_tpu.geometry.structured import unit_square_mesh

    sq = unit_square_mesh(n)
    x, y = sq.nodes[:, 0], sq.nodes[:, 1]
    z = 0.3 * np.sin(np.pi * x) * np.sin(np.pi * y)
    return Triangulation(np.stack([x, y, z], axis=1), sq.cells,
                         sq.boundary_nodes)


def _grid_network(k: int):
    """1.5D network: the edges of a k x k lattice over the unit square."""
    from fdapde_core_tpu.geometry import LinearNetwork

    xs = np.linspace(0.0, 1.0, k + 1)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    nodes = np.stack([X.reshape(-1), Y.reshape(-1)], axis=1)
    idx = np.arange((k + 1) ** 2).reshape(k + 1, k + 1)
    segs = np.concatenate([
        np.stack([idx[:-1, :].reshape(-1), idx[1:, :].reshape(-1)], axis=1),
        np.stack([idx[:, :-1].reshape(-1), idx[:, 1:].reshape(-1)], axis=1),
    ])
    boundary = ((X == 0) | (X == 1) | (Y == 0) | (Y == 1)).reshape(-1)
    return LinearNetwork(nodes, segs, boundary)


def load_mesh(name: str):
    """Test mesh by name. The families a generator covers are generated:
    `unit_square` (59 x 59 grid, the reference fixture's size),
    `unit_square_N`, `unit_sphere` (tetrahedral ball), `surface` (2.5D open
    surface) and `network`; any other name is read from the golden data."""
    from fdapde_core_tpu.geometry.structured import unit_square_mesh

    m = re.fullmatch(r"unit_square(?:_(\d+))?", name)
    if m:
        return unit_square_mesh(int(m.group(1) or 59))
    generated = {
        "unit_sphere": lambda: _ball_mesh(6),
        "surface": lambda: _graph_surface(12),
        "network": lambda: _grid_network(8),
    }
    if name in generated:
        return generated[name]()
    return golden_mesh(name)


@pytest.fixture(scope="session")
def unit_square():
    return load_mesh("unit_square")


@pytest.fixture(scope="session")
def unit_sphere():
    return load_mesh("unit_sphere")


@pytest.fixture(scope="session")
def surface():
    return load_mesh("surface")


@pytest.fixture
def gpu():
    """The first JAX device, if it is a GPU; skips the test otherwise.
    Tests that need the card take this fixture and carry the `gpu` marker;
    `python chip_smoke.py` runs the same paths end to end on the card."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {dev.platform!r})")
    return dev


def reference_neighbors(name: str) -> np.ndarray:
    from fdapde_core_tpu.utils.io import read_csv

    raw = read_csv(reference_path("mesh", name, "neigh.csv")).astype(np.int64)
    return np.where(raw > 0, raw - 1, -1)


def reference_edges(name: str) -> np.ndarray:
    from fdapde_core_tpu.utils.io import read_csv

    return read_csv(reference_path("mesh", name, "edges.csv")).astype(np.int64) - 1
