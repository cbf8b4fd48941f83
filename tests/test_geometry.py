"""Geometry tests: topology parity with reference mesh fixtures (golden
data), measures, point location, KD-tree, projection, Voronoi on generated
meshes."""

import numpy as np
import pytest

from tests.conftest import (
    golden_mesh,
    reference_edges,
    reference_neighbors,
    reference_path,
)


def test_unit_square_counts(unit_square):
    # documented counts (test/src/utils/mesh_loader.h:33-37): the reference
    # fixture is a 59 x 59 two-triangle grid, as is the generated mesh
    assert unit_square.n_nodes == 3600
    assert unit_square.n_cells == 6962
    assert unit_square.n_edges == 10561


def test_unit_square_edges_match_reference():
    """Edge *set* must match edges.csv (the file's ordering comes from the R
    mesh generator, not the C++ first-encounter numbering, so compare as
    sets). The first-encounter numbering itself is exercised by the P2 golden
    tests (lagrangian_pointwise_eval_order2.mtx)."""
    ref = np.sort(reference_edges("unit_square"), axis=1)
    mine = np.sort(golden_mesh("unit_square").edges, axis=1)
    ref_sorted = ref[np.lexsort(ref.T[::-1])]
    mine_sorted = mine[np.lexsort(mine.T[::-1])]
    np.testing.assert_array_equal(mine_sorted, ref_sorted)


def test_unit_square_neighbors_match_reference():
    ref = reference_neighbors("unit_square")
    np.testing.assert_array_equal(golden_mesh("unit_square").neighbors, ref)


def test_unit_sphere_neighbors_match_reference():
    unit_sphere = golden_mesh("unit_sphere")
    assert unit_sphere.n_nodes == 587
    assert unit_sphere.n_cells == 2775
    ref = reference_neighbors("unit_sphere")
    np.testing.assert_array_equal(unit_sphere.neighbors, ref)


def test_surface_mesh():
    surface = golden_mesh("surface")
    # 2.5D manifold: 340 3D points, 616 elements (mesh_loader.h:35)
    assert surface.n_nodes == 340
    assert surface.n_cells == 616
    assert surface.is_manifold
    assert surface.measures.min() > 0


def test_unit_square_measure(unit_square):
    assert unit_square.measure() == pytest.approx(1.0, abs=1e-12)


def test_boundary_consistency(unit_square):
    # boundary nodes from file == derived from single-adjacency facets
    np.testing.assert_array_equal(
        unit_square.boundary_nodes, unit_square.derived_boundary_nodes
    )


def test_locate_random_barycentric(unit_square):
    """Property test mirroring MeshLoader::sample (mesh_loader.h:94-122):
    random points generated inside known cells must be located there."""
    rng = np.random.default_rng(0)
    n = 200
    ids = rng.integers(0, unit_square.n_cells, n)
    coords = unit_square.cell_coords[ids]  # (n, 3, 2)
    w = rng.dirichlet([1.0, 1.0, 1.0], size=n)
    pts = np.einsum("nkd,nk->nd", coords, w)
    found = unit_square.locate(pts)
    np.testing.assert_array_equal(found, ids)


def test_locate_outside(unit_square):
    out = unit_square.locate(np.array([[2.0, 2.0], [-1.0, 0.5]]))
    np.testing.assert_array_equal(out, [-1, -1])


def test_interval():
    from fdapde_core_tpu.geometry import Interval

    m = Interval(0.0, 2.0, 10)
    assert m.n_nodes == 11
    assert m.n_cells == 10
    assert m.measure() == pytest.approx(2.0)
    np.testing.assert_array_equal(m.locate([0.05, 1.95, -0.1, 2.05]), [0, 9, -1, -1])
    assert m.boundary_node_markers().sum() == 2


def test_network():
    net = golden_mesh("network")
    assert net.local_dim == 1 and net.embed_dim == 2
    # actual fixture sizes (mesh_loader.h:33's "204/559" comment is stale)
    assert net.n_nodes == 201
    assert net.n_cells == 200
    nbrs = net.cell_neighbors(0)
    assert len(nbrs) > 0 and 0 not in nbrs


def test_kd_tree():
    from fdapde_core_tpu.geometry import KDTree

    rng = np.random.default_rng(1)
    pts = rng.uniform(size=(300, 2))
    tree = KDTree(pts)
    queries = rng.uniform(size=(50, 2))
    for q in queries:
        best = tree.nn_search(q)
        brute = np.argmin(((pts - q) ** 2).sum(axis=1))
        assert best == brute
    # range search vs brute force
    ll, ur = np.array([0.2, 0.3]), np.array([0.6, 0.8])
    got = tree.range_search(ll, ur)
    want = np.nonzero(((pts >= ll) & (pts <= ur)).all(axis=1))[0]
    np.testing.assert_array_equal(got, want)


def test_projection(unit_square):
    from fdapde_core_tpu.geometry import project

    pts = np.array([[0.5, 1.7], [-0.3, 0.5], [0.5, 0.5]])
    proj = project(unit_square, pts)
    np.testing.assert_allclose(proj[0], [0.5, 1.0], atol=1e-12)
    np.testing.assert_allclose(proj[1], [0.0, 0.5], atol=1e-12)
    np.testing.assert_allclose(proj[2], [0.5, 0.5], atol=1e-12)


def test_hyperplane():
    from fdapde_core_tpu.geometry import HyperPlane

    # plane z = 0 through 3 points
    hp = HyperPlane(np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], dtype=float))
    p = np.array([0.3, 0.4, 2.0])
    np.testing.assert_allclose(hp.project(p), [0.3, 0.4, 0.0], atol=1e-12)
    assert hp.distance(p) == pytest.approx(2.0)
    assert abs(hp.normal() @ np.array([0, 0, 1.0])) == pytest.approx(1.0)


def test_voronoi_partitions_area():
    """Voronoi cells of a structured triangulation partition the domain."""
    from fdapde_core_tpu.geometry import Triangulation, Voronoi

    # small structured unit-square mesh
    k = 6
    xs = np.linspace(0, 1, k)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    nodes = np.stack([X.reshape(-1), Y.reshape(-1)], axis=1)
    cells = []
    for i in range(k - 1):
        for j in range(k - 1):
            a = i * k + j
            b = (i + 1) * k + j
            cells.append([a, b, a + 1])
            cells.append([b, b + 1, a + 1])
    mesh = Triangulation(nodes, np.array(cells))
    vor = Voronoi(mesh)
    assert vor.measure() == pytest.approx(1.0, abs=5e-2)
    # locate: interior points map to nearest site
    assert vor.locate(np.array([[0.01, 0.01]]))[0] == 0


def test_simplex_nearest():
    from fdapde_core_tpu.geometry.projection import nearest_on_simplex

    tri = np.array([[0, 0], [1, 0], [0, 1]], dtype=float)
    np.testing.assert_allclose(
        nearest_on_simplex(tri, np.array([2.0, 2.0])), [0.5, 0.5], atol=1e-12
    )
    np.testing.assert_allclose(
        nearest_on_simplex(tri, np.array([0.2, 0.3])), [0.2, 0.3], atol=1e-12
    )
    np.testing.assert_allclose(
        nearest_on_simplex(tri, np.array([-1.0, -1.0])), [0.0, 0.0], atol=1e-12
    )


def test_simplex_helpers(unit_square):
    from fdapde_core_tpu.geometry import simplex as sx

    rng = np.random.default_rng(3)
    ids = rng.integers(0, unit_square.n_cells, 20)
    w = rng.dirichlet([1, 1, 1], size=20)
    pts = np.einsum("nkd,nk->nd", unit_square.cell_coords[ids], w)
    bary = sx.barycentric_coords(unit_square, ids, pts)
    np.testing.assert_allclose(bary, w, atol=1e-10)
    assert sx.contains(unit_square, ids, pts).all()
    cc = sx.circumcenters(unit_square)
    # circumcenter is equidistant from all three vertices
    d = np.linalg.norm(
        unit_square.cell_coords - cc[:, None, :], axis=2
    )
    np.testing.assert_allclose(d[:, 0], d[:, 1], atol=1e-9)
    np.testing.assert_allclose(d[:, 0], d[:, 2], atol=1e-9)
    np.testing.assert_allclose(
        sx.circumradii(unit_square), d[:, 0], atol=1e-12
    )
    lo, hi = sx.bounding_boxes(unit_square)
    assert (hi >= lo).all()


def test_mesh_integration(unit_square, unit_sphere):
    """Quadrature exactness vs closed-form volumes (integration_test.cpp:45-70)."""
    from fdapde_core_tpu.utils.integration import integrate

    assert integrate(unit_square, lambda p: 1.0) == pytest.approx(1.0, abs=1e-12)
    assert integrate(unit_square, lambda p: p[0] + p[1], order=1) == pytest.approx(
        1.0, abs=1e-12
    )
    # quadratic needs the order-2 rule
    assert integrate(unit_square, lambda p: p[0] ** 2, order=2) == pytest.approx(
        1.0 / 3.0, abs=1e-12
    )
    vol = integrate(unit_sphere, lambda p: 1.0)
    assert abs(vol - 4.0 / 3.0 * np.pi) < 0.15  # faceted sphere approximation


def test_native_topology_matches_numpy():
    """Native C++ first-encounter extraction == NumPy fallback."""
    from fdapde_core_tpu.native import first_encounter_unique_native, native_available

    assert native_available(), "g++ toolchain expected in this environment"
    rng = np.random.default_rng(7)
    keys = np.sort(rng.integers(0, 500, size=(5000, 2)).astype(np.int32), axis=1)
    uniq_n, ids_n = first_encounter_unique_native(keys)
    # numpy fallback path (reproduce inline to avoid the native dispatch)
    _, first_idx, inverse = np.unique(keys, axis=0, return_index=True, return_inverse=True)
    inverse = inverse.reshape(-1)
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(order.size)
    ids_np = rank[inverse].astype(np.int32)
    uniq_np = keys[np.sort(first_idx)]
    np.testing.assert_array_equal(ids_n, ids_np)
    np.testing.assert_array_equal(uniq_n, uniq_np)


def test_network_sparse_neighbors_csv():
    """The reference stores 1.5D network adjacency as sparse COO CSV
    (mesh_loader.h:82); it must agree with the derived adjacency."""
    from fdapde_core_tpu.utils.io import read_csv_sparse

    net = golden_mesh("network")
    N = read_csv_sparse(
        reference_path("mesh", "network", "neigh.csv"),
        shape=(net.n_cells, net.n_cells)
    ).toarray()
    for c in (0, 7, 100, 199):
        mine = set(net.cell_neighbors(c).tolist())
        ref = set(np.nonzero(N[c])[0].tolist()) - {c}
        assert mine == ref, (c, mine, ref)


def test_voronoi_cell_edges_reference_semantics():
    """VoronoiCell edge views (voronoi.h:87-121): consecutive wrap-around
    vertex pairs, per-edge Simplex coordinates, shoelace measure from the
    edge loop, on_boundary marker logic, contains == nearest-site."""
    from fdapde_core_tpu.geometry import Triangulation, Voronoi

    k = 6
    xs = np.linspace(0, 1, k)
    X, Y = np.meshgrid(xs, xs, indexing="ij")
    nodes = np.stack([X.reshape(-1), Y.reshape(-1)], axis=1)
    cells = []
    for i in range(k - 1):
        for j in range(k - 1):
            a, b = i * k + j, (i + 1) * k + j
            cells.append([a, b, a + 1])
            cells.append([b, b + 1, a + 1])
    mesh = Triangulation(nodes, np.array(cells))
    vor = Voronoi(mesh)

    c = vor.cell(3 * k + 3)  # interior site
    E = c.edges()
    assert E.shape == (c.n_edges, 2)
    # consecutive wrap-around pairs (voronoi.h:87-95)
    np.testing.assert_array_equal(E[:, 1], np.roll(E[:, 0], -1))
    # edge(i) coordinates match the pair view
    for i in range(c.n_edges):
        np.testing.assert_allclose(c.edge(i), c.vertices[E[i]])
    # measure via the reference's edge-loop cross-product formula
    area = 0.0
    for i in range(c.n_edges):
        x, y = c.vertices[E[i, 0]], c.vertices[E[i, 1]]
        area += x[0] * y[1] - x[1] * y[0]
    assert c.measure == pytest.approx(0.5 * abs(area))
    assert not c.on_boundary

    # boundary cell: edge with both endpoints in the boundary closure
    cb = vor.cell(0)
    assert cb.on_boundary
    # every boundary node's cell touches the boundary; interior never does
    markers = mesh.boundary_node_markers()
    for nid in range(mesh.n_nodes):
        assert vor.cell(nid).on_boundary == bool(markers[nid]), nid

    # contains is the nearest-site predicate (voronoi.h:121)
    rng = np.random.default_rng(3)
    pts = rng.uniform(0.05, 0.95, size=(40, 2))
    ids = vor.locate(pts)
    for p, i in zip(pts, ids):
        assert vor.cell(int(i)).contains(p)
