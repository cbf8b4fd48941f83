"""General-mesh Poisson at device scale: the matrix-free gather pipeline.

Counterpart of `StructuredPoisson` for meshes WITHOUT tensor-product
structure — the product-level form of the flagship general path:

  device mesh arrays (nodes, cells, boundary) -> batched local stiffness
  (ops/matfree.p1_local_stiffness) -> ELL incidence table (one device
  argsort; ops/ell.py) -> matrix-free gather SpMV CG with a device-built
  auxiliary-grid preconditioner (ops/auxgrid.py) -> mixed-precision
  converged solve (f64 CG vectors + f64 fine operator + f32 aux V-cycle).

Nothing here assumes anything about the topology: the solver sees opaque
index arrays. The mesh may come from `geometry.structured.
irregular_mesh_device` (generated on device, no host transfer) or from any
host Triangulation's (nodes, cells, boundary) arrays.

Reference anchor: PDE + FEMLinearEllipticSolver (pde/pde.h:40-114,
fem_linear_elliptic_solver.h:34-50) on arbitrary simplicial meshes; the
aux-grid + CG pair replaces Eigen SparseLU as the scalable solve.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..fem.solvers import DirichletSystem
from ..linear_algebra.solvers import cg
from ..ops.auxgrid import AuxGridPreconditioner, AuxGridPreconditioner3D
from ..ops.matfree_soa import MatrixFreeSoA, MatrixFreeSoA3D

__all__ = ["MatrixFreePoisson", "MatrixFreeElliptic",
           "MatrixFreeParabolic"]


class MatrixFreePoisson:
    """-Laplace u = f with Dirichlet data g, P1, arbitrary 2D triangulation
    or 3D tetrahedralization (dispatched on nodes.shape[1]).

    nodes (N, d), cells (C, d+1) int32, boundary (N,) bool — device arrays.
    max_degree bounds the per-node cell incidence (8 covers 2D quad-split
    meshes, 24 Freudenthal tet meshes; Delaunay may need more — a violated
    bound raises ValueError at construction). grid_n sets the auxiliary
    preconditioner grid (default ~N^(1/d)).
    """

    def __init__(self, nodes, cells, boundary, max_degree: int | None = None,
                 grid_n: int | None = None, bbox=None,
                 format: str = "ell", max_cols: int | None = None,
                 kappa=None, preconditioner: str = "auto",
                 split_plan=None):
        self.nodes = nodes
        self.cells = cells
        self.boundary = boundary
        self.n_dofs = nodes.shape[0]
        self.format = format
        self.dim = nodes.shape[1]
        if self.dim not in (2, 3):
            raise ValueError(f"2D/3D only, got embedding dim {self.dim}")
        if max_degree is None:
            max_degree = 8 if self.dim == 2 else 24
        if max_cols is None:
            # 2D: neighbors + self; 3D: Euler bound on the vertex link
            # (2 + F/2 neighbors; Freudenthal max_degree=24 -> 16)
            max_cols = (max_degree + 1 if self.dim == 2
                        else max_degree // 2 + 4)
        if bbox is None:
            bbox = ((0.0,) * self.dim, (1.0,) * self.dim)

        # SoA pipeline throughout (ops/matfree_soa.py): cell/dof axis
        # last, so small per-cell axes never become the minor dimension.
        # kappa enters as a TRACED argument (a closed-over array would be
        # baked in as a compile-time constant, one compile per kappa
        # array). format == "ell" fuses local assembly + adjacency + ELL
        # conversion into ONE program.
        soa_cls = MatrixFreeSoA if self.dim == 2 else MatrixFreeSoA3D

        @functools.partial(jax.jit, static_argnums=(3, 4))
        def build(nodes, cells, kappa, has_kappa, want_ell):
            coords = tuple(nodes[:, d] for d in range(self.dim))
            corners = tuple(cells[:, j] for j in range(self.dim + 1))
            mf, over = soa_cls.build(
                *coords, *corners, self.n_dofs, max_degree,
                kappa=kappa if has_kappa else None,
            )
            if not want_ell:
                return mf, over, None, None
            E, overc = mf.to_ell(max_cols)
            return mf, over, E, overc

        kap = jnp.zeros((0,)) if kappa is None else kappa
        mf, over, E, overc = build(nodes, cells, kap, kappa is not None,
                                   format == "ell")
        if bool(over):
            raise ValueError(
                f"a node exceeds max_degree={max_degree} cell incidences; "
                "rebuild with a larger bound"
            )
        # the load_vector combine rides the adjacency regardless of format
        self.adj, self.adj_mask = mf.adj, mf.adj_mask
        if format == "ell":
            # assembled row-ELL: ~1.6x fewer gathered elements per SpMV
            if bool(overc):
                raise ValueError(
                    f"a row exceeds {max_cols} distinct columns; "
                    "rebuild with a larger max_cols"
                )
            self.op = E
        elif format == "matfree":
            self.op = mf
        else:
            raise ValueError(format)
        self.system = DirichletSystem(self.op, boundary)
        self.preconditioner = "auxgrid"
        if preconditioner in ("auto", "banded_mg") and format == "ell":
            S, bmg = _try_banded_upgrade(self.op, boundary, dim=self.dim,
                                         split_plan=split_plan)
            if S is not None:
                self.op = S
                self.system = DirichletSystem(S, boundary)
                self.aux = bmg
                self.preconditioner = "banded_mg"
        if preconditioner == "banded_mg" and self.preconditioner != "banded_mg":
            raise ValueError(
                "banded_mg requested but the operator has no concentrated "
                "band (plan_split_width rejected it); use 'auto' or 'auxgrid'"
            )
        if self.preconditioner == "auxgrid":
            diag32 = jax.jit(
                lambda op, bnd: DirichletSystem(op, bnd)
                .diagonal().astype(jnp.float32)
            )(self.op, boundary)
            aux_cls = (
                AuxGridPreconditioner if self.dim == 2
                else AuxGridPreconditioner3D
            )
            self.aux = aux_cls.build_device(nodes, diag32, grid_n=grid_n,
                                            bbox=bbox)

    def load_vector(self, f_cells):
        """P1 load b_i = sum_T |T|/(d+1) * f(centroid_T) over incident cells
        (1-point centroid quadrature — same order as the P1 interpolation;
        integrator.h:52-55 semantics). f_cells: (C,) forcing at centroids.
        One cached jitted program in SoA layouts (per-corner (C,) gathers,
        slot-major combine over the shared (D, n) incidence table)."""
        return _p1_load_fn(self.dim)(
            self.nodes, self.cells, self.adj, self.adj_mask,
            jnp.asarray(f_cells),
        )

    def solve(self, b, g=None, rtol: float = 1e-9, maxiter: int = 100,
              chunk: int | None = None, on_chunk=None):
        """Mixed-precision converged solve; returns (x, iterations, true
        relative residual) — all device scalars (fetch to fence).

        chunk: split the Krylov loop into <=chunk-iteration device
        programs (bit-identical iterates), the hook for between-chunk
        stall observation (on_chunk(k, rnorm) after every chunk;
        SURVEY §5.3)."""
        if g is None:
            g = jnp.zeros_like(b)
        if chunk is not None:
            return _solve_chunked(self.op, self.boundary, self.aux, b, g,
                                  True, rtol, maxiter, chunk, on_chunk)
        run = _solve_fn(float(rtol), int(maxiter))
        return run(self.op, self.boundary, self.aux, b, g)


@functools.lru_cache(maxsize=None)
def _p1_load_fn(dim: int):
    @jax.jit
    def run(nodes, cells, adj, adj_mask, f_cells):
        co = [nodes[:, d] for d in range(dim)]
        cr = [cells[:, j] for j in range(dim + 1)]
        e = [[co[d][cr[j + 1]] - co[d][cr[0]] for d in range(dim)]
             for j in range(dim)]
        if dim == 2:
            meas = 0.5 * jnp.abs(e[0][0] * e[1][1] - e[0][1] * e[1][0])
        else:
            cxd = (e[1][1] * e[2][2] - e[1][2] * e[2][1],
                   e[1][2] * e[2][0] - e[1][0] * e[2][2],
                   e[1][0] * e[2][1] - e[1][1] * e[2][0])
            meas = jnp.abs(sum(e[0][d] * cxd[d] for d in range(3))) / 6.0
        fa = meas * f_cells / (dim + 1.0)
        floc = jnp.concatenate([fa] * (dim + 1))  # slot-major ((d+1)C,)
        gathered = floc[adj] * adj_mask.astype(floc.dtype)
        return gathered.sum(axis=0)

    return run


def _aux_apply(aux, r):
    """f32 aux V-cycle inside a higher-precision Krylov loop (module-level
    identity: stable across solves for the chunk-program caches)."""
    return aux(r.astype(jnp.float32)).astype(r.dtype)


def _try_banded_upgrade(E_soa, boundary, dim: int = 2, split_plan=None,
                        **mg_kw):
    """Structure auto-detection (preconditioner="auto"): when the assembled
    operator's offset histogram is band-concentrated (quasi-uniform /
    RCM-tight meshes — decided from the MATRIX alone by plan_split_width's
    coverage guard), swap the gather-SpMV + aux-grid pair for the banded
    DIA split + BandedMGPreconditioner: the SpMV becomes static 2D stencil
    shifts (no index arrays to read) and the V-cycle has zero gathers.
    Returns (split_operator, bmg) or (None, None) to keep the general
    gather path.

    The returned operator is the UNFOLDED split (exact A): boundary
    handling stays in DirichletSystem — its rhs reduction needs A's
    boundary columns (a Dirichlet-folded operator would zero the -A@g
    coupling term). Folding happens only inside the preconditioner build.
    """
    if dim == 3:
        from ..ops.dia_split3d import (
            BandedMGPreconditioner3D as _BMG,
            build_banded_split_3d,
            plan_split_3d,
        )

        if split_plan is None:
            split_plan = plan_split_3d(E_soa)
        W1, W2 = split_plan
        if W1 is None:
            return None, None

        @jax.jit
        def split_fold(E_, b_):  # one program: split + rem count + fold
            S_, over_ = build_banded_split_3d(E_, W1, W2)
            rem_nnz_ = jnp.sum(S_.rem.vals != 0.0).astype(jnp.int32)
            F32_ = S_.astype(jnp.float32).fold_dirichlet(b_)
            return S_, over_.astype(jnp.int32), rem_nnz_, F32_

        S, over, rem_nnz, F32 = split_fold(E_soa, boundary)
        if bool(over):
            return None, None
        if int(rem_nnz) == 0:
            S = S.drop_empty_remainder()
        bmg = _BMG.build(F32, **mg_kw)
        if bmg is None:
            return None, None
        return S, bmg

    from ..ops.dia_split import (
        BandedMGPreconditioner as _BMG,
        build_banded_split,
        plan_split_width,
    )

    if split_plan is None:
        split_plan = plan_split_width(E_soa)
    W, amax = split_plan
    if W is None:
        return None, None

    # the level plan is fully static given (W, amax): ONE fused program
    # runs split + rem count + fold + the whole Galerkin coarsening chain
    # (one program instead of four: one compile, no intermediate
    # round-trips to the host)
    n = E_soa.shape[0]
    R = -(-n // W)
    offsets2d = tuple(
        (a, b) for a in range(-amax, amax + 1) for b in range(-1, 2)
    )
    plan = _BMG.static_plan(offsets2d, (R, W), mg_kw.get("coarse_n", 32))

    @jax.jit
    def split_fold_coarsen(E_, b_):
        S_, over_ = build_banded_split(E_, W, amax=amax)
        rem_nnz_ = jnp.sum(S_.rem.vals != 0.0).astype(jnp.int32)
        F32_ = S_.astype(jnp.float32).fold_dirichlet(b_)
        if plan is None:
            return S_, over_.astype(jnp.int32), rem_nnz_, F32_, ()
        levels = _BMG.coarsen_levels(F32_.G.data, (R, W), offsets2d, plan)
        return S_, over_.astype(jnp.int32), rem_nnz_, F32_, levels

    S, over, rem_nnz, F32, levels = split_fold_coarsen(E_soa, boundary)
    if bool(over) or plan is None:
        return None, None
    if int(rem_nnz) == 0:
        S = S.drop_empty_remainder()
    bmg = _BMG.from_levels(
        levels, (R, W), n, plan,
        **{k: v for k, v in mg_kw.items() if k != "coarse_n"},
    )
    return S, bmg


@functools.lru_cache(maxsize=None)
def _prep_fn():
    @jax.jit
    def prep(op, bnd, b, g):
        sys = DirichletSystem(op, bnd)
        return sys.rhs(b, g), jnp.where(bnd, g, 0.0)

    return prep


@functools.lru_cache(maxsize=None)
def _rel_fn():
    @jax.jit
    def rel(op, bnd, x, b_mod):
        sys = DirichletSystem(op, bnd)
        res = b_mod - sys(x)
        return jnp.sqrt(jnp.sum(res * res) / jnp.sum(b_mod * b_mod))

    return rel


def _solve_chunked(op, bnd, aux, b, g, symmetric, rtol, maxiter, chunk,
                   on_chunk, u0=None):
    from ..linear_algebra.solvers import bicgstab_chunked, cg_chunked

    b_mod, x0 = _prep_fn()(op, bnd, b, g)
    if u0 is not None:  # warm start (time stepping): free dofs from u0
        x0 = _warm_x0_fn()(bnd, g, u0)
    pre = jax.tree_util.Partial(_aux_apply, aux)
    solver = cg_chunked if symmetric else bicgstab_chunked
    x, info = solver(DirichletSystem(op, bnd), b_mod, M_inv=pre, x0=x0,
                     rtol=rtol, maxiter=maxiter, chunk=chunk,
                     on_chunk=on_chunk)
    return x, info.iterations, _rel_fn()(op, bnd, x, b_mod)


@functools.lru_cache(maxsize=None)
def _warm_x0_fn():
    @jax.jit
    def warm(bnd, g, u0):
        return jnp.where(bnd, g, u0)

    return warm


@functools.lru_cache(maxsize=None)
def _solve_fn(rtol: float, maxiter: int):
    """Module-level jit cache: a fresh closure per solve() call would
    retrace/recompile every time; op/aux are pytrees, so one compile
    serves all same-shaped solves."""

    @jax.jit
    def run(op, bnd, aux, b, g):
        sys = DirichletSystem(op, bnd)

        def pre(r):
            return aux(r.astype(jnp.float32)).astype(r.dtype)

        b_mod = sys.rhs(b, g)
        x0 = jnp.where(bnd, g, 0.0)
        x, info = cg(sys, b_mod, M_inv=pre, x0=x0, rtol=rtol,
                     maxiter=maxiter)
        res = b_mod - sys(x)
        rel = jnp.sqrt(jnp.sum(res * res) / jnp.sum(b_mod * b_mod))
        return x, info.iterations, rel

    return run


@functools.lru_cache(maxsize=None)
def _load_vector_fn(order: int, dim: int = 2):
    @jax.jit
    def run(coords, dofs, adj, adj_mask, f_cells):
        e = [[coords[d][dofs[j + 1]] - coords[d][dofs[0]]
              for d in range(dim)] for j in range(dim)]
        if dim == 2:
            meas = 0.5 * jnp.abs(e[0][0] * e[1][1] - e[0][1] * e[1][0])
        else:
            cxd = (e[1][1] * e[2][2] - e[1][2] * e[2][1],
                   e[1][2] * e[2][0] - e[1][0] * e[2][2],
                   e[1][0] * e[2][1] - e[1][1] * e[2][0])
            meas = jnp.abs(sum(e[0][d] * cxd[d] for d in range(3))) / 6.0
        fa = meas * f_cells / (dim + 1.0)
        if order == 1:
            floc = jnp.concatenate([fa] * (dim + 1))
        else:  # P2 2D: vertex basis integrates to zero, edge to |T|/3
            zero = jnp.zeros_like(fa)
            floc = jnp.concatenate([zero, zero, zero] + [fa] * 3)
        gathered = floc[adj] * adj_mask.astype(floc.dtype)
        return gathered.sum(axis=0)

    return run


def _percell(value, C, dtype=jnp.float64):
    """Normalize a coefficient to a per-cell (C,) array (or None)."""
    if value is None:
        return None
    v = jnp.asarray(value, dtype)
    if v.ndim == 0:
        v = jnp.full((C,), v, dtype)
    return v


def _normalize_K(K, centroids, C, dim: int = 2):
    """Diffusion spec -> upper-triangle per-cell arrays or Nones.

    2D: (kxx, kxy, kyy); 3D: (kxx, kxy, kxz, kyy, kyz, kzz). Accepts None
    (identity), scalar, (d, d) tensor, the upper-triangle tuple of
    scalars/(C,) arrays, per-cell (C,) scalar field, or a callable
    evaluated at cell centroids (midpoint coefficient sampling — cf. the
    reference's quadrature-point protocol, scalar_expressions.h:98-108).
    """
    ntri = 3 if dim == 2 else 6
    if K is None:
        return (None,) * ntri
    if callable(K):
        K = K(centroids())
    if isinstance(K, tuple):
        if len(K) != ntri:
            raise ValueError(
                f"tuple K must be the {ntri} upper-triangle entries for "
                f"dim={dim}, got {len(K)}"
            )
        return tuple(_percell(v, C) for v in K)
    K_arr = jnp.asarray(K, jnp.float64)
    if K_arr.ndim == 2 and K_arr.shape == (dim, dim):
        iu = [(i, j) for i in range(dim) for j in range(i, dim)]
        return tuple(_percell(K_arr[i, j], C) for i, j in iu)
    return (_percell(K_arr, C),) + (None,) * (ntri - 1)  # isotropic


def _normalize_b(b, centroids, C, dim: int = 2):
    if b is None:
        return (None,) * dim
    if callable(b):
        b = b(centroids())
    if isinstance(b, tuple):
        if len(b) != dim:
            raise ValueError(
                f"tuple b must have {dim} components for dim={dim}, "
                f"got {len(b)} (a short tuple would silently zero the rest)"
            )
        return tuple(_percell(v, C) for v in b)
    b_arr = jnp.asarray(b, jnp.float64)
    if b_arr.ndim == 1 and b_arr.shape[0] == dim:
        return tuple(_percell(b_arr[d], C) for d in range(dim))
    return tuple(_percell(b_arr[..., d], C) for d in range(dim))


class MatrixFreeElliptic:
    """General elliptic operator at device scale on the gather pipeline:

        -div(K grad u) + b . grad u + c u = f,  u = g on the boundary

    2D triangulations (P1 order=1 raw device arrays, P2 order=2 via
    `from_space`) and 3D tetrahedralizations (P1), SoA layouts throughout
    (ops/matfree_soa.py). Solver: aux-grid-preconditioned CG when
    symmetric (b None), BiCGStab otherwise. Extends MatrixFreePoisson to
    the reference assembler's full operator algebra (fem_assembler.h:
    63-118, operators/advection.h:33-56) without leaving the device-scale
    path.

    K: None | scalar | (d,d) | upper-triangle tuple ((kxx,kxy,kyy) in 2D,
    (kxx,kxy,kxz,kyy,kyz,kzz) in 3D) | (C,) | callable(centroids);
    b: None | (d,) | component tuple | callable;
    c: None | scalar | (C,) | callable.
    """

    def __init__(self, nodes, cells, boundary, order: int = 1, K=None,
                 b=None, c=None, max_degree: int | None = None,
                 grid_n: int | None = None, bbox=None,
                 format: str = "ell", max_cols: int | None = None,
                 preconditioner: str = "auto", _space=None,
                 split_plan=None):
        from ..ops.matfree_soa import MatrixFreeP2SoA

        if isinstance(nodes, tuple):
            coords = [jnp.asarray(v) for v in nodes]
        else:
            nodes = jnp.asarray(nodes)
            coords = [nodes[:, d] for d in range(nodes.shape[1])]
        dim = len(coords)
        if dim not in (2, 3):
            raise ValueError(f"2D/3D only, got embedding dim {dim}")
        if max_degree is None:
            max_degree = 8 if dim == 2 else 24
        if _space is None:
            if order != 1:
                raise ValueError(
                    "order=2 needs a dof table: use from_space(space, ...)"
                )
            dofs = jnp.asarray(cells).T.astype(jnp.int32)  # (d+1, C)
            n_dofs = coords[0].shape[0]
            dof_coords = coords
        else:
            if dim != 2:
                raise ValueError("from_space (P2) is 2D-only for now")
            dofs = jnp.asarray(_space.dofs.T)
            n_dofs = _space.n_dofs
            dc = jnp.asarray(_space.dof_coords)
            dof_coords = [dc[:, 0], dc[:, 1]]
        self.dof_x, self.dof_y = dof_coords[0], dof_coords[1]
        if dim == 3:
            self.dof_z = dof_coords[2]
        C = dofs.shape[1]

        # centroids are only materialized for CALLABLE coefficients — the
        # scalar/tuple/per-cell forms skip the eager gathers over (C,)
        _cent_cache = []

        def centroids():
            if not _cent_cache:
                cs = [sum(co[dofs[j]] for j in range(dim + 1)) / (dim + 1.0)
                      for co in coords]  # P2: rows 0..d are the vertices
                _cent_cache.append(jnp.stack(cs, axis=1))
            return _cent_cache[0]

        ktri = _normalize_K(K, centroids, C, dim)
        badv = _normalize_b(b, centroids, C, dim)
        react = _percell(c(centroids()) if callable(c) else c, C)
        knames = (("kxx", "kxy", "kyy") if dim == 2
                  else ("kxx", "kxy", "kxz", "kyy", "kyz", "kzz"))
        bnames = ("bx", "by") if dim == 2 else ("bx", "by", "bz")
        coef = dict(zip(knames, ktri))
        coef.update(zip(bnames, badv))
        coef["react"] = react

        self.order = order
        self.dim = dim
        self.n_dofs = n_dofs
        self.boundary = jnp.asarray(boundary)
        self.is_symmetric = all(v is None for v in badv)
        if dim == 3:
            build = MatrixFreeSoA3D.build_general
        elif order == 1:
            build = MatrixFreeSoA.build_general
        else:
            build = MatrixFreeP2SoA.build
        corners = (tuple(dofs[j] for j in range(dim + 1)) if order == 1
                   else (dofs,))
        if max_cols is None and format == "ell":
            # 2D P1: degree+1 cols; P2 vertex rows: 1 + deg + 2*deg;
            # 3D P1: Euler bound on the vertex link — an interior
            # vertex with F incident tets has 2 + F/2 distinct
            # neighbors (V' - E' + F' = 2, 2E' = 3F'); +1 for self and
            # +1 slack for boundary links (disk: one extra vertex).
            # Freudenthal (max_degree=24) -> 16 (actual 15).
            if dim == 3:
                max_cols = max_degree // 2 + 4
            else:
                max_cols = (max_degree + 1 if order == 1
                            else 3 * max_degree + 1)

        # ONE fused program: local assembly + adjacency (+ ELL conversion
        # when format == "ell"). The mesh arrays are jit ARGUMENTS: closed
        # over, they would become program constants that XLA folds at
        # compile time (an argsort over every cell incidence)
        @functools.partial(jax.jit, static_argnums=(3,))
        def build_all(coords_, corners_, cf, want_ell):
            mf_, over_ = build(*coords_, *corners_, n_dofs, max_degree, **cf)
            if not want_ell:
                return mf_, over_, None, None
            E_, overc_ = mf_.to_ell(max_cols)
            return mf_, over_, E_, overc_

        mf, over, E, overc = build_all(tuple(coords), corners, coef,
                                       format == "ell")
        if bool(over):
            raise ValueError(
                f"a dof exceeds max_degree={max_degree} cell incidences; "
                "rebuild with a larger bound"
            )
        self.adj, self.adj_mask = mf.adj, mf.adj_mask
        self.dofs = dofs
        self._coords = coords
        self._x, self._y = coords[0], coords[1]
        if format == "ell":
            if bool(overc):
                raise ValueError(
                    f"a row exceeds {max_cols} distinct columns; "
                    "rebuild with a larger max_cols"
                )
            self.op = E
        elif format == "matfree":
            self.op = mf
        else:
            raise ValueError(format)
        self.system = DirichletSystem(self.op, self.boundary)
        self.preconditioner = "auxgrid"
        if preconditioner in ("auto", "banded_mg") and format == "ell":
            S, bmg = _try_banded_upgrade(self.op, self.boundary, dim=dim,
                                         split_plan=split_plan)
            if S is not None:
                self.op = S
                self.system = DirichletSystem(S, self.boundary)
                self.aux = bmg
                self.preconditioner = "banded_mg"
        if preconditioner == "banded_mg" and self.preconditioner != "banded_mg":
            raise ValueError(
                "banded_mg requested but the operator has no concentrated "
                "band (plan_split_width rejected it); use 'auto' or 'auxgrid'"
            )
        if self.preconditioner == "auxgrid":
            diag32 = jax.jit(
                lambda op, bnd: DirichletSystem(op, bnd)
                .diagonal().astype(jnp.float32)
            )(self.op, self.boundary)
            if bbox is None:
                bbox = ((0.0,) * dim, (1.0,) * dim)
            if dim == 2:
                self.aux = AuxGridPreconditioner.build_device(
                    (self.dof_x, self.dof_y), diag32, grid_n=grid_n,
                    bbox=bbox,
                )
            else:
                self.aux = AuxGridPreconditioner3D.build_device(
                    jnp.stack(dof_coords, axis=1), diag32, grid_n=grid_n,
                    bbox=bbox,
                )

    @classmethod
    def from_space(cls, space, K=None, b=None, c=None, **kw):
        """Build from a host FEMSpace (order 1 or 2): dof table, boundary
        dofs and dof coordinates come from the space."""
        mesh = space.mesh
        return cls(
            jnp.asarray(mesh.nodes), jnp.asarray(mesh.cells),
            jnp.asarray(space.boundary_dofs), order=space.order,
            K=K, b=b, c=c, _space=space, **kw,
        )

    def load_vector(self, f_cells):
        """Load vector from per-cell forcing values (centroid rule).

        P1: b_a = |T|/3 f per incident cell; P2: vertex basis functions
        integrate to ZERO on affine triangles (int phi_vertex = 0), edge
        ones to |T|/3 — both served by the same adjacency combine.
        One cached jitted program (the eager form dispatches ~10 ops)."""
        return _load_vector_fn(self.order, self.dim)(
            tuple(self._coords), self.dofs, self.adj, self.adj_mask,
            jnp.asarray(f_cells),
        )

    def solve(self, b, g=None, rtol: float = 1e-9, maxiter: int = 200,
              chunk: int | None = None, on_chunk=None):
        """Mixed-precision converged solve (f64 vectors, f32 aux V-cycle);
        CG when symmetric, BiCGStab otherwise. Returns (x, iterations,
        true relative residual) as device scalars. `chunk` bounds each
        device program to <=chunk Krylov iterations (stall
        observability) — see MatrixFreePoisson.solve."""
        if g is None:
            g = jnp.zeros_like(b)
        if chunk is not None:
            return _solve_chunked(self.op, self.boundary, self.aux, b, g,
                                  self.is_symmetric, rtol, maxiter, chunk,
                                  on_chunk)
        run = _general_solve_fn(float(rtol), int(maxiter),
                                self.is_symmetric)
        return run(self.op, self.boundary, self.aux, b, g)


@functools.lru_cache(maxsize=None)
def _general_solve_fn(rtol: float, maxiter: int, symmetric: bool):
    from ..linear_algebra.solvers import bicgstab

    solver = cg if symmetric else bicgstab

    @jax.jit
    def run(op, bnd, aux, b, g):
        sys = DirichletSystem(op, bnd)

        def pre(r):
            return aux(r.astype(jnp.float32)).astype(r.dtype)

        b_mod = sys.rhs(b, g)
        x0 = jnp.where(bnd, g, 0.0)
        x, info = solver(sys, b_mod, M_inv=pre, x0=x0, rtol=rtol,
                         maxiter=maxiter)
        res = b_mod - sys(x)
        rel = jnp.sqrt(jnp.sum(res * res) / jnp.sum(b_mod * b_mod))
        return x, info.iterations, rel

    return run


class MatrixFreeParabolic:
    """Implicit-Euler heat/diffusion stepping at device scale on the gather
    pipeline: arbitrary 2D/3D simplicial topology, P1, LUMPED mass
    (linear_algebra/lumping.h:30 semantics — the P1 row-sum lumped mass is
    exactly the load vector of 1, sum_T |T|/(d+1) over incident cells).

    Each step solves  (A + M_L/dt) u_next = M_L u/dt + f  with the SAME
    structure-detected operator stack as MatrixFreePoisson: when the
    offset histogram is band-concentrated the shifted operator rides the
    banded DIA split (the diagonal shift only touches the center stencil
    layer) with the zero-gather BandedMG preconditioner; otherwise
    ELL + device aux-grid. Steps run as a HOST loop of chunked CG solves —
    bounded programs, per-step convergence observability, and
    program caches shared across all steps (first step pays the compiles).

    Reference anchor: fem_linear_parabolic_solver.h:37-72 (factorize once,
    back-solve per step) — here the "factorization" is the preconditioner
    build, equally amortized over the trajectory.
    """

    def __init__(self, nodes, cells, boundary, dt: float, kappa=None,
                 **kw):
        self.base = MatrixFreePoisson(nodes, cells, boundary, kappa=kappa,
                                      **kw)
        self.boundary = self.base.boundary
        self.n_dofs = self.base.n_dofs
        self.dt = float(dt)
        C = cells.shape[0]

        @jax.jit
        def shifted(op, mdiag):
            K_op = op.with_added_diagonal(mdiag / dt)
            return K_op, K_op.diagonal().astype(jnp.float32)

        self.mdiag = self.base.load_vector(
            jnp.ones(C, self.base.nodes.dtype)
        )  # lumped mass
        self.op, diag32 = shifted(self.base.op, self.mdiag)
        self.preconditioner = self.base.preconditioner
        if self.preconditioner == "banded_mg":
            from ..ops.dia_split import BandedMGPreconditioner
            from ..ops.dia_split3d import BandedMGPreconditioner3D

            F32 = jax.jit(
                lambda S_, b_: S_.astype(jnp.float32).fold_dirichlet(b_)
            )(self.op, self.boundary)
            bmg_cls = (BandedMGPreconditioner if self.base.dim == 2
                       else BandedMGPreconditioner3D)
            self.aux = bmg_cls.build(F32)
        else:
            from ..ops.auxgrid import (
                AuxGridPreconditioner,
                AuxGridPreconditioner3D,
            )

            aux_cls = (AuxGridPreconditioner if self.base.dim == 2
                       else AuxGridPreconditioner3D)
            self.aux = aux_cls.build_device(
                self.base.nodes, diag32, grid_n=kw.get("grid_n"),
                bbox=kw.get("bbox"),
            )

    def load_vector(self, f_cells):
        return self.base.load_vector(f_cells)

    def step(self, u, f=None, g=None, rtol: float = 1e-9,
             maxiter: int = 100, chunk: int | None = None, on_chunk=None):
        """One implicit-Euler step. f: assembled load vector (n,) for the
        NEXT instant (use load_vector) or None; g: Dirichlet data at the
        next instant (default 0). Returns (u_next, iterations, true rel
        residual)."""
        if g is None:
            g = jnp.zeros_like(u)
        b = _parabolic_rhs(self.mdiag, jnp.asarray(self.dt), u, f)
        if chunk is not None:
            return _solve_chunked(self.op, self.boundary, self.aux, b, g,
                                  True, rtol, maxiter, chunk, on_chunk,
                                  u0=u)  # warm start from the last instant
        run = _parabolic_step_fn(float(rtol), int(maxiter))
        return run(self.op, self.boundary, self.aux, b, g, u)

    def solve(self, u0, n_steps: int, f=None, g=None, rtol: float = 1e-9,
              maxiter: int = 100, chunk: int | None = None,
              keep_trajectory: bool = False, on_step=None):
        """March n_steps from u0 (host loop; program caches shared across
        steps). f/g: constant-in-time load vector / Dirichlet data (per-
        step variation: drive `step` directly). Returns (u_final, info
        dict with per-step iterations/rel lists [host floats]); with
        keep_trajectory=True also stacks every step's solution (memory:
        n_steps x n_dofs — device-scale callers should sample via
        on_step instead)."""
        u = jnp.asarray(u0)
        iters, rels, traj = [], [], []
        for k in range(n_steps):
            u, it, rel = self.step(u, f=f, g=g, rtol=rtol, maxiter=maxiter,
                                   chunk=chunk)
            iters.append(int(it))
            rels.append(float(rel))
            if keep_trajectory:
                traj.append(u)
            if on_step is not None:
                on_step(k, u, iters[-1], rels[-1])
        info = {"iterations": iters, "rel_residuals": rels}
        if keep_trajectory:
            info["trajectory"] = jnp.stack(traj, axis=1)
        return u, info


@jax.jit
def _parabolic_rhs(mdiag, dt, u, f):
    b = mdiag * u / dt
    return b if f is None else b + f


@functools.lru_cache(maxsize=None)
def _parabolic_step_fn(rtol: float, maxiter: int):
    """Like _solve_fn but warm-started from the previous instant (an
    excellent initial guess for small dt)."""

    @jax.jit
    def run(op, bnd, aux, b, g, u_prev):
        sys = DirichletSystem(op, bnd)

        def pre(r):
            return aux(r.astype(jnp.float32)).astype(r.dtype)

        b_mod = sys.rhs(b, g)
        x0 = jnp.where(bnd, g, u_prev)
        x, info = cg(sys, b_mod, M_inv=pre, x0=x0, rtol=rtol,
                     maxiter=maxiter)
        res = b_mod - sys(x)
        rel = jnp.sqrt(jnp.sum(res * res) / jnp.sum(b_mod * b_mod))
        return x, info.iterations, rel

    return run
