"""Separable space-time operators: sums of Kronecker products, matrix-free.

The reference provides the Kronecker building block
(linear_algebra/kronecker_product.h) that downstream fdaPDE space-time
models combine into penalties like  R = T1 (x) S0 + T0 (x) S1  (spline
penalty in time, FEM matrices in space). Materializing n_t*n_s square
matrices is hostile to accelerators; here the operator stays a sum of
Kronecker factors and every matvec is two batched matmuls per term
(vec identity: (A (x) B) vec(X) = vec(B X A^T)) — matmul-shaped.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..linear_algebra.kron import kron_matvec
from ..linear_algebra.solvers import bicgstab, cg
from ..linear_algebra.sparse import SparseMatrix

__all__ = ["SeparableOperator", "ModeDiagPreconditioner", "solve_space_time",
           "SpaceTimeSmoothing"]


def _space_n(S):
    return S.shape2d[0] * S.shape2d[1] if hasattr(S, "shape2d") else S.shape[0]


def _apply_space_batch(S, X):
    """S applied to every row of X (n_t, n_s): matrices via one matmul /
    sparse transpose trick, stencil operators via their batched hook."""
    if hasattr(S, "matvec_batch"):
        return S.matvec_batch(X)
    if isinstance(S, SparseMatrix):
        return (S @ X.T).T
    return X @ jnp.asarray(S).T


def _diag_of(M):
    return M.diagonal() if hasattr(M, "diagonal") and not isinstance(
        M, jnp.ndarray
    ) else jnp.diagonal(jnp.asarray(M))


def _host_dense(T):
    """Small time factor as a host numpy array (for the eigh setup)."""
    if hasattr(T, "toarray"):
        return np.asarray(T.toarray())
    return np.asarray(T)


class SeparableOperator:
    """sum_k  T_k (x) S_k  as a matrix-free linear operator.

    T_k act on the time index (n_t x n_t), S_k on space (n_s x n_s); the
    operator acts on vec(u) with u of shape (n_t, n_s) row-major. S_k may
    be dense, SparseMatrix, or ANY operator exposing `matvec_batch(X)` +
    `diagonal()` (e.g. ops/grid_dia.GridDIAMatrix) — the device-scale form
    where materializing S is hostile to the accelerator.
    """

    def __init__(self, terms):
        self.terms = list(terms)  # [(T, S), ...]
        T0, S0 = self.terms[0]
        self.n_t = T0.shape[0]
        self.n_s = _space_n(S0)
        self.shape = (self.n_t * self.n_s, self.n_t * self.n_s)

    def __call__(self, x):
        X = jnp.asarray(x).reshape(self.n_t, self.n_s)
        out = None
        for T, S in self.terms:
            SX = _apply_space_batch(S, X)
            # HIGHEST: an f32 matmul may otherwise run in a reduced-
            # precision mode (TF32 on NVIDIA tensor cores) — a ~3-digit
            # perturbation of the time factor stalls tight-tolerance Krylov
            # iterations at scale
            y = (T @ SX) if isinstance(T, SparseMatrix) else jnp.matmul(
                jnp.asarray(T), SX, precision=jax.lax.Precision.HIGHEST
            )
            out = y if out is None else out + y
        return out.reshape(-1)

    __matmul__ = __call__

    def diagonal(self):
        """Diagonal of the operator (for Jacobi preconditioning)."""
        d = None
        for T, S in self.terms:
            term = jnp.kron(_diag_of(T), _diag_of(S))
            d = term if d is None else d + term
        return d

    def tree_flatten(self):
        return tuple(self.terms), None

    @classmethod
    def tree_unflatten(cls, aux, terms):
        return cls(list(terms))


jax.tree_util.register_pytree_node_class(SeparableOperator)


@jax.tree_util.register_pytree_node_class
class ModeDiagPreconditioner:
    """Mode-diagonal preconditioner for  R = T1 (x) S0 + T0 (x) S1.

    With the generalized time eigenbasis Z^T T1 Z = diag(lam),
    Z^T T0 Z = I (host eigh on the tiny n_t x n_t pair), the exact
    transform (Z (x) I)^T R (Z (x) I) = diag(lam) (x) S0 + I (x) S1
    decouples time; replacing S0/S1 by their DIAGONALS gives the SPD
    approximation  M^{-1} r = (Z (x) I) D^{-1} (Z^T (x) I) r  with
    D_t = lam_t diag(S0) + diag(S1) — two small time matmuls plus an
    elementwise scale per application, matmul-shaped. This is what makes an
    f32 Krylov iteration on the ill-conditioned space-time sum actually
    REDUCE the residual (unpreconditioned f32 CG diverges at
    kappa ~ 1e6+); the exact per-mode solve is solve_space_time_fdm.
    """

    def __init__(self, Z, Dinv):
        self.Z = Z  # (n_t, n_t)
        self.Dinv = Dinv  # (n_t, n_s)

    def tree_flatten(self):
        return (self.Z, self.Dinv), None

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves)

    @classmethod
    def build(cls, T0, T1, dS0, dS1, floor: float = 0.0):
        """Host-side setup (T0/T1 host arrays, tiny); dS0/dS1 device (n_s,)."""
        import scipy.linalg as sla

        lam, Z = sla.eigh(np.asarray(T1), np.asarray(T0))
        dtype = jnp.asarray(dS0).dtype
        lamj = jnp.asarray(lam, dtype)
        D = lamj[:, None] * dS0[None, :] + dS1[None, :]
        D = jnp.where(jnp.abs(D) > floor, D, 1.0)
        return cls(jnp.asarray(Z, dtype), 1.0 / D)

    def __call__(self, r):
        n_t = self.Z.shape[0]
        X = jnp.asarray(r).reshape(n_t, -1)
        hi = jax.lax.Precision.HIGHEST
        W = jnp.matmul(self.Z.T, X, precision=hi)
        W = W * self.Dinv
        return jnp.matmul(self.Z, W, precision=hi).reshape(-1)

    __matmul__ = __call__


@jax.tree_util.register_pytree_node_class
class ModeMGPreconditioner:
    """Mode-batched MULTIGRID preconditioner for R = T1 (x) S0 + T0 (x) S1
    on structured space grids (S0/S1 ops/grid_dia.GridDIAMatrix).

    Time is diagonalized exactly (host eigh of the tiny (T1, T0) pencil);
    each time mode's space system  S1 + lam_t S0  gets ONE GridMG V-cycle,
    batched over ALL modes with jax.vmap (the two Galerkin chains share
    the bilinear P, so level data is the AXPY  A_l + lam_t E_l — one
    (n_t, K_l, m_l, m_l) stack per level, built in a single jit). Against
    the kappa ~ 1e6 space conditioning that defeats diagonal
    preconditioning, this makes the f32 space-time CG iteration converge
    h-independently — the iteration THAT solve_space_time_fdm runs to
    convergence, exposed as a reusable SPD preconditioner.
    """

    def __init__(self, Z, mg):
        self.Z = Z  # (n_t, n_t) time eigenbasis, T0-orthonormal
        self.mg = mg  # GridMG with mode-batched level data

    def tree_flatten(self):
        return (self.Z, self.mg), None

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        return cls(*leaves)

    @classmethod
    def build(cls, T0, T1, S0, S1, dtype=jnp.float32, coarse_n: int = 32,
              omega: float = 0.8, nu: int = 2, coarse_iters: int = 64):
        """T0/T1 host (n_t, n_t); S0/S1 GridDIAMatrix with IDENTICAL
        offsets2d (pad the sparser one with zero layers) and boundary
        treatment already folded (with_dirichlet_identity on S1)."""
        import scipy.linalg as sla

        from ..ops.grid_dia import GridDIAMatrix
        from ..ops.grid_mg import GridMG, galerkin_coarsen

        if S0.offsets2d != S1.offsets2d:
            raise ValueError("S0/S1 must share offsets2d (pad zero layers)")
        lam, Z = sla.eigh(np.asarray(T1), np.asarray(T0))
        lamj = jnp.asarray(lam, dtype)

        # static level plan (GridMG.build's rule), then ONE jitted program
        # for both Galerkin chains + the per-mode AXPY
        shapes = [S1.shape2d[0]]
        offsets = [S1.offsets2d]
        while True:
            nn = shapes[-1] - 1
            if nn % 2 != 0 or nn // 2 < coarse_n:
                break
            shapes.append(nn // 2 + 1)
            offsets.append(
                tuple((a, b) for a in (-1, 0, 1) for b in (-1, 0, 1))
            )

        @jax.jit
        def chains_and_combine(dA, dE, lamj):
            GA = GridDIAMatrix(dA, S1.offsets2d, S1.shape2d)
            GE = GridDIAMatrix(dE, S0.offsets2d, S0.shape2d)
            out = []
            for _ in range(len(shapes)):
                out.append(
                    GA.data[None].astype(dtype)
                    + lamj[:, None, None, None] * GE.data[None].astype(dtype)
                )
                if len(out) < len(shapes):
                    GA = galerkin_coarsen(GA)
                    GE = galerkin_coarsen(GE)
            return tuple(out)

        datas = list(chains_and_combine(S1.data, S0.data, lamj))
        mg = GridMG(datas, tuple(offsets), tuple(shapes), omega, nu,
                    coarse_iters)
        return cls(jnp.asarray(Z, dtype), mg)

    def __call__(self, r):
        from ..ops.grid_mg import GridMG

        n_t = self.Z.shape[0]
        X = jnp.asarray(r).reshape(n_t, -1)
        hi = jax.lax.Precision.HIGHEST
        W = jnp.matmul(self.Z.T, X, precision=hi)
        W = jax.vmap(GridMG.v_cycle)(self.mg, W)
        return jnp.matmul(self.Z, W, precision=hi).reshape(-1)

    __matmul__ = __call__


def solve_space_time(op: SeparableOperator, b, symmetric=True, rtol=1e-10,
                     maxiter=None, recovery=True):
    """Solve (sum_k T_k (x) S_k) x = b matrix-free with Jacobi-CG/BiCGStab.

    Failure recovery (SURVEY §5.3): on a stalled/diverged Krylov loop, one
    escalation — for the two-term penalty form T_a (x) S_a + T_b (x) S_b
    the retry swaps Jacobi for the mode-diagonal preconditioner (exact
    time diagonalization; the conditioning of the time pencil, e.g. a
    spline bilaplacian Gram spanning ~h_t^-3, is what usually defeats
    plain Jacobi here); otherwise GMRES(50). Eager path only (flags are
    tracers inside jit)."""
    import jax

    d = op.diagonal()
    inv = 1.0 / jnp.where(jnp.abs(d) > 0, d, 1.0)
    solver = cg if symmetric else bicgstab
    b = jnp.asarray(b)
    x, info = solver(op, b, M_inv=lambda r: inv * r, rtol=rtol, maxiter=maxiter)
    if (
        recovery
        and not isinstance(info.converged, jax.core.Tracer)
        and not bool(info.converged)
    ):
        import warnings

        from ..linear_algebra.solvers import gmres

        x_start = jnp.where(jnp.all(jnp.isfinite(x)), x, jnp.zeros_like(x))
        pre = None
        if len(op.terms) == 2 and symmetric:
            # terms [(T_b, S_a), (T_a, S_b)]: mode system S_b + lam S_a
            # from eigh(T_b, T_a) — matches the R = T1 (x) S0 + T0 (x) S1
            # convention of ModeDiagPreconditioner.build(T0, T1, dS0, dS1)
            (Tb, Sa), (Ta, Sb) = op.terms
            try:
                pre = ModeDiagPreconditioner.build(
                    _host_dense(Ta), _host_dense(Tb),
                    _diag_of(Sa), _diag_of(Sb),
                )
            except Exception:  # non-SPD pencil etc.: fall through to GMRES
                pre = None
        if pre is not None:
            warnings.warn(
                "space-time solve stalled; escalating to the "
                "mode-diagonal preconditioner", stacklevel=2,
            )
            x, info = cg(op, b, M_inv=pre, x0=x_start, rtol=rtol,
                         maxiter=maxiter)
        else:
            warnings.warn(
                "space-time solve stalled; escalating to GMRES(50)",
                stacklevel=2,
            )
            x, info = gmres(op, b, M_inv=lambda r: inv * r, x0=x_start,
                            rtol=rtol, maxiter=maxiter, restart=50)
    return x, info


class SpaceTimeSmoothing:
    """Separable space-time field estimation (spline-in-time x FEM-in-space).

    The downstream fdaPDE space-time model on a monitoring design (fixed
    spatial locations p_i observed at all instants t_j): estimate
    f(p, t) = sum_{uv} c_{uv} phi_u(t) psi_v(p) minimizing

        ||Y - Phi C Psi^T||_F^2 + lam_s * <(Mt (x) As) c, c>
                                 + lam_t * <(Pt (x) Ms) c, c>

    with As/Ms the FEM stiffness/mass on the spatial mesh, Mt/Pt the spline
    mass/bilaplacian penalty in time. On the grid design the normal
    equations are a SUM OF KRONECKER PRODUCTS —

        [(Phi^T Phi) (x) (Psi^T Psi) + lam_s Mt (x) As + lam_t Pt (x) Ms] c
            = vec(Phi^T Y Psi)

    — solved matrix-free (every matvec is a few small matmuls, matmul-shaped).
    """

    def __init__(self, mesh, time_interval, fem_order=1, spline_order=3):
        from ..fem.assembler import assemble_matrix
        from ..fem.space import FEMSpace
        from ..pde.operators import laplacian, reaction
        from ..splines.assembler import assemble_mass, assemble_operator
        from ..splines.space import SplineSpace
        from ..pde.operators import bilaplacian

        self.space = FEMSpace(mesh, fem_order)
        self.tspace = SplineSpace(time_interval, spline_order)
        self.As = assemble_matrix(self.space, -laplacian())
        self.Ms = assemble_matrix(self.space, reaction(1.0))
        self.Mt = assemble_mass(self.tspace)
        self.Pt = assemble_operator(self.tspace, -bilaplacian())

    def fit(self, locs, times, Y, lam_s, lam_t, rtol=1e-10, maxiter=20000):
        """locs (n_i, d) spatial points; times (n_j,); Y (n_i, n_j)."""
        from ..fem.evaluation import eval_basis_pointwise

        Psi, _ = eval_basis_pointwise(self.space, np.asarray(locs))
        Phi, _ = self.tspace.eval(np.asarray(times))
        PsiTPsi = jnp.asarray(Psi.to_scipy().T @ Psi.to_scipy().toarray())
        PhiTPhi = jnp.asarray(Phi.to_scipy().T @ Phi.to_scipy().toarray())
        from ..linear_algebra.sparse import SparseMatrix

        op = SeparableOperator(
            [
                (SparseMatrix.from_dense(np.asarray(PhiTPhi)),
                 SparseMatrix.from_dense(np.asarray(PsiTPsi))),
                (lam_t * self.Pt, self.Ms),
                (lam_s * self.Mt, self.As),
            ]
        )
        Yj = jnp.asarray(Y, self.As.dtype)
        rhs_mat = Phi.rmatvec(Yj.T)  # (nt_basis, n_i)
        rhs = Psi.rmatvec(rhs_mat.T).T  # -> (nt_basis, ns)
        self._op = op
        c, info = solve_space_time(op, rhs.reshape(-1), rtol=rtol, maxiter=maxiter)
        self.coefficients_ = c.reshape(self.tspace.n_dofs, self.space.n_dofs)
        self.solve_info_ = info
        return self.coefficients_

    def predict(self, locs, times):
        """Field values at the (locs x times) grid: (n_i, n_j)."""
        from ..fem.evaluation import eval_basis_pointwise

        Psi, _ = eval_basis_pointwise(self.space, np.asarray(locs))
        Phi, _ = self.tspace.eval(np.asarray(times))
        tmp = Psi @ self.coefficients_.T  # (n_i, nt_basis)
        return (Phi @ tmp.T).T  # (n_i, n_j)


def solve_space_time_fdm(T0, T1, S0, S1, b, rtol: float = 1e-10,
                         maxiter: int = 2000, device_mesh=None):
    """Fast diagonalization (Lynch–Rice–Thomas) for the 2-term operator
    R = T1 (x) S0 + T0 (x) S1.

    Host-side generalized time eigenbasis T1 Z = T0 Z diag(lam) with
    Z^T T0 Z = I decouples the system into n_t INDEPENDENT space solves

        (S1 + lam_t S0) w_t = (Z^T (x) I) b,   x = (Z (x) I) w

    batched on device with a vmapped Jacobi-CG (one shared while_loop over
    all modes) — or, with `device_mesh`, MODE-PARALLEL across chips: the
    modes are embarrassingly parallel, so each device solves its shard of
    the (lam_t, rhs_t) pairs with ZERO per-iteration communication (the
    small time transforms run replicated). This is the scaling story the
    coupled Kronecker CG (parallel/space_time.ShardedSpaceTime) cannot
    match: no halo exchange at all. The transforms are two (n_t, n_t)
    matmuls; the space solves are the same SpMV streams as the elliptic
    path, so the Kronecker structure costs NOTHING beyond n_t elliptic
    solves. Accelerator replacement of factorizing the materialized
    Kronecker sum (reference building block: kronecker_product.h:27-80).

    Requirements: T0 SPD, T1 symmetric PSD (numpy dense, n_t small);
    S0 SPD, S1 symmetric PSD with S1 + lam_min*S0 SPD (the usual
    mass/stiffness pairs qualify). Returns (x, SolveInfo) where iterations
    is the max over modes and converged the AND.
    """
    import jax
    import scipy.linalg as sla

    from ..linear_algebra.solvers import SolveInfo

    T0n = np.asarray(T0.toarray() if hasattr(T0, "toarray") else T0)
    T1n = np.asarray(T1.toarray() if hasattr(T1, "toarray") else T1)
    lam, Z = sla.eigh(T1n, T0n)  # Z^T T0 Z = I
    n_t = T0n.shape[0]
    n_s = S0.shape[0]
    B = jnp.asarray(b).reshape(n_t, n_s)
    Zj = jnp.asarray(Z, B.dtype)
    lamj = jnp.asarray(lam, B.dtype)
    Bt = Zj.T @ B  # (Z^T (x) I) b on the (t, s) row-major layout

    d0 = S0.diagonal()
    d1 = S1.diagonal()

    def solve_mode(lam_t, rhs):
        def op(v):
            return (S1 @ v) + lam_t * (S0 @ v)

        d = d1 + lam_t * d0
        dinv = 1.0 / jnp.where(jnp.abs(d) > 0, d, 1.0)
        x, info = cg(op, rhs, M_inv=lambda r: dinv * r, rtol=rtol,
                     maxiter=maxiter)
        return x, info.iterations, info.converged

    if device_mesh is None:
        W, iters, conv = jax.vmap(solve_mode)(lamj, Bt)
    else:
        from jax.sharding import PartitionSpec as P

        n_dev = device_mesh.devices.size
        pad = (-n_t) % n_dev
        lam_p = jnp.pad(lamj, (0, pad))
        Bt_p = jnp.pad(Bt, ((0, pad), (0, 0)))

        def shard_fn(lams, rhss):
            return jax.vmap(solve_mode)(lams, rhss)

        W, iters, conv = jax.shard_map(
            shard_fn,
            mesh=device_mesh,
            in_specs=(P("shard"), P("shard", None)),
            out_specs=(P("shard", None), P("shard"), P("shard")),
        )(lam_p, Bt_p)
        W, iters, conv = W[:n_t], iters[:n_t], conv[:n_t]
    X = Zj @ W
    return X.reshape(-1), SolveInfo(iters.max(), jnp.zeros(()), conv.all())
