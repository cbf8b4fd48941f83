"""The PDE problem descriptor.

Counterpart of /root/reference/fdaPDE/pde/pde.h:40-114 (and the type-erased
`make_pde`, pde.h:117-168 — unnecessary in Python). Usage mirrors the
reference tests (test/src/fem_pde_test.cpp):

    mesh = Triangulation(nodes, cells, boundary)
    L = -laplacian()
    pde = PDE(mesh, L, order=1)
    pde.set_dirichlet_bc(g)           # g: values at dof coordinates
    pde.set_forcing(f)                # callable, or array over quadrature nodes
    pde.init()                        # assemble stiff/mass/force
    pde.solve()                       # CG / BiCGStab / implicit-Euler scan
    u = pde.solution()

The solver is selected like `pde_solver_selector` (fem_solver_selector.h:29-33):
parabolic iff the operator contains dt(), SPLINE discretization for
`discretization="spline"` (splines/solvers/spline_solver_selector.h).
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .operators import DifferentialOp

__all__ = ["PDE"]

# beyond this size, an unpreconditioned/Jacobi CG pays more iterations than
# the auxgrid/AMG setup costs: switch to the "auto" preconditioner ladder
_AUTO_PRECOND_DOFS = 20_000


class PDE:
    """An initialized boundary-value problem over a mesh."""

    def __init__(
        self,
        domain,
        operator: DifferentialOp,
        forcing=None,
        times=None,
        order: int = 1,
        discretization: str = "fem",
        solver_rtol: float = 1e-12,
        solver_maxiter: int | None = None,
        lumped_mass: bool = False,
        solver_preconditioner=None,
    ):
        self.domain = domain
        self.operator = operator
        self.times = None if times is None else np.asarray(times).reshape(-1)
        self.order = order
        self.discretization = discretization
        self.solver_rtol = solver_rtol
        self.solver_maxiter = solver_maxiter
        self.lumped_mass = lumped_mass
        # None/callable M_inv(r), "amg" (smoothed-aggregation V-cycle of
        # the masked operator, linear_algebra/amg.py — topology-only,
        # always applicable), or "auxgrid" (auxiliary structured-grid
        # two-level preconditioner, ops/auxgrid.py — box-like domains,
        # far fewer gathers per application); both give h-independent CG
        # iteration counts on unstructured meshes
        self.solver_preconditioner = solver_preconditioner

        if discretization == "fem":
            from ..fem.space import FEMSpace

            self.space = FEMSpace(domain, order)
        elif discretization == "spline":
            from ..splines.space import SplineSpace

            self.space = SplineSpace(domain, order)
        else:
            raise ValueError(discretization)

        self._forcing = forcing
        self._dirichlet = None
        self._initial_condition = None
        self._stiff = None
        self._mass = None
        self._force = None
        self._solution = None
        self.is_init = False
        self.success = False

    # -- setters (pde.h:74-85) ----------------------------------------------
    def set_forcing(self, f):
        self._forcing = f

    def set_dirichlet_bc(self, g):
        self._dirichlet = np.asarray(g, dtype=np.float64)

    def set_initial_condition(self, u0):
        self._initial_condition = np.asarray(u0, dtype=np.float64).reshape(-1)

    def set_differential_operator(self, L: DifferentialOp):
        self.operator = L

    # -- queries (pde.h:86-100) ----------------------------------------------
    def dof_coords(self) -> np.ndarray:
        return self.space.dof_coords

    def quadrature_nodes(self) -> np.ndarray:
        return self.space.quadrature_nodes

    @property
    def n_dofs(self) -> int:
        return self.space.n_dofs

    def stiff(self):
        return self._stiff

    def mass(self):
        return self._mass

    def force(self):
        return self._force

    def solution(self):
        return self._solution

    @property
    def is_parabolic(self) -> bool:
        return self.operator.is_parabolic

    def eval_functional_basis(self, locs, policy: str = "pointwise"):
        """Psi matrix of basis evaluations (pde.h:89-92)."""
        if self.discretization == "spline":
            return self.space.eval(locs, policy)
        from ..fem.evaluation import eval_basis_areal, eval_basis_pointwise

        if policy == "pointwise":
            return eval_basis_pointwise(self.space, locs)
        if policy == "areal":
            return eval_basis_areal(self.space, locs)
        raise ValueError(policy)

    # -- init: assembly (fem_solver_base.h:104-139) ---------------------------
    def init(self):
        if self.discretization == "spline":
            from ..splines.assembler import assemble_operator as _asm
            from ..splines.assembler import assemble_mass as _asm_mass

            self._stiff = _asm(self.space, self.operator)
            self._mass = _asm_mass(self.space)
            if self._forcing is not None:
                from ..splines.assembler import assemble_forcing as _asm_f

                self._force = _asm_f(self.space, self._forcing)
            else:
                self._force = jnp.zeros(self.space.n_dofs)
            self.is_init = True
            return self

        from ..fem.assembler import assemble_forcing, assemble_matrix
        from .operators import reaction

        self._stiff = assemble_matrix(self.space, self.operator)
        self._mass = assemble_matrix(self.space, reaction(1.0))
        if self._forcing is not None:
            self._force = assemble_forcing(self.space, self._forcing)
        else:
            self._force = jnp.zeros(self.space.n_dofs)
        self.is_init = True
        return self

    # -- solve (fem_linear_{elliptic,parabolic}_solver.h) ---------------------
    def solve(self):
        import time as _time

        _t0 = _time.time()
        if not self.is_init:
            self.init()
        if self._dirichlet is None:
            # no boundary data set: solve the raw system (the reference
            # imposes conditions only when supplied; splines upstream have no
            # BC handling at all, spline_solver_base.h:79)
            mask = jnp.zeros(self.space.n_dofs, dtype=bool)
            g = np.zeros(
                (self.space.n_dofs,)
                if self.times is None
                else (self.space.n_dofs, self.times.size)
            )
        else:
            mask = jnp.asarray(self.space.boundary_dofs)
            g = self._dirichlet

        if not self.is_parabolic:
            from ..fem.solvers import solve_elliptic

            gvec = jnp.asarray(g.reshape(-1) if g.ndim > 1 else g)
            # preconditioner selection. "auto" (also the default beyond
            # _AUTO_PRECOND_DOFS): auxiliary-grid first — far fewer gathers
            # per application than SA-AMG at equal (h-independent)
            # iteration counts — with SA-AMG for meshes the aux-grid build
            # cannot cover (it raises ValueError or fails a grid-shape
            # assertion); solve errors are never caught here
            precond = self.solver_preconditioner
            auto = precond == "auto" or (
                precond is None and self.space.n_dofs >= _AUTO_PRECOND_DOFS
            )
            name = "custom" if callable(precond) else (precond or "jacobi")
            if precond == "auxgrid":
                precond = ("auxgrid", self.space.dof_coords)
            elif auto:
                from ..fem.solvers import DirichletSystem, auxgrid_preconditioner

                try:
                    precond = auxgrid_preconditioner(
                        DirichletSystem(self._stiff, mask),
                        self.space.dof_coords,
                    )
                    name = "auxgrid"
                except (ValueError, AssertionError):
                    precond = name = "amg"
            self.solve_preconditioner = name
            x, info = solve_elliptic(
                self._stiff,
                self._force
                if self._force.ndim == 1
                else self._force.reshape(-1),
                mask,
                gvec,
                symmetric=self.operator.is_symmetric,
                rtol=self.solver_rtol,
                maxiter=self.solver_maxiter,
                preconditioner=precond,
            )
            self._solution = x
            self.solve_info = info
            self.success = bool(info.converged)
        else:
            from ..fem.solvers import solve_parabolic

            assert self.times is not None, "parabolic problems need a time grid"
            assert self._initial_condition is not None, (
                "parabolic problems need an initial condition (pde.h:83)"
            )
            F = self._force
            if F.ndim == 1:
                F = jnp.tile(F[:, None], (1, self.times.size))
            G = jnp.asarray(
                g if g.ndim == 2 else np.tile(g[:, None], (1, self.times.size))
            )
            self._solution = solve_parabolic(
                self._stiff,
                self._mass,
                F,
                mask,
                G,
                jnp.asarray(self._initial_condition),
                jnp.asarray(self.times),
                rtol=self.solver_rtol,
                maxiter=self.solver_maxiter,
                lumped=self.lumped_mass,
                symmetric=self.operator.is_symmetric,
            )
            self.success = True
        self.solve_seconds = _time.time() - _t0
        return self._solution

    def report(self) -> dict:
        """Structured per-solve observability record (SURVEY.md §5.5).

        The reference exposes only `is_init`/`success` flags
        (fem_solver_base.h:61-62); here: problem size, operator sparsity,
        solver iterations and final residual.
        """
        rec = {
            "discretization": self.discretization,
            "order": self.order,
            "n_dofs": self.n_dofs,
            "is_parabolic": self.is_parabolic,
            "is_init": self.is_init,
            "success": self.success,
        }
        if self._stiff is not None:
            rec["stiff_nnz"] = self._stiff.nnz
        if hasattr(self, "solve_info"):
            rec["solver_iterations"] = int(self.solve_info.iterations)
            rec["solver_residual"] = float(self.solve_info.residual)
            rec["solver_converged"] = bool(self.solve_info.converged)
        if hasattr(self, "solve_seconds"):
            rec["solve_seconds"] = round(self.solve_seconds, 4)
        return rec

    # -- error functional (fem_pde_test.cpp:72-74) ----------------------------
    def l2_error(self, exact_at_dofs) -> float:
        """Mass-weighted squared L2 error functional used by the reference
        tests: (mass @ (e * e)).sum()."""
        e = jnp.asarray(exact_at_dofs).reshape(self._solution.shape) - self._solution
        if e.ndim == 1:
            return float((self._mass @ (e * e)).sum())
        return float(jnp.max(jnp.sum(self._mass @ (e * e), axis=0)))
