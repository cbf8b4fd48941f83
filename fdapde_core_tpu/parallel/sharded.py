"""shard_map'ed FEM assembly + conjugate gradients over a device mesh.

The multi-chip execution model (new in this build; the reference is
serial — SURVEY.md §2.9):

- elements are partitioned into contiguous SFC blocks, one per device
  (`partition.py`); per-element local stiffness matrices are computed
  *without any communication* inside `shard_map` (the reference's serial
  assembly loop fem_assembler.h:79-110, parallelized over the element axis),
- the dof vector is replicated; an SpMV is: local gather x[dofs] ->
  batched (nb x nb) contraction -> local segment-sum scatter -> one `psum`
  over the mesh axis (rides ICI on real hardware),
- CG runs replicated inside the shard_map region: dot products of replicated
  vectors need no collective; the single psum per iteration is the SpMV.

Dirichlet conditions use the same symmetric masking formulation as the
single-chip solver (fem/solvers.py).
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..fem.space import FEMSpace
from .partition import partition_elements

__all__ = ["make_device_mesh", "ShardedPoisson"]


def make_device_mesh(n_devices: int | None = None) -> Mesh:
    """1D device mesh over the first n_devices JAX devices."""
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    return Mesh(np.array(devs[:n_devices]), ("shard",))


class ShardedPoisson:
    """Sharded assemble+solve for (diffusion-type) operators, P1/P2 Lagrange.

    The flagship end-to-end pipeline: given a triangulation, partitions
    elements across the device mesh and exposes a single jitted `solve`
    (assembly + preconditioned CG) plus separate `assemble` / `cg` stages for
    benchmarking.
    """

    def __init__(
        self,
        mesh,
        order: int = 1,
        device_mesh: Mesh | None = None,
        dtype=None,
        operator=None,
        preconditioner: str = "jacobi",
        spmv: str = "segment",
        max_degree: int | None = None,
    ):
        from ..pde.operators import laplacian

        self.mesh = mesh
        self.operator = operator if operator is not None else -laplacian()
        self.space = FEMSpace(mesh, order)
        self.device_mesh = device_mesh or make_device_mesh()
        self.n_shards = self.device_mesh.devices.size
        if dtype is None:
            dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        self.dtype = dtype

        perm, live, block = partition_elements(mesh, self.n_shards)
        self.block = block
        nb = self.space.n_basis_per_cell

        # static (host) shard layout
        self._cells = np.ascontiguousarray(mesh.cells[perm])  # (S*B, k)
        self._dofs = np.ascontiguousarray(self.space.dofs[perm])  # (S*B, nb)
        self._live = live.astype(np.float64)  # padded copies get weight 0
        self.n_dofs = self.space.n_dofs

        sh = lambda spec: NamedSharding(self.device_mesh, spec)
        self._cells_d = jax.device_put(jnp.asarray(self._cells), sh(P("shard")))
        self._dofs_d = jax.device_put(jnp.asarray(self._dofs), sh(P("shard")))
        self._live_d = jax.device_put(
            jnp.asarray(self._live, dtype=dtype), sh(P("shard"))
        )
        self._nodes = jnp.asarray(mesh.nodes, dtype=dtype)
        self._phi = jnp.asarray(self.space.phi_tab, dtype=dtype)
        self._grad = jnp.asarray(self.space.grad_tab, dtype=dtype)
        self._w = jnp.asarray(self.space.quad.weights, dtype=dtype)
        self._bmask = jnp.asarray(self.space.boundary_dofs)

        # optional auxiliary-grid preconditioner (ops/auxgrid.py): the
        # apply is REPLICATED on every device (n*2d gathered elements + a
        # tiny structured V-cycle — cheaper to redo than to communicate);
        # only the SpMV stays sharded, so no extra collectives per iteration
        self.preconditioner = preconditioner
        self._aux = None
        if preconditioner == "auxgrid":
            from ..ops.auxgrid import (
                AuxGridPreconditioner,
                AuxGridPreconditioner3D,
            )

            coords = self.space.dof_coords
            cls3 = AuxGridPreconditioner3D if coords.shape[1] == 3 else (
                AuxGridPreconditioner
            )
            # dinv is recomputed from the psum'd diagonal inside the solve;
            # a placeholder keeps the pytree structure static
            self._aux = cls3.build(
                coords, np.ones(self.n_dofs), dtype=dtype
            )
        elif preconditioner != "jacobi":
            raise ValueError(preconditioner)

        # operator terms: constant coefficients close over the jit; space-
        # varying ones (callables evaluated at quadrature nodes, or arrays
        # in the reference's nq*cell+q forward protocol) become per-cell
        # arrays permuted into SFC order and SHARDED with the cells
        from ..fem.assembler import _KIND, prepare_coefficient
        from ..pde.operators import BiLaplacian, Laplacian

        self._terms = []  # (scale, kind, varying, const_or_slot)
        coeff_arrays = []
        for scale, leaf in self.operator.spatial_terms:
            if isinstance(leaf, BiLaplacian):
                raise ValueError("bilaplacian is SPLINE-only")
            kind, ckind = _KIND[type(leaf)]
            if isinstance(leaf, Laplacian):
                varying, coeff = False, None
            else:
                cval = (
                    leaf.K if kind == "diffusion"
                    else leaf.b if kind == "advection" else leaf.c
                )
                varying, coeff = prepare_coefficient(self.space, cval, ckind)
            if varying:
                cperm = jnp.asarray(np.asarray(coeff)[perm], dtype=dtype)
                coeff_arrays.append(
                    jax.device_put(cperm, sh(P("shard")))
                )
                self._terms.append((scale, kind, True, len(coeff_arrays) - 1))
            else:
                self._terms.append((scale, kind, False, coeff))
        self._coeffs_d = tuple(coeff_arrays)

        # scatter-free per-shard combine (ops/ell.py): each device holds the
        # ELL incidence table of ITS OWN cell block over the replicated dof
        # axis, so the partial SpMV is pure gathers — segment_sum's
        # scatter-add serializes on duplicate indices. One vmapped
        # device build at init, sharded (S, n_dofs, K) over the mesh axis.
        self.spmv = spmv
        self._adj_d = self._adjmask_d = None
        if spmv == "ell":
            from ..ops.ell import build_ell_adjacency

            if max_degree is None:
                max_degree = int(
                    np.bincount(self._dofs.reshape(-1),
                                minlength=self.n_dofs).max()
                )
            dofs_blocks = jnp.asarray(
                self._dofs.reshape(self.n_shards, self.block, nb)
            )
            adj, amask, over = jax.jit(
                jax.vmap(
                    lambda d: build_ell_adjacency(d, self.n_dofs, max_degree)
                )
            )(dofs_blocks)
            if bool(over.any()):
                raise ValueError(
                    f"a dof exceeds max_degree={max_degree} incidences in "
                    "its shard; rebuild with a larger bound"
                )
            self._adj_d = jax.device_put(adj, sh(P("shard")))
            self._adjmask_d = jax.device_put(amask, sh(P("shard")))
        elif spmv != "segment":
            raise ValueError(spmv)

        self._assemble_jit = jax.jit(self._assemble)
        self._cg_jit = jax.jit(self._cg, static_argnames=("maxiter",))
        self._solve_jit = jax.jit(self._solve, static_argnames=("maxiter",))

    # -- sharded local assembly ----------------------------------------------
    def _local_matrices(self, nodes, cells, live, coeffs=()):
        """(B, nb, nb) local matrices of the operator, one shard's block.

        Same weak forms as fem/assembler.local_matrices; space-varying
        coefficients arrive as this shard's (B, nq, ...) blocks in `coeffs`
        (slot order fixed at init).
        """
        from ..fem.assembler import local_matrices
        from ..geometry.affine import affine_maps

        J, invJ, measure = affine_maps(nodes, cells)
        meff = measure * live
        nb = self.space.n_basis_per_cell
        out = jnp.zeros((cells.shape[0], nb, nb), dtype=nodes.dtype)
        for scale, kind, varying, c in self._terms:
            if varying:
                coeff = coeffs[c]
            else:
                coeff = None if c is None else jnp.asarray(c, nodes.dtype)
            out = out + scale * local_matrices(
                kind, coeff, varying, self._phi, self._grad, self._w, invJ,
                meff,
            )
        return out

    def _assemble(self):
        mesh = self.device_mesh

        def shard_fn(cells, live, *coeffs):
            return self._local_matrices(self._nodes, cells, live, coeffs)

        return jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P("shard"), P("shard"))
            + (P("shard"),) * len(self._coeffs_d),
            out_specs=P("shard"),
        )(self._cells_d, self._live_d, *self._coeffs_d)

    def assemble(self):
        """Sharded local matrices (S*B, nb, nb); no communication."""
        return self._assemble_jit()

    # -- sharded CG ----------------------------------------------------------
    def _spmv_local(self, A_loc, dofs, x, free, combine=None):
        """One shard's partial A@x with Dirichlet masking; psum'd by caller."""
        xf = x * free
        xe = xf[dofs]  # (B, nb) local gather
        ye = jnp.einsum("cij,cj->ci", A_loc, xe)
        if combine is None:
            return jax.ops.segment_sum(
                ye.reshape(-1), dofs.reshape(-1), self.n_dofs
            )
        return combine(ye.reshape(-1))

    def _cg(self, A_loc, b, g, rtol=1e-6, maxiter=200):
        """Preconditioned CG; runs inside shard_map, one psum per SpMV."""
        mesh = self.device_mesh
        bmask = self._bmask
        free = (~bmask).astype(b.dtype)
        use_ell = self._adj_d is not None

        def shard_fn(A_loc, dofs, b, g, *ell):
            if use_ell:
                adj, amask = ell[0][0], ell[1][0]  # (1, n, K) shard blocks

                def combine(ye_flat):
                    gat = ye_flat[adj] * amask.astype(ye_flat.dtype)
                    return gat.sum(axis=1)
            else:
                combine = None

            def Ax(x):
                part = self._spmv_local(A_loc, dofs, x, free, combine)
                y = jax.lax.psum(part, "shard")
                return y * free + x * bmask

            # Jacobi diagonal (psum of local diag contributions)
            dloc = jnp.einsum("cii->ci", A_loc).reshape(-1)
            if use_ell:
                diag_part = combine(dloc)
            else:
                diag_part = jax.ops.segment_sum(
                    dloc, dofs.reshape(-1), self.n_dofs
                )
            diag = jax.lax.psum(diag_part, "shard") * free + bmask
            inv_diag = 1.0 / jnp.where(jnp.abs(diag) > 0, diag, 1.0)

            if self._aux is not None:
                aux = self._aux

                def prec(r):
                    # replicated aux-grid apply with the true Jacobi term
                    z = aux(r) - aux.omega * aux.dinv * r
                    return z + aux.omega * inv_diag * r
            else:
                def prec(r):
                    return inv_diag * r

            # move boundary data to the RHS via the *unmasked* column action
            # A[:, bdofs] @ g (fem/solvers.py DirichletSystem.rhs)
            gm = g * bmask
            col_action = jax.lax.psum(
                self._spmv_local(A_loc, dofs, gm, jnp.ones_like(free),
                                 combine),
                "shard",
            )
            b_mod = (b - col_action) * free + gm

            x0 = gm
            r0 = b_mod - Ax(x0)
            z0 = prec(r0)
            bnorm = jnp.linalg.norm(b_mod)
            tol = rtol * bnorm

            def cond(state):
                x, r, z, p, rz, k = state
                rn = jnp.linalg.norm(r)
                return (rn > tol) & (k < maxiter) & jnp.isfinite(rn)

            def body(state):
                x, r, z, p, rz, k = state
                Ap = Ax(p)
                alpha = rz / jnp.vdot(p, Ap)
                x = x + alpha * p
                r = r - alpha * Ap
                z = prec(r)
                rz_new = jnp.vdot(r, z)
                p = z + (rz_new / rz) * p
                return (x, r, z, p, rz_new, k + 1)

            x, r, *_, k = jax.lax.while_loop(
                cond, body, (x0, r0, z0, z0, jnp.vdot(r0, z0), 0)
            )
            return x, jnp.linalg.norm(r), k

        extra = (self._adj_d, self._adjmask_d) if use_ell else ()
        extra_specs = (P("shard"), P("shard")) if use_ell else ()
        return jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P("shard"), P("shard"), P(), P()) + extra_specs,
            out_specs=(P(), P(), P()),
        )(A_loc, self._dofs_d, b, g, *extra)

    def cg(self, A_loc, b, g, rtol=1e-6, maxiter=200):
        return self._cg_jit(A_loc, b, g, rtol=rtol, maxiter=maxiter)

    # -- fused step ----------------------------------------------------------
    def _solve(self, b, g, rtol=1e-6, maxiter=200):
        A_loc = self._assemble()
        return self._cg(A_loc, b, g, rtol, maxiter=maxiter)

    def solve(self, b, g, rtol=1e-6, maxiter=200, recovery=True):
        """Assemble + CG in one jit: the 'training step' of this framework.

        Failure recovery (SURVEY §5.3): a stalled/non-finite distributed CG
        gets one retry with a 3x iteration budget (the assembled operator's
        dtype is fixed at construction, so no precision recast here)."""
        bj = jnp.asarray(b, self.dtype)
        gj = jnp.asarray(g, self.dtype)
        x, res, k = self._solve_jit(bj, gj, rtol, maxiter=maxiter)
        if recovery:
            import math
            import warnings

            resf = float(res)
            # k == maxiter is the while_loop's "budget exhausted" exit; the
            # in-kernel tolerance references the boundary-reduced rhs, so
            # res alone cannot be compared against rtol*||b|| here
            if not math.isfinite(resf) or int(k) >= maxiter:
                warnings.warn(
                    "sharded solve stalled "
                    f"(||r|| = {resf:.2e}); escalating with a 3x "
                    "iteration budget",
                    stacklevel=2,
                )
                x, res, k = self._solve_jit(bj, gj, rtol, maxiter=3 * maxiter)
        return x, res, k
