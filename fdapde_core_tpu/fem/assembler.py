"""Batched FEM assembly: quadrature contraction + segment-sum scatter.

The batched replacement of the reference's serial triple loop
(fdaPDE/finite_elements/fem_assembler.h:79-110, innermost quadrature loop
integrator.h:93-106). All cells are processed at once:

    local[c,i,j] = measure[c] * sum_q w[q] * weak_form(c, q, i, j)

as einsum contractions (XLA fuses these), followed by one `segment_sum` into the precomputed sorted-COO slots
(the `setFromTriplets` scatter-add of fem_assembler.h:112).

Weak forms implemented (signs match the reference operator headers):
- Laplacian:  -(invJ^T grad_i) . (invJ^T grad_j)      (operators/laplacian.h:37-44)
- Diffusion:  -(invJ^T grad_i) . K (invJ^T grad_j)    (operators/diffusion.h:32-55)
- Advection:   psi_i * b . (invJ^T grad_j)            (operators/advection.h:33-56)
- Reaction:    c * psi_i * psi_j                      (operators/reaction.h:31-53)
- dt: zero spatial contribution                       (operators/dt.h:28-37)

Matrix rows are test functions i, columns trial functions j
(fem_assembler.h:96-102).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..geometry.affine import affine_maps
from ..linear_algebra.sparse import SparseMatrix
from ..pde.operators import Advection, BiLaplacian, Diffusion, Dt, Laplacian, Reaction

# operators are built in full precision: an f32 contraction must not run
# in a reduced-precision matmul mode (e.g. TF32 on NVIDIA tensor cores)
_HIGHEST = jax.lax.Precision.HIGHEST

__all__ = ["assemble_matrix", "assemble_forcing", "local_matrices", "prepare_coefficient"]


def prepare_coefficient(space, value, kind: str):
    """Normalize an operator coefficient to either a constant or a per-(cell,
    quad-node) array.

    Accepted inputs (pde/operators.py docstring): scalars/constant arrays;
    callables f(x) evaluated at physical quadrature nodes; arrays indexed by
    global quadrature node `nq * cell + q` (the reference's discretized-field
    `forward` protocol, fields/scalar_expressions.h:98-108).

    Returns (is_varying, array) with array shapes:
      scalar: () or (C, nq); vector: (N,) or (C, nq, N); matrix: (N, N) or
      (C, nq, N, N).
    """
    C = space.mesh.n_cells
    nq = space.n_quad
    N = space.mesh.embed_dim
    if callable(value):
        from ..utils.callables import eval_at_points

        pts = space.quadrature_nodes  # (C*nq, N)
        vals = eval_at_points(value, pts)  # batch -> vmap -> loop tiers
        return True, jnp.asarray(vals.reshape((C, nq) + vals.shape[1:]))
    arr = np.asarray(value, dtype=np.float64)
    if kind == "scalar":
        if arr.ndim == 0:
            return False, jnp.asarray(arr)
        return True, jnp.asarray(arr.reshape(C, nq))
    if kind == "vector":
        if arr.ndim == 1:
            return False, jnp.asarray(arr)
        return True, jnp.asarray(arr.reshape(C, nq, N))
    if kind == "matrix":
        if arr.ndim == 2:
            return False, jnp.asarray(arr)
        return True, jnp.asarray(arr.reshape(C, nq, N, N))
    raise ValueError(kind)


def local_matrices(term_kind, coeff, varying, phi, grad, w, invJ, measure):
    """Local (C, nb, nb) matrices for one operator term. Pure JAX, jit-safe."""
    # physical gradients: pg[c,q,i,n] = sum_m invJ[c,m,n] * grad[q,i,m]
    if term_kind in ("laplacian", "diffusion", "advection"):
        pg = jnp.einsum("cmn,qim->cqin", invJ, grad, precision=_HIGHEST)
    if term_kind == "laplacian":
        out = -jnp.einsum("cqin,cqjn,q->cij", pg, pg, w, precision=_HIGHEST)
    elif term_kind == "diffusion":
        if varying:
            out = -jnp.einsum("cqin,cqnk,cqjk,q->cij", pg, coeff, pg, w,
                              precision=_HIGHEST)
        else:
            out = -jnp.einsum("cqin,nk,cqjk,q->cij", pg, coeff, pg, w,
                              precision=_HIGHEST)
    elif term_kind == "advection":
        if varying:
            out = jnp.einsum("qi,cqjn,cqn,q->cij", phi, pg, coeff, w,
                             precision=_HIGHEST)
        else:
            out = jnp.einsum("qi,cqjn,n,q->cij", phi, pg, coeff, w,
                             precision=_HIGHEST)
    elif term_kind == "reaction":
        if varying:
            out = jnp.einsum("cq,qi,qj,q->cij", coeff, phi, phi, w,
                             precision=_HIGHEST)
        else:
            out = coeff * jnp.einsum("qi,qj,q->ij", phi, phi, w,
                                     precision=_HIGHEST)[None, :, :]
            return out * measure[:, None, None]
    else:
        raise ValueError(term_kind)
    return out * measure[:, None, None]


_KIND = {
    Laplacian: ("laplacian", None),
    Diffusion: ("diffusion", "matrix"),
    Advection: ("advection", "vector"),
    Reaction: ("reaction", "scalar"),
}


def assemble_matrix(space, op, layout: str = "aos") -> SparseMatrix:
    """Discretize a DifferentialOp over a FEMSpace -> sparse n_dofs^2 matrix.

    Counterpart of Assembler::discretize_operator (fem_assembler.h:52-120).

    layout="soa" routes through the cell-axis-last path (ops/soa_assembly.py)
    — for meshes beyond ~1M cells, where (C, nq, nb, N) intermediates put
    tiny axes minor-most.
    """
    if layout == "soa":
        from ..ops.soa_assembly import assemble_soa_values

        rows, cols, _ = space.scatter
        vals = assemble_soa_values(space, op)
        return SparseMatrix(
            jnp.asarray(rows), jnp.asarray(cols), vals, (space.n_dofs, space.n_dofs)
        )
    terms = []
    for scale, leaf in op.spatial_terms:
        if isinstance(leaf, BiLaplacian):
            raise ValueError("bilaplacian requires the SPLINE discretization (splines/)")
        kind, ckind = _KIND[type(leaf)]
        if isinstance(leaf, Laplacian):
            varying, coeff = False, None
        else:
            cval = leaf.K if kind == "diffusion" else leaf.b if kind == "advection" else leaf.c
            varying, coeff = prepare_coefficient(space, cval, ckind)
        terms.append((scale, kind, varying, coeff))

    nodes = jnp.asarray(space.mesh.nodes)
    cells = jnp.asarray(space.mesh.cells)
    phi = jnp.asarray(space.phi_tab)
    grad = jnp.asarray(space.grad_tab)
    w = jnp.asarray(space.quad.weights)

    _, invJ, measure = affine_maps(nodes, cells)
    nb = space.n_basis_per_cell
    local = jnp.zeros((space.mesh.n_cells, nb, nb), dtype=nodes.dtype)
    for scale, kind, varying, coeff in terms:
        local = local + scale * local_matrices(
            kind, coeff, varying, phi, grad, w, invJ, measure
        )

    rows, cols, inv = space.scatter
    vals = jax.ops.segment_sum(
        local.reshape(-1), jnp.asarray(inv), rows.shape[0]
    )
    return SparseMatrix(
        jnp.asarray(rows), jnp.asarray(cols), vals, (space.n_dofs, space.n_dofs)
    )


def assemble_dia(space, op):
    """Discretize into DIA (offset-diagonal) storage.

    Fast path: SpMV becomes static shifts + fused multiply-adds
    (linear_algebra/dia.py). Efficient when the dof numbering yields a small
    offset set (structured or strongly banded meshes — check
    `len(unique_offsets(space.dofs))` first; RCM/SFC reordering shrinks it).
    """
    from ..linear_algebra.dia import dia_from_coo, unique_offsets

    A = assemble_matrix(space, op)
    offsets = unique_offsets(space.dofs)
    return dia_from_coo(A.rows, A.cols, A.vals, space.n_dofs, offsets)


def assemble_forcing(space, f) -> jnp.ndarray:
    """Discretize a forcing term: F[i] = int f * psi_i.

    Counterpart of Assembler::discretize_forcing (fem_assembler.h:122-136).
    `f` may be a callable, or an array of values at the physical quadrature
    nodes with rows `nq * cell + q` (one or more columns; parabolic problems
    pass one column per time instant, fem_solver_base.h:124-128).
    """
    C, nq = space.mesh.n_cells, space.n_quad
    if callable(f):
        from ..utils.callables import eval_at_points

        pts = space.quadrature_nodes
        fv = jnp.asarray(eval_at_points(f, pts).reshape(C, nq))
        multi = False
    else:
        fv = jnp.asarray(np.asarray(f, dtype=np.float64))
        multi = fv.ndim == 2 and fv.shape[1] > 1
        if fv.ndim == 1 or fv.shape[1] == 1:
            fv = fv.reshape(C, nq)
            multi = False
        else:
            fv = fv.reshape(C, nq, -1)

    nodes = jnp.asarray(space.mesh.nodes)
    cells = jnp.asarray(space.mesh.cells)
    phi = jnp.asarray(space.phi_tab)
    w = jnp.asarray(space.quad.weights)
    _, _, measure = affine_maps(nodes, cells)

    if multi:
        loc = jnp.einsum("cqt,qi,q->cit", fv, phi, w,
                         precision=_HIGHEST) * measure[:, None, None]
        flat = loc.reshape(C * space.n_basis_per_cell, -1)
    else:
        loc = jnp.einsum("cq,qi,q->ci", fv, phi, w,
                         precision=_HIGHEST) * measure[:, None]
        flat = loc.reshape(-1)
    seg = jnp.asarray(space.dofs.reshape(-1))
    return jax.ops.segment_sum(flat, seg, space.n_dofs)
