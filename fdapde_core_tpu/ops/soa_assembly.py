"""Struct-of-arrays (cell-axis-last) assembly path.

A (C, nq, nb, N) intermediate puts tiny axes minor-most, which device
layouts may pad many-fold at 10M cells. Keeping the cell axis LAST leaves
every array one long contiguous axis.
This module mirrors fem/assembler.local_matrices with every array shaped
(..., C), unrolling the tiny nq/nb/N axes into scalar-weighted fused
elementwise ops on (C,) vectors.

Used by the large-scale path (assemble_matrix(..., layout="soa")) and the
benchmark; results are bit-identical module reassociation to the AoS path.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["affine_maps_soa", "local_matrices_soa", "assemble_soa_values"]


def gather_coords_soa(nodes, cells_t):
    """coords[v][d]: (C,) arrays of vertex coordinates; cells_t (k, C)."""
    k = cells_t.shape[0]
    N = nodes.shape[1]
    return [[nodes[:, d][cells_t[v]] for d in range(N)] for v in range(k)]


def affine_maps_soa(nodes, cells_t):
    """C-last affine maps: (J, invJ, measure) with J[n][m] a (C,) array.

    Mirrors geometry/affine.py (simplex.h:184-195) for M == N in {1,2,3} and
    the manifold cases (2,3) and (1,2)/(1,3) via the Gram pseudo-inverse.
    invJ is indexed [m][n] (the (M, N) inverse / pseudo-inverse).
    """
    coords = gather_coords_soa(nodes, cells_t)
    k = len(coords)  # M + 1 vertices
    N = len(coords[0])
    M = k - 1
    J = [[coords[m + 1][n] - coords[0][n] for m in range(M)] for n in range(N)]
    if M != N:
        # Gram pseudo-inverse: invJ = (J^T J)^{-1} J^T  (simplex.h:190)
        G = [
            [
                sum(J[n][m1] * J[n][m2] for n in range(N))
                for m2 in range(M)
            ]
            for m1 in range(M)
        ]
        if M == 1:
            detG = G[0][0]
            invG = [[1.0 / detG]]
            measure = jnp.sqrt(detG)  # segment length (simplex.h:192)
        elif M == 2:
            detG = G[0][0] * G[1][1] - G[0][1] * G[1][0]
            invG = [
                [G[1][1] / detG, -G[0][1] / detG],
                [-G[1][0] / detG, G[0][0] / detG],
            ]
            # area = 0.5 ||J0 x J1|| = 0.5 sqrt(det G)  (simplex.h:191)
            measure = 0.5 * jnp.sqrt(detG)
        else:
            raise NotImplementedError((M, N))
        inv = [
            [sum(invG[m][m2] * J[n][m2] for m2 in range(M)) for n in range(N)]
            for m in range(M)
        ]
        return J, inv, measure
    if M == 1:
        det = J[0][0]
        inv = [[1.0 / det]]
    elif M == 2:
        det = J[0][0] * J[1][1] - J[0][1] * J[1][0]
        inv = [
            [J[1][1] / det, -J[0][1] / det],
            [-J[1][0] / det, J[0][0] / det],
        ]
    elif M == 3:
        c00 = J[1][1] * J[2][2] - J[1][2] * J[2][1]
        c01 = J[1][2] * J[2][0] - J[1][0] * J[2][2]
        c02 = J[1][0] * J[2][1] - J[1][1] * J[2][0]
        det = J[0][0] * c00 + J[0][1] * c01 + J[0][2] * c02
        c10 = J[0][2] * J[2][1] - J[0][1] * J[2][2]
        c11 = J[0][0] * J[2][2] - J[0][2] * J[2][0]
        c12 = J[0][1] * J[2][0] - J[0][0] * J[2][1]
        c20 = J[0][1] * J[1][2] - J[0][2] * J[1][1]
        c21 = J[0][2] * J[1][0] - J[0][0] * J[1][2]
        c22 = J[0][0] * J[1][1] - J[0][1] * J[1][0]
        inv = [
            [c00 / det, c10 / det, c20 / det],
            [c01 / det, c11 / det, c21 / det],
            [c02 / det, c12 / det, c22 / det],
        ]
    else:
        raise NotImplementedError(M)
    measure = jnp.abs(det) / math.factorial(M)
    return J, inv, measure


def local_matrices_soa(kind, coeff, nodes, cells_t, phi_tab, grad_tab, w, coeff_q=None):
    """(nb, nb) grid of (C,) local-matrix entries for one operator term.

    kind/coeff as in fem/assembler.local_matrices. Space-varying
    coefficients come through `coeff_q` (then `coeff` is ignored):
    reaction: coeff_q[q] -> (C,); advection: coeff_q[q][n] -> (C,);
    diffusion: coeff_q[q][n1][n2] -> (C,).
    phi_tab (nq, nb), grad_tab (nq, nb, M), w (nq,): host constants.
    """
    phi_tab = np.asarray(phi_tab)
    grad_tab = np.asarray(grad_tab)
    w = np.asarray(w)
    nq, nb = phi_tab.shape
    M = grad_tab.shape[2]
    J, inv, measure = affine_maps_soa(nodes, cells_t)
    N = len(inv[0])

    if kind == "reaction":
        if coeff_q is not None:
            out = [[None] * nb for _ in range(nb)]
            for i in range(nb):
                for j in range(nb):
                    acc = None
                    for q in range(nq):
                        s = float(phi_tab[q, i] * phi_tab[q, j] * w[q])
                        if s == 0.0:
                            continue
                        term = coeff_q[q] * s
                        acc = term if acc is None else acc + term
                    out[i][j] = acc * measure
            return out
        c = 1.0 if coeff is None else float(coeff)
        gram = phi_tab.T @ (w[:, None] * phi_tab)  # (nb, nb) scalars
        return [
            [c * gram[i, j] * measure for j in range(nb)] for i in range(nb)
        ]

    # physical gradients pg[q][i][n] = sum_m inv[m][n] * grad_tab[q, i, m]
    def pg(q, i, n):
        acc = None
        for m in range(M):
            gqim = float(grad_tab[q, i, m])
            if gqim == 0.0:
                continue
            term = inv[m][n] * gqim
            acc = term if acc is None else acc + term
        return acc if acc is not None else 0.0

    out = [[None for _ in range(nb)] for _ in range(nb)]
    if kind in ("laplacian", "diffusion"):
        K = (
            None
            if (kind == "laplacian" or coeff_q is not None)
            else np.asarray(coeff, dtype=np.float64)
        )
        for i in range(nb):
            for j in range(nb):
                acc = None
                for q in range(nq):
                    for n1 in range(N):
                        a = pg(q, i, n1)
                        if kind == "laplacian":
                            b = pg(q, j, n1)
                            term = a * b * float(w[q])
                        else:
                            term = None
                            for n2 in range(N):
                                kval = (
                                    coeff_q[q][n1][n2]
                                    if coeff_q is not None
                                    else float(K[n1, n2])
                                )
                                if coeff_q is None and kval == 0.0:
                                    continue
                                t2 = pg(q, j, n2) * kval
                                term = t2 if term is None else term + t2
                            if term is None:
                                continue
                            term = a * term * float(w[q])
                        acc = term if acc is None else acc + term
                out[i][j] = -(acc) * measure  # leading minus (laplacian.h:37-44)
        return out
    if kind == "advection":
        b = None if coeff_q is not None else np.asarray(coeff, dtype=np.float64)
        for i in range(nb):
            for j in range(nb):
                acc = None
                for q in range(nq):
                    scal = float(phi_tab[q, i] * w[q])
                    if scal == 0.0:
                        continue
                    term = None
                    for n1 in range(N):
                        bval = coeff_q[q][n1] if coeff_q is not None else float(b[n1])
                        if coeff_q is None and bval == 0.0:
                            continue
                        t2 = pg(q, j, n1) * bval
                        term = t2 if term is None else term + t2
                    if term is None:
                        continue
                    term = term * scal
                    acc = term if acc is None else acc + term
                out[i][j] = acc * measure
        return out
    raise ValueError(kind)


def assemble_soa_values(space, op, nodes=None, cells_t=None):
    """Sparse values of the operator via the SoA path (same slot order as
    space.scatter). Returns (nnz,) values for SparseMatrix(space.scatter...)."""
    from ..pde.operators import Advection, Diffusion, Laplacian, Reaction

    if nodes is None:
        nodes = jnp.asarray(space.mesh.nodes)
    if cells_t is None:
        cells_t = jnp.asarray(space.mesh.cells.T)
    nb = space.n_basis_per_cell
    C = space.mesh.n_cells
    grid = None
    for scale, leaf in op.spatial_terms:
        if isinstance(leaf, Laplacian):
            kind, coeff, ckind = "laplacian", None, None
        elif isinstance(leaf, Diffusion):
            kind, coeff, ckind = "diffusion", leaf.K, "matrix"
        elif isinstance(leaf, Advection):
            kind, coeff, ckind = "advection", leaf.b, "vector"
        elif isinstance(leaf, Reaction):
            kind, coeff, ckind = "reaction", leaf.c, "scalar"
        else:
            raise ValueError(leaf)
        # space-varying coefficients: evaluate to (C, nq, ...) then restructure
        # into per-quadrature-node lists of (C,) arrays (cell axis last)
        coeff_q = None
        if coeff is not None and ckind is not None:
            from ..fem.assembler import prepare_coefficient

            varying, cval = prepare_coefficient(space, coeff, ckind)
            if varying:
                nq = space.n_quad
                if ckind == "scalar":
                    coeff_q = [cval[:, q] for q in range(nq)]
                elif ckind == "vector":
                    coeff_q = [
                        [cval[:, q, n] for n in range(cval.shape[2])]
                        for q in range(nq)
                    ]
                else:
                    coeff_q = [
                        [
                            [cval[:, q, n1, n2] for n2 in range(cval.shape[3])]
                            for n1 in range(cval.shape[2])
                        ]
                        for q in range(nq)
                    ]
                coeff = None
        term = local_matrices_soa(
            kind, coeff, nodes, cells_t, space.phi_tab, space.grad_tab,
            space.quad.weights, coeff_q=coeff_q,
        )
        if grid is None:
            grid = [[scale * term[i][j] for j in range(nb)] for i in range(nb)]
        else:
            grid = [
                [grid[i][j] + scale * term[i][j] for j in range(nb)]
                for i in range(nb)
            ]
    # flatten in (cell-major, i, j) order to match space.scatter's inverse map:
    # entry index = c * nb*nb + i * nb + j; we have (i, j) -> (C,)
    rows, cols, inv = space.scatter
    # per-entry slot for (i, j, c): reshape host inverse map
    inv_ijc = np.asarray(inv).reshape(C, nb, nb).transpose(1, 2, 0)  # (nb, nb, C)
    vals = jnp.zeros(rows.shape[0], dtype=nodes.dtype)
    for i in range(nb):
        for j in range(nb):
            vals = vals + jax.ops.segment_sum(
                grid[i][j], jnp.asarray(inv_ijc[i, j]), rows.shape[0]
            )
    return vals
