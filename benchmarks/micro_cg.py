#!/usr/bin/env python
"""CG iteration variants on the 10M-dof 2D grid stencil.

Variants:
  cg0_7 : current bench body (per-iter jnp.pad + dynamic_slice, 7 layers)
  cg0_5 : same, zero layers pruned (criss-cross P1 has exactly-zero
          hypotenuse coupling: +-(m-1) layers vanish)
  cg1_7 : padded-state restructure — p kept in a (m+2, m+2) frame, static
          slices, Dirichlet identity folded into the center layer
  cg1_5 : padded-state, pruned
  cg2_5 : padded-state, pruned, bf16 stencil data (f32 vectors/compute)

Timing soundness: the whole CG state is the fori_loop carry and the jit
returns (x, |r|): nothing is DCE-able.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
os.environ["FDAPDE_TPU_X64"] = "0"

import jax

from fdapde_core_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()
import jax.numpy as jnp

from fdapde_core_tpu.ops.grid_dia import GridDIAMatrix

N_ITERS = 500
n = 3163
m = n + 1
dtype = jnp.float32

OFF7 = ((-1, 0), (-1, 1), (0, -1), (0, 0), (0, 1), (1, -1), (1, 0))
OFF5 = ((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0))


@jax.jit
def build_operator():
    """Masked 5-point operator on the (m, m) grid, Dirichlet folded in.

    Matches bench.py's criss-cross P1 stiffness: center 4, axis neighbors
    -1, diagonal (+-(m-1)) exactly 0; pinned rows/cols zeroed + identity.
    """
    i = jnp.arange(m)
    interior = (i > 0) & (i < m - 1)
    free = (interior[:, None] & interior[None, :]).astype(dtype)
    fp = jnp.pad(free, 1)
    layers = {}
    for (di, dj) in OFF7:
        shifted = jax.lax.dynamic_slice(fp, (1 + di, 1 + dj), (m, m))
        if (di, dj) == (0, 0):
            layers[(di, dj)] = 4.0 * free + (1.0 - free)  # identity on pinned
        elif abs(di) + abs(dj) == 1:
            layers[(di, dj)] = -1.0 * free * shifted
        else:
            layers[(di, dj)] = jnp.zeros((m, m), dtype)
    data7 = jnp.stack([layers[o] for o in OFF7])
    b = free  # rhs = 1 on interior
    invdiag = 1.0 / data7[OFF7.index((0, 0))]
    return data7, free, b, invdiag, data7[0, 0, 0]


def cg0(data, offs, b, invdiag, n_iter):
    D = GridDIAMatrix(data, offs, (m, m))

    def body(k, state):
        x, r, z, p, rz = state
        Ap = D @ p
        alpha = rz / jnp.vdot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = invdiag.reshape(-1) * r
        rz_new = jnp.vdot(r, z)
        p = z + (rz_new / rz) * p
        return (x, r, z, p, rz_new)

    bf = b.reshape(-1)
    z0 = invdiag.reshape(-1) * bf
    x, r, *_ = jax.lax.fori_loop(
        0, n_iter, body, (jnp.zeros_like(bf), bf, z0, z0, jnp.vdot(bf, z0))
    )
    return x, jnp.linalg.norm(r)


def cg1(data, offs, b, invdiag, n_iter, data_dtype=None):
    """Padded-state CG: p lives in an (m+2, m+2) frame; static slices."""
    if data_dtype is not None:
        data = data.astype(data_dtype)

    def stencil(p_pad):
        acc = None
        for k, (di, dj) in enumerate(offs):
            term = data[k].astype(dtype) * jax.lax.slice(
                p_pad, (1 + di, 1 + dj), (1 + di + m, 1 + dj + m)
            )
            acc = term if acc is None else acc + term
        return acc

    def body(k, state):
        x, r, p_pad, rz = state
        Ap = stencil(p_pad)
        p_c = jax.lax.slice(p_pad, (1, 1), (1 + m, 1 + m))
        alpha = rz / jnp.sum(p_c * Ap)
        x = x + alpha * p_c
        r = r - alpha * Ap
        z = invdiag * r
        rz_new = jnp.sum(r * z)
        p_pad = jnp.pad(z + (rz_new / rz) * p_c, 1)
        return (x, r, p_pad, rz_new)

    z0 = invdiag * b
    state = (jnp.zeros_like(b), b, jnp.pad(z0, 1), jnp.sum(b * z0))
    x, r, *_ = jax.lax.fori_loop(0, n_iter, body, state)
    return x, jnp.linalg.norm(r)


def main():
    data7, free, b, invdiag, w = build_operator()
    float(w)
    i5 = [OFF7.index(o) for o in OFF5]
    data5 = data7[jnp.array(i5)]

    cases = [
        ("cg0_7", cg0, data7, OFF7, None),
        ("cg0_5", cg0, data5, OFF5, None),
        ("cg1_7", cg1, data7, OFF7, None),
        ("cg1_5", cg1, data5, OFF5, None),
        ("cg2_5", cg1, data5, OFF5, jnp.bfloat16),
    ]
    for name, fn, data, offs, ddt in cases:
        if ddt is None:
            jfn = jax.jit(lambda d, bb, iv, fn=fn, offs=offs: fn(
                d, offs, bb, iv, N_ITERS))
        else:
            jfn = jax.jit(lambda d, bb, iv, fn=fn, offs=offs, ddt=ddt: fn(
                d, offs, bb, iv, N_ITERS, ddt))
        x, res = jfn(data, b, invdiag)
        float(res)
        t0 = time.time()
        x, res = jfn(data, b, invdiag)
        resv = float(res)
        dt = (time.time() - t0) / N_ITERS
        print(json.dumps({"variant": name, "ms_per_iter": round(dt * 1e3, 4),
                          "iters_per_s": round(1 / dt, 1),
                          "final_residual": resv}))


if __name__ == "__main__":
    main()
