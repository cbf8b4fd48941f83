#!/usr/bin/env python
"""Multigrid-preconditioned CG at 10.2M dofs.

n = 3200 (m = 3201 nodes/side): coarsens 3200 -> 1600 -> ... -> 50.
Variants: f32 MG-CG (floored by eps32*kappa in TRUE residual), f64 MG-CG
(~10 iters), f64-outer refinement with f32 MG-CG inner.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
os.environ["FDAPDE_TPU_X64"] = "1"

import jax

from fdapde_core_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()

jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp

from fdapde_core_tpu.ops.grid_dia import GridDIAMatrix
from fdapde_core_tpu.ops.grid_mg import GridMG, mg_preconditioned_cg, _stencil

n = 3200
m = n + 1
OFF5 = ((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0))


def build_operator(dtype):
    @jax.jit
    def go():
        h2 = jnp.asarray(1.0 / (n * n), dtype)
        i = jnp.arange(m)
        interior = (i > 0) & (i < m - 1)
        free = (interior[:, None] & interior[None, :]).astype(dtype)
        fp = jnp.pad(free, 1)
        layers = []
        for (di, dj) in OFF5:
            shifted = jax.lax.dynamic_slice(fp, (1 + di, 1 + dj), (m, m))
            if (di, dj) == (0, 0):
                layers.append(4.0 * free + (1.0 - free))
            else:
                layers.append(-1.0 * free * shifted)
        data = jnp.stack(layers)
        b = free * h2
        return data, b, data[0, 0, 0]

    data, b, w = go()
    float(w)
    return GridDIAMatrix(data, OFF5, (m, m)), b


def main():
    for dtype, label in ((jnp.float32, "f32"), (jnp.float64, "f64")):
        G, b = build_operator(dtype)
        t0 = time.time()
        mg = GridMG.build(G, coarse_n=32)
        # force build (host fetch of a coarse scalar)
        float(mg.datas[-1][0, 0, 0])
        t_build = time.time() - t0

        run = jax.jit(
            lambda Gm, mgm, bb: mg_preconditioned_cg(
                Gm, bb, rtol=1e-12, maxiter=40, mg=mgm
            )
        )
        x, rel, k = run(G, mg, b)
        float(rel)
        t0 = time.time()
        x, rel, k = run(G, mg, b)
        relv = float(rel)
        dt = time.time() - t0
        print(json.dumps({
            "variant": f"mgcg_{label}", "levels": mg.n_levels,
            "build_s": round(t_build, 3), "solve_s": round(dt, 3),
            "iters": int(k), "true_rel_res": relv,
            "ms_per_iter": round(dt / max(int(k), 1) * 1e3, 2),
        }))

    # f64-outer refinement, f32 MG-CG inner (8 iters/cycle)
    G64, b64 = build_operator(jnp.float64)
    G32 = GridDIAMatrix(G64.data.astype(jnp.float32), OFF5, (m, m))
    mg32 = GridMG.build(G32, coarse_n=32)
    float(mg32.datas[-1][0, 0, 0])

    @jax.jit
    def refined(G64, G32, mg32, b):
        bn2 = jnp.sum(b * b)

        def cond(s):
            x, rn2, k = s
            return (rn2 > 1e-20 * bn2) & (k < 10)

        def body(s):
            x, _, k = s
            r = b - _stencil(G64.data, OFF5, x.reshape(m, m), m).reshape(-1)
            dx, _, _ = mg_preconditioned_cg(
                G32, r.astype(jnp.float32), rtol=1e-30, maxiter=8, mg=mg32
            )
            x = x + dx.astype(jnp.float64)
            r2 = b - _stencil(G64.data, OFF5, x.reshape(m, m), m).reshape(-1)
            return (x, jnp.sum(r2 * r2), k + 1)

        s = (jnp.zeros_like(b), bn2, 0)
        x, rn2, k = jax.lax.while_loop(cond, body, s)
        return x, jnp.sqrt(rn2 / bn2), k

    bflat = b64.reshape(-1)
    x, rel, k = refined(G64, G32, mg32, bflat)
    float(rel)
    t0 = time.time()
    x, rel, k = refined(G64, G32, mg32, bflat)
    relv = float(rel)
    dt = time.time() - t0
    print(json.dumps({"variant": "f64refined_f32mgcg8", "solve_s": round(dt, 3),
                      "outer_cycles": int(k), "true_rel_res": relv}))


if __name__ == "__main__":
    main()
