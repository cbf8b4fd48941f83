#!/usr/bin/env python
"""Where does the MG-CG iteration time go? (10M dofs)

Suspect: the deep-hierarchy tail — tiny levels + a 64-step sequential
coarse CG are latency-bound, not bandwidth-bound. Sweep (coarse_n, coarse_iters, nu) at fixed convergence
target and report s/iter + iters.
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
from fdapde_core_tpu.ops.grid_mg import GridMG, mg_preconditioned_cg

n = 3200
m = n + 1
OFF5 = ((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0))


@jax.jit
def build_operator():
    i = jnp.arange(m)
    interior = (i > 0) & (i < m - 1)
    free = (interior[:, None] & interior[None, :]).astype(jnp.float32)
    fp = jnp.pad(free, 1)
    layers = []
    for (di, dj) in OFF5:
        shifted = jax.lax.dynamic_slice(fp, (1 + di, 1 + dj), (m, m))
        if (di, dj) == (0, 0):
            layers.append(4.0 * free + (1.0 - free))
        else:
            layers.append(-1.0 * free * shifted)
    data = jnp.stack(layers)
    return data, free, data[0, 0, 0]


def main():
    data, b, w = build_operator()
    float(w)
    G = GridDIAMatrix(data, OFF5, (m, m))

    configs = [
        dict(coarse_n=32, coarse_iters=64, nu=2),   # current default
        dict(coarse_n=32, coarse_iters=24, nu=2),
        dict(coarse_n=100, coarse_iters=64, nu=2),
        dict(coarse_n=100, coarse_iters=128, nu=2),
        dict(coarse_n=200, coarse_iters=200, nu=2),
        dict(coarse_n=100, coarse_iters=64, nu=1),
    ]
    for cfg in configs:
        t0 = time.time()
        mg = GridMG.build(G, omega=0.8, **cfg)
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
        relv, kv = float(rel), int(k)
        dt = time.time() - t0
        print(json.dumps({**cfg, "levels": mg.n_levels,
                          "build_s": round(t_build, 2),
                          "solve_s": round(dt, 3), "iters": kv,
                          "s_per_iter": round(dt / max(kv, 1), 4),
                          "true_rel_res_f32": relv}), flush=True)


if __name__ == "__main__":
    main()
