#!/usr/bin/env python
"""MG-preconditioned CG, f32 vs bf16 stencil STORAGE (10M dofs).

Vector arithmetic stays f32 in both; the bf16 variant streams every stencil
layer (fine CG operator + all V-cycle levels) at half the bytes, converts
fusing into the consuming multiply. On the uniform grid the P1 entries are
exact binary fractions, so bf16 storage is lossless here.
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

from fdapde_core_tpu.ops.grid_dia import GridDIAMatrix, prune_zero_offsets_grid
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

    t0 = time.time()
    mg = GridMG.build(G, coarse_n=32)
    float(mg.datas[-1][0, 0, 0])
    t_build = time.time() - t0
    print(json.dumps({"stage": "mg_build", "s": round(t_build, 3),
                      "levels": mg.n_levels}))

    variants = {
        "f32": (G, mg),
        "bf16_storage": (
            GridDIAMatrix(data.astype(jnp.bfloat16), OFF5, (m, m)),
            mg.astype(jnp.bfloat16),
        ),
    }
    for name, (Gv, mgv) in variants.items():
        run = jax.jit(
            lambda Gm, mgm, bb: mg_preconditioned_cg(
                Gm, bb, rtol=1e-12, maxiter=40, mg=mgm
            )
        )
        x, rel, k = run(Gv, mgv, b)
        float(rel)  # compile + warmup
        t0 = time.time()
        x, rel, k = run(Gv, mgv, b)
        relv, kv = float(rel), int(k)
        dt = time.time() - t0
        print(json.dumps({"variant": name, "solve_s": round(dt, 3),
                          "iters": kv, "true_rel_res_f32": relv}))


if __name__ == "__main__":
    main()
