#!/usr/bin/env python
"""Mixed-precision CG: time-to-residual vs pure f32 (10M dofs).

f32 CG runs until rz-based rtol; the mixed scheme runs bf16-vector inner CG
cycles (f32 dot accumulation) inside an f32 refinement loop. Compared on
WALL TIME TO THE SAME TRUE RESIDUAL, not iterations (bf16 iterations are
not equivalent currency).
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

n = 3163
m = n + 1
dtype = jnp.float32
OFF5 = ((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0))
RTOL = 1e-5


@jax.jit
def build_operator():
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
    b = free
    invdiag = 1.0 / layers[OFF5.index((0, 0))]
    return data, b, invdiag, data[0, 0, 0]


def stencil(data, x_pad, vdt):
    acc = None
    for k, (di, dj) in enumerate(OFF5):
        t = data[k].astype(vdt) * jax.lax.slice(
            x_pad, (1 + di, 1 + dj), (1 + di + m, 1 + dj + m)
        )
        acc = t if acc is None else acc + t
    return acc


def cg_rtol(data, b, invdiag, rtol, maxiter, vdt=jnp.float32):
    """rz-stopped CG in vector dtype vdt; dots accumulated in f32."""
    data = data.astype(vdt)
    b_ = b.astype(vdt)
    invd = invdiag.astype(vdt)

    def fdot(a, c):
        return jnp.sum(a.astype(jnp.float32) * c.astype(jnp.float32))

    z0 = invd * b_
    rz0 = fdot(b_, z0)
    tol2 = (rtol * rtol) * rz0

    def cond(s):
        x, r, p_pad, rz, k = s
        return (rz > tol2) & (k < maxiter) & jnp.isfinite(rz)

    def body(s):
        x, r, p_pad, rz, k = s
        Ap = stencil(data, p_pad, vdt)
        p_c = jax.lax.slice(p_pad, (1, 1), (1 + m, 1 + m))
        pAp = fdot(p_c, Ap)
        alpha = (jnp.where(pAp > 0, rz / jnp.where(pAp == 0, 1.0, pAp), 0.0)).astype(vdt)
        x = x + alpha * p_c
        r = r - alpha * Ap
        z = invd * r
        rz_new = fdot(r, z)
        beta = (jnp.where(rz > 0, rz_new / jnp.where(rz == 0, 1.0, rz), 0.0)).astype(vdt)
        p_pad = jnp.pad(z + beta * p_c, 1)
        return (x, r, p_pad, rz_new, k + 1)

    s = (jnp.zeros_like(b_), b_, jnp.pad(z0, 1), rz0, 0)
    x, r, _, rz, k = jax.lax.while_loop(cond, body, s)
    return x, k


def main():
    data, b, invdiag, w = build_operator()
    float(w)

    # ---- pure f32 to rtol ----
    @jax.jit
    def run_f32(data, b, invdiag):
        x, k = cg_rtol(data, b, invdiag, RTOL, 20000)
        r = b - stencil(data, jnp.pad(x, 1), jnp.float32)
        return x, k, jnp.linalg.norm(r), jnp.linalg.norm(b)

    x, k, rn, bn = run_f32(data, b, invdiag)
    float(rn)
    t0 = time.time()
    x, k, rn, bn = run_f32(data, b, invdiag)
    rnv = float(rn)
    t_f32 = time.time() - t0
    print(json.dumps({"variant": "f32_to_rtol", "s": round(t_f32, 3),
                      "iters": int(k), "true_rel_res": rnv / float(bn)}))

    # ---- mixed: bf16 inner cycles + f32 refinement ----
    for inner in (50, 100, 200):
        @jax.jit
        def run_mixed(data, b, invdiag, inner=inner):
            data16 = data.astype(jnp.bfloat16)

            def outer_cond(s):
                x, k_tot, rn2 = s
                return (rn2 > (RTOL * RTOL) * jnp.sum(b * b)) & (k_tot < 20000)

            def outer_body(s):
                x, k_tot, _ = s
                r = b - stencil(data, jnp.pad(x, 1), jnp.float32)
                dx, kin = cg_rtol(data16, r, invdiag, 1e-8, inner,
                                  vdt=jnp.bfloat16)
                x = x + dx.astype(jnp.float32)
                r2 = b - stencil(data, jnp.pad(x, 1), jnp.float32)
                return (x, k_tot + kin, jnp.sum(r2 * r2))

            s = (jnp.zeros_like(b), 0, jnp.sum(b * b))
            x, k_tot, rn2 = jax.lax.while_loop(outer_cond, outer_body, s)
            return x, k_tot, jnp.sqrt(rn2), jnp.linalg.norm(b)

        x2, k2, rn2, bn2 = run_mixed(data, b, invdiag)
        float(rn2)
        t0 = time.time()
        x2, k2, rn2, bn2 = run_mixed(data, b, invdiag)
        rv = float(rn2)
        t_mix = time.time() - t0
        print(json.dumps({"variant": f"mixed_bf16_inner{inner}",
                          "s": round(t_mix, 3), "inner_iters": int(k2),
                          "true_rel_res": rv / float(bn2),
                          "speedup_vs_f32": round(t_f32 / t_mix, 3)}))


if __name__ == "__main__":
    main()
