#!/usr/bin/env python
"""f64-refined f32 CG vs pure f64 CG: time to TRUE rel residual <= 1e-6.

At 10M dofs kappa ~ 4e6, so f32 CG's attainable true residual is O(eps32 *
kappa) ~ 0.2 relative — converging for real requires f64 somewhere. Pure
f64 CG pays f64 bandwidth every iteration; refinement pays it
once per outer cycle (1 f64 SpMV per ~hundreds of f32 inner iterations).
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

n = 3163
m = n + 1
OFF5 = ((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0))
RTOL = 1e-6


@jax.jit
def build_operator():
    h2 = jnp.float64(1.0 / (n * n))
    i = jnp.arange(m)
    interior = (i > 0) & (i < m - 1)
    free = (interior[:, None] & interior[None, :]).astype(jnp.float64)
    fp = jnp.pad(free, 1)
    layers = []
    for (di, dj) in OFF5:
        shifted = jax.lax.dynamic_slice(fp, (1 + di, 1 + dj), (m, m))
        if (di, dj) == (0, 0):
            layers.append(4.0 * free + (1.0 - free))
        else:
            layers.append(-1.0 * free * shifted)
    data = jnp.stack(layers)
    b = free * h2  # load vector of f = 1 (physical h^2 scaling)
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


def cg_fixed(data, b, invdiag, maxiter, vdt):
    data = data.astype(vdt)
    b_ = b.astype(vdt)
    invd = invdiag.astype(vdt)

    def fdot(a, c):
        return jnp.sum(a * c)

    z0 = invd * b_
    rz0 = fdot(b_, z0)

    def body(_, s):
        x, r, p_pad, rz = s
        Ap = stencil(data, p_pad, vdt)
        p_c = jax.lax.slice(p_pad, (1, 1), (1 + m, 1 + m))
        pAp = fdot(p_c, Ap)
        alpha = jnp.where(pAp > 0, rz / jnp.where(pAp == 0, 1.0, pAp), 0.0)
        x = x + alpha * p_c
        r = r - alpha * Ap
        z = invd * r
        rz_new = fdot(r, z)
        beta = jnp.where(rz > 0, rz_new / jnp.where(rz == 0, 1.0, rz), 0.0)
        p_pad = jnp.pad(z + beta * p_c, 1)
        return (x, r, p_pad, rz_new)

    s = (jnp.zeros_like(b_), b_, jnp.pad(z0, 1), rz0)
    x, r, *_ = jax.lax.fori_loop(0, maxiter, body, s)
    return x


def main():
    data, b, invdiag, w = build_operator()
    float(w)
    data32 = data.astype(jnp.float32)
    invd32 = invdiag.astype(jnp.float32)

    # pure f64 CG, fixed 500 iters: measure per-iteration cost
    @jax.jit
    def f64_500(data, b, invdiag):
        x = cg_fixed(data, b, invdiag, 500, jnp.float64)
        r = b - stencil(data, jnp.pad(x, 1), jnp.float64)
        return x, jnp.linalg.norm(r)

    x, rn = f64_500(data, b, invdiag)
    float(rn)
    t0 = time.time()
    x, rn = f64_500(data, b, invdiag)
    float(rn)
    t64 = time.time() - t0
    print(json.dumps({"variant": "f64_cg_500iters", "s": round(t64, 3),
                      "iters_per_s": round(500 / t64, 1)}))

    # f64-refined f32 inner: outer while on true f64 residual
    for inner in (500, 1000):
        @jax.jit
        def refined(data, data32, b, invd32, inner=inner):
            bn2 = jnp.sum(b * b)

            def cond(s):
                x, rn2, k = s
                return (rn2 > (RTOL * RTOL) * bn2) & (k < 30)

            def body(s):
                x, _, k = s
                r = b - stencil(data, jnp.pad(x, 1), jnp.float64)
                dx = cg_fixed(data32, r.astype(jnp.float32), invd32,
                              inner, jnp.float32)
                x = x + dx.astype(jnp.float64)
                r2 = b - stencil(data, jnp.pad(x, 1), jnp.float64)
                return (x, jnp.sum(r2 * r2), k + 1)

            s = (jnp.zeros_like(b), bn2, 0)
            x, rn2, k = jax.lax.while_loop(cond, body, s)
            return x, jnp.sqrt(rn2 / bn2), k

        xr, rel, k = refined(data, data32, b, invd32)
        float(rel)
        t0 = time.time()
        xr, rel, k = refined(data, data32, b, invd32)
        relv = float(rel)
        tr = time.time() - t0
        print(json.dumps({"variant": f"f64refined_f32_inner{inner}",
                          "s": round(tr, 3), "outer_cycles": int(k),
                          "true_rel_res": relv,
                          "inner_iters_total": int(k) * inner}))


if __name__ == "__main__":
    main()
