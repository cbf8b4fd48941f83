#!/usr/bin/env python
"""Micro-benchmark: SpMV formulations for SCATTERED-banded topologies.

Meshes whose RCM histogram is spread across the band are rejected by
plan_split_width and fall back to raw ELL gathers. This probes, on the
accelerator, every plausible route to a faster gather:

  A. ell_flat    one (K, n) gather + weighted sum (current ELLSoA path,
                 single fused program)
  B. ell_slots   K separate 1-D gathers (the exact ELLSoA.__matmul__)
  C. windowed    static row blocks (R rows), window = x[i*R - B : .. + B]
                 stacked (nb, Wwin) + ONE batched take_along_axis —
                 XLA sees gathers bounded inside a 350 KB window
  D. sorted      rate probe: globally sorted indices (locality best-case,
                 not a valid SpMV)
  E. random      rate probe: uniform random indices (locality worst-case)

Synthetic scattered-banded matrix at n = 3201^2 = 10.25M, K = 9:
cols[k, i] = clip(i + delta, 0, n-1), delta = hash(k, i) in [-B, B],
B = 12288 — a maximally scattered histogram (every offset populated),
exactly the class plan_split_width rejects.

Usage: python benchmarks/micro_scatter_spmv.py [--small]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

from fdapde_core_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()
import jax.numpy as jnp

SMALL = "--small" in sys.argv
N_SIDE = 256 if SMALL else 3201
N = N_SIDE * N_SIDE
K = 9
B = 2048 if SMALL else 12288
R_BLK = 16384 if SMALL else 65536
REPS = 8


def fence():
    f = jax.jit(lambda v: v + 1.0)
    float(f(jnp.float32(1.0)))
    t0 = time.time()
    for _ in range(3):
        float(f(jnp.float32(1.0)))
    return (time.time() - t0) / 3


@jax.jit
def build(seed):
    i = jnp.arange(N, dtype=jnp.int32)
    ks = jnp.arange(K, dtype=jnp.int32)[:, None]
    h = jnp.sin(i[None, :] * 12.9898 + ks * 78.233 + seed) * 43758.5453
    u = h - jnp.floor(h)  # U(0,1) hash
    delta = ((u * (2 * B + 1)).astype(jnp.int32) - B)
    cols = jnp.clip(i[None, :] + delta, 0, N - 1)
    h2 = jnp.sin(i[None, :] * 39.425 + ks * 11.135 + seed) * 27183.1415
    vals = (h2 - jnp.floor(h2)).astype(jnp.float32) + 0.1
    x = (jnp.sin(i * 0.001) * 0.5 + 0.5).astype(jnp.float32)
    return cols, vals, x, cols[0, 0] + jnp.sum(x).astype(jnp.int32)


def timed(fn, *args):
    """REPS sequential executions inside one jit; returns s/rep."""

    @jax.jit
    def run(eps, *a):
        def body(k, carry):
            acc, _ = carry
            y = fn(eps * k.astype(jnp.float32), *a)
            return (acc + jnp.sum(y), y[0])
        acc, w = jax.lax.fori_loop(0, REPS, body,
                                   (jnp.float32(0.0), jnp.float32(0.0)))
        return acc + w

    float(run(jnp.float32(1e-30), *args))  # compile + warm
    t0 = time.time()
    float(run(jnp.float32(1e-30), *args))
    return (time.time() - t0) / REPS


def main():
    fence_s = fence()
    print(f"fence_s={fence_s:.4f}", flush=True)
    cols, vals, x, w = build(jnp.float32(0.0))
    int(w)
    print(f"n={N} K={K} B={B} built", flush=True)
    results = {}

    # A: one (K, n) gather
    def ell_flat(eps, cols, vals, x):
        xe = x + eps
        return jnp.sum(vals * xe[cols], axis=0)

    results["A_ell_flat"] = timed(ell_flat, cols, vals, x)

    # B: K slot gathers (ELLSoA.__matmul__ form)
    def ell_slots(eps, cols, vals, x):
        xe = x + eps
        acc = None
        for k in range(K):
            t = vals[k] * xe[cols[k]]
            acc = t if acc is None else acc + t
        return acc

    results["B_ell_slots"] = timed(ell_slots, cols, vals, x)

    # C: windowed batched gather
    NB = -(-N // R_BLK)
    WWIN = R_BLK + 2 * B
    PADL = B
    NPAD = NB * R_BLK + 2 * B

    @jax.jit
    def localize(cols, vals):
        # (NB, K, R) block layouts: pad n up to NB*R first
        padn = NB * R_BLK - N
        colsp = jnp.pad(cols, ((0, 0), (0, padn)))
        valsp = jnp.pad(vals, ((0, 0), (0, padn)))
        colsb = colsp.reshape(K, NB, R_BLK).transpose(1, 0, 2)
        valsb = valsp.reshape(K, NB, R_BLK).transpose(1, 0, 2)
        base = (jnp.arange(NB, dtype=jnp.int32) * R_BLK - PADL)
        loc = colsb - base[:, None, None]  # in [0, WWIN) for REAL rows;
        # rows padded beyond n carry col 0 (val 0) -> clamp into range
        loc = jnp.clip(loc, 0, WWIN - 1)
        return loc.reshape(NB, K * R_BLK), valsb, loc[0, 0, 0]

    idxl, valsb, wl = localize(cols, vals)
    int(wl)

    def windowed(eps, idxl, valsb, x):
        xp = jnp.pad(x + eps, (PADL, NPAD - N - PADL))
        wins = jnp.stack([
            jax.lax.slice(xp, (i * R_BLK,), (i * R_BLK + WWIN,))
            for i in range(NB)
        ])
        g = jnp.take_along_axis(wins, idxl, axis=1)  # (NB, K*R)
        y = jnp.sum(valsb * g.reshape(NB, K, R_BLK), axis=1)
        return y.reshape(-1)[:N]

    # parity: windowed == ell_flat (one fetch of the max abs diff)
    perr = float(jax.jit(
        lambda idxl, valsb, cols, vals, x: jnp.max(jnp.abs(
            windowed(jnp.float32(0.0), idxl, valsb, x)
            - ell_flat(jnp.float32(0.0), cols, vals, x)))
    )(idxl, valsb, cols, vals, x))
    print(f"C_windowed parity max|diff| = {perr:.3e}", flush=True)
    results["C_windowed"] = timed(windowed, idxl, valsb, x)

    # D/E: locality probes (not valid SpMVs)
    @jax.jit
    def presort(cols):
        cs = jnp.sort(cols.reshape(-1)).reshape(K, N)
        return cs, cs[0, 0]

    cs, ws = presort(cols)
    int(ws)

    def sorted_gather(eps, cs, vals, x):
        xe = x + eps
        return jnp.sum(vals * xe[cs], axis=0)

    results["D_sorted"] = timed(sorted_gather, cs, vals, x)

    @jax.jit
    def randidx(cols):
        i = jnp.arange(N, dtype=jnp.int32)
        ks = jnp.arange(K, dtype=jnp.int32)[:, None]
        h = jnp.sin(i[None, :] * 7.13 + ks * 3.7) * 15731.743
        u = h - jnp.floor(h)
        cr = (u * N).astype(jnp.int32) % N
        return cr, cr[0, 0]

    cr, wr = randidx(cols)
    int(wr)
    results["E_random"] = timed(sorted_gather, cr, vals, x)

    for name, t in results.items():
        gel = K * N / t / 1e9
        print(f"{name}: {t*1e3:8.2f} ms/SpMV  {gel:7.2f} G gathered elem/s",
              flush=True)



if __name__ == "__main__":
    main()
