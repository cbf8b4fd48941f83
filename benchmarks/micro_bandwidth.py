#!/usr/bin/env python
"""Calibrate achievable device-memory bandwidth + assembly variants.

b0: y = 2x on (6, L, 128)   -> pure stream: 48 B/elem-col, calibrates BW
b1: y(6) = f(x(6)) closed-form stiffness, XLA, fused divide
b2: same but multiply by precomputed reciprocal-free form (no divide)
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

REPS = 20
N_CELLS = 20_000_000


def timeit(call, x, dtype=jnp.float32):
    @jax.jit
    def run(coords):
        def body(k, acc):
            out = call(coords + k.astype(dtype) * 1e-30)
            return acc + out.reshape(-1)[0]

        return jax.lax.fori_loop(0, REPS, body, jnp.float32(0.0))

    float(run(x))
    t0 = time.time()
    float(run(x))
    return (time.time() - t0) / REPS


def stiffness_rows(c, sym=True):
    x1, y1, x2, y2, x3, y3 = c[0], c[1], c[2], c[3], c[4], c[5]
    b1, b2, b3 = y2 - y3, y3 - y1, y1 - y2
    c1, c2, c3 = x3 - x2, x1 - x3, x2 - x1
    det = (x2 - x1) * (y3 - y1) - (x3 - x1) * (y2 - y1)
    inv = 1.0 / (2.0 * jnp.abs(det))
    return [
        (b1 * b1 + c1 * c1) * inv, (b1 * b2 + c1 * c2) * inv,
        (b1 * b3 + c1 * c3) * inv, (b2 * b2 + c2 * c2) * inv,
        (b2 * b3 + c2 * c3) * inv, (b3 * b3 + c3 * c3) * inv,
    ]


def main():
    dtype = jnp.float32
    L = ((N_CELLS + 127) // 128) // 512 * 512  # lane-major cols, mult of 512
    C = L * 128
    key = jax.random.PRNGKey(0)

    @jax.jit
    def mk():
        c = jax.random.uniform(key, (6, L, 128), dtype)
        return c, c[0, 0, 0]

    x, w = mk()
    float(w)

    # b0: pure stream 6 rows -> 6 rows
    dt = timeit(lambda c: c * 2.0, x)
    bw = (2 * 6 * 4 * C) / dt / 1e9
    print(json.dumps({"variant": "b0_stream6to6", "ms": round(dt * 1e3, 3),
                      "GBps": round(bw, 1)}))

    # b0b: reduce read-only (read 6 rows, write tiny)
    dt = timeit(lambda c: jnp.sum(c, axis=(0,), keepdims=True), x)
    bw = (7 * 4 * C) / dt / 1e9
    print(json.dumps({"variant": "b0b_read6_write1", "ms": round(dt * 1e3, 3),
                      "GBps": round(bw, 1)}))

    # b1: XLA closed form with divide
    dt = timeit(lambda c: jnp.stack(stiffness_rows(c)), x)
    print(json.dumps({"variant": "b1_xla6_div", "ms": round(dt * 1e3, 3),
                      "G_elem_per_s": round(C / dt / 1e9, 3),
                      "eff_GBps": round(12 * 4 * C / dt / 1e9, 1)}))

    # b2: XLA closed form, no divide (scaled by 2|det| instead -- traffic-
    # equal surrogate to isolate the divide cost)
    def no_div(c):
        x1, y1, x2, y2, x3, y3 = c[0], c[1], c[2], c[3], c[4], c[5]
        b1, b2, b3 = y2 - y3, y3 - y1, y1 - y2
        c1, c2, c3 = x3 - x2, x1 - x3, x2 - x1
        det = (x2 - x1) * (y3 - y1) - (x3 - x1) * (y2 - y1)
        inv = 2.0 * jnp.abs(det)
        return jnp.stack([
            (b1 * b1 + c1 * c1) * inv, (b1 * b2 + c1 * c2) * inv,
            (b1 * b3 + c1 * c3) * inv, (b2 * b2 + c2 * c2) * inv,
            (b2 * b3 + c2 * c3) * inv, (b3 * b3 + c3 * c3) * inv,
        ])

    dt = timeit(no_div, x)
    print(json.dumps({"variant": "b2_xla6_nodiv", "ms": round(dt * 1e3, 3),
                      "G_elem_per_s": round(C / dt / 1e9, 3)}))



if __name__ == "__main__":
    main()
