#!/usr/bin/env python
"""End-to-end check of the main solve paths on an NVIDIA GPU.

    python chip_smoke.py                 # phases A-C on one GPU
    python chip_smoke.py --four-cards    # phase D only, on four GPUs

A. Public API: `PDE(unit_square_mesh(1024), -laplacian())`, f64, the
   preconditioner PDE.solve picks at this size, harmonic u = x + y.
B. Structured flagship: `StructuredPoisson(n=3200)` (f32 stencil assembled
   from node coordinates, multigrid CG with f64 vectors); operator parity
   against the COO assembler at n = 1024.
C. General mesh with a block-scrambled numbering that the banded split
   rejects: `MatrixFreeElliptic(format="ell")` with the aux-grid
   preconditioner, f64; ELL SpMV parity against the matrix-free apply and
   its achieved bandwidth next to a copy measured in the same run.
D. Distributed paths (`__graft_entry__.dryrun_multichip`) at >= 1M dofs on
   four devices, each compared with the same solve on one device.

Each phase prints one JSON line (wall times split into compile and run,
iterations, true relative residuals, parity with its precision, peak device
memory). The run fails, without the final `ok` line, if JAX finds no GPU or
any phase raises or misses a threshold. The last line is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}`.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

# thresholds (phase: metric -> bound)
A_MAX_REL_RES = 1e-10
A_MAX_L2_ERR = 1e-6
B_MAX_REL_RES = 1e-8
B_MAX_PARITY_F64 = 1e-12
C_MAX_REL_RES = 1e-8
C_MAX_PARITY_F64 = 1e-12
D_RTOL = 1e-10
D_MAX_DIFF = 1e-7  # max|x_4 - x_1| <= D_MAX_DIFF * max|x_1|
D_PATHS = (
    "sharded psum CG", "sharded ELL CG", "halo DIA CG", "grid-halo CG",
    "sharded grid MG", "parabolic halo scan", "halo ELL CG",
    "sharded banded-split CG", "sharded BandedMG CG",
    "time-sharded Kronecker CG", "FDM mode-parallel",
)

# phase C block scramble: p(i) = blk*S + (G * (i mod S) mod S), G odd, coprime
# to S (the bench's genscat numbering)
SCRAMBLE_S = 4096
SCRAMBLE_G = 1361


def require_gpu():
    """jax.devices() if the first device is a GPU; otherwise exit non-zero."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a GPU, JAX found {devs[0].platform!r}"
        )
    return devs


def _now():
    return time.perf_counter()


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _block(x):
    import jax

    return jax.block_until_ready(x)


def _timed_jit(fn, *args, reps: int = 1):
    """(result, compile_s, run_s): AOT compile, then `reps` timed runs
    (run_s is the mean)."""
    import jax

    t0 = _now()
    compiled = jax.jit(fn).lower(*args).compile()
    t_compile = _now() - t0
    out = _block(compiled(*args))  # first run: warms allocations
    t0 = _now()
    for _ in range(reps):
        out = compiled(*args)
    _block(out)
    return out, t_compile, (_now() - t0) / reps


def copy_bandwidth(n_bytes: int = 1 << 30, reps: int = 20):
    """Achieved GB/s of a streaming read + write of an n_bytes f32 array."""
    import jax
    import jax.numpy as jnp

    a = jnp.ones((n_bytes // 4,), jnp.float32)

    def stream(a):
        def body(_, c):
            return c * jnp.float32(1.0000001)
        return jax.lax.fori_loop(0, reps, body, a)

    _, _, t = _timed_jit(stream, a)
    return 2.0 * n_bytes * reps / t / 1e9


def _rel_max_diff(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


# -- phase A -----------------------------------------------------------------


def phase_a(n: int = 1024) -> dict:
    """Public API: PDE on unit_square_mesh(n), Dirichlet u = x + y."""
    import jax.numpy as jnp

    import fdapde_core_tpu as fdm
    from fdapde_core_tpu.fem.solvers import DirichletSystem
    from fdapde_core_tpu.geometry.structured import unit_square_mesh

    mesh = unit_square_mesh(n)

    def solve():
        t0 = _now()
        pde = fdm.PDE(mesh, -fdm.laplacian(), order=1)
        g = pde.dof_coords().sum(axis=1)
        pde.set_dirichlet_bc(g)
        pde.init()
        _block(pde.solve())
        return pde, g, _now() - t0

    pde, g, t_cold = solve()
    pde, g, t_warm = solve()
    mask = jnp.asarray(pde.space.boundary_dofs)
    sys_ = DirichletSystem(pde.stiff(), mask)
    b_mod = sys_.rhs(pde.force(), jnp.asarray(g))
    r = b_mod - sys_(pde.solution())
    rel = float(jnp.linalg.norm(r) / jnp.linalg.norm(b_mod))
    l2 = float(np.sqrt(max(pde.l2_error(g), 0.0)))
    return {
        "phase": "A", "n_dofs": pde.n_dofs, "n_cells": mesh.n_cells,
        "precision": "f64", "preconditioner": pde.solve_preconditioner,
        "cold_s": t_cold, "run_s": t_warm, "compile_s": t_cold - t_warm,
        "iterations": int(pde.solve_info.iterations),
        "true_rel_res": rel, "l2_error": l2,
        "peak_bytes_in_use": _peak_bytes(),
        "ok": rel <= A_MAX_REL_RES and l2 <= A_MAX_L2_ERR,
    }


# -- phase B -----------------------------------------------------------------


def _perturbed_planes(n: int, seed: int, amp: float = 0.2):
    """(n+1, n+1) node coordinate planes, interior nodes displaced by up to
    +-amp/2 cells (amp <= 0.2 keeps every triangle non-degenerate)."""
    m = n + 1
    rng = np.random.default_rng(seed)
    gi, gj = np.meshgrid(np.arange(m), np.arange(m), indexing="ij")
    d = rng.uniform(-amp / 2, amp / 2, size=(2, m, m))
    d[:, [0, -1], :] = 0.0
    d[:, :, [0, -1]] = 0.0
    return (gi + d[0]) / n, (gj + d[1]) / n


def stencil_parity(n: int, seed: int = 0) -> dict:
    """Stencil assembly from coordinates against the COO assembler on the
    same perturbed mesh: relative max |G v - A v| for f64 and f32 G."""
    import jax
    import jax.numpy as jnp

    import fdapde_core_tpu as fdm
    from fdapde_core_tpu.fem.assembler import assemble_matrix
    from fdapde_core_tpu.fem.space import FEMSpace
    from fdapde_core_tpu.geometry.structured import unit_square_mesh
    from fdapde_core_tpu.geometry.triangulation import Triangulation
    from fdapde_core_tpu.ops.grid_assembly import stencil_from_coords

    X, Y = _perturbed_planes(n, seed)
    base = unit_square_mesh(n)  # same node numbering: node (i, j) = i*m + j
    mesh = Triangulation(
        np.stack([X.reshape(-1), Y.reshape(-1)], axis=1), base.cells,
        base.boundary_nodes,
    )
    A = assemble_matrix(FEMSpace(mesh, 1), -fdm.laplacian())
    v = jnp.asarray(np.random.default_rng(seed + 1).normal(size=(n + 1) ** 2))
    ref = A @ v
    asm = jax.jit(stencil_from_coords, static_argnums=2)
    out = {}
    for name, dt in (("f64", jnp.float64), ("f32", jnp.float32)):
        G = asm(jnp.asarray(X, dt), jnp.asarray(Y, dt), n)
        out[name] = _rel_max_diff(G @ v, ref)
    return out


def phase_b(n: int = 3200, parity_n: int = 1024, asm_reps: int = 20) -> dict:
    """StructuredPoisson(n): f32 stencil assembly, MG-CG with f64 vectors."""
    import jax.numpy as jnp

    from fdapde_core_tpu.models.structured import StructuredPoisson
    from fdapde_core_tpu.ops.grid_assembly import stencil_from_coords

    m = n + 1
    # assembly alone, at the flagship size (bytes: 2 coordinate planes in,
    # 7 stencil layers out)
    X = jnp.broadcast_to(jnp.arange(m, dtype=jnp.float32)[:, None] / n, (m, m))
    Y = jnp.broadcast_to(jnp.arange(m, dtype=jnp.float32)[None, :] / n, (m, m))
    X, Y = _block((X + 0.0, Y + 0.0))
    _, asm_compile, asm_run = _timed_jit(
        lambda X, Y: stencil_from_coords(X, Y, n).data, X, Y, reps=asm_reps
    )
    asm_bytes = (2 + 7) * m * m * 4
    del X, Y

    sp = StructuredPoisson(n)  # f32 operator and V-cycle
    t0 = _now()
    G = sp.operator()
    mg = sp.multigrid()
    b = sp.rhs()
    _block((G.data, mg.datas, b))
    t_setup = _now() - t0
    t0 = _now()
    x, rel, it = _block(sp.solve(b, rtol=1e-9))
    t_cold = _now() - t0
    t0 = _now()
    x, rel, it = _block(sp.solve(b, rtol=1e-9))
    t_warm = _now() - t0
    # true residual of the returned x against the f32-stored operator,
    # recomputed here in f64
    b64 = jnp.asarray(b, jnp.float64)
    r = b64 - G @ x
    rel_true = float(jnp.linalg.norm(r) / jnp.linalg.norm(b64))
    parity = stencil_parity(parity_n)
    return {
        "phase": "B", "n_dofs": m * m, "n_cells": 2 * n * n,
        "precision": "f32 operator and V-cycle, f64 CG vectors",
        "assembly_compile_s": asm_compile, "assembly_run_s": asm_run,
        "assembly_gbps": asm_bytes / asm_run / 1e9,
        "setup_s": t_setup, "cold_s": t_cold, "run_s": t_warm,
        "compile_s": t_cold - t_warm, "mg_levels": mg.n_levels,
        "iterations": int(it), "solver_rel_res": float(rel),
        "true_rel_res": rel_true,
        "parity_n": parity_n, "parity_f64": parity["f64"],
        "parity_f32_vs_f64_ref": parity["f32"],
        "peak_bytes_in_use": _peak_bytes(),
        "ok": rel_true <= B_MAX_REL_RES and parity["f64"] <= B_MAX_PARITY_F64,
    }


# -- phase C -----------------------------------------------------------------


def scrambled_mesh(n: int, amp: float = 0.2, S: int = SCRAMBLE_S,
                   G: int = SCRAMBLE_G):
    """irregular_mesh_device_soa(n) renumbered by the block scramble
    p(i) = blk*S + (G * (i mod S) mod S) (identity on the trailing partial
    block). Returns (x, y, c0, c1, c2, boundary) in the new numbering."""
    import jax
    import jax.numpy as jnp

    from fdapde_core_tpu.geometry.structured import irregular_mesh_device_soa

    GI = pow(G, -1, S)

    @jax.jit
    def build(amp):  # traced amp: a nullary program would be constant-folded
        x, y, c0, c1, c2, bnd = irregular_mesh_device_soa(
            n, amp, dtype=jnp.float64)
        nd = x.shape[0]
        nfull = (nd // S) * S
        i = jnp.arange(nd, dtype=jnp.int32)
        p = jnp.where(i < nfull, (i // S) * S + (G * (i % S)) % S, i)
        pinv = jnp.where(i < nfull, (i // S) * S + (GI * (i % S)) % S, i)
        return x[pinv], y[pinv], p[c0], p[c1], p[c2], bnd[pinv]

    return build(jnp.float64(amp))


def ell_spmv_rate(E, reps: int = 50):
    """(seconds per SpMV, bytes moved per SpMV counted from the shapes):
    vals + cols + x + y, each read or written once."""
    import jax
    import jax.numpy as jnp

    K, n = E.vals.shape
    v0 = jnp.ones((n,), E.vals.dtype)

    def loop(E, v):
        def body(_, v):
            return (E @ v) * jnp.asarray(1.0 / 16.0, v.dtype)
        return jax.lax.fori_loop(0, reps, body, v)

    _, _, t = _timed_jit(loop, E, v0)
    itemsize = E.vals.dtype.itemsize
    nbytes = K * n * (itemsize + E.cols.dtype.itemsize) + 2 * n * itemsize
    return t / reps, nbytes


def phase_c(n: int = 2240, scramble=(SCRAMBLE_S, SCRAMBLE_G),
            copy_bytes: int = 1 << 30) -> dict:
    """MatrixFreeElliptic(format="ell") on a block-scrambled general mesh."""
    import jax.numpy as jnp

    from fdapde_core_tpu.models.matfree import MatrixFreeElliptic
    from fdapde_core_tpu.ops.matfree_soa import MatrixFreeSoA

    x, y, c0, c1, c2, bnd = _block(scrambled_mesh(n, S=scramble[0],
                                                  G=scramble[1]))
    nd = x.shape[0]
    cells = jnp.stack([c0, c1, c2], axis=1)
    t0 = _now()
    model = MatrixFreeElliptic((x, y), cells, bnd, format="ell")
    _block((model.op.vals, model.aux.dinv))
    t_setup = _now() - t0
    f = jnp.where(bnd, 0.0, 1.0)
    t0 = _now()
    u, it, rel = _block(model.solve(f, rtol=1e-9, maxiter=400))
    t_cold = _now() - t0
    t0 = _now()
    u, it, rel = _block(model.solve(f, rtol=1e-9, maxiter=400))
    t_warm = _now() - t0

    # parity: assembled ELL SpMV against the matrix-free apply, f64
    mf, _ = MatrixFreeSoA.build(x, y, c0, c1, c2, nd, 8)
    v = jnp.asarray(np.random.default_rng(3).normal(size=nd))
    parity = _rel_max_diff(model.op @ v, mf @ v)
    t_spmv, spmv_bytes = ell_spmv_rate(model.op)
    copy_gbps = copy_bandwidth(copy_bytes)
    return {
        "phase": "C", "n_dofs": nd, "n_cells": int(c0.shape[0]),
        "precision": "f64 operator and CG, f32 aux-grid V-cycle",
        "preconditioner": model.preconditioner, "ell_slots": model.op.vals.shape[0],
        "setup_s": t_setup, "cold_s": t_cold, "run_s": t_warm,
        "compile_s": t_cold - t_warm, "iterations": int(it),
        "true_rel_res": float(rel), "parity_f64": parity,
        "spmv_s": t_spmv, "spmv_gbps": spmv_bytes / t_spmv / 1e9,
        "copy_gbps": copy_gbps,
        "peak_bytes_in_use": _peak_bytes(),
        "ok": (model.preconditioner == "auxgrid"
               and float(rel) <= C_MAX_REL_RES
               and parity <= C_MAX_PARITY_F64),
    }


# -- phase D -----------------------------------------------------------------


def phase_d(n_devices: int = 4, n: int = 1024) -> dict:
    """Every distributed path at (n+1)^2 >= 1M dofs, N devices vs one."""
    from __graft_entry__ import dryrun_multichip

    t0 = _now()
    paths = dryrun_multichip(n_devices, n=n, rtol=D_RTOL, tol=D_MAX_DIFF)
    return {
        "phase": "D", "n_devices": n_devices, "n_dofs": (n + 1) ** 2,
        "precision": "f64", "rtol": D_RTOL, "max_rel_diff_bound": D_MAX_DIFF,
        "paths": paths, "wall_s": _now() - t0,
        "peak_bytes_in_use": _peak_bytes(),
        "missing_paths": [p for p in D_PATHS if p not in paths],
        "ok": (set(paths) >= set(D_PATHS)
               and all(p["ok"] for p in paths.values())),
    }


# -- main --------------------------------------------------------------------


def _gpu_name_and_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run phase D (distributed paths) on four GPUs only")
    args = ap.parse_args(argv)

    devs = require_gpu()
    if args.four_cards and len(devs) < 4:
        raise SystemExit(f"chip_smoke: --four-cards needs 4 GPUs, "
                         f"found {len(devs)}")
    print(_gpu_name_and_power(), flush=True)
    print(json.dumps({"device_kind": devs[0].device_kind,
                      "count": len(devs)}), flush=True)

    from fdapde_core_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import fdapde_core_tpu  # noqa: F401  (enables x64)

    phases = [lambda: phase_d(4)] if args.four_cards else [
        phase_a, phase_b, phase_c]
    ok = True
    for run in phases:
        res = run()
        print(json.dumps(res), flush=True)
        ok = ok and res["ok"]
    if not ok:
        print("chip_smoke: a phase missed its threshold", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
