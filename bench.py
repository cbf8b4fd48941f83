#!/usr/bin/env python
"""Benchmark: the solve paths of fdapde_core_tpu on one accelerator.

Full size: 10M dofs (20M cells) in the structured and gen10m groups.

Prints ONE final JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...extras}
plus cumulative lines (`"partial": true`) after every group.

Structure:
  - the parent process never touches jax; each GROUP runs in its own
    subprocess, one at a time (one process per card: a JAX process
    reserves most of the device memory when it starts),
  - children write their metrics to the out-file after EVERY stage, so a
    mid-group failure still surfaces everything measured up to that point,
  - a group that fails makes the whole run exit non-zero (rc 1); a child
    that spends its time budget stops cleanly at a stage boundary (rc 4,
    not an error).

Groups:
  structured: coords->stencil assembly throughput, stencil CG iters/s (f32
              + bf16-stencil), Galerkin-MG and mixed-precision converged
              solves; then the PERTURBED-geometry variant.
  general:    genuine Delaunay topology (scipy) at ~0.5M dofs, host SA-AMG
              + aux-grid PCG with the gather SpMV on device.
  spacetime:  Kronecker system (T1 (x) S0 + T0 (x) S1) at 1M space dofs x
              64 time knots: matrix-free CG throughput + a CONVERGED
              fast-diagonalization solve.
  gen10m:     ARBITRARY-TOPOLOGY path at 10.25M dofs, fully on device, in
              the SoA layouts: matrix-free + assembled-ELL gather SpMV,
              banded split, mixed-precision converged solves.
  genscat:    the gen10m operator under a block-scrambled numbering that
              the banded split rejects: ELL SpMV rate and an aux-grid
              preconditioned converged solve.
  genp2:      P2 elements on the general path.
  gendel:     a host Delaunay base refined on device to ~5M dofs with
              ragged vertex degrees: ELL SpMV, aux-grid converged solve.
  gen3d:      3D tetrahedral general path with the 3D banded split.

vs_baseline compares element-assembly throughput against an estimated
64-core multithreaded CPU-class port of the reference's Eigen assembly loop
(~1M elements/s/core serial, fem_assembler.h:79-110 => ~5e7 elements/s at
perfect scaling; the reference publishes no numbers, BASELINE.md).

Usage: python bench.py [--small]            orchestrator
       python bench.py --group G --out F    one group, in-process (children)
"""

import json
import os
import subprocess
import sys
import time

BASELINE_ELEMENTS_PER_S = 5.0e7
T_START = time.time()

GROUPS = ("structured", "genscat", "genp2", "gendel", "gen10m",
          "gen3d", "spacetime", "general")
# elapsed() gate before STARTING a group (full size; --small runs all)
GATES = {"structured": 10**9, "genscat": 420, "genp2": 1100,
         "gendel": 1200, "gen10m": 1480, "gen3d": 1560,
         "spacetime": 1600, "general": 1630}
# wall cap per child process
CAPS = {"structured": 420, "general": 200, "spacetime": 140,
        "gen10m": 340, "gen3d": 380, "genscat": 430, "genp2": 360,
        "gendel": 480}
CAPS_SMALL = {"structured": 900, "general": 500, "spacetime": 500,
              "gen10m": 500, "gen3d": 400, "genscat": 500, "genp2": 400,
              "gendel": 400}


def elapsed():
    return time.time() - T_START


# --------------------------------------------------------------------------
# orchestrator (no jax in this process)
# --------------------------------------------------------------------------


TOTAL_BUDGET_S = 1680  # hard bound on orchestrator wall time


def _run_group(group, small, outdir):
    path = os.path.join(outdir, f"{group}.json")
    try:
        os.remove(path)
    except OSError:
        pass
    cap = (CAPS_SMALL if small else CAPS)[group]
    cap = min(cap, max(120, TOTAL_BUDGET_S - elapsed()))
    cmd = [sys.executable, "-u", __file__, "--group", group, "--out", path,
           "--budget", str(max(60, cap - 60))]
    if small:
        cmd.append("--small")
    try:
        p = subprocess.run(cmd, capture_output=True, text=True, timeout=cap)
        rc = p.returncode
        tail = (p.stdout + "\n" + p.stderr).strip()[-400:]
    except subprocess.TimeoutExpired as e:
        rc = -9
        tail = "group wall cap %ds exceeded: %s" % (
            cap, ((e.stdout or b"") + (e.stderr or b""))[-200:])
    res = {}
    if os.path.exists(path):
        try:
            with open(path) as f:
                res = json.load(f)
        except (OSError, ValueError):
            pass
    err = None if rc == 0 else f"rc={rc}: {tail}"
    return res, err


# the headline fields replicated into the final COMPACT line (a reader
# that keeps only the tail of stdout still gets a parseable line)
HEADLINE_KEYS = (
    "metric", "value", "unit", "vs_baseline", "device",
    "cg_iters_per_s", "mg_converged_solve_s", "mg_converged_true_rel_res",
    "unstr_converged_solve_s", "unstr_converged_true_rel_res",
    "gen10m_n_dofs", "gen10m_ell_convert_s", "gen10m_ell_cg_iters_per_s",
    "gen10m_dia_cg_iters_per_s", "gen10m_scat_cg_iters_per_s",
    "gen10m_scat_bandwidth",
    "gen10m_scat_converged_cold_s", "gen10m_scat_converged_iters",
    "gen10m_scat_converged_true_rel_res",
    "gendel_n_dofs", "gendel_max_degree", "gendel_bandwidth",
    "gendel_converged_cold_s", "gendel_converged_true_rel_res",
    "gendel_converged_iters", "gendel_ell_cg_iters_per_s",
    "gendel_converged_warm_s",
    "gen10m_bmg_converged_solve_s", "gen10m_bmg_converged_iters",
    "gen10m_bmg_converged_true_rel_res",
    "gen10m_advdiff_solve_s", "gen10m_advdiff_iters",
    "gen10m_advdiff_true_rel_res",
    "gen_aux_pcg_iters", "gen_aux_refined_true_rel_res",
    "gen_p2_n_dofs", "gen_p2_solve_s", "gen_p2_true_rel_res",
    "gen3d_n_dofs", "gen3d_dia_cg_iters_per_s", "gen3d_converged_solve_s",
    "gen3d_converged_true_rel_res",
    "st_unknowns", "st_cg_iters_per_s", "st_solve_s", "st_solve_iters",
    "st_fdm_solve_s", "st_fdm_true_rel_res",
    "groups_completed", "bench_total_s",
)


def orchestrate(small):
    """Run every group in its own child process; returns the exit code
    (1 if any group failed, else 0)."""
    import tempfile

    out = {}
    done = []
    failed = []
    with tempfile.TemporaryDirectory(prefix="fdapde_bench_") as outdir:
        for group in GROUPS:
            if not small and elapsed() > GATES[group]:
                out[f"{group}_skipped_s"] = round(elapsed(), 1)
                continue
            res, err = _run_group(group, small, outdir)
            if err and "rc=4" in err:
                # cooperative budget stop: the child flushed its sink and
                # exited cleanly at a stage boundary
                out[f"{group}_budget_stopped"] = True
                err = None
            if err:
                out[f"{group}_error"] = err[:300]
                failed.append(group)
            else:
                done.append(group)
            # NEWEST group's keys FIRST: a tail-truncated line then loses
            # the OLDEST keys, which the final compact line still carries
            merged = {**res, **{k: v for k, v in out.items() if k not in res}}
            out = merged
            print(json.dumps({**merged, "bench_total_s": round(elapsed(), 1),
                              "partial": True}), flush=True)
    out["groups_completed"] = ",".join(done)
    out["bench_total_s"] = round(elapsed(), 1)
    print(json.dumps(out), flush=True)
    # LAST line: compact, valid JSON, headline-only
    print(json.dumps({k: out[k] for k in HEADLINE_KEYS if k in out}),
          flush=True)
    if failed:
        print(f"bench: groups failed: {','.join(failed)}", file=sys.stderr)
        return 1
    return 0


# --------------------------------------------------------------------------
# child plumbing
# --------------------------------------------------------------------------


class BudgetUp(Exception):
    """Raised by Sink.put when the child's wall budget is spent: the
    child exits CLEANLY at a stage boundary (rc=4) with its metrics
    flushed, instead of being killed mid-stage by the parent's cap."""


class Sink(dict):
    """Metrics dict persisted to the out-file after every stage, so a
    mid-group worker crash still surfaces everything measured so far."""

    def __init__(self, path, budget=None):
        super().__init__()
        self.path = path
        self.budget = budget
        self.t0 = time.time()

    def put(self, **kw):
        self.update(kw)
        if self.path:
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(dict(self), f)
            os.replace(tmp, self.path)
        if self.budget and time.time() - self.t0 > self.budget:
            raise BudgetUp()


def child_main(group, small, outpath, budget=None):
    # FDAPDE_TPU_X64 is read at package import: set it before the first import
    os.environ["FDAPDE_TPU_X64"] = "0" if group == "structured" else "1"
    import jax

    from fdapde_core_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    sink = Sink(outpath, budget=budget)
    dev = jax.devices()[0]
    sink.put(**{("" if group == "structured" else group + "_") + "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}})
    fn = {
        "structured": _structured_metrics,
        "general": _general_path_metrics,
        "spacetime": _space_time_metrics,
        "gen10m": _general_gather_metrics,
        "gen3d": _gen3d_metrics,
        "genscat": _genscat_metrics,
        "genp2": _genp2_metrics,
        "gendel": _gendel_metrics,
    }[group]
    try:
        fn(small, sink)
    except BudgetUp:
        sink.budget = None  # the handler's own flush must not re-raise
        sink.put(**{group + "_budget_stop_s": round(time.time() - sink.t0,
                                                    1)})
        sys.exit(4)  # clean partial: connection idle, sink flushed


# --------------------------------------------------------------------------
# group: structured (coords->stencil assembly + stencil solves) + perturbed
# --------------------------------------------------------------------------


def _structured_metrics(small, sink):
    # n divisible by 2^k so the multigrid hierarchy coarsens deeply
    n = 256 if small else 3200  # 2 n^2 cells: 131k small, 20.5M full

    import jax
    import jax.numpy as jnp

    from fdapde_core_tpu.ops.grid_assembly import stencil_from_coords
    from fdapde_core_tpu.ops.grid_cg import grid_cg
    from fdapde_core_tpu.ops.grid_mg import GridMG, mg_preconditioned_cg
    from fdapde_core_tpu.ops.grid_dia import prune_zero_offsets_grid

    dtype = jnp.float32
    m = n + 1
    n_dofs = m * m
    n_cells = 2 * n * n

    def _mesh_coords(amp):
        """Node coordinate PLANES (the assembly input): X/Y (m, m) with
        node (i, j) at [i, j]; interior nodes deterministically displaced
        by +-amp/2 cells (amp <= 0.2 keeps every triangle non-degenerate).
        amp is a TRACED argument: a nullary build would be constant-folded
        by XLA into a large program literal."""
        gi = jnp.arange(m, dtype=dtype)[:, None]
        gj = jnp.arange(m, dtype=dtype)[None, :]
        interior = ((gi > 0) & (gi < n) & (gj > 0) & (gj < n)).astype(dtype)
        # shader-style hash: deterministic, jit-constant-free
        hx = jnp.sin(gi * 12.9898 + gj * 78.233) * 43758.5453
        hy = jnp.sin(gi * 39.4250 + gj * 11.1350) * 27183.1415
        X = (gi + (hx - jnp.floor(hx) - 0.5) * amp * interior) / n
        Y = (gj + (hy - jnp.floor(hy) - 0.5) * amp * interior) / n + 0.0 * X
        # min scaled cell det over live quads (validity witness)
        dX, dY = X[1 : n + 1] - X[:n], Y[1 : n + 1] - Y[:n]
        rX, rY = X[:, 1:] - X[:, :-1], Y[:, 1:] - Y[:, :-1]
        detA = dX[:, :n] * rY[:n, :n] - rX[:n, :n] * dY[:, :n]
        detB = rX[1 : n + 1, :n] * (rY[:n, :n] - dY[:, :n]) - (
            rX[:n, :n] - dX[:, :n]
        ) * rY[1 : n + 1, :n]
        min_det = jnp.minimum(jnp.min(detA), jnp.min(detB)) * (n * n)
        nid = jnp.arange(n_dofs, dtype=jnp.int32)
        ni = (nid // m).astype(dtype)
        nj = (nid % m).astype(dtype)
        on_bnd = (ni == 0) | (ni == n) | (nj == 0) | (nj == n)
        return X, Y, on_bnd, min_det

    build = jax.jit(_mesh_coords)

    ASM_REPS = 20

    @jax.jit
    def assemble(X, Y):
        """GridDIAMatrix straight from the coordinate planes: local
        assembly + global stencil scatter in one elementwise expression
        (ops/grid_assembly.stencil_from_coords)."""
        return stencil_from_coords(X, Y, n)

    @jax.jit
    def fold_bc(D, free):
        return D.with_dirichlet_identity(free)

    t0 = time.time()
    X, Y, on_bnd, mind = jax.block_until_ready(build(dtype(0.0)))
    t_build_cold = time.time() - t0  # includes compile
    t0 = time.time()
    X, Y, on_bnd, mind = jax.block_until_ready(build(dtype(0.0)))
    t_build = time.time() - t0
    sink.put(device_mesh_build_s=round(t_build, 4),
             device_mesh_build_cold_s=round(t_build_cold, 2))

    D = jax.block_until_ready(assemble(X, Y))  # compile + warm
    t0 = time.time()
    for _ in range(ASM_REPS):
        D = assemble(X, Y)
    jax.block_until_ready(D)
    t_asm = (time.time() - t0) / ASM_REPS
    elements_per_s = n_cells / t_asm
    # bytes model: 2 coordinate planes read + 7 stencil layers written
    asm_bytes = (2 + 7) * m * m * 4
    sink.put(
        metric="p1_poisson_assembly_throughput",
        value=round(elements_per_s, 1),
        unit="elements/s",
        vs_baseline=round(elements_per_s / BASELINE_ELEMENTS_PER_S, 3),
        n_cells=n_cells,
        n_dofs=n_dofs,
        assembly_s=round(t_asm, 6),
        assembly_gbps=round(asm_bytes / t_asm / 1e9, 1),
        dtype="float32",
    )

    free = (~on_bnd).astype(dtype)
    b = jnp.ones(n_dofs, dtype) * free
    CG_ITERS = 500
    G = fold_bc(D, free)
    G = prune_zero_offsets_grid(G)  # 7 -> 5 layers (exact zeros only)

    def cg_bytes(layers, itemsize=4):
        # per iter: stencil layers + ~10 full vector passes (bytes model)
        return (layers + 10) * n_dofs * itemsize

    run_cg = jax.jit(lambda Gm, bb: grid_cg(Gm, bb, CG_ITERS))
    x, res = run_cg(G, b)
    float(res)  # compile + warmup
    t0 = time.time()
    x, res = run_cg(G, b)
    float(res)
    t_cg_iter = (time.time() - t0) / CG_ITERS
    sink.put(cg_iters_per_s=round(1.0 / t_cg_iter, 1),
             cg_gbps=round(cg_bytes(len(G.offsets2d)) / t_cg_iter / 1e9, 1),
             final_cg_residual=float(res))

    run_cg16 = jax.jit(
        lambda Gm, bb: grid_cg(Gm, bb, CG_ITERS, data_dtype=jnp.bfloat16)
    )
    x16, res16 = run_cg16(G, b)
    float(res16)
    t0 = time.time()
    x16, res16 = run_cg16(G, b)
    float(res16)
    sink.put(cg_bf16_data_iters_per_s=round(CG_ITERS / (time.time() - t0), 1),
             final_cg_bf16_residual=float(res16))

    t0 = time.time()
    mg = GridMG.build(G, coarse_n=32)
    float(mg.datas[-1][0, 0, 0])
    t_mg_build = time.time() - t0

    # (no standalone f32 MG solve: its f32 arithmetic floors on rough
    # coefficients; only the *_converged_* stages below solve)

    @jax.jit
    def check(D, free):
        return jnp.abs((D @ jnp.ones(n_dofs, dtype)) * free).max()

    rowsum = float(check(D, free))
    sink.put(mg_levels=mg.n_levels, mg_build_s=round(t_mg_build, 3),
             interior_rowsum_max=rowsum)

    # ---- perturbed-geometry (unstructured) section, f32 part --------------
    AMP = dtype(0.2)  # +-0.1 h per coordinate; guaranteed non-degenerate
    Xp, Yp, p_bnd, p_mind = build(AMP)
    p_min_det = float(p_mind)  # scaled by n^2: structured value = 1.0
    Dp = assemble(Xp, Yp)  # same compiled program (shape-identical)
    Gp = fold_bc(Dp, free)
    Gp = prune_zero_offsets_grid(Gp)  # generic geometry: nothing prunes
    sink.put(unstr_n_dofs=n_dofs, unstr_min_cell_det=round(p_min_det, 4),
             unstr_stencil_layers=len(Gp.offsets2d))

    t0 = time.time()
    mgp = GridMG.build(Gp, coarse_n=32)
    float(mgp.datas[-1][0, 0, 0])
    p_mg_build_s = time.time() - t0

    sink.put(unstr_mg_build_s=round(p_mg_build_s, 3))

    # CG iteration throughput on the 7-layer variable stencil
    run_cg_p = jax.jit(lambda Gm, bb: grid_cg(Gm, bb, CG_ITERS))
    xpc, respc = run_cg_p(Gp, b)
    float(respc)
    t0 = time.time()
    xpc, respc = run_cg_p(Gp, b)
    float(respc)
    t_iter_p = (time.time() - t0) / CG_ITERS
    sink.put(unstr_cg_iters_per_s=round(1.0 / t_iter_p, 1),
             unstr_cg_gbps=round(
                 cg_bytes(len(Gp.offsets2d)) / t_iter_p / 1e9, 1))

    # ---- x64 flip: mixed-precision converged solves ----------------------
    jax.config.update("jax_enable_x64", True)

    def converged_solve(Gm, mgm, bb):
        """f64-vector CG with the f32 V-cycle preconditioner (the f32
        rounding perturbs the preconditioner only); supersedes iterative
        refinement, whose f32 inner solves floor on rough coefficients."""
        b64 = jnp.asarray(bb, jnp.float64)
        run = jax.jit(
            lambda Gm, mgm, b64: mg_preconditioned_cg(
                Gm, b64, rtol=1e-9, maxiter=60, mg=mgm,
                prec_dtype=jnp.float32,
            )
        )
        xr, rrel, rk = run(Gm, mgm, b64)
        float(rrel)  # warm
        t0 = time.time()
        xr, rrel, rk = run(Gm, mgm, b64)
        rrelv, rkv = float(rrel), int(rk)
        return time.time() - t0, rrelv, rkv

    t_refined, rrelv, rkv = converged_solve(G, mg, b)
    sink.put(mg_converged_solve_s=round(t_refined, 3),
             mg_converged_iters=rkv, mg_converged_true_rel_res=rrelv)
    # Perturbed geometry: same mixed-precision converged solve (f64 CG
    # vectors over f32-stored stencils, f32 V-cycle preconditioner);
    # iterative refinement is NOT usable here (f32 inner solves floor at
    # ~4e-3 on rough coefficients).
    p_ref_s, p_ref_rel, p_ref_k = converged_solve(Gp, mgp, b)
    sink.put(unstr_converged_solve_s=round(p_ref_s, 3),
             unstr_converged_iters=p_ref_k,
             unstr_converged_true_rel_res=p_ref_rel)


# --------------------------------------------------------------------------
# group: general (host Delaunay topology, SA-AMG + aux-grid on chip)
# --------------------------------------------------------------------------


def _host_p1_stiffness(nodes, cells):
    """Pure-NumPy P1 stiffness + boundary mask (host-side assembly of the
    general-path section)."""
    import numpy as np

    p = nodes[cells]  # (C, 3, 2)
    J = np.stack([p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]], axis=2)
    det = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
    area = 0.5 * np.abs(det)
    inv_det = 1.0 / det
    invJ = (
        np.stack(
            [
                np.stack([J[:, 1, 1], -J[:, 0, 1]], 1),
                np.stack([-J[:, 1, 0], J[:, 0, 0]], 1),
            ],
            axis=1,
        )
        * inv_det[:, None, None]
    )
    gref = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])  # (3, 2)
    g = np.einsum("cmn,im->cin", invJ, gref)  # physical gradients (C,3,2)
    loc = np.einsum("cin,cjn,c->cij", g, g, area)  # +grad.grad (the
    # reference's -laplacian weak form sign, operators/laplacian.h:37-44)
    rows = np.repeat(cells, 3, axis=1).reshape(-1)
    cols = np.tile(cells, (1, 3)).reshape(-1)
    import scipy.sparse as sp

    A = sp.coo_matrix(
        (loc.reshape(-1), (rows, cols)), shape=(nodes.shape[0],) * 2
    ).tocsr()
    return A


def _general_path_metrics(small, sink):
    """Genuine unstructured topology at scale, general (gather-SpMV) solve
    path: host Delaunay + numpy assembly + SA-AMG setup; AMG-PCG + f64
    refinement ON CHIP."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    import scipy.sparse as sp
    from scipy.spatial import Delaunay

    from fdapde_core_tpu.linear_algebra.amg import AMG
    from fdapde_core_tpu.linear_algebra.sparse import SparseMatrix

    t_sec = time.time()
    nx = 64 if small else 720  # (nx+1)^2 nodes: ~4.2k small, ~0.52M full
    rng = np.random.default_rng(7)
    ii, jj = np.meshgrid(np.arange(nx + 1), np.arange(nx + 1), indexing="ij")
    pts = np.stack([ii, jj], axis=-1).reshape(-1, 2).astype(np.float64)
    interior = (
        (pts[:, 0] > 0) & (pts[:, 0] < nx) & (pts[:, 1] > 0) & (pts[:, 1] < nx)
    )
    pts[interior] += rng.uniform(-0.35, 0.35, size=(interior.sum(), 2))
    pts /= nx
    tri = Delaunay(pts)
    cells = tri.simplices.astype(np.int32)
    n = pts.shape[0]
    sink.put(gen_n_dofs=n, gen_n_cells=int(cells.shape[0]))

    t0 = time.time()
    A = _host_p1_stiffness(pts, cells)
    on_bnd = ~interior
    # Dirichlet masking (fem/solvers.py semantics) at the scipy level
    coo = A.tocoo()
    keep = ~(on_bnd[coo.row] | on_bnd[coo.col])
    vals = np.where(keep, coo.data, 0.0)
    diag_fix = sp.coo_matrix(
        (np.ones(on_bnd.sum()), (np.nonzero(on_bnd)[0],) * 2), shape=A.shape
    )
    Am = sp.coo_matrix((vals, (coo.row, coo.col)), shape=A.shape).tocsr() + diag_fix
    # RCM reordering: Delaunay's native node order scatters SpMV gathers
    # across device memory; a banded order restores locality
    # (parallel/reorder.py, native C++ BFS)
    from fdapde_core_tpu.parallel.reorder import rcm_permutation

    coom = Am.tocoo()
    perm, inv = rcm_permutation(coom.row, coom.col, n)
    P = sp.coo_matrix((np.ones(n), (np.arange(n), perm)), shape=(n, n)).tocsr()
    Am = (P @ Am @ P.T).tocsr()
    on_bnd = on_bnd[perm]
    pts_rcm = pts[perm]
    t_host_asm = time.time() - t0
    sink.put(gen_host_assembly_s=round(t_host_asm, 3))

    t0 = time.time()
    mg = AMG.build(Am.astype(np.float32))
    t_amg_setup = time.time() - t0
    sink.put(gen_amg_setup_s=round(t_amg_setup, 3), gen_amg_levels=mg.n_levels,
             gen_amg_op_complexity=round(mg.operator_complexity(), 3))

    # setup amortization (SURVEY §5.4): the AMG hierarchy is a HOST-side
    # artifact, the class where checkpointing beats rebuild. Warm restore
    # should be <~1/10 of the cold build.
    import tempfile

    from fdapde_core_tpu.utils.checkpoint import load_amg, save_amg

    ckpt = os.path.join(tempfile.gettempdir(),
                        f"fdapde_amg_ckpt_{os.getpid()}.npz")
    t0 = time.time()
    save_amg(ckpt, mg)
    t_save = time.time() - t0
    t0 = time.time()
    mg = load_amg(ckpt)
    sink.put(gen_amg_ckpt_save_s=round(t_save, 3),
             gen_amg_ckpt_restore_s=round(time.time() - t0, 3))
    try:
        os.remove(ckpt)
    except OSError:
        pass

    t0 = time.time()
    coo = Am.tocoo()
    order = np.lexsort((coo.col, coo.row))
    A32 = SparseMatrix(
        jnp.asarray(coo.row[order].astype(np.int32)),
        jnp.asarray(coo.col[order].astype(np.int32)),
        jnp.asarray(coo.data[order].astype(np.float32)),
        Am.shape,
    )
    vals64 = jnp.asarray(coo.data[order])  # f64 for refinement residuals
    b = jnp.asarray(np.where(on_bnd, 0.0, 1.0 / (nx * nx)).astype(np.float32))
    jax.block_until_ready(b)
    t_upload = time.time() - t0
    sink.put(gen_upload_s=round(t_upload, 2))

    from fdapde_core_tpu.linear_algebra.solvers import cg

    @jax.jit
    def solve(A32, mgm, b):
        x, info = cg(A32, b, M_inv=mgm.v_cycle, rtol=1e-6, maxiter=60)
        return x, info.iterations, info.residual

    x, it, res = solve(A32, mg, b)
    float(res)  # warm
    t0 = time.time()
    x, it, res = solve(A32, mg, b)
    itv = int(it)
    t_solve = time.time() - t0
    sink.put(gen_amg_pcg_iters=itv, gen_amg_pcg_solve_s=round(t_solve, 3))

    # f64 refinement wrapped around the f32 AMG-CG (true residual on chip)
    b64 = jnp.asarray(np.where(on_bnd, 0.0, 1.0 / (nx * nx)))
    A64 = SparseMatrix(A32.rows, A32.cols, vals64, Am.shape)

    def _refined(M, apply_fn):
        # M is a PYTREE (AMG hierarchy / aux-grid) passed as a jit argument;
        # apply_fn(M, v) applies the preconditioner inside the trace
        @jax.jit
        def refined(A32, A64, M, b64):
            bn2 = jnp.sum(b64 * b64)

            def body(k, s):
                x, _ = s
                r = b64 - A64 @ x
                dx, _ = cg(A32, r.astype(jnp.float32),
                           M_inv=lambda v: apply_fn(M, v),
                           rtol=1e-6, maxiter=40)
                x = x + dx.astype(jnp.float64)
                r2 = b64 - A64 @ x
                return (x, jnp.sum(r2 * r2))

            x, rn2 = jax.lax.fori_loop(0, 3, body, (jnp.zeros_like(b64), bn2))
            return x, jnp.sqrt(rn2 / bn2)

        xr, rrel = refined(A32, A64, M, b64)
        float(rrel)
        t0 = time.time()
        xr, rrel = refined(A32, A64, M, b64)
        rrelv = float(rrel)
        return time.time() - t0, rrelv

    # (AMG is measured by its setup/ckpt/pcg fields; the refined solve
    # below uses the aux-grid preconditioner)

    # auxiliary-grid preconditioner (ops/auxgrid.py): ~h-independent like
    # AMG but each application costs 8n gathered elements instead of a
    # multi-level cascade of matrix SpMVs
    from fdapde_core_tpu.ops.auxgrid import AuxGridPreconditioner

    t0 = time.time()
    aux = AuxGridPreconditioner.build(pts_rcm, A32.diagonal())
    t_aux_setup = time.time() - t0
    sink.put(gen_aux_setup_s=round(t_aux_setup, 3))

    @jax.jit
    def solve_aux(A32, aux, b):
        x, info = cg(A32, b, M_inv=aux, rtol=1e-6, maxiter=100)
        return x, info.iterations, info.residual

    xa, ita, resa = solve_aux(A32, aux, b)
    float(resa)  # warm
    t0 = time.time()
    xa, ita, resa = solve_aux(A32, aux, b)
    ita_v = int(ita)
    t_aux_solve = time.time() - t0
    sink.put(gen_aux_pcg_iters=ita_v, gen_aux_pcg_solve_s=round(t_aux_solve, 3))

    t_aux_refined, arrel_v = _refined(aux, lambda m, v: m(v))
    sink.put(gen_aux_refined_solve_s=round(t_aux_refined, 3),
             gen_aux_refined_true_rel_res=arrel_v)

    sink.put(gen_section_s=round(time.time() - t_sec, 1))


# --------------------------------------------------------------------------
# group: spacetime (Kronecker CG throughput + converged fast diagonalization)
# --------------------------------------------------------------------------


def _space_time_metrics(small, sink):
    """Kronecker space-time CG: R = T1 (x) S0 + T0 (x) S1 at n_t knots x
    m^2 space dofs, matrix-free (stencil per time slice + small time
    matmul). Mirrors the reference's Kronecker use
    (linear_algebra/kronecker_product.h:27-80) at scale."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    t_sec = time.time()
    mst = 129 if small else 1025  # space grid nodes per side (m^2 dofs)
    n_t = 64
    ST_ITERS = 60

    # time matrices from the spline layer (host, tiny)
    from fdapde_core_tpu.geometry.interval import Interval
    from fdapde_core_tpu.splines.space import SplineSpace
    from fdapde_core_tpu.splines.assembler import assemble_mass, assemble_operator
    from fdapde_core_tpu.pde.operators import bilaplacian

    sspace = SplineSpace(Interval(0.0, 1.0, n_t - 3), 3)  # n_t basis fns
    T0 = np.asarray(assemble_mass(sspace).toarray())
    T1 = np.asarray(assemble_operator(sspace, -bilaplacian()).toarray())
    n_t = T0.shape[0]

    # equilibrate the two Kronecker terms (the spline bilaplacian Gram
    # scales like h_t^-3): keeps the synthetic operator f32-friendly
    T0 = T0 / np.abs(np.diag(T0)).max()
    T1 = T1 / np.abs(np.diag(T1)).max()
    T0j = jnp.asarray(T0.astype(np.float32))
    T1j = jnp.asarray(T1.astype(np.float32))
    sink.put(st_n_time=int(n_t), st_n_space=int(mst * mst),
             st_unknowns=int(n_t * mst * mst))

    # space stencils of the uniform criss-cross P1 grid (closed form),
    # stiffness with Dirichlet identity fold; mass lumped (lumping.h:30).
    # PRODUCT-API path from here on: ops/grid_dia.GridDIAMatrix space
    # factors inside models/space_time.SeparableOperator, preconditioned
    # by models/space_time.ModeMGPreconditioner, iterated by
    # linear_algebra.solvers.cg_chunked (bounded programs).
    from fdapde_core_tpu.linear_algebra.solvers import cg_chunked
    from fdapde_core_tpu.models.space_time import (
        ModeMGPreconditioner,
        SeparableOperator,
    )
    from fdapde_core_tpu.ops.grid_dia import GridDIAMatrix

    offs5 = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))

    @jax.jit
    def st_build(shift):
        gi = jnp.arange(mst, dtype=jnp.float32)
        interior1d = (gi > 0) & (gi < mst - 1)
        free = (interior1d[:, None] & interior1d[None, :]).astype(jnp.float32)
        h2 = (1.0 / (mst - 1)) ** 2 + shift
        # 5-point stiffness layers (criss-cross P1 == FD Laplacian here)
        diag = jnp.where(free > 0, 4.0, 1.0)
        off = -1.0 * free
        dataA = jnp.stack([diag, off, off, off, off])
        # lumped mass on shared offsets (zero off-layers) for the Galerkin
        # chain AXPY inside ModeMGPreconditioner
        zero = jnp.zeros((mst, mst), jnp.float32)
        dataE = jnp.stack([h2 * jnp.ones((mst, mst), jnp.float32),
                           zero, zero, zero, zero])
        return dataA, dataE, free, dataA[0, 0, 0]

    dataA, dataE, free, wst = st_build(jnp.float32(0.0))
    float(wst)
    S1 = GridDIAMatrix(dataA, offs5, (mst, mst)).with_dirichlet_identity(
        free.reshape(-1)
    )
    S0 = GridDIAMatrix(dataE, offs5, (mst, mst))

    op = SeparableOperator([(T1j, S0), (T0j, S1)])
    t0 = time.time()
    pre = ModeMGPreconditioner.build(T0, T1, S0, S1)
    float(jax.jit(lambda d: d[0, 0, 0, 0])(pre.mg.datas[-1]))
    sink.put(st_pre_build_s=round(time.time() - t0, 2),
             st_mg_levels=pre.mg.n_levels)

    b = jnp.ones((n_t * mst * mst,), jnp.float32)
    bnorm = (n_t * mst * mst) ** 0.5

    # iteration throughput, fixed ST_ITERS (chunked)
    x, info = cg_chunked(op, b, M_inv=pre, rtol=0.0, maxiter=ST_ITERS,
                         chunk=10)  # warm/compile
    t0 = time.time()
    x, info = cg_chunked(op, b, M_inv=pre, rtol=0.0, maxiter=ST_ITERS,
                         chunk=10)
    t_cg = time.time() - t0
    iters_done = max(int(info.iterations), 1)
    sink.put(
        st_cg_iters_per_s=round(iters_done / t_cg, 1),
        st_cg_rel_res_after=float(info.residual) / bnorm,
        st_cg_iters_timed=iters_done,
    )

    # CONVERGED product-API solve (mode-MG CG, f32)
    t0 = time.time()
    xc, infoc = cg_chunked(op, b, M_inv=pre, rtol=1e-6, maxiter=60,
                           chunk=10)
    sink.put(st_solve_s=round(time.time() - t0, 2),
             st_solve_iters=int(infoc.iterations),
             st_solve_rel_res=float(infoc.residual) / bnorm)

    del x, xc, b, dataA, dataE, free, op, pre
    _space_time_fdm_converged(T0, T1, mst, n_t, sink)
    sink.put(st_section_s=round(time.time() - t_sec, 1))


def _space_time_fdm_converged(T0, T1, mst, n_t, sink):
    """CONVERGED space-time solve of R = T1 (x) S0 + T0 (x) S1 by fast
    diagonalization (models/space_time.solve_space_time_fdm semantics, here
    on grid stencils): host time eigenbasis -> n_t decoupled space systems
    (S1 + lam_t S0), each solved by f64 MG-CG whose per-mode hierarchy is
    an AXPY of two precomputed Galerkin chains (stiffness chain + shifted-
    identity chain share the bilinear P, so P^T (A + s M) P =
    P^T A P + s P^T M P). One lax.scan over modes — a single compile."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    import scipy.linalg as sla

    from fdapde_core_tpu.ops.grid_dia import GridDIAMatrix
    from fdapde_core_tpu.ops.grid_mg import (
        GridMG,
        galerkin_coarsen,
        mg_preconditioned_cg,
    )

    t0_sec = time.time()
    lam, Z = sla.eigh(T1, T0)  # Z^T T0 Z = I
    lamj = jnp.asarray(lam, jnp.float64)
    Zj = jnp.asarray(Z, jnp.float64)

    n_sp = mst - 1
    h2 = (1.0 / n_sp) ** 2
    offs5 = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))

    # static level plan (same rule as GridMG.build)
    shapes = [mst]
    while True:
        nn = shapes[-1] - 1
        if nn % 2 != 0 or nn // 2 < 32:
            break
        shapes.append(nn // 2 + 1)
    offsets = [offs5] + [
        tuple((a, b) for a in (-1, 0, 1) for b in (-1, 0, 1))
    ] * (len(shapes) - 1)

    @jax.jit
    def chains(shift):
        # Only LEVEL 0 must be f64 (the fine mode operator has to match the
        # f64 residual check exactly — an f32-rounded A + lam*E leaves a
        # systematic ~1e-5 full-system floor); the coarsening chain feeds
        # the PRECONDITIONER only, so it runs entirely in f32 (fast).
        gi = jnp.arange(mst, dtype=jnp.float64) + shift
        int1d = (gi > 0) & (gi < mst - 1)
        free = (int1d[:, None] & int1d[None, :]).astype(jnp.float64)
        diag = jnp.where(free > 0, 4.0, 1.0)
        off = -1.0 * free
        # Dirichlet-masked 5-point stiffness (columns masked via symmetry of
        # the folded operator: off layers already vanish on boundary rows;
        # boundary columns are handled because off[b-row]=0 both directions)
        offm = [off * jnp.pad(free, 1)[1 + di : 1 + di + mst,
                                       1 + dj : 1 + dj + mst]
                for (di, dj) in offs5[1:]]
        dataA = jnp.stack([diag] + offm)
        dataE = jnp.stack(
            [h2 * free] + [jnp.zeros((mst, mst), jnp.float64)] * 4
        )
        outA, outE = [dataA.astype(jnp.float32)], [dataE.astype(jnp.float32)]
        GA = GridDIAMatrix(outA[0], offs5, (mst, mst))
        GE = GridDIAMatrix(outE[0], offs5, (mst, mst))
        for _ in range(len(shapes) - 1):
            GA = galerkin_coarsen(GA)
            GE = galerkin_coarsen(GE)
            outA.append(GA.data)
            outE.append(GE.data)
        return dataA, dataE, tuple(outA), tuple(outE), free

    A64, E64, As, Es, free = chains(jnp.float64(0.0))
    float(As[-1][0, 0, 0])

    b = jnp.ones((n_t, mst, mst), jnp.float64) * free[None]

    @jax.jit
    def fdm_solve(A64, E64, As, Es, b, lamj, Zj):
        Bt = jnp.einsum("ts,smn->tmn", Zj.T, b)  # (Z^T (x) I) b

        bscale = jnp.sqrt(jnp.sum(Bt * Bt))

        def mode(carry, inp):
            lam_t, rhs = inp
            # f32 PRECONDITIONER hierarchy; f64 FINE operator (exact)
            lam32 = lam_t.astype(jnp.float32)
            datas32 = [A + lam32 * E for A, E in zip(As, Es)]
            mg = GridMG(datas32, tuple(offsets), tuple(shapes), 0.8, 2, 64)
            Gm = GridDIAMatrix(A64 + lam_t * E64, offs5, (mst, mst))
            w, rel, k = mg_preconditioned_cg(
                Gm, rhs.reshape(-1), rtol=1e-10, maxiter=40, mg=mg,
                prec_dtype=jnp.float32,
            )
            # time modes orthogonal to b (rhs ~ 1e-13 relative) sit below
            # the f64 resolution of the FULL system; a stalled CG on such a
            # mode can wander to small-but-nonzero absolute garbage — their
            # true contribution is 0, so pin it
            live = jnp.linalg.norm(rhs) > 1e-12 * bscale
            w = jnp.where(live, w, 0.0)
            k = jnp.where(live, k, 0)
            return carry, (w, rel, k)

        _, (W, rels, ks) = jax.lax.scan(mode, 0, (lamj, Bt))
        Xs = jnp.einsum("ts,smn->tmn", Zj, W.reshape(n_t, mst, mst))
        # true residual of the full Kronecker system (f64 fine operators)
        dataA, dataE = A64, E64

        def s_apply(data, V):
            vp = jnp.pad(V, ((0, 0), (1, 1), (1, 1)))
            acc = data[0][None] * V
            for i, (di, dj) in enumerate(offs5[1:]):
                acc += data[i + 1][None] * jax.lax.slice(
                    vp, (0, 1 + di, 1 + dj), (n_t, 1 + di + mst, 1 + dj + mst)
                )
            return acc

        T0j = jnp.asarray(T0, jnp.float64)
        T1j = jnp.asarray(T1, jnp.float64)
        R = jnp.einsum("ts,smn->tmn", T1j, s_apply(dataE, Xs)) + jnp.einsum(
            "ts,smn->tmn", T0j, s_apply(dataA, Xs)
        )
        rel = jnp.sqrt(jnp.sum((R - b) ** 2) / jnp.sum(b * b))
        return Xs, rel, ks.max(), rels.max()

    Xs, rel, kmax, rmax = fdm_solve(A64, E64, As, Es, b, lamj, Zj)
    float(rel)  # warm
    t0 = time.time()
    Xs, rel, kmax, rmax = fdm_solve(A64, E64, As, Es, b, lamj, Zj)
    relv = float(rel)
    t_solve = time.time() - t0
    sink.put(
        st_fdm_solve_s=round(t_solve, 2),
        st_fdm_true_rel_res=relv,
        st_fdm_max_mode_iters=int(kmax),
        st_fdm_setup_s=round(time.time() - t0_sec - t_solve, 2),
    )


# --------------------------------------------------------------------------
# group: gen10m (flagship-scale general gather path, SoA layouts)
# --------------------------------------------------------------------------


def _aux_cast_pre(aux, rr):
    """f32 aux V-cycle inside f64 CG (module-level: stable identity keeps
    the cg_chunked program cache warm across calls)."""
    import jax.numpy as jnp

    return aux(rr.astype(jnp.float32)).astype(jnp.float64)


def _general_gather_metrics(small, sink):
    """Flagship-size general path: genuinely irregular topology, fully on
    device, SoA LAYOUTS THROUGHOUT (ops/matfree_soa.py: cell/dof axis
    last). The mesh (hash-flipped diagonals + jittered
    nodes) and the element-local stiffness are generated on device; the
    operator action is the assembled-ELL gather SpMV over opaque index
    arrays, upgraded to the banded DIA split + zero-gather BandedMG where
    the offset histogram concentrates (this mesh's lattice numbering
    does; the SCATTERED control below measures the class that does NOT).
    Converged solves: f64 CG vectors + f64 fine operator + f32 V-cycle
    (the f32 rounding perturbs the preconditioner only). Also: a
    scattered-numbering control (block-scrambled symmetric
    permutation — spread histogram, plan rejected) with the WindowedELL
    gather path, and a 10M-dof NON-SYMMETRIC advection-diffusion-reaction
    converged solve (operators/advection.h:33-56 at flagship scale).
    Every stage is its own jit with its own sink flush so a full-size
    failure is attributable."""
    import jax
    import jax.numpy as jnp

    from fdapde_core_tpu.fem.solvers import DirichletSystem
    from fdapde_core_tpu.geometry.structured import irregular_mesh_device_soa
    from fdapde_core_tpu.linear_algebra.solvers import (
        bicgstab_chunked,
        cg_chunked,
    )
    from fdapde_core_tpu.ops.matfree_soa import (
        MatrixFreeSoA,
        build_adjacency_soa,
        p1_general_soa,
        p1_offdiag_soa,
    )

    t_sec = time.time()
    n = 256 if small else 3200  # full: 10.25M dofs, 20.48M cells
    n_dofs = (n + 1) ** 2
    n_cells = 2 * n * n
    MAXD = 8  # flipped-quad P1 meshes: node degrees are 4..8 exactly
    MAXC = 9  # distinct columns per row: degree <= 8 neighbors + self
    sink.put(gen10m_n_dofs=n_dofs, gen10m_n_cells=n_cells,
             gen10m_layout="soa")

    # stage 1: device mesh (pure elementwise + iota; no gathers)
    @jax.jit
    def mesh(amp):
        x, y, c0, c1, c2, bnd = irregular_mesh_device_soa(
            n, amp, dtype=jnp.float64
        )
        return x, y, c0, c1, c2, bnd, jnp.sum(x) + jnp.sum(c2)

    x, y, c0, c1, c2, bnd, wm = mesh(jnp.float64(0.2))
    float(wm)  # compile absorbed here
    t0 = time.time()
    x, y, c0, c1, c2, bnd, wm = mesh(jnp.float64(0.2))
    float(wm)
    sink.put(gen10m_mesh_s=round(time.time() - t0, 3))

    # stage 2: element-local stiffness (6 coordinate gathers of (C,))
    @jax.jit
    def offdiag(x, y, c0, c1, c2):
        s01, s02, s12 = p1_offdiag_soa(x, y, c0, c1, c2)
        s = jnp.stack([s01, s02, s12])
        return s, jnp.sum(s[:, :8])

    s, ws = offdiag(x, y, c0, c1, c2)
    float(ws)
    t0 = time.time()
    s, ws = offdiag(x, y, c0, c1, c2)
    float(ws)
    sink.put(gen10m_local_assembly_s=round(time.time() - t0, 3))

    # stage 3: ELL incidence table (one device argsort over (3C,))
    @jax.jit
    def adjacency(c0, c1, c2):
        flat = jnp.concatenate([c0, c1, c2])  # slot-major: p = slot*C + cell
        adj, mask, over = build_adjacency_soa(flat, n_dofs, MAXD)
        return adj, mask, over.astype(jnp.int32)

    adj, mask8, over = adjacency(c0, c1, c2)
    overflowed = int(over)
    t0 = time.time()
    adj, mask8, over = adjacency(c0, c1, c2)
    int(over)
    sink.put(gen10m_adjacency_s=round(time.time() - t0, 3),
             gen10m_adjacency_overflow=overflowed)

    c = jnp.stack([c0, c1, c2])
    op64 = MatrixFreeSoA(s, c, adj, mask8, n_dofs)

    ITERS = 40
    # cg_chunked carries the full Krylov state across <=CH-iteration
    # programs (bit-identical iterates; one host sync per chunk).
    CH = 4
    ITERS_ELL = ITERS if small else 8

    rhs32 = jax.jit(
        lambda bnd: jnp.where(bnd, 0.0, 1.0).astype(jnp.float32) / (n * n)
    )(bnd)

    # stage 4: assembled row-ELL (SoA (K, n)). BLOCKED conversion: bounded
    # per-block programs (ops/matfree_soa.ell_from_op_blocked): a
    # co-sorting network + K masked reductions (scatter-free).
    from fdapde_core_tpu.ops.matfree_soa import ell_from_op_blocked

    t0 = time.time()
    E64, overe = ell_from_op_blocked(op64, MAXC, blocks=8 if not small else 2)
    ell_overflow = int(overe)
    sink.put(gen10m_ell_convert_cold_s=round(time.time() - t0, 3))
    t0 = time.time()
    E64, overe = ell_from_op_blocked(op64, MAXC, blocks=8 if not small else 2)
    int(overe)
    sink.put(gen10m_ell_convert_s=round(time.time() - t0, 3),
             gen10m_ell_overflow=ell_overflow)
    E32 = jax.jit(lambda E: E.astype(jnp.float32))(E64)
    del s  # the f32 operator rides the assembled ELL from here

    del op64  # conversions done: free the matfree form
    # (the raw-ELL CG rate stage — the 1.2 iters/s honesty baseline —
    # moved to the END of the group: in squeezed windows it was eating
    # ~65 s while the flagship BandedMG/advdiff converged stages fell
    # off; the baseline is r3/r4-official and never changes)

    # stage 5b: banded DIA + ELL-remainder split (ops/dia_split.py) — the
    # dominant offsets of the RCM-banded operator become STATIC 2D stencil
    # shifts at memory bandwidth; gathers only for the tiny remainder
    from fdapde_core_tpu.ops.dia_split import (
        banded_cg, build_banded_split, plan_split_width,
    )

    t0 = time.time()
    W, amax = plan_split_width(E32)
    sink.put(gen10m_dia_plan_s=round(time.time() - t0, 3),
             gen10m_dia_W=int(W or 0), gen10m_dia_amax=int(amax))
    if W:
        @jax.jit
        def to_split(E, bnd):
            S, over = build_banded_split(E, W, amax=amax)
            F = S.fold_dirichlet(bnd)
            rem_nnz = jnp.sum(F.rem.vals != 0.0)
            return F, over.astype(jnp.int32), rem_nnz.astype(jnp.int32)

        S32, overs, remnnz = to_split(E32, bnd)
        t0 = time.time()
        S32, overs, remnnz = to_split(E32, bnd)
        int(overs)
        sink.put(gen10m_dia_split_s=round(time.time() - t0, 3),
                 gen10m_dia_rem_overflow=int(overs),
                 gen10m_dia_rem_nnz=int(remnnz))
        if int(remnnz) == 0:  # never gather to multiply zeros
            S32 = S32.drop_empty_remainder()

        b32 = jnp.where(bnd, 0.0, 1.0).astype(jnp.float32) / (n * n)
        run_dia = jax.jit(lambda S, bb: banded_cg(S, bb, ITERS)[1])
        float(run_dia(S32, b32))  # warm
        t0 = time.time()
        float(run_dia(S32, b32))
        t_dia_iter = (time.time() - t0) / ITERS
        L = len(S32.G.offsets2d)
        RW = S32.G.shape2d[0] * S32.G.shape2d[1]
        dia_bytes = (L + 1) * RW * 4 + 10 * n_dofs * 4
        sink.put(gen10m_dia_cg_iters_per_s=round(1.0 / t_dia_iter, 2),
                 gen10m_dia_gbps=round(dia_bytes / t_dia_iter / 1e9, 1))


    # stage 5 (converged): ZERO-GATHER preconditioning — GridMG directly
    # on the (R, W) banded grid (ops/dia_split.BandedMGPreconditioner):
    # every V-cycle level is static slices. This is the flagship
    # converged path.
    rhs64 = jax.jit(
        lambda bnd: jnp.where(bnd, 0.0, 1.0).astype(jnp.float64) / (n * n)
    )(bnd)
    if W:
        @jax.jit
        def to_split64(E, bnd):
            S, _ = build_banded_split(E, W, amax=amax)
            F = S.fold_dirichlet(bnd)
            return F, F.G.data[0, 0, 0]

        S64, w64 = to_split64(E64, bnd)
        float(w64)
        if int(remnnz) == 0:
            S64 = S64.drop_empty_remainder()

        @jax.jit
        def true_rel_dia(S, xx, b):
            res = b - S @ xx
            return jnp.sqrt(jnp.sum(res * res) / jnp.sum(b * b))

        from fdapde_core_tpu.ops.dia_split import BandedMGPreconditioner

        t0 = time.time()
        bmg = BandedMGPreconditioner.build(S32)
        if bmg is not None:
            float(jax.jit(lambda d: d[0, 0, 0])(bmg.mg.datas[-1]))
            sink.put(gen10m_bmg_setup_s=round(time.time() - t0, 3),
                     gen10m_bmg_levels=bmg.mg.n_levels)
            pre_bmg = jax.tree_util.Partial(_aux_cast_pre, bmg)
            xb, info_b = cg_chunked(S64, rhs64, M_inv=pre_bmg, rtol=1e-9,
                                    maxiter=100, chunk=4 * CH)
            float(true_rel_dia(S64, xb, rhs64))  # warm
            t0 = time.time()
            xb, info_b = cg_chunked(S64, rhs64, M_inv=pre_bmg, rtol=1e-9,
                                    maxiter=100, chunk=4 * CH)
            relb = float(true_rel_dia(S64, xb, rhs64))
            sink.put(gen10m_bmg_converged_solve_s=round(time.time() - t0, 3),
                     gen10m_bmg_converged_iters=int(info_b.iterations),
                     gen10m_bmg_converged_true_rel_res=relb)
            # free the Poisson f64 forms before the advdiff build: the
            # free E64 + S64 before the advdiff operator and its
            # conversion transients are built
            del S64, E64, xb, info_b

            # stage 6: NON-SYMMETRIC at flagship scale:
            # tensor-K advection-diffusion-reaction on the SAME mesh —
            # shared adjacency (no re-argsort), shared split plan, shared
            # to_split/cast programs (identical shapes -> jit cache hits),
            # POISSON BandedMG as preconditioner (the SPD part dominates),
            # chunked BiCGStab, f64 true residual.
            # Envelope anchor: fem_assembler.h:63-118 any-weak-form
            # assembly + BiCGStab replacing SparseLU at a scale Eigen
            # cannot factorize (operators/advection.h:33-56).
            t0 = time.time()

            @jax.jit
            def build_adv(x, y, c0, c1, c2):
                C = c0.shape[0]

                def cc(v):
                    return jnp.full((C,), v, jnp.float64)

                sd, wadv, r = p1_general_soa(
                    x, y, c0, c1, c2,
                    kxx=cc(1.3), kxy=cc(0.2), kyy=cc(0.9),
                    bx=cc(1.0), by=cc(0.5), react=cc(0.3),
                )
                return sd, wadv, r, sd[0, 0]

            sd, wadv, ra, wsd = build_adv(x, y, c0, c1, c2)
            float(wsd)
            op_adv = MatrixFreeSoA(sd, c, adj, mask8, n_dofs, w=wadv, r=ra)
            E_adv64, overa = ell_from_op_blocked(
                op_adv, MAXC, blocks=8 if not small else 2)
            Sa64, wa = to_split64(E_adv64, bnd)  # cached program
            float(wa)
            # the advection pattern matches Poisson's: same rem state
            if int(remnnz) == 0:
                Sa64 = Sa64.drop_empty_remainder()
            sink.put(gen10m_advdiff_setup_s=round(time.time() - t0, 2),
                     gen10m_advdiff_overflow=int(overa))

            xa, info_a = bicgstab_chunked(
                Sa64, rhs64, M_inv=pre_bmg, rtol=1e-9, maxiter=100,
                chunk=2 * CH)
            float(true_rel_dia(Sa64, xa, rhs64))  # warm
            t0 = time.time()
            xa, info_a = bicgstab_chunked(
                Sa64, rhs64, M_inv=pre_bmg, rtol=1e-9, maxiter=100,
                chunk=2 * CH)
            rela = float(true_rel_dia(Sa64, xa, rhs64))
            sink.put(gen10m_advdiff_solve_s=round(time.time() - t0, 3),
                     gen10m_advdiff_iters=int(info_a.iterations),
                     gen10m_advdiff_true_rel_res=rela)
            del (op_adv, E_adv64, Sa64, sd, wadv, ra, x, y, c, S32, bmg,
                 pre_bmg)

    # raw-ELL CG rate (the XLA flat-gather honesty baseline; see note
    # at the conversion stage above)
    sys_ell = DirichletSystem(E32, bnd)
    cg_chunked(sys_ell, rhs32, rtol=0.0, maxiter=ITERS_ELL, chunk=CH)  # warm
    t0 = time.time()
    cg_chunked(sys_ell, rhs32, rtol=0.0, maxiter=ITERS_ELL, chunk=CH)
    t_iter = (time.time() - t0) / ITERS_ELL
    # bytes model: vals+cols+gathered x per nonzero + ~10 vector passes
    ell_bytes = (MAXC * 12 + 10 * 4) * n_dofs
    sink.put(gen10m_ell_cg_iters_per_s=round(1.0 / t_iter, 2),
             gen10m_ell_gbps=round(ell_bytes / t_iter / 1e9, 1))
    del sys_ell

    # stage 7 (full only): PRODUCT-API general elliptic at 1M+ dofs —
    # the same operator family through models/matfree.MatrixFreeElliptic
    # (fused constructor: ONE assembly+adjacency+ELL program, ONE plan
    # probe, ONE split+fold+coarsen program — SURVEY §5.4 setup cut).
    if not small:
        del adj, mask8
        from fdapde_core_tpu.models.matfree import MatrixFreeElliptic

        n1 = 1024  # 1.05M dofs, 2.1M cells
        t0 = time.time()
        x1, y1, c01, c11, c21, bnd1 = jax.jit(
            lambda amp: irregular_mesh_device_soa(n1, amp, dtype=jnp.float64)
        )(jnp.float64(0.2))
        cells1 = jax.jit(
            lambda a, b_, c_: jnp.stack([a, b_, c_], axis=1)
        )(c01, c11, c21)
        model = MatrixFreeElliptic(
            (x1, y1), cells1, bnd1,
            K=(1.3, 0.2, 0.9), b=(1.0, 0.5), c=0.3,
            split_plan=(n1 + 1, 1),  # the lattice numbering's known plan
        )
        sink.put(gen1m_advdiff_setup_s=round(time.time() - t0, 2),
                 gen1m_n_dofs=int(model.n_dofs))

        C1 = 2 * n1 * n1
        b1 = model.load_vector(jnp.ones(C1, jnp.float64))
        xs, it1, rel1 = model.solve(b1, rtol=1e-9, maxiter=200, chunk=CH)
        float(rel1)  # warm
        t0 = time.time()
        xs, it1, rel1 = model.solve(b1, rtol=1e-9, maxiter=200, chunk=CH)
        sink.put(gen1m_advdiff_solve_s=round(time.time() - t0, 2),
                 gen1m_advdiff_iters=int(it1),
                 gen1m_advdiff_true_rel_res=float(rel1))

    sink.put(gen10m_section_s=round(time.time() - t_sec, 1))



def _genp2_metrics(small, sink):
    """P2 at device scale, as its OWN group. Order-2 space on a genuine Delaunay
    topology -> ~2.1M dofs (nodes + edges). The P2 dof numbering (nodes
    first, then edges; lagrangian_basis.h:94-136 parity order) has a
    SPREAD offset histogram — plan_split_width rejects it and the model
    runs the gather + aux-grid path: the honest P2-at-scale story."""
    import numpy as np
    import jax.numpy as jnp
    from scipy.spatial import Delaunay

    from fdapde_core_tpu.fem.space import FEMSpace
    from fdapde_core_tpu.geometry.triangulation import Triangulation
    from fdapde_core_tpu.models.matfree import MatrixFreeElliptic

    t_sec = time.time()
    nx = 64 if small else 720  # (nx+1)^2 nodes: ~4.2k small, ~0.52M full
    rng = np.random.default_rng(7)
    ii, jj = np.meshgrid(np.arange(nx + 1), np.arange(nx + 1),
                         indexing="ij")
    pts = np.stack([ii, jj], axis=-1).reshape(-1, 2).astype(np.float64)
    interior = (
        (pts[:, 0] > 0) & (pts[:, 0] < nx)
        & (pts[:, 1] > 0) & (pts[:, 1] < nx)
    )
    pts[interior] += rng.uniform(-0.35, 0.35, size=(interior.sum(), 2))
    pts /= nx
    tri = Delaunay(pts)
    cells = tri.simplices.astype(np.int32)
    n = pts.shape[0]

    t0 = time.time()
    bdry = np.zeros(n, bool)
    bdry[~interior] = True
    mesh2 = Triangulation(pts, cells, bdry)
    space = FEMSpace(mesh2, order=2)
    t_host = time.time() - t0
    t0 = time.time()
    model = MatrixFreeElliptic.from_space(
        space, K=1.0, c=1.0, max_degree=16,
    )
    sink.put(gen_p2_n_dofs=int(model.n_dofs),
             gen_p2_host_s=round(t_host, 2),
             gen_p2_setup_s=round(time.time() - t0, 2),
             gen_p2_preconditioner=model.preconditioner)
    fC = jnp.ones((int(cells.shape[0]),), jnp.float64)
    b2 = model.load_vector(fC)
    # COLD first: the witness survives a budget stop. Progress puts at
    # chunk boundaries: the budget check fires INSIDE the long solve, so
    # a spent budget exits rc=4 cleanly instead of at the parent's cap.
    prog = lambda k, r: sink.put(gen_p2_progress_iters=int(k))  # noqa: E731
    t0 = time.time()
    xs, it2, rel2 = model.solve(b2, rtol=1e-8, maxiter=200, chunk=6,
                                on_chunk=prog)
    sink.put(gen_p2_solve_cold_s=round(time.time() - t0, 2),
             gen_p2_iters=int(it2),
             gen_p2_true_rel_res=float(rel2))
    remaining = ((sink.budget - (time.time() - sink.t0))
                 if sink.budget else 1e9)
    if remaining > 100:  # warm rerun only with budget left
        t0 = time.time()
        xs, it2, rel2 = model.solve(b2, rtol=1e-8, maxiter=200, chunk=6,
                                    on_chunk=prog)
        sink.put(gen_p2_solve_s=round(time.time() - t0, 2))
    sink.put(genp2_section_s=round(time.time() - t_sec, 1))



def _gendel_metrics(small, sink):
    """Genuinely VARIABLE-DEGREE topology at device scale: a small host
    Delaunay base (jittered grid, ragged degree histogram, ~3 MB) is
    uploaded, red-refined on device to ~5.1M dofs
    (geometry/refine_device.py — base-vertex degrees preserved
    verbatim), renumbered by device strip-quantile ordering
    (bandwidth-bounded without shipping a host permutation), and run
    through the full product path: SoA assembly, blocked ELL, split-plan
    rejection, ELL gather SpMV, aux-grid preconditioner, f64 CONVERGED
    solve.
    Anchor: fem_assembler.h:79-110 (topology-blind cell loop),
    fem_linear_elliptic_solver.h:38-47 (solve on ANY assembled mesh)."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from scipy.spatial import Delaunay

    from fdapde_core_tpu.fem.solvers import DirichletSystem
    from fdapde_core_tpu.geometry.refine_device import (
        strip_order_binned,
        uniform_refine_device,
    )
    from fdapde_core_tpu.linear_algebra.solvers import cg_chunked
    from fdapde_core_tpu.models.matfree import _general_solve_fn
    from fdapde_core_tpu.ops.auxgrid import AuxGridPreconditioner
    from fdapde_core_tpu.ops.dia_split import plan_split_width
    from fdapde_core_tpu.ops.matfree_soa import (
        MatrixFreeSoA,
        ell_from_op_blocked,
    )

    t_sec = time.time()
    nx = 16 if small else 283  # base ~(nx+1)^2 nodes; 3 levels -> ~5.1M
    LEVELS = 2 if small else 3
    rng = np.random.default_rng(11)
    ii, jj = np.meshgrid(np.arange(nx + 1), np.arange(nx + 1),
                         indexing="ij")
    pts = np.stack([ii, jj], axis=-1).reshape(-1, 2).astype(np.float64)
    interior = (
        (pts[:, 0] > 0) & (pts[:, 0] < nx)
        & (pts[:, 1] > 0) & (pts[:, 1] < nx)
    )
    pts[interior] += rng.uniform(-0.35, 0.35, size=(interior.sum(), 2))
    pts /= nx
    cells = Delaunay(pts).simplices.astype(np.int32)
    bdry0 = ~interior

    t0 = time.time()
    x = jnp.asarray(pts[:, 0])
    y = jnp.asarray(pts[:, 1])
    c0 = jnp.asarray(cells[:, 0])
    c1 = jnp.asarray(cells[:, 1])
    c2 = jnp.asarray(cells[:, 2])
    bnd = jnp.asarray(bdry0)
    jax.block_until_ready(c2)
    sink.put(gendel_upload_s=round(time.time() - t0, 2),
             gendel_base_nodes=int(pts.shape[0]),
             gendel_base_cells=int(cells.shape[0]))

    t0 = time.time()
    x, y, c0, c1, c2, bnd = uniform_refine_device(
        x, y, c0, c1, c2, bnd, LEVELS)
    nd = x.shape[0]
    sink.put(gendel_refine_s=round(time.time() - t0, 2),
             gendel_n_dofs=nd, gendel_n_cells=int(c0.shape[0]))

    POP = 64 if small else 5000  # strip population: bandwidth ~2.5*POP
    t0 = time.time()
    order, rank = strip_order_binned(x, y, POP)

    # ONE fused permute program
    @jax.jit
    def permute_all(x, y, bnd, c0, c1, c2, order, rank):
        return (x[order], y[order], bnd[order], rank[c0], rank[c1],
                rank[c2])

    x, y, bnd, c0, c1, c2 = permute_all(x, y, bnd, c0, c1, c2, order,
                                        rank)
    jax.block_until_ready(c2)
    sink.put(gendel_reorder_s=round(time.time() - t0, 2))

    MAXDEG = 12  # planar max cell-degree measured 9; 24 paid a
    # (24, n) adjacency table for nothing
    t0 = time.time()

    @jax.jit
    def build(x, y, c0, c1, c2):
        op, over = MatrixFreeSoA.build(x, y, c0, c1, c2, nd, MAXDEG)
        deg = op.adj_mask.sum(axis=0).astype(jnp.int32)
        return op, over, jnp.bincount(deg, length=MAXDEG + 1)

    op64, over, deghist = build(x, y, c0, c1, c2)
    hist = np.asarray(deghist)
    assert not bool(over)
    maxdeg = int(np.nonzero(hist)[0].max())
    sink.put(gendel_build_s=round(time.time() - t0, 2),
             gendel_max_degree=maxdeg,
             gendel_degree_hist=[int(v) for v in hist[:maxdeg + 1]])

    MAXC = maxdeg + 2  # distinct columns per row <= 1 + max neighbors;
    # cell-incidence degree bounds neighbor count on planar meshes
    t0 = time.time()
    E64, overe = ell_from_op_blocked(op64, MAXC, blocks=2)
    int(overe)
    assert not bool(overe)
    sink.put(gendel_ell_convert_s=round(time.time() - t0, 2))
    del op64

    E32 = jax.jit(lambda E_: E_.astype(jnp.float32))(E64)
    i_r = jnp.arange(nd, dtype=jnp.int32)
    bw = int(jax.jit(
        lambda c_: jnp.max(jnp.abs(c_ - i_r[None, :])))(E32.cols))
    Wp, _am = plan_split_width(E32, bcap=16384)
    sink.put(gendel_bandwidth=bw, gendel_plan_W=int(Wp or 0))

    rhs32 = jax.jit(
        lambda b_: jnp.where(b_, 0.0, 1.0).astype(jnp.float32) / nd
    )(bnd)
    sys_e = DirichletSystem(E32, bnd)
    ITERS = 40 if small else 20
    cg_chunked(sys_e, rhs32, rtol=0.0, maxiter=ITERS, chunk=10)
    t0 = time.time()
    cg_chunked(sys_e, rhs32, rtol=0.0, maxiter=ITERS, chunk=10)
    sink.put(gendel_ell_cg_iters_per_s=round(
        ITERS / (time.time() - t0), 2))

    t0 = time.time()
    diag32 = jax.jit(
        lambda E_, b_: DirichletSystem(E_, b_).diagonal()
    )(E32, bnd)
    aux = AuxGridPreconditioner.build_device((x, y), diag32)
    float(aux.dinv[0])
    sink.put(gendel_aux_build_s=round(time.time() - t0, 2))

    # converged solve: f64 ELL + CG vectors, f32 aux-grid V-cycle (the
    # MatrixFreeElliptic.solve program)
    rhs64 = jax.jit(
        lambda b_: jnp.where(b_, 0.0, 1.0).astype(jnp.float64) / nd
    )(bnd)
    run = _general_solve_fn(1e-8, 400, True)
    t0 = time.time()
    xs, its, rel = run(E64, bnd, aux, rhs64, jnp.zeros_like(rhs64))
    sink.put(gendel_converged_cold_s=round(time.time() - t0, 2),
             gendel_converged_iters=int(its),
             gendel_converged_true_rel_res=float(rel))
    t0 = time.time()
    xs, its, rel = run(E64, bnd, aux, rhs64, jnp.zeros_like(rhs64))
    float(rel)
    sink.put(gendel_converged_warm_s=round(time.time() - t0, 2),
             gendel_section_s=round(time.time() - t_sec, 1))


def _genscat_metrics(small, sink):
    """SCATTERED-numbering group: rebuilds the operator in f64 (mesh +
    local assembly + adjacency + blocked ELL), permutes it into the class
    plan_split_width rejects, and runs the scattered control.
    A block-local multiplicative scramble applied SYMMETRICALLY spreads
    the offset histogram across the whole +-(B + 2S) band — the class
    plan_split_width rejects and an imported mesh lands in after RCM.
    Permutation similarity: same spectrum, only gather locality changes.
    The converged solve is the Eigen-SparseLU any-topology envelope
    (fem_linear_elliptic_solver.h:38-47) on the numbering the banded
    split rejects."""
    import jax
    import jax.numpy as jnp

    from fdapde_core_tpu.geometry.structured import irregular_mesh_device_soa
    from fdapde_core_tpu.ops.matfree_soa import (
        MatrixFreeSoA,
        build_adjacency_soa,
        ell_from_op_blocked,
        p1_offdiag_soa,
    )

    t_sec = time.time()
    n = 256 if small else 3200
    n_dofs = (n + 1) ** 2
    MAXC = 9
    CH = 4
    sink.put(genscat_n_dofs=n_dofs)

    @jax.jit
    def build(amp):
        x, y, c0, c1, c2, bnd = irregular_mesh_device_soa(
            n, amp, dtype=jnp.float64)
        s01, s02, s12 = p1_offdiag_soa(x, y, c0, c1, c2)
        s = jnp.stack([s01, s02, s12])  # f64: the refinement reference
        c = jnp.stack([c0, c1, c2])
        adj, mask, over = build_adjacency_soa(
            c.reshape(-1), n_dofs, 8)
        # lumped mass (row-sum, lumping.h:30 semantics): parabolic stage
        area3 = 0.5 * jnp.abs(
            (x[c1] - x[c0]) * (y[c2] - y[c0])
            - (x[c2] - x[c0]) * (y[c1] - y[c0])) / 3.0
        ml = jnp.zeros(n_dofs, x.dtype)
        for cc in (c0, c1, c2):
            ml = ml.at[cc].add(area3)
        return x, y, s, c, adj, mask, bnd, ml, over.astype(jnp.int32)

    t0 = time.time()
    x, y, s, c, adj, mask8, bnd, ml, over = build(jnp.float64(0.2))
    int(over)
    # single invocation: a one-time setup stage, compile included
    sink.put(genscat_build_cold_s=round(time.time() - t0, 3))

    op64 = MatrixFreeSoA(s, c, adj, mask8, n_dofs)
    t0 = time.time()
    E64, overe = ell_from_op_blocked(op64, MAXC, blocks=8 if not small
                                     else 2)
    int(overe)
    sink.put(genscat_ell_convert_s=round(time.time() - t0, 3))
    del op64, s, c, adj, mask8

    box = [E64]
    del E64
    _scattered_control(sink, box, x, y, bnd, ml, n, n_dofs, MAXC, CH,
                       small)
    sink.put(genscat_section_s=round(time.time() - t_sec, 1))


def _scattered_control(sink, box, x, y, bnd, ml, n, n_dofs, MAXC, CH,
                       small):
    """Scattered-numbering control operator: the CONVERGED mixed-precision
    solve, the ELL CG rate and implicit-Euler stepping.

    p(i) = blk*S + (g * (i mod S) mod S) — a symmetric permutation
    similarity with block-local multiplicative scrambling: the offset
    histogram spreads over the whole +-(B + 2S) band (plan_split_width
    rejects it, asserted into the sink), CG spectra are identical to the
    lattice operator's."""
    import jax
    import jax.numpy as jnp

    from fdapde_core_tpu.fem.solvers import DirichletSystem
    from fdapde_core_tpu.linear_algebra.solvers import cg_chunked
    from fdapde_core_tpu.ops.dia_split import plan_split_width
    from fdapde_core_tpu.ops.matfree_soa import ELLSoA

    S = 512 if small else 4096
    G = 397 if small else 1361  # coprime to S (odd, not dividing 2^k)
    GI = pow(G, -1, S)
    ITERS_SC = 40 if small else 8

    nfull = (n_dofs // S) * S  # identity on the trailing partial block
    E64 = box.pop()  # sole owner: freed right after the permute

    @jax.jit
    def permute(E64, x, y, bnd, ml):
        def p(i):
            return jnp.where(i < nfull, (i // S) * S + (G * (i % S)) % S, i)

        def pinv(i):
            return jnp.where(i < nfull, (i // S) * S + (GI * (i % S)) % S, i)

        i = jnp.arange(n_dofs, dtype=jnp.int32)
        src = pinv(i)  # row i of the permuted operator = row pinv(i)
        vals_s = E64.vals[:, src]
        cols_s = p(E64.cols[:, src])
        rows = i[None, :]
        bw = jnp.max(jnp.abs(cols_s - rows))
        # f32 cast + solve vectors fused into the permute program
        bnd_p = bnd[src]
        rhs64 = jnp.where(bnd_p, 0.0, 1.0) / (n * n)
        return (vals_s, vals_s.astype(jnp.float32), cols_s, bnd_p,
                x[src], y[src], ml[src], rhs64,
                rhs64.astype(jnp.float32), bw)

    (vals64_s, vals32_s, cols_s, bnd_s, x_s, y_s, ml_s, rhs64, rhs_sc,
     bwd) = permute(E64, x, y, bnd, ml)
    Bsc = int(bwd)
    del E64
    E64_sc = ELLSoA(vals64_s, cols_s, (n_dofs, n_dofs))
    E_sc = ELLSoA(vals32_s, cols_s, (n_dofs, n_dofs))
    Wp, _amax = plan_split_width(E_sc, bcap=16384)
    sink.put(gen10m_scat_plan_W=int(Wp or 0), gen10m_scat_bandwidth=Bsc)

    from fdapde_core_tpu.models.matfree import _general_solve_fn
    from fdapde_core_tpu.ops.auxgrid import AuxGridPreconditioner

    t0 = time.time()
    diag32 = jax.jit(
        lambda E_, b_: DirichletSystem(E_, b_).diagonal()
    )(E_sc, bnd_s)
    aux = AuxGridPreconditioner.build_device((x_s, y_s), diag32)
    float(aux.dinv[0])
    sink.put(gen10m_scat_aux_build_s=round(time.time() - t0, 2))

    # CONVERGED scattered solve: f64 ELL + CG vectors, f32 aux-grid
    # V-cycle on the permuted coordinates (the MatrixFreeElliptic.solve
    # program); cold first, so the correctness witness lands in the sink
    run = _general_solve_fn(1e-8, 400, True)
    t0 = time.time()
    xs, its, rel = run(E64_sc, bnd_s, aux, rhs64, jnp.zeros_like(rhs64))
    sink.put(gen10m_scat_converged_cold_s=round(time.time() - t0, 2),
             gen10m_scat_converged_iters=int(its),
             gen10m_scat_converged_true_rel_res=float(rel))

    # fixed-iteration CG rate on the f32 ELL gather SpMV
    sys_e = DirichletSystem(E_sc, bnd_s)
    ITERS_E = ITERS_SC if small else 40
    cg_chunked(sys_e, rhs_sc, rtol=0.0, maxiter=ITERS_E, chunk=4 * CH)
    t0 = time.time()
    cg_chunked(sys_e, rhs_sc, rtol=0.0, maxiter=ITERS_E, chunk=4 * CH)
    t_it = (time.time() - t0) / ITERS_E
    sink.put(gen10m_scat_cg_iters_per_s=round(1.0 / t_it, 2),
             gen10m_scat_gbps=round(
                 (MAXC * 8 + 10 * 4) * n_dofs / t_it / 1e9, 1))

    # implicit-Euler stepping on the scattered topology: the system
    # S = A + M_lump/dt shares A's sparsity (only the diagonal slot
    # changes) — fem_linear_parabolic_solver.h:37-72 on the numbering the
    # banded split rejects. Warm-started chunked CG per step.
    dt_p = 1e-7  # ~h^2: both stiffness and mass terms contribute
    S32 = jax.jit(
        lambda E_, m_: E_.with_added_diagonal((m_ / dt_p).astype(
            jnp.float32))
    )(E_sc, ml_s)
    sys_p = DirichletSystem(S32, bnd_s)
    mdt32 = jax.jit(lambda m_: (m_ / dt_p).astype(jnp.float32))(ml_s)

    def run_steps(n_steps, u):
        tot = 0
        for _ in range(n_steps):
            rhs = jax.jit(
                lambda m_, u_, b_: jnp.where(b_, 0.0, m_ * u_ + 1.0)
            )(mdt32, u, bnd_s)
            u, info = cg_chunked(sys_p, rhs, x0=u, rtol=1e-6,
                                 maxiter=80, chunk=4 * CH)
            tot += int(info.iterations)
        return u, tot

    u0 = jnp.zeros(n_dofs, jnp.float32)
    u1, _ = run_steps(1, u0)  # warm the programs
    STEPS = 5
    t0 = time.time()
    uT, tot_it = run_steps(STEPS, u1)
    sink.put(gen10m_scat_parabolic_steps_per_s=round(
        STEPS / (time.time() - t0), 2),
             gen10m_scat_parabolic_iters_per_step=round(tot_it / STEPS, 1))


# --------------------------------------------------------------------------
# group: gen3d (3D arbitrary-topology SoA path — 2D gen10m's tet analogue)
# --------------------------------------------------------------------------


def _gen3d_metrics(small, sink):
    """3D general gather path: jittered Freudenthal tet mesh generated on
    device in SoA layouts, MatrixFreeSoA3D local assembly + adjacency,
    blocked ELL conversion, two-spacing banded DIA split (every flat
    offset a*m^2 + b*m + c a static 3D stencil shift), and a converged
    mixed-precision solve with the zero-gather BandedMGPreconditioner3D —
    the Eigen-SparseLU any-mesh envelope (fem_linear_elliptic_solver.h:
    38-47) in 3D at sizes Eigen cannot factorize."""
    import jax
    import jax.numpy as jnp

    from fdapde_core_tpu.fem.solvers import DirichletSystem
    from fdapde_core_tpu.geometry.structured import cube_mesh_device_soa
    from fdapde_core_tpu.linear_algebra.solvers import cg_chunked
    from fdapde_core_tpu.ops.dia_split3d import (
        BandedMGPreconditioner3D,
        build_banded_split_3d,
        plan_split_3d,
    )
    from fdapde_core_tpu.ops.matfree_soa import (
        MatrixFreeSoA3D,
        ell_from_op_blocked,
    )

    t_sec = time.time()
    n = 16 if small else 128  # 2.15M dofs / 12.6M tets at full size
    m = n + 1
    nd = m ** 3
    C = 6 * n ** 3
    ITERS = 10
    CH = 5 if not small else 10
    sink.put(gen3d_n_dofs=nd, gen3d_n_cells=C)

    # f64 mesh + assembly; the f32 throughput stages cast DOWN (the
    # gen10m convention)
    mesh_fn = jax.jit(
        lambda a: cube_mesh_device_soa(n, a, dtype=jnp.float64))
    parts = mesh_fn(jnp.float64(0.2))
    float(parts[0][0])
    t0 = time.time()
    parts = mesh_fn(jnp.float64(0.2))
    float(parts[0][0])
    sink.put(gen3d_mesh_s=round(time.time() - t0, 3))
    x, y, z, c0, c1, c2, c3, bnd = parts

    build_fn = jax.jit(
        lambda x, y, z, c0, c1, c2, c3: MatrixFreeSoA3D.build(
            x, y, z, c0, c1, c2, c3, nd, 24))
    op, over = build_fn(x, y, z, c0, c1, c2, c3)
    float(op.s[0][0])
    t0 = time.time()
    op, over = build_fn(x, y, z, c0, c1, c2, c3)
    float(op.s[0][0])
    sink.put(gen3d_local_assembly_s=round(time.time() - t0, 3),
             gen3d_adjacency_overflow=int(over))

    t0 = time.time()
    E64, overe = ell_from_op_blocked(op, 15, blocks=2 if small else 6)
    int(overe)
    sink.put(gen3d_ell_convert_s=round(time.time() - t0, 3),
             gen3d_ell_overflow=int(overe))
    E32 = jax.jit(lambda E: E.astype(jnp.float32))(E64)

    rhs32 = jax.jit(
        lambda bnd: jnp.where(bnd, 0.0, 1.0).astype(jnp.float32) / C)(bnd)

    t0 = time.time()
    W1, W2 = plan_split_3d(E32)
    sink.put(gen3d_dia_plan_s=round(time.time() - t0, 3),
             gen3d_W1=int(W1 or 0), gen3d_W2=int(W2 or 0))
    if not W1:
        sink.put(gen3d_section_s=round(time.time() - t_sec, 1))
        return

    @jax.jit
    def to_split(E, bnd):
        S, over = build_banded_split_3d(E, W1, W2)
        F = S.fold_dirichlet(bnd)
        return F, over.astype(jnp.int32), jnp.sum(F.rem.vals != 0.0)

    S32, overs, remnnz = to_split(E32, bnd)
    int(overs)
    t0 = time.time()
    S32, overs, remnnz = to_split(E32, bnd)
    int(overs)
    sink.put(gen3d_dia_split_s=round(time.time() - t0, 3),
             gen3d_rem_overflow=int(overs), gen3d_rem_nnz=int(remnnz))
    if int(remnnz) == 0:
        S32 = S32.drop_empty_remainder()

    sysd = DirichletSystem(S32, bnd)
    cg_chunked(sysd, rhs32, rtol=0.0, maxiter=2 * ITERS, chunk=ITERS)
    t0 = time.time()
    cg_chunked(sysd, rhs32, rtol=0.0, maxiter=2 * ITERS, chunk=ITERS)
    t_dit = (time.time() - t0) / (2 * ITERS)
    L = S32.G.data.shape[0]
    RW = 1
    for d in S32.G.shape3d:
        RW *= d
    sink.put(gen3d_dia_cg_iters_per_s=round(1.0 / t_dit, 2),
             gen3d_dia_gbps=round(((L + 1) * RW * 4 + 10 * nd * 4)
                                  / t_dit / 1e9, 1))
    # (the n=128 chunk program doubles as the rate stage warm-up for the
    # converged path below - no separate warm spend)

    S64, _, _ = jax.jit(to_split)(E64, bnd)
    if int(remnnz) == 0:
        S64 = S64.drop_empty_remainder()
    t0 = time.time()
    bmg = BandedMGPreconditioner3D.build(S32)
    if bmg is None:
        sink.put(gen3d_section_s=round(time.time() - t_sec, 1))
        return
    float(jax.jit(lambda d: d[0, 0, 0, 0])(bmg.mg.datas[-1]))
    sink.put(gen3d_bmg_setup_s=round(time.time() - t0, 3),
             gen3d_bmg_levels=bmg.mg.n_levels)

    rhs64 = jax.jit(
        lambda bnd: jnp.where(bnd, 0.0, 1.0).astype(jnp.float64) / C)(bnd)

    def pre(r):
        return bmg(r.astype(jnp.float32)).astype(r.dtype)

    from fdapde_core_tpu.linear_algebra.solvers import cg_split_programs

    sys64 = DirichletSystem(S64, bnd)
    rel_fn = jax.jit(
        lambda S, xx, b: jnp.sqrt(
            jnp.sum((b - S(xx)) ** 2) / jnp.sum(b * b)))
    # split-program PCG: the banded apply and the deep MG3D V-cycle run
    # as two small programs per iteration instead of one fused chunk
    t0 = time.time()
    x64, info = cg_split_programs(sys64, rhs64, pre, rtol=1e-9,
                                  maxiter=100, check_every=5)
    rel = float(rel_fn(sys64, x64, rhs64))
    # COLD first: the correctness witness survives a budget stop
    sink.put(gen3d_converged_cold_s=round(time.time() - t0, 3),
             gen3d_converged_iters=int(info.iterations),
             gen3d_converged_true_rel_res=rel)
    t0 = time.time()
    x64, info = cg_split_programs(sys64, rhs64, pre, rtol=1e-9,
                                  maxiter=100, check_every=5)
    rel = float(rel_fn(sys64, x64, rhs64))
    sink.put(gen3d_converged_solve_s=round(time.time() - t0, 3),
             gen3d_section_s=round(time.time() - t_sec, 1))


# --------------------------------------------------------------------------


def main():
    argv = sys.argv[1:]
    small = "--small" in argv
    if "--group" in argv:
        group = argv[argv.index("--group") + 1]
        out = argv[argv.index("--out") + 1] if "--out" in argv else None
        budget = (float(argv[argv.index("--budget") + 1])
                  if "--budget" in argv else None)
        child_main(group, small, out, budget)
    else:
        sys.exit(orchestrate(small))


if __name__ == "__main__":
    main()
