"""3D general-path probe at device scale (SoA tet pipeline).

First hardware measurement of the 3D arbitrary-topology path: jittered
Freudenthal tet mesh generated ON DEVICE in SoA layouts
(geometry/structured.cube_mesh_device_soa), MatrixFreeSoA3D local
assembly + adjacency, blocked ELL conversion, 3D two-spacing banded
split (ops/dia_split3d) and a converged mixed-precision solve with the
zero-gather BandedMGPreconditioner3D. The 3D analogue of bench.py's
gen10m group (the Eigen-SparseLU any-mesh envelope,
fem_linear_elliptic_solver.h:38-47, in 3D beyond Eigen's RAM reach).

Run: timeout 900 python benchmarks/micro_gen3d.py [n]
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
os.environ["FDAPDE_TPU_X64"] = "1"  # f64 fine op for the converged stage

import jax

from fdapde_core_tpu.utils.compile_cache import enable_compile_cache

enable_compile_cache()
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

n = int(sys.argv[1]) if len(sys.argv) > 1 else 128
m = n + 1
nd = m ** 3
C = 6 * n ** 3
print(f"n={n}: {nd} dofs, {C} tets", flush=True)
out = {}


def put(**kw):
    out.update({k: (round(v, 4) if isinstance(v, float) and abs(v) >= 0.01
                    else v)
                for k, v in kw.items()})
    print(out, flush=True)


# mesh ON DEVICE (traced amp: a nullary jit would constant-fold the mesh)
mesh_fn = jax.jit(lambda a: cube_mesh_device_soa(n, a, dtype=jnp.float32))
parts = mesh_fn(jnp.float32(0.2))
float(parts[0][0])
t0 = time.time()
parts = mesh_fn(jnp.float32(0.2))
float(parts[0][0])
put(mesh_s=time.time() - t0)
x, y, z, c0, c1, c2, c3, bnd = parts

build_fn = jax.jit(
    lambda x, y, z, c0, c1, c2, c3: MatrixFreeSoA3D.build(
        x, y, z, c0, c1, c2, c3, nd, 24
    )
)
op, over = build_fn(x, y, z, c0, c1, c2, c3)
float(op.s[0][0])
t0 = time.time()
op, over = build_fn(x, y, z, c0, c1, c2, c3)
float(op.s[0][0])
put(local_assembly_s=time.time() - t0, adjacency_overflow=int(over))

t0 = time.time()
E64, overe = ell_from_op_blocked(op.astype(jnp.float64), 15, blocks=6)
int(overe)
put(ell_convert_s=time.time() - t0, ell_overflow=int(overe))
E32 = jax.jit(lambda E: E.astype(jnp.float32))(E64)

# fixed-iteration ELL gather CG rate
ITERS = 10
rhs32 = jax.jit(
    lambda bnd: jnp.where(bnd, 0.0, 1.0).astype(jnp.float32) / C
)(bnd)
sys32 = DirichletSystem(E32, bnd)
cg_chunked(sys32, rhs32, rtol=0.0, maxiter=ITERS, chunk=5)
t0 = time.time()
cg_chunked(sys32, rhs32, rtol=0.0, maxiter=ITERS, chunk=5)
put(ell_cg_iters_per_s=ITERS / (time.time() - t0))

# 3D two-spacing banded split: every flat offset a*m^2 + b*m + c becomes
# a static 3D stencil shift
t0 = time.time()
W1, W2 = plan_split_3d(E32)
put(dia_plan_s=time.time() - t0, W1=int(W1 or 0), W2=int(W2 or 0))
if W1:
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
    put(dia_split_s=time.time() - t0, rem_overflow=int(overs),
        rem_nnz=int(remnnz))
    if int(remnnz) == 0:
        S32 = S32.drop_empty_remainder()

    # fixed-iteration banded CG rate through the same chunked driver
    sysd = DirichletSystem(S32, bnd)
    cg_chunked(sysd, rhs32, rtol=0.0, maxiter=2 * ITERS, chunk=ITERS)
    t0 = time.time()
    cg_chunked(sysd, rhs32, rtol=0.0, maxiter=2 * ITERS, chunk=ITERS)
    put(dia_cg_iters_per_s=2 * ITERS / (time.time() - t0))

    # converged mixed-precision solve: f64 banded fine op + f32 MG3D
    S64, _, _ = jax.jit(to_split)(E64, bnd)
    if int(remnnz) == 0:
        S64 = S64.drop_empty_remainder()
    t0 = time.time()
    bmg = BandedMGPreconditioner3D.build(S32)
    assert bmg is not None
    float(jax.jit(lambda d: d[0, 0, 0, 0])(bmg.mg.datas[-1]))
    put(bmg_setup_s=time.time() - t0, bmg_levels=bmg.mg.n_levels)

    rhs64 = jax.jit(
        lambda bnd: jnp.where(bnd, 0.0, 1.0).astype(jnp.float64) / C
    )(bnd)

    def pre(r):
        return bmg(r.astype(jnp.float32)).astype(r.dtype)

    sys64 = DirichletSystem(S64, bnd)
    x64, info = cg_chunked(sys64, rhs64, M_inv=pre, rtol=1e-9,
                           maxiter=100, chunk=10)
    rel_fn = jax.jit(
        lambda S, xx, b: jnp.sqrt(
            jnp.sum((b - S(xx)) ** 2) / jnp.sum(b * b)
        )
    )
    float(rel_fn(sys64, x64, rhs64))
    t0 = time.time()
    x64, info = cg_chunked(sys64, rhs64, M_inv=pre, rtol=1e-9,
                           maxiter=100, chunk=10)
    rel = float(rel_fn(sys64, x64, rhs64))
    put(converged_solve_s=time.time() - t0, converged_iters=int(info.iterations),
        converged_true_rel_res=rel)

print("FINAL", out, flush=True)
