"""chip_smoke.py on the CPU: its device check, and each phase function at a
tiny size called past that check (the full-size run needs a GPU:
`python chip_smoke.py`)."""

import json
import os

import numpy as np
import pytest

import chip_smoke


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit) as exc:
        chip_smoke.require_gpu()
    assert exc.value.code not in (0, None)
    assert "needs a GPU" in str(exc.value.code)


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_main_fails_without_gpu_and_prints_no_result(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main(argv)
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_phase_a_tiny():
    res = chip_smoke.phase_a(16)
    assert res["ok"], res
    assert res["n_dofs"] == 17 * 17
    assert res["true_rel_res"] <= chip_smoke.A_MAX_REL_RES
    assert res["preconditioner"] == "jacobi"  # below the auto threshold
    json.dumps(res)  # one JSON line per phase


def test_phase_b_tiny():
    res = chip_smoke.phase_b(32, parity_n=12, asm_reps=1)
    assert res["ok"], res
    assert res["n_dofs"] == 33 * 33
    assert res["parity_f64"] <= chip_smoke.B_MAX_PARITY_F64
    # the f32 operator differs from the f64 reference at f32 rounding
    assert 1e-9 < res["parity_f32_vs_f64_ref"] < 1e-5
    json.dumps(res)


def test_phase_c_tiny():
    res = chip_smoke.phase_c(48, scramble=(64, 13), copy_bytes=1 << 20)
    assert res["ok"], res
    assert res["preconditioner"] == "auxgrid"  # the banded split rejected it
    assert res["spmv_gbps"] > 0 and res["copy_gbps"] > 0
    json.dumps(res)


def test_scrambled_mesh_is_a_relabelling():
    """The block scramble permutes node ids only: same coordinates, same
    cells up to relabelling, ids outside full blocks unchanged."""
    import jax.numpy as jnp

    from fdapde_core_tpu.geometry.structured import irregular_mesh_device_soa

    n, S, G = 20, 64, 13
    x0, y0, *c_0, b0 = irregular_mesh_device_soa(n, 0.2, dtype=jnp.float64)
    x1, y1, *c_1, b1 = chip_smoke.scrambled_mesh(n, S=S, G=G)
    nd = (n + 1) ** 2
    i = np.arange(nd)
    nfull = (nd // S) * S
    p = np.where(i < nfull, (i // S) * S + (G * (i % S)) % S, i)
    assert sorted(p.tolist()) == list(range(nd))
    # coordinates: a jitted vs an eager evaluation of the same hash
    np.testing.assert_allclose(np.asarray(x1)[p], np.asarray(x0), atol=1e-9)
    np.testing.assert_allclose(np.asarray(y1)[p], np.asarray(y0), atol=1e-9)
    np.testing.assert_array_equal(np.asarray(b1)[p], np.asarray(b0))
    for a, b in zip(c_0, c_1):
        np.testing.assert_array_equal(p[np.asarray(a)], np.asarray(b))


def test_phase_d_tiny():
    """Every distributed path, 4 virtual devices against one."""
    res = chip_smoke.phase_d(4, n=8)
    assert res["ok"], res
    assert sorted(res["paths"]) == sorted(chip_smoke.D_PATHS)
    json.dumps(res)


@pytest.mark.gpu
def test_phase_b_on_gpu(gpu):
    """Structured flagship path, compiled for the card, at a real width."""
    res = chip_smoke.phase_b(1024, parity_n=256)
    assert res["ok"], res


def test_compile_cache_defaults_to_checkout(monkeypatch):
    import jax

    from fdapde_core_tpu.utils.compile_cache import CHECKOUT_ROOT, enable_compile_cache

    assert os.path.isfile(os.path.join(CHECKOUT_ROOT, "chip_smoke.py"))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(CHECKOUT_ROOT, ".jax_cache")
    before = jax.config.jax_compilation_cache_dir
    try:
        assert enable_compile_cache() == want
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_respects_env(tmp_path, monkeypatch):
    import jax

    from fdapde_core_tpu.utils.compile_cache import enable_compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
    before = jax.config.jax_compilation_cache_dir
    assert enable_compile_cache() == str(tmp_path / "env")
    assert jax.config.jax_compilation_cache_dir == before  # set nothing
