"""Early pytest plugin: re-exec onto CPU JAX before capture/jax start.

Loaded via `addopts = "-p tests.force_cpu"` so it runs at initial plugin
import, before pytest's fd capture begins (a conftest re-exec would inherit
the capture temp file as stdout and appear silent).

Why a re-exec at all: JAX fixes its platform and the virtual device count
when it first initializes, and an interpreter started with another
JAX_PLATFORMS (e.g. on a GPU machine) may already have imported jax. Tests
need CPU (f64 + 8 virtual devices for the sharding tests).
"""

import os
import sys

_WANT = {
    "JAX_PLATFORMS": "cpu",
    "FDAPDE_TPU_X64": "1",
}


def _needs_reexec() -> bool:
    if os.environ.get("_FDAPDE_TEST_REEXEC") == "1":
        return False
    return os.environ.get("JAX_PLATFORMS", "cpu") != "cpu"


if _needs_reexec():
    env = dict(os.environ)
    env.update(_WANT)
    env["_FDAPDE_TEST_REEXEC"] = "1"
    flags = env.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        env["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    sys.stdout.flush()
    sys.stderr.flush()
    os.execve(
        sys.executable,
        [sys.executable, "-m", "pytest", *sys.argv[1:]],
        env,
    )
