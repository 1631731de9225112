"""Nothing chooses a solver path, a cache location or a result from the
platform it happens to run on, and the accelerator-only entry points
refuse the CPU instead of falling back to it."""

import os
import subprocess
import sys

import pytest

import jax

from poroelasticity_dealii_tpu.config import read_input_file
from poroelasticity_dealii_tpu.solvers.structured import (
    build_grid_discretization, mechanics_backend_name)
from poroelasticity_dealii_tpu.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def _paths():
    d3 = read_input_file("configs/consolidation_3d.data")
    d2 = read_input_file("configs/golden_2d.data")
    return [mechanics_backend_name(build_grid_discretization(
        data, cells_per_axis=n, multigrid="off"))
        for data, n in ((d3, 4), (d3, 18), (d2, 8), (d2, 140))]


@pytest.mark.parametrize("platform", ["gpu", "rocm"])
def test_auto_backend_ignores_platform(monkeypatch, platform):
    """'auto' picks the same mechanics path whatever the backend reports:
    conv below the size threshold, rows (3D) / parity (2D) above it."""
    here = _paths()
    assert here[0].startswith("conv") and here[2].startswith("conv")
    assert here[1].startswith("rows3d") and here[3].startswith("parity2d")
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert _paths() == here


def test_pallas_deck_value_is_rows_alias():
    data = read_input_file("configs/consolidation_3d.data")
    names = {eb: mechanics_backend_name(build_grid_discretization(
        data, cells_per_axis=4, multigrid="off", elasticity_backend=eb))
        for eb in ("pallas", "rows")}
    assert names["pallas"] == names["rows"]
    assert names["rows"].startswith("rows3d")
    with pytest.raises(NotImplementedError, match="3D Q2"):
        build_grid_discretization(read_input_file("configs/golden_2d.data"),
                                  cells_per_axis=4, elasticity_backend="rows")


def test_compile_cache_dir_follows_env(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/shared/cache")
    assert compile_cache.cache_dir() == "/some/shared/cache"
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert compile_cache.cache_dir() == os.path.join(ROOT, ".jax_cache")


@pytest.mark.parametrize("env_dir", [None, "set"])
def test_enable_compile_cache_in_fresh_process(tmp_path, env_dir):
    """A fresh process: with JAX_COMPILATION_CACHE_DIR set, the cache is
    there and nothing else is configured (a min-compile-time from the
    environment survives); unset, it is the checkout's fixed .jax_cache."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.pop("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", None)
    want = os.path.join(ROOT, ".jax_cache"), "1.0"
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cc")
        env["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"] = "7"
        want = str(tmp_path / "cc"), "7.0"
    code = ("import jax\n"
            "from poroelasticity_dealii_tpu.utils.compile_cache import "
            "enable_compile_cache\n"
            "enable_compile_cache()\n"
            "print(jax.config.jax_compilation_cache_dir)\n"
            "print(float("
            "jax.config.jax_persistent_cache_min_compile_time_secs))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split()
    assert tuple(out) == want


def test_chip_smoke_refuses_cpu_device():
    with pytest.raises(SystemExit):
        chip_smoke.require_gpu(1)


def test_chip_smoke_script_fails_without_gpu():
    """Run as a script on a host with no usable GPU: non-zero exit and no
    result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "FAILED" in proc.stderr
