"""The engine options that remain, the compile-cache placement, and the GPU
requirement of the on-device scripts (chip_smoke.py, bench.py)."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

import trajopt_jax

ROOT = Path(__file__).resolve().parents[1]


def _ilqr(**kw):
    from trajopt_jax.parallel.mpc import make_ilqr_solver

    return make_ilqr_solver(trajopt_jax.make("Pendulum-TO-v0"), 8, **kw)


def _ilqr_batched(**kw):
    from trajopt_jax.parallel.mpc import make_ilqr_solver_batched

    return make_ilqr_solver_batched(trajopt_jax.make("Cartpole-TO-v0"), 8, **kw)


def _elqr(**kw):
    from trajopt_jax.parallel.elqr import make_elqr_solver_batched

    return make_elqr_solver_batched(trajopt_jax.make("Cartpole-TO-v0"), 8, **kw)


def _bsp_batched(**kw):
    from trajopt_jax.parallel.bsp import make_bsp_solver_batched

    return make_bsp_solver_batched(trajopt_jax.make("LightDark-TO-v0"), 8, **kw)


def _bsp_mpc(**kw):
    from trajopt_jax.parallel.bsp import make_bsp_mpc_runner

    return make_bsp_mpc_runner(trajopt_jax.make("LightDark-TO-v0"), 8, 2, **kw)


def _gps_batched(**kw):
    from trajopt_jax.parallel.gps import make_mbgps_solver_batched

    return make_mbgps_solver_batched(trajopt_jax.make("LQR-TO-v0"), 8, **kw)


def _rgps(**kw):
    from trajopt_jax.parallel.rgps import make_rgps_solver

    return make_rgps_solver(trajopt_jax.make("LQR-TO-v1"), 8, **kw)


@pytest.mark.parametrize(
    "build,option,value,remaining",
    [
        (_ilqr, "backward", "pallas-pscan", "'scan', 'pscan'"),
        (_ilqr_batched, "backward", "pallas-fused", "'scan', 'pallas'"),
        (_ilqr_batched, "rollout", "pallas-fused", "'scan', 'pallas'"),
        (_elqr, "engine", "pallas", "'scan'"),
        (_elqr, "engine", "pallas-fused", "'scan'"),
        (_elqr, "engine", "auto", "'scan'"),
        (_bsp_batched, "engine", "pallas", "'scan'"),
        (_bsp_mpc, "engine", "pallas", "'scan'"),
        (_bsp_mpc, "engine", "auto", "'scan'"),
        (_gps_batched, "engine", "pallas", "'scan'"),
        (_rgps, "fp_engine", "pallas", "'scan'"),
        (_rgps, "fp_engine", "auto", "'scan'"),
    ],
)
def test_removed_engine_raises(build, option, value, remaining):
    """Naming an engine that no longer exists fails at build time and says
    which engines remain."""
    with pytest.raises(ValueError, match=f"available: {remaining}"):
        build(**{option: value})


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_follows_env_var(monkeypatch, tmp_path, restore_cache_dir):
    """With JAX_COMPILATION_CACHE_DIR set, the helper sets no directory of its
    own (JAX reads the variable itself)."""
    from trajopt_jax.utils.compile_cache import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch, restore_cache_dir):
    """Without the variable the cache is the fixed, gitignored .jax_cache/ at
    the checkout root."""
    from trajopt_jax.utils.compile_cache import enable_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = enable_compile_cache()
    assert path == str(ROOT / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


def _run_on_cpu(script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run(
        [sys.executable, str(ROOT / script)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_chip_smoke_fails_without_gpu():
    """No GPU: non-zero exit and no result line."""
    out = _run_on_cpu("chip_smoke.py")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr


def test_bench_refuses_non_gpu_device():
    """The benchmark measures the GPU or nothing: no CPU fallback."""
    out = _run_on_cpu("bench.py")
    assert out.returncode != 0
    assert "metric" not in out.stdout
    assert "no GPU" in out.stderr
