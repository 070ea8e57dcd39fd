"""Platform plumbing: the matmul-precision pin, the compile-cache location,
chip_smoke.py's refusal to run without a GPU, bench.py's reduction of a
profiler trace to device busy time, and (marker ``gpu``) checks that run
only on a card."""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent


def _cpu_env(**extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **extra)
    env.pop("XLA_FLAGS", None)
    return env


def test_import_pins_highest_without_starting_a_backend():
    code = ("import vio_tpu, jax\n"
            "from jax._src import xla_bridge\n"
            "print(jax.config.jax_default_matmul_precision,"
            " xla_bridge.backends_are_initialized())\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       env=_cpu_env(), capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-1500:]
    assert r.stdout.split() == ["highest", "False"]


@pytest.mark.parametrize("env_dir", [None, "cache_from_env"])
def test_compile_cache_dir(env_dir, tmp_path, monkeypatch):
    from vio_tpu import compile_cache

    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    sentinel = str(tmp_path / "untouched")
    jax.config.update("jax_compilation_cache_dir", sentinel)
    try:
        if env_dir is None:
            monkeypatch.delenv(compile_cache.ENV, raising=False)
            got = compile_cache.enable()
            assert got == str(ROOT / ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == got
        else:
            want = str(tmp_path / env_dir)
            monkeypatch.setenv(compile_cache.ENV, want)
            assert compile_cache.enable() == want
            # JAX reads the variable itself; the helper sets nothing
            assert jax.config.jax_compilation_cache_dir == sentinel
    finally:
        jax.config.update("jax_compilation_cache_dir", saved[0])
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          saved[1])


def test_chip_smoke_refuses_cpu():
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       env=_cpu_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "no GPU found" in r.stderr


def test_bench_refuses_cpu():
    r = subprocess.run([sys.executable, "bench.py"], cwd=ROOT,
                       env=_cpu_env(), capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0
    assert "no GPU found" in r.stderr


def test_busy_time_is_the_union_of_stream_intervals():
    import bench

    # two streams on GPU 0 overlap in [15, 20); the derived "XLA Ops" line
    # and the host plane must not count
    planes = [
        ("/device:GPU:0", [
            ("Stream #13(Compute)", [(0, 10), (15, 10), (40, 5)]),
            ("Stream #14(MemcpyH2D)", [(5, 2), (20, 10)]),
            ("XLA Ops", [(0, 100)]),
        ]),
        ("/host:CPU", [("python", [(0, 1000)])]),
    ]
    ivs = bench.device_intervals(planes)
    assert sorted(ivs) == [(0, 10), (5, 2), (15, 10), (20, 10), (40, 5)]
    # union: [0,10) + [15,30) + [40,45)
    assert bench.busy_ns(ivs) == 10 + 15 + 5
    assert bench.busy_ns([]) == 0


# ---------------------------------------------------------------------------
# On the card: JAX_PLATFORMS=cuda python -m pytest -m gpu tests/ -p no:xdist
# ---------------------------------------------------------------------------

@pytest.fixture
def gpu():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {dev.platform}")
    return dev


@pytest.mark.gpu
def test_gpu_float32_matmul_is_not_tf32(gpu):
    import vio_tpu  # noqa: F401

    rng = np.random.default_rng(0)
    a = rng.standard_normal((512, 512)).astype(np.float32)
    b = rng.standard_normal((512, 512)).astype(np.float32)
    got = np.asarray(jax.jit(jnp.matmul)(jnp.asarray(a), jnp.asarray(b)),
                     np.float64)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    # TF32 keeps 10 mantissa bits (~1e-3 relative); float32 ~1e-6
    assert np.abs(got - ref).max() / np.abs(ref).max() < 1e-5


@pytest.mark.gpu
def test_gpu_track_fb_recovers_shift(gpu):
    from vio_tpu.features import klt

    rng = np.random.default_rng(1)
    img0 = rng.standard_normal((640, 640)).astype(np.float32)
    for _ in range(2):
        img0 = (np.roll(img0, 1, 0) + np.roll(img0, -1, 0) +
                np.roll(img0, 1, 1) + np.roll(img0, -1, 1) + img0) / 5.0
    img0 = (img0 - img0.min()) / (img0.max() - img0.min()) * 255.0
    img1 = np.roll(img0, (2, 3), axis=(0, 1))
    pts = rng.uniform(40, 600, (150, 2)).astype(np.float32)
    p1, ok, _ = klt.track_fb(jnp.asarray(img0), jnp.asarray(img1),
                             jnp.asarray(pts), jnp.ones(150, bool))
    ok = np.asarray(ok)
    assert ok.mean() > 0.9
    d = np.abs(np.asarray(p1) - (pts + [3.0, 2.0]))[ok]
    assert (d.max(axis=1) < 0.05).mean() >= 0.95


@pytest.mark.gpu
def test_gpu_spd_solve_float32(gpu):
    from vio_tpu.ops import linsolve

    P = 171
    key = jax.random.PRNGKey(7)
    M = jax.random.normal(key, (P, P), jnp.float32)
    A = M @ M.T + P * jnp.eye(P, dtype=jnp.float32)
    b = jax.random.normal(key, (P,), jnp.float32)
    x = np.asarray(jax.jit(linsolve.spd_solve)(A, b), np.float64)
    A64, b64 = np.asarray(A, np.float64), np.asarray(b, np.float64)
    assert np.linalg.norm(A64 @ x - b64) / np.linalg.norm(b64) < 1e-5
