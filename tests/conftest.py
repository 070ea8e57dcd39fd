"""Test harness: CPU backend + float64 + persistent compile cache.

Tests run on the CPU in float64 unless JAX_PLATFORMS names another
platform: the tests marked ``gpu`` run on a card with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/ -p no:xdist`` and skip
elsewhere.

Multi-device tests (the virtual 8-device mesh) run in a SUBPROCESS with
XLA_FLAGS=--xla_force_host_platform_device_count=8 (tests/test_sharding.py)
— forcing 8 virtual devices globally on a small box has produced
segfaults inside XLA:CPU compilation when many programs compile in one
process.

The persistent compilation cache (vio_tpu/compile_cache.py) makes repeated
suite runs (and the estimator's big solver programs) compile once per
machine, not once per process."""
import os
import subprocess
import sys

import jax

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)

from vio_tpu import compile_cache  # noqa: E402

compile_cache.enable()

# Build the C++ pairing runtime up front so the async-pipeline parity test
# never silently skips on a fresh checkout.  Build
# failures are non-fatal here — the runtime tests then skip with a reason.
_root = os.path.join(os.path.dirname(__file__), "..")


def _native_fresh():
    import glob
    sos = glob.glob(os.path.join(_root, "vio_native*.so"))
    if not sos:
        return False
    src = os.path.join(_root, "native", "vio_native.cpp")
    return os.path.getmtime(sos[0]) >= os.path.getmtime(src)


if not _native_fresh():
    subprocess.run([sys.executable, os.path.join(_root, "native", "build.py")],
                   capture_output=True)


# ---------------------------------------------------------------------------
# Per-test wall-clock limits (a full-suite run once died ~45 min in with a
# faulthandler dump and no attribution).  SIGALRM turns
# a runaway test into a clean TimeoutError failure naming the test; the
# limits are far above healthy runtimes (fast tier ~seconds-to-2 min, slow
# tier ≤ ~10 min per test on this box).  Override per test with
# @pytest.mark.timeout_s(N).
# ---------------------------------------------------------------------------
import signal

import pytest

FAST_LIMIT_S = 600
SLOW_LIMIT_S = 1800


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "timeout_s(n): per-test wall-clock limit override")


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    mark = item.get_closest_marker("timeout_s")
    limit = (mark.args[0] if mark else
             SLOW_LIMIT_S if item.get_closest_marker("slow") else FAST_LIMIT_S)

    def _on_alarm(signum, frame):
        raise TimeoutError(
            f"{item.nodeid} exceeded the {limit}s per-test limit "
            f"(tests/conftest.py)")

    old = signal.signal(signal.SIGALRM, _on_alarm)
    signal.alarm(int(limit))
    try:
        return (yield)
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
