"""The damped pose solve (ops/linsolve.spd_solve): the direct route at the
window sizes the estimator uses, in the production float32, against a
numpy float64 solve of the same float32-rounded system; the Jacobi-PCG
route above P=1024; and the float64 path the CPU tests run."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vio_tpu.ops import linsolve


def _spd(key, P, dtype):
    M = jax.random.normal(key, (P, P), dtype)
    return M @ M.T + P * jnp.eye(P, dtype=dtype)


# P = 6 + 15 (W + 1): 171 is the W=10 window, 321 the W=20 window
@pytest.mark.parametrize("P", [17, 171, 321])
def test_spd_solve_float32_matches_float64(P):
    key = jax.random.PRNGKey(3 + P)
    A = _spd(key, P, jnp.float32)
    b = jax.random.normal(key, (P,), jnp.float32)
    x = linsolve.spd_solve(A, b)
    assert x.dtype == jnp.float32 and x.shape == (P,)
    A64 = np.asarray(A, np.float64)
    b64 = np.asarray(b, np.float64)
    ref = np.linalg.solve(A64, b64)
    x64 = np.asarray(x, np.float64)
    # float32 LU on a matrix with condition number ~10: a few ulps
    assert np.linalg.norm(A64 @ x64 - b64) / np.linalg.norm(b64) < 1e-5
    np.testing.assert_allclose(x64, ref, rtol=1e-4, atol=1e-5)


def test_spd_solve_large_routes_to_pcg(monkeypatch):
    from vio_tpu.solver import pcg
    calls = []
    real = pcg.pcg_solve

    def spy(A, b, *a, **k):
        calls.append(A.shape)
        return real(A, b, *a, **k)

    monkeypatch.setattr(pcg, "pcg_solve", spy)
    P = 1030
    key = jax.random.PRNGKey(11)
    A = _spd(key, P, jnp.float64)
    b = jax.random.normal(key, (P,), jnp.float64)
    x = linsolve.spd_solve(A, b)
    linsolve.spd_solve(A[:1024, :1024], b[:1024])
    assert calls == [(P, P)]
    assert x.shape == (P,)
    # PCG stops at ||r|| < 1e-6 ||b|| (pcg.pcg_solve rtol)
    r = np.linalg.norm(np.asarray(A @ x - b)) / np.linalg.norm(np.asarray(b))
    assert r < 1e-6, r


def test_spd_solve_fallback_f64():
    key = jax.random.PRNGKey(5)
    A = _spd(key, 40, jnp.float64)
    b = jax.random.normal(key, (40,), jnp.float64)
    x = linsolve.spd_solve(A, b)
    np.testing.assert_allclose(np.asarray(A @ x), np.asarray(b), atol=1e-9)
