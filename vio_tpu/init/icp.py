"""Point-cloud alignment: SVD-Umeyama ICP and GN-on-SE3 refinement.

Re-derivation in JAX of the reference's ICP assignment
(reference: 05-frontend-feature-matching/04-icp/SVD.cpp:183 Umeyama
closed form, G-N.cpp:222 Gauss-Newton on SE3, incl. trajectory
alignment).  Known correspondences (the assignment aligns two
trajectories); closed-form solve is one batched SVD, GN is a fixed
iteration loop — both jittable.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..utils import lie


@jax.jit
def umeyama(src, dst, weights=None):
    """Closed-form rigid alignment: returns (R, t) with dst ≈ R·src + t.
    src/dst (N, 3); optional weights (N,)."""
    w = jnp.ones(src.shape[0], src.dtype) if weights is None else weights
    wsum = jnp.sum(w)
    mu_s = jnp.sum(src * w[:, None], axis=0) / wsum
    mu_d = jnp.sum(dst * w[:, None], axis=0) / wsum
    xs = src - mu_s
    xd = dst - mu_d
    cov = (xd * w[:, None]).T @ xs / wsum
    U, _, Vt = jnp.linalg.svd(cov)
    d = jnp.sign(jnp.linalg.det(U @ Vt))
    S = jnp.diag(jnp.asarray([1.0, 1.0, 1.0], src.dtype)).at[2, 2].set(d)
    R = U @ S @ Vt
    t = mu_d - R @ mu_s
    return R, t


@partial(jax.jit, static_argnames=("iters",))
def icp_gn(src, dst, R0, t0, weights=None, iters: int = 10):
    """Gauss-Newton refinement of (R, t) minimizing Σ‖dst − (R src + t)‖²
    with left-multiplicative SE3 updates (G-N.cpp:222)."""
    w = jnp.ones(src.shape[0], src.dtype) if weights is None else weights

    def body(_, carry):
        R, t = carry
        p = src @ R.T + t                       # (N, 3)
        r = p - dst
        # d r / d [dt, dθ] = [I, -hat(p)]
        J = jnp.concatenate(
            [jnp.broadcast_to(jnp.eye(3, dtype=src.dtype),
                              p.shape + (3,)).reshape(-1, 3, 3),
             -lie.so3_hat(p)], axis=-1)          # (N, 3, 6)
        Jw = J * w[:, None, None]
        H = jnp.einsum("nip,niq->pq", Jw, J) + 1e-9 * jnp.eye(6, dtype=src.dtype)
        b = -jnp.einsum("nip,ni->p", Jw, r)
        dx = jnp.linalg.solve(H, b)
        return lie.so3_exp_mat(dx[3:6]) @ R, t + dx[0:3]

    R, t = jax.lax.fori_loop(0, iters, body, (R0, t0))
    res = jnp.sqrt(jnp.mean(jnp.sum((src @ R.T + t - dst) ** 2, axis=-1)))
    return R, t, res
