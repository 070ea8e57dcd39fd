"""Jacobi-preconditioned conjugate gradients for the reduced camera system.

Re-derivation of the reference's PCGSolver
(reference: vins-mono/src/backend/problem.cc:580-610 — Jacobi
preconditioner, stop at ‖r‖ < 1e-6·‖r0‖ or n iterations).  This is the
*scalable* pose solve: the matvec is one GEMM, so for the
large-window / multi-host configs (BASELINE.json: 200-1000 keyframes) the
reduced system can stay block-partitioned over the mesh, with the matvec
psum-reduced — CG never materializes a factorization.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("max_iter",))
def pcg_solve(H, b, max_iter: int = 0, rtol: float = 1e-6):
    """Solve H x = b (H SPD) with Jacobi-PCG.  max_iter=0 → 2·dim like the
    reference's default (problem.cc:445)."""
    n = b.shape[0]
    iters = max_iter if max_iter > 0 else 2 * n
    Minv = jnp.where(jnp.abs(jnp.diagonal(H)) > 1e-30,
                     1.0 / jnp.diagonal(H), 0.0)

    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = Minv * r0
    p0 = z0
    rz0 = jnp.dot(r0, z0)
    thresh = rtol * jnp.linalg.norm(b)

    def cond(c):
        x, r, p, rz, k = c
        return jnp.logical_and(k < iters, jnp.linalg.norm(r) > thresh)

    def body(c):
        x, r, p, rz, k = c
        Hp = H @ p
        alpha = rz / jnp.maximum(jnp.dot(p, Hp), 1e-300)
        x = x + alpha * p
        r = r - alpha * Hp
        z = Minv * r
        rz_new = jnp.dot(r, z)
        beta = rz_new / jnp.maximum(rz, 1e-300)
        p = z + beta * p
        return x, r, p, rz_new, k + 1

    x, r, p, rz, k = jax.lax.while_loop(cond, body, (x0, r0, p0, rz0, 0))
    return x, k
