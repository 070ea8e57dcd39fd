"""Small dense SPD solve for the damped reduced camera system.

The reference solves its damped reduced camera system with Eigen's LDLT
(reference: vins-mono/src/backend/problem.cc:439 ``H.ldlt().solve(b)``).
Every system solved here is SPD by construction (J^T W J + lambda*I with
lambda >= 1e-5 * max|diag|, problem.cc:434-436), so the direct route is a
Cholesky factorization.  Its accuracy does not depend on how the rows are
scaled, and this system is badly scaled: the IMU bias blocks carry ~1e8
times the information of the pose blocks.  An LU with partial pivoting
(``jnp.linalg.solve``) picks pivots by magnitude instead, and in float32
it stalls the LM at a chi2 floor some 400 times the optimum.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import jax.scipy.linalg


def spd_solve(A: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Solve the SPD system ``A x = b`` (A: (P, P), b: (P,)).

    Systems up to P=1024 use a Cholesky solve.  Beyond that (the
    200-1000-keyframe global-BA configs, BASELINE.json north star) they
    route through Jacobi-PCG (solver/pcg.py), whose matvec is one GEMM per
    iteration and stays sharded under GSPMD (reference's own scalable
    path: problem.cc:580-610 PCGSolver).

    A system whose gauge directions carry only a small damping can be
    indefinite after float32 rounding; its factorization breaks down and
    the result is NaN.  The LM loops treat a non-finite step as a rejected
    one and raise the damping, as Ceres does when its linear solver fails.
    An LU answer to such a system is finite but poor, and accepting it
    stalls the LM at the chi2 floor described above.
    """
    P = A.shape[0]
    if P > 1024:
        from ..solver.pcg import pcg_solve
        x, _ = pcg_solve(A, b)
        return x
    return jax.scipy.linalg.cho_solve(jax.scipy.linalg.cho_factor(A), b)
