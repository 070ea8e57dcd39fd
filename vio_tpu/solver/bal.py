"""Large-scale bundle adjustment in BAL form (cameras + XYZ points).

Capability parity with the reference's BAL-g2o assignment
(reference: 07-backend-optimization/01-bal-g2o/src/bal_g2o.cpp:67-216 —
9-param BAL cameras [angle-axis R, t, f, k1, k2], XYZ landmarks, analytic
Jacobians, Schur over points), re-designed as batched device code:

- States are SoA pytrees: camera quaternions/translations/intrinsics
  stacked ``(C, ·)``, points ``(M, 3)``.
- Observations are a flat static-shape batch ``(O,)`` with (cam, point)
  indices and a validity mask; residual+Jacobian for every observation is
  one ``vmap`` (fwd-mode Jacobian of the 2-vector residual — 12 columns).
- The normal equations are built with ``segment_sum`` scatter-adds into
  block form: dense camera Hessian ``(9C, 9C)`` via one GEMM over the
  row-stacked observation Jacobians, per-point 3x3 blocks, and the
  camera-point coupling as a dense ``(C, M, 9, 3)`` block tensor (BAL
  problems have C << M; the tensor feeds the Schur GEMMs).
- Schur: batched 3x3 point-block inverse -> reduced camera system ->
  damped solve (ops/linsolve.spd_solve) -> back-substitution,
  all inside one jitted Nielsen-LM ``lax.while_loop``.

BAL convention: P = R X + t, p = -P_xy / P_z, r(p) = 1 + k1|p|^2 + k2|p|^4,
predicted = f * r(p) * p  (bal_g2o.cpp projection / BAL docs).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import lie
from . import blockba


class BalProblem(NamedTuple):
    cam_q: jnp.ndarray    # (C, 4) world->cam rotation quaternion
    cam_t: jnp.ndarray    # (C, 3)
    cam_fkk: jnp.ndarray  # (C, 3) [f, k1, k2]
    points: jnp.ndarray   # (M, 3)
    cam_idx: jnp.ndarray  # (O,) int32
    pt_idx: jnp.ndarray   # (O,) int32
    uv: jnp.ndarray       # (O, 2)
    valid: jnp.ndarray    # (O,) bool


def load_bal(path: str, dtype=jnp.float64) -> BalProblem:
    """Read the BAL text format (num_cams num_points num_obs; obs lines;
    then 9 params per camera [Rodrigues(3), t(3), f, k1, k2]; 3 per point)."""
    with open(path) as fh:
        tokens = fh.read().split()
    it = iter(tokens)
    C, M, O = int(next(it)), int(next(it)), int(next(it))
    cam_idx = np.empty(O, np.int32)
    pt_idx = np.empty(O, np.int32)
    uv = np.empty((O, 2), np.float64)
    for o in range(O):
        cam_idx[o] = int(next(it))
        pt_idx[o] = int(next(it))
        uv[o, 0] = float(next(it))
        uv[o, 1] = float(next(it))
    cams = np.array([float(next(it)) for _ in range(9 * C)]).reshape(C, 9)
    pts = np.array([float(next(it)) for _ in range(3 * M)]).reshape(M, 3)
    qs = np.stack([np.asarray(lie.so3_exp_quat(jnp.asarray(w))) for w in cams[:, :3]])
    return BalProblem(
        cam_q=jnp.asarray(qs, dtype), cam_t=jnp.asarray(cams[:, 3:6], dtype),
        cam_fkk=jnp.asarray(cams[:, 6:9], dtype), points=jnp.asarray(pts, dtype),
        cam_idx=jnp.asarray(cam_idx), pt_idx=jnp.asarray(pt_idx),
        uv=jnp.asarray(uv, dtype), valid=jnp.ones((O,), bool))


def bal_residual(q, t, fkk, X, uv):
    """2-vector reprojection residual for one observation."""
    P = lie.quat_rotate(q, X) + t
    p = -P[:2] / P[2]
    r2 = jnp.dot(p, p)
    d = 1.0 + fkk[1] * r2 + fkk[2] * r2 * r2
    return fkk[0] * d * p - uv


def _obs_residual_jac(q, t, fkk, X, uv, optimize_intrinsics: bool):
    """Residual and Jacobian wrt [dtheta(3), dt(3), dfkk(3), dX(3)]."""
    def h(z):
        dq = lie.so3_exp_quat(z[0:3])
        return bal_residual(lie.quat_mul(q, dq), t + z[3:6],
                            fkk + z[6:9], X + z[9:12], uv)
    z0 = jnp.zeros((12,), q.dtype)
    r = h(z0)
    J = jax.jacfwd(h)(z0)          # (2, 12)
    if not optimize_intrinsics:
        J = J.at[:, 6:9].set(0.0)
    return r, J


@partial(jax.jit, static_argnames=("C", "M", "optimize_intrinsics", "huber",
                                   "gauge_fix"))
def _assemble(p: BalProblem, C: int, M: int, optimize_intrinsics: bool,
              huber: float, gauge_fix: int) -> blockba.BlockNormal:
    dtype = p.points.dtype
    q = p.cam_q[p.cam_idx]
    t = p.cam_t[p.cam_idx]
    fkk = p.cam_fkk[p.cam_idx]
    X = p.points[p.pt_idx]
    r, J = jax.vmap(_obs_residual_jac, in_axes=(0, 0, 0, 0, 0, None))(
        q, t, fkk, X, p.uv, optimize_intrinsics)       # (O,2), (O,2,12)

    # fixed-vertex zeroing (the gauge: first gauge_fix cameras), like the
    # reference's MakeHessian fixed-block handling (problem.cc:365-384)
    free_obs = (p.cam_idx >= gauge_fix).astype(dtype)
    J = J.at[:, :, 0:9].multiply(free_obs[:, None, None])

    m = p.valid.astype(dtype)
    e2 = jnp.sum(r * r, axis=-1)
    # Huber: w = min(1, delta/|r|); chi uses rho
    e = jnp.sqrt(jnp.maximum(e2, 1e-30))
    w = jnp.where(e <= huber, 1.0, huber / e) * m
    rho = jnp.where(e <= huber, e2, huber * (2.0 * e - huber)) * m

    # unit diagonal on fixed parameters so the reduced system stays SPD
    free_param = (jnp.arange(C) >= gauge_fix).astype(dtype)  # (C,)
    fp9 = jnp.tile(free_param[:, None], (1, 9))
    if not optimize_intrinsics:
        fp9 = fp9.at[:, 6:9].set(0.0)
    fixed_diag = 1.0 - fp9.reshape(9 * C)

    return blockba.assemble_blocks(r, J[:, :, 0:9], J[:, :, 9:12],
                                   p.cam_idx, p.pt_idx, w, rho, C, M,
                                   fixed_diag=fixed_diag)


def _apply(p: BalProblem, dxc, dxp, gauge_fix: int):
    """Right-multiplicative SO3 update on cameras; first ``gauge_fix``
    cameras held fixed (the BAL gauge: fix cam0, cf. TestMonoBA's pose
    fixation alternative)."""
    mask = (jnp.arange(p.cam_q.shape[0]) >= gauge_fix).astype(p.cam_t.dtype)
    dxc = dxc * mask[:, None]
    q = lie.quat_normalize(jax.vmap(lie.quat_mul)(
        p.cam_q, jax.vmap(lie.so3_exp_quat)(dxc[:, 0:3])))
    return p._replace(cam_q=q, cam_t=p.cam_t + dxc[:, 3:6],
                      cam_fkk=p.cam_fkk + dxc[:, 6:9],
                      points=p.points + dxp)


def solve(p: BalProblem, max_iter: int = 30, optimize_intrinsics: bool = True,
          huber: float = 2.0, gauge_fix: int = 1, verbose: bool = False):
    """Nielsen-LM over the Schur-reduced camera system.  Host loop (BA runs
    once, not per frame); each step is jitted device work."""
    C = p.cam_q.shape[0]
    M = p.points.shape[0]
    return blockba.lm_loop(
        p,
        lambda p_: _assemble(p_, C, M, optimize_intrinsics, huber, gauge_fix),
        lambda p_, dxc, dxp: _apply(p_, dxc, dxp, gauge_fix),
        C, M, max_iter=max_iter, verbose=verbose)
