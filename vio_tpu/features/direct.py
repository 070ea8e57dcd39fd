"""Sparse direct (photometric) pose estimation on an image pyramid.

Re-derivation in JAX of the reference's direct method
(reference: 06-frontend-direct-method/02-direct-method/direct_method.cpp:
184-340 DirectPoseEstimationSingle/MultiLayer — photometric Gauss-Newton
over 4 pyramid levels with scale 0.5, 4x4 patches around sparse points
with known depth).  All points form one batch; each GN iteration is a
bilinear gather + one 6x6 solve; levels unroll statically.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import pyramid
from ..utils import lie

HALF_PATCH = 2     # 4x4 patch, as in the reference


def _patch_offsets(dtype):
    d = jnp.arange(-HALF_PATCH, HALF_PATCH, dtype=dtype)
    dx, dy = jnp.meshgrid(d, d)
    return jnp.stack([dx, dy], axis=-1).reshape(-1, 2)   # (16, 2)


def _estimate_level(img1, img2, pts_ref, depth_ref, K, R0, t0,
                    iters: int):
    """One pyramid level of photometric GN.

    pts_ref (N,2) pixel positions in img1, depth_ref (N,) depths,
    K = (fx, fy, cx, cy).  Estimates (R, t): X_2 = R X_1 + t."""
    fx, fy, cx, cy = K
    offs = _patch_offsets(img1.dtype)
    # back-project reference points
    X = jnp.stack([(pts_ref[:, 0] - cx) / fx * depth_ref,
                   (pts_ref[:, 1] - cy) / fy * depth_ref,
                   depth_ref], axis=-1)                   # (N, 3)
    I_ref = pyramid.bilinear_sample(
        img1, pts_ref[:, None, :] + offs[None])           # (N, 16)
    gx2, gy2 = pyramid.central_gradients(img2)

    def body(_, carry):
        R, t = carry
        Xc = X @ R.T + t                                  # (N, 3)
        z = jnp.maximum(Xc[:, 2], 1e-3)
        u = fx * Xc[:, 0] / z + cx
        v = fy * Xc[:, 1] / z + cy
        pos = jnp.stack([u, v], axis=-1)[:, None, :] + offs[None]
        valid = (u > 4) & (u < img2.shape[1] - 4) & \
                (v > 4) & (v < img2.shape[0] - 4) & (Xc[:, 2] > 0.1)
        w = valid.astype(img1.dtype)

        I_cur = pyramid.bilinear_sample(img2, pos)
        r = (I_cur - I_ref) * w[:, None]                  # (N, 16)
        gx = pyramid.bilinear_sample(gx2, pos)
        gy = pyramid.bilinear_sample(gy2, pos)

        inv_z = 1.0 / z
        inv_z2 = inv_z * inv_z
        # d(u,v)/d(dxi) with dxi = [dt(3), dθ(3)], left-perturbation
        Xc0, Xc1, Xc2 = Xc[:, 0], Xc[:, 1], Xc[:, 2]
        Ju = jnp.stack([
            fx * inv_z, jnp.zeros_like(inv_z), -fx * Xc0 * inv_z2,
            -fx * Xc0 * Xc1 * inv_z2, fx + fx * Xc0 * Xc0 * inv_z2,
            -fx * Xc1 * inv_z,
        ], axis=-1)                                        # (N, 6)
        Jv = jnp.stack([
            jnp.zeros_like(inv_z), fy * inv_z, -fy * Xc1 * inv_z2,
            -fy - fy * Xc1 * Xc1 * inv_z2, fy * Xc0 * Xc1 * inv_z2,
            fy * Xc0 * inv_z,
        ], axis=-1)
        # J_photometric (N, 16, 6) = grad · J_proj
        J = (gx[..., None] * Ju[:, None, :] +
             gy[..., None] * Jv[:, None, :]) * w[:, None, None]
        H = jnp.einsum("npi,npj->ij", J, J) + 1e-6 * jnp.eye(6, dtype=img1.dtype)
        b = -jnp.einsum("npi,np->i", J, r)
        dx = jnp.linalg.solve(H, b)
        return lie.so3_exp_mat(dx[3:6]) @ R, t + dx[0:3]

    return jax.lax.fori_loop(0, iters, body, (R0, t0))


@partial(jax.jit, static_argnames=("levels", "iters"))
def direct_pose_estimation(img1, img2, pts_ref, depth_ref, K,
                           R0=None, t0=None, levels: int = 4,
                           iters: int = 10):
    """Multi-layer direct pose estimation (direct_method.cpp:184-214).
    K = (fx, fy, cx, cy).  Returns (R, t) with X_2 = R X_1 + t."""
    dtype = img1.dtype
    R = jnp.eye(3, dtype=dtype) if R0 is None else R0
    t = jnp.zeros(3, dtype) if t0 is None else t0
    pyr1 = pyramid.build_pyramid(img1, levels)
    pyr2 = pyramid.build_pyramid(img2, levels)
    fx, fy, cx, cy = K
    for lv in range(levels - 1, -1, -1):
        s = 0.5 ** lv
        Ks = (fx * s, fy * s, cx * s, cy * s)
        R, t = _estimate_level(pyr1[lv], pyr2[lv], pts_ref * s, depth_ref,
                               Ks, R, t, iters)
    return R, t


# ---------------------------------------------------------------------------
# Direct (photometric) bundle adjustment: poses + XYZ landmarks
# (reference: 07-backend-optimization/02-direct-ba/direct_ba.cpp:44,124-319 —
# 4x4-patch photometric error, g2o pose/point graph; here one blockba
# camera-point Schur system with fwd-mode Jacobians through the bilinear
# image sampler)
# ---------------------------------------------------------------------------

from typing import NamedTuple

from ..solver import blockba
from ..utils import lie as _lie


class DirectBAProblem(NamedTuple):
    images: jnp.ndarray     # (C, H, W)
    K: tuple                # (fx, fy, cx, cy) — static
    cam_q: jnp.ndarray      # (C, 4) world->cam quaternion
    cam_t: jnp.ndarray      # (C, 3)
    points: jnp.ndarray     # (M, 3) world XYZ
    ref_patch: jnp.ndarray  # (M, 16) target intensities (from host frame)
    cam_idx: jnp.ndarray    # (O,)
    pt_idx: jnp.ndarray     # (O,)
    valid: jnp.ndarray      # (O,) bool


def _photo_residual(img, K, q, t, X, ref_patch):
    """16-vector photometric residual of one (camera, point) observation."""
    fx, fy, cx, cy = K
    offs = _patch_offsets(img.dtype)
    Xc = _lie.quat_rotate(q, X) + t
    z = jnp.maximum(Xc[2], 1e-3)
    u = fx * Xc[0] / z + cx
    v = fy * Xc[1] / z + cy
    pos = jnp.stack([u, v])[None, :] + offs            # (16, 2)
    I = pyramid.bilinear_sample(img, pos[None])[0]     # (16,)
    inb = ((u > HALF_PATCH + 1) & (u < img.shape[1] - HALF_PATCH - 2) &
           (v > HALF_PATCH + 1) & (v < img.shape[0] - HALF_PATCH - 2) &
           (Xc[2] > 0.1))
    return jnp.where(inb, I - ref_patch, 0.0), inb


def _photo_residual_jac(img, K, q, t, X, ref_patch):
    def h(z):
        dq = _lie.so3_exp_quat(z[0:3])
        r, _ = _photo_residual(img, K, _lie.quat_mul(q, dq), t + z[3:6],
                               X + z[6:9], ref_patch)
        return r
    z0 = jnp.zeros((9,), X.dtype)
    r, inb = _photo_residual(img, K, q, t, X, ref_patch)
    J = jax.jacfwd(h)(z0)                               # (16, 9)
    return r, J, inb


def _direct_assemble(p: DirectBAProblem, C: int, M: int, gauge_fix: int,
                     huber: float):
    dtype = p.points.dtype
    r, J, inb = jax.vmap(
        lambda ci, pi: _photo_residual_jac(
            p.images[ci], p.K, p.cam_q[ci], p.cam_t[ci], p.points[pi],
            p.ref_patch[pi]))(p.cam_idx, p.pt_idx)      # (O,16),(O,16,9)

    free_obs = (p.cam_idx >= gauge_fix).astype(dtype)
    J = J.at[:, :, 0:6].multiply(free_obs[:, None, None])

    m = (p.valid & inb).astype(dtype)
    e2 = jnp.sum(r * r, axis=-1)
    e = jnp.sqrt(jnp.maximum(e2, 1e-30))
    w = jnp.where(e <= huber, 1.0, huber / e) * m
    rho = jnp.where(e <= huber, e2, huber * (2.0 * e - huber)) * m

    free_param = (jnp.arange(C) >= gauge_fix).astype(dtype)
    fixed_diag = jnp.tile((1.0 - free_param)[:, None], (1, 6)).reshape(6 * C)
    return blockba.assemble_blocks(r, J[:, :, 0:6], J[:, :, 6:9],
                                   p.cam_idx, p.pt_idx, w, rho, C, M,
                                   fixed_diag=fixed_diag)


_direct_assemble_j = jax.jit(_direct_assemble,
                             static_argnames=("C", "M", "gauge_fix", "huber"))


def _direct_apply(p: DirectBAProblem, dxc, dxp, gauge_fix: int):
    mask = (jnp.arange(p.cam_q.shape[0]) >= gauge_fix).astype(p.cam_t.dtype)
    dxc = dxc * mask[:, None]
    q = _lie.quat_normalize(jax.vmap(_lie.quat_mul)(
        p.cam_q, jax.vmap(_lie.so3_exp_quat)(dxc[:, 0:3])))
    return p._replace(cam_q=q, cam_t=p.cam_t + dxc[:, 3:6],
                      points=p.points + dxp)


def direct_ba(p: DirectBAProblem, max_iter: int = 30, gauge_fix: int = 1,
              huber: float = 40.0, verbose: bool = False):
    """Photometric BA over poses + XYZ points (the reference's direct-BA
    assignment).  Returns (optimized problem, chi2 history)."""
    C = p.cam_q.shape[0]
    M = p.points.shape[0]
    return blockba.lm_loop(
        p,
        lambda p_: _direct_assemble_j(p_, C, M, gauge_fix, huber),
        lambda p_, dxc, dxp: _direct_apply(p_, dxc, dxp, gauge_fix),
        C, M, max_iter=max_iter, verbose=verbose)
