"""Plain-numpy twins of the hot host-side conversions in utils/lie.py.

The estimator's per-frame host orchestration (pack/unpack around the
jitted solve) was calling the jnp versions eagerly — one device dispatch
and one transfer per conversion.  These run on the host in microseconds.
Same conventions: quaternions (x, y, z, w); matches lie.mat_to_quat's
branch-free Shepperd selection bit-for-bit up to float rounding.
"""
from __future__ import annotations

import numpy as np


def quat_to_mat_np(q: np.ndarray) -> np.ndarray:
    """(..., 4) (x,y,z,w) → (..., 3, 3)."""
    q = np.asarray(q, np.float64)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    out = np.empty(q.shape[:-1] + (3, 3))
    out[..., 0, 0] = 1 - 2 * (y * y + z * z)
    out[..., 0, 1] = 2 * (x * y - w * z)
    out[..., 0, 2] = 2 * (x * z + w * y)
    out[..., 1, 0] = 2 * (x * y + w * z)
    out[..., 1, 1] = 1 - 2 * (x * x + z * z)
    out[..., 1, 2] = 2 * (y * z - w * x)
    out[..., 2, 0] = 2 * (x * z - w * y)
    out[..., 2, 1] = 2 * (y * z + w * x)
    out[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return out


def mat_to_quat_np(m: np.ndarray) -> np.ndarray:
    """(..., 3, 3) → (..., 4) (x,y,z,w), Shepperd best-candidate."""
    m = np.asarray(m, np.float64)
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def ssqrt(x):
        return np.sqrt(np.maximum(x, 1e-30))

    s0 = ssqrt(tr + 1.0) * 2.0
    q0 = np.stack([(m21 - m12) / s0, (m02 - m20) / s0,
                   (m10 - m01) / s0, 0.25 * s0], -1)
    s1 = ssqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = np.stack([0.25 * s1, (m01 + m10) / s1,
                   (m02 + m20) / s1, (m21 - m12) / s1], -1)
    s2 = ssqrt(1.0 + m11 - m00 - m22) * 2.0
    q2 = np.stack([(m01 + m10) / s2, 0.25 * s2,
                   (m12 + m21) / s2, (m02 - m20) / s2], -1)
    s3 = ssqrt(1.0 + m22 - m00 - m11) * 2.0
    q3 = np.stack([(m02 + m20) / s3, (m12 + m21) / s3,
                   0.25 * s3, (m10 - m01) / s3], -1)
    cand = np.stack([q0, q1, q2, q3], axis=-2)
    scores = np.stack([tr, m00 - m11 - m22, m11 - m00 - m22,
                       m22 - m00 - m11], -1)
    idx = np.argmax(scores, axis=-1)
    q = np.take_along_axis(
        cand, idx[..., None, None] + np.zeros_like(cand[..., :1, :],
                                                   dtype=np.int64),
        axis=-2)[..., 0, :]
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def ypr_to_mat_np(ypr_deg: np.ndarray) -> np.ndarray:
    """Yaw-pitch-roll (degrees) → rotation matrix, Rz·Ry·Rx
    (reference: utility.h:84-108; host twin of lie.ypr_to_mat)."""
    r = np.asarray(ypr_deg, np.float64) * (np.pi / 180.0)
    y, p, ro = r[..., 0], r[..., 1], r[..., 2]
    cy, sy = np.cos(y), np.sin(y)
    cp, sp = np.cos(p), np.sin(p)
    cr, sr = np.cos(ro), np.sin(ro)
    m = np.stack([
        cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
        sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
        -sp, cp * sr, cp * cr,
    ], axis=-1)
    return m.reshape(r.shape[:-1] + (3, 3))


def mat_to_ypr_np(R: np.ndarray) -> np.ndarray:
    """Rotation matrix → yaw-pitch-roll in DEGREES
    (reference: utility.h:66-81 R2ypr; host twin of lie.mat_to_ypr)."""
    R = np.asarray(R, np.float64)
    n = R[..., :, 0]
    o = R[..., :, 1]
    a = R[..., :, 2]
    y = np.arctan2(n[..., 1], n[..., 0])
    p = np.arctan2(-n[..., 2], n[..., 0] * np.cos(y) + n[..., 1] * np.sin(y))
    r = np.arctan2(a[..., 0] * np.sin(y) - a[..., 1] * np.cos(y),
                   -o[..., 0] * np.sin(y) + o[..., 1] * np.cos(y))
    return np.stack([y, p, r], axis=-1) * (180.0 / np.pi)


def so3_log_np(R: np.ndarray) -> np.ndarray:
    """Rotation-matrix log → axis-angle vector (host twin of
    lie.so3_log_mat) for a single 3×3 matrix."""
    R = np.asarray(R, np.float64)
    cos_th = np.clip(0.5 * (np.trace(R) - 1.0), -1.0, 1.0)
    th = np.arccos(cos_th)
    if th < 1e-10:
        return 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                               R[1, 0] - R[0, 1]])
    if th > np.pi - 1e-6:
        # near-pi: axis from the symmetric part
        A = 0.5 * (R + np.eye(3))
        axis = np.sqrt(np.maximum(np.diag(A), 0.0))
        # fix signs from off-diagonals
        if A[0, 1] < 0:
            axis[1] = -axis[1]
        if A[0, 2] < 0:
            axis[2] = -axis[2]
        n = np.linalg.norm(axis)
        return th * axis / (n if n > 0 else 1.0)
    return th / (2.0 * np.sin(th)) * np.array(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
