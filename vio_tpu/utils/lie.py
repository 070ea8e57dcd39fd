"""Lie-group / quaternion substrate (SO3, SE3) for the VIO stack.

Quaternions are stored as ``(x, y, z, w)`` arrays of shape ``(..., 4)`` —
the same memory layout the reference uses for its pose parameter blocks
(reference: vins-mono/src/estimator.cpp:512-516, Eigen coeffs order).

Everything here is pure jnp, shape-polymorphic over leading batch axes, and
safe under ``jax.vmap`` / ``jax.jit`` / ``jax.grad``.  Functional replacement
for the vendored Sophus + Utility helpers
(reference: vins-mono/include/utility/utility.h:11-108, thirdparty/Sophus).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = [
    "quat_identity", "quat_mul", "quat_conj", "quat_normalize", "quat_rotate",
    "quat_to_mat", "mat_to_quat", "delta_q", "so3_exp_quat", "quat_log",
    "so3_hat", "so3_exp_mat", "so3_log_mat", "so3_jacobian_r_inv",
    "q_left_corner", "q_right_corner", "ypr_to_mat", "mat_to_ypr", "g_to_R",
    "from_two_vectors",
]


def quat_identity(dtype=None):
    dtype = dtype or jnp.result_type(float)
    return jnp.array([0.0, 0.0, 0.0, 1.0], dtype=dtype)


def quat_mul(q, p):
    """Hamilton product q ⊗ p, both (..., 4) in (x,y,z,w) layout."""
    qx, qy, qz, qw = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    px, py, pz, pw = p[..., 0], p[..., 1], p[..., 2], p[..., 3]
    return jnp.stack([
        qw * px + qx * pw + qy * pz - qz * py,
        qw * py - qx * pz + qy * pw + qz * px,
        qw * pz + qx * py - qy * px + qz * pw,
        qw * pw - qx * px - qy * py - qz * pz,
    ], axis=-1)


def quat_conj(q):
    return jnp.concatenate([-q[..., :3], q[..., 3:4]], axis=-1)


def quat_normalize(q):
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def quat_rotate(q, v):
    """Rotate vector(s) v (..., 3) by quaternion(s) q (..., 4)."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    t = 2.0 * jnp.cross(qv, v)
    return v + qw * t + jnp.cross(qv, t)


def quat_to_mat(q):
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = jnp.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], axis=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def mat_to_quat(m):
    """Rotation matrix (..., 3, 3) → quaternion (x,y,z,w). Branch-free
    (Shepperd's method evaluated on all four candidates, pick the best)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return jnp.sqrt(jnp.maximum(x, 1e-30))

    # candidate 0: w largest
    s0 = safe_sqrt(tr + 1.0) * 2.0
    q0 = jnp.stack([(m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0, 0.25 * s0], -1)
    # candidate 1: x largest
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = jnp.stack([0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1, (m21 - m12) / s1], -1)
    # candidate 2: y largest
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    q2 = jnp.stack([(m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2, (m02 - m20) / s2], -1)
    # candidate 3: z largest
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    q3 = jnp.stack([(m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3, (m10 - m01) / s3], -1)

    cand = jnp.stack([q0, q1, q2, q3], axis=-2)  # (..., 4cand, 4)
    scores = jnp.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], -1)
    idx = jnp.argmax(scores, axis=-1)
    q = jnp.take_along_axis(cand, idx[..., None, None].astype(jnp.int32) *
                            jnp.ones_like(cand[..., :1, :], dtype=jnp.int32), axis=-2)[..., 0, :]
    return quat_normalize(q)


def delta_q(theta):
    """Small-angle quaternion [theta/2, 1] (UN-normalized), the reference's
    Utility::deltaQ (utility.h:12-24)."""
    half = 0.5 * theta
    one = jnp.ones(theta.shape[:-1] + (1,), theta.dtype)
    return jnp.concatenate([half, one], axis=-1)


def so3_exp_quat(phi):
    """Exact SO3 exponential as a quaternion (x,y,z,w)."""
    angle2 = jnp.sum(phi * phi, axis=-1, keepdims=True)
    angle = jnp.sqrt(jnp.maximum(angle2, 1e-32))
    half = 0.5 * angle
    small = angle2 < 1e-16
    k = jnp.where(small, 0.5 - angle2 / 48.0, jnp.sin(half) / angle)
    w = jnp.where(small, 1.0 - angle2 / 8.0, jnp.cos(half))
    return jnp.concatenate([k * phi, w], axis=-1)


def quat_log(q):
    """SO3 log of a unit quaternion → rotation vector (..., 3)."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    # force positive hemisphere
    sgn = jnp.where(qw < 0, -1.0, 1.0)
    qv = qv * sgn
    qw = qw * sgn
    n = jnp.linalg.norm(qv, axis=-1, keepdims=True)
    angle = 2.0 * jnp.arctan2(n, qw[..., 0:1].reshape(qw.shape))
    small = n < 1e-9
    k = jnp.where(small, 2.0 / jnp.maximum(qw, 1e-12), angle / jnp.maximum(n, 1e-30))
    return k * qv


def so3_hat(v):
    """Skew-symmetric matrix (..., 3, 3) of v (..., 3)
    (reference: utility.h:27-34 skewSymmetric)."""
    z = jnp.zeros_like(v[..., 0])
    m = jnp.stack([
        z, -v[..., 2], v[..., 1],
        v[..., 2], z, -v[..., 0],
        -v[..., 1], v[..., 0], z,
    ], axis=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def so3_exp_mat(phi):
    return quat_to_mat(so3_exp_quat(phi))


def so3_log_mat(R):
    return quat_log(mat_to_quat(R))


def so3_jacobian_r_inv(phi):
    """Inverse right Jacobian of SO3 (Forster RSS15 eq. A.32), used by the
    SE3 prior edge (reference: src/backend/edge_prior.cpp:72)."""
    angle2 = jnp.sum(phi * phi, axis=-1)
    angle = jnp.sqrt(jnp.maximum(angle2, 1e-32))
    hat = so3_hat(phi)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=phi.dtype), hat.shape)
    half_angle = 0.5 * angle
    cot = half_angle / jnp.tan(jnp.maximum(half_angle, 1e-12))
    k = jnp.where(angle2 < 1e-16, 1.0 / 12.0, (1.0 - cot) / jnp.maximum(angle2, 1e-32))
    return eye + 0.5 * hat + k[..., None, None] * (hat @ hat)


def q_left_corner(q):
    """Bottom-right 3x3 of Utility::Qleft (utility.h:47-54): w·I + [v]x."""
    return q[..., 3, None, None] * jnp.eye(3, dtype=q.dtype) + so3_hat(q[..., :3])


def q_right_corner(q):
    """Bottom-right 3x3 of Utility::Qright (utility.h:57-64): w·I − [v]x."""
    return q[..., 3, None, None] * jnp.eye(3, dtype=q.dtype) - so3_hat(q[..., :3])


def ypr_to_mat(ypr_deg):
    """Yaw-pitch-roll (degrees) → rotation matrix, Rz·Ry·Rx
    (reference: utility.h:84-108)."""
    r = ypr_deg * (jnp.pi / 180.0)
    y, p, ro = r[..., 0], r[..., 1], r[..., 2]
    cy, sy = jnp.cos(y), jnp.sin(y)
    cp, sp = jnp.cos(p), jnp.sin(p)
    cr, sr = jnp.cos(ro), jnp.sin(ro)
    m = jnp.stack([
        cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
        sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
        -sp, cp * sr, cp * cr,
    ], axis=-1)
    return m.reshape(ypr_deg.shape[:-1] + (3, 3))


def mat_to_ypr(R):
    """Rotation matrix → yaw-pitch-roll in DEGREES
    (reference: utility.h:66-81 R2ypr)."""
    n = R[..., :, 0]
    o = R[..., :, 1]
    a = R[..., :, 2]
    y = jnp.arctan2(n[..., 1], n[..., 0])
    p = jnp.arctan2(-n[..., 2], n[..., 0] * jnp.cos(y) + n[..., 1] * jnp.sin(y))
    r = jnp.arctan2(a[..., 0] * jnp.sin(y) - a[..., 1] * jnp.cos(y),
                    -o[..., 0] * jnp.sin(y) + o[..., 1] * jnp.cos(y))
    return jnp.stack([y, p, r], axis=-1) * (180.0 / jnp.pi)


def from_two_vectors(a, b):
    """Quaternion rotating unit-ish vector a onto b (Eigen FromTwoVectors)."""
    a = a / jnp.linalg.norm(a, axis=-1, keepdims=True)
    b = b / jnp.linalg.norm(b, axis=-1, keepdims=True)
    c = jnp.cross(a, b)
    d = jnp.sum(a * b, axis=-1, keepdims=True)
    w = 1.0 + d
    # degenerate antiparallel case: pick any orthogonal axis
    ortho = jnp.where(jnp.abs(a[..., 0:1]) < 0.9,
                      jnp.cross(a, jnp.array([1.0, 0.0, 0.0], a.dtype)),
                      jnp.cross(a, jnp.array([0.0, 1.0, 0.0], a.dtype)))
    anti = w[..., 0] < 1e-8
    xyz = jnp.where(anti[..., None], ortho, c)
    w = jnp.where(anti[..., None], jnp.zeros_like(w), w)
    return quat_normalize(jnp.concatenate([xyz, w], axis=-1))


def g_to_R(g):
    """Rotation aligning gravity vector g with +z then zeroing its own yaw
    (reference: src/utility/utility.cpp g2R)."""
    ng1 = g / jnp.linalg.norm(g)
    ng2 = jnp.array([0.0, 0.0, 1.0], g.dtype)
    R0 = quat_to_mat(from_two_vectors(ng1, ng2))
    yaw = mat_to_ypr(R0)[0]
    return ypr_to_mat(jnp.stack([-yaw, jnp.zeros_like(yaw), jnp.zeros_like(yaw)])) @ R0
