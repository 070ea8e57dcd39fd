"""Factor residuals + hand-derived analytic Jacobians, as pure batched fns.

Batched replacement for the edge hierarchy (reference:
vins-mono/src/backend/edge_imu.cc:13-157, edge_reprojection.cc:18-128,
edge_prior.cpp:39-80).  Each factor is a pure function of stacked state
arrays; ``jax.vmap`` batches over the factor axis.  Tests assert the
analytic Jacobians against ``jax.jacfwd`` (the reference only had these
checks commented out).

Conventions (identical to reference):
  * pose local update: p += dp; q = q ⊗ exp(dθ)   (vertex_pose.cc:7-19)
  * quaternion storage (x, y, z, w)
  * IMU residual ordering [p, θ, v, ba, bg]
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import imu as imu_mod
from .utils import lie


# ---------------------------------------------------------------------------
# IMU factor (15-dim; vertices pose_i(6), sb_i(9), pose_j(6), sb_j(9))
# ---------------------------------------------------------------------------

class ImuFactorTerms(NamedTuple):
    """Preintegrated terms consumed by the factor (one per window interval)."""
    delta_p: jnp.ndarray       # (3,)
    delta_q: jnp.ndarray       # (4,)
    delta_v: jnp.ndarray       # (3,)
    jacobian: jnp.ndarray      # (15, 15)
    covariance: jnp.ndarray    # (15, 15)
    sum_dt: jnp.ndarray        # ()
    linearized_ba: jnp.ndarray # (3,)
    linearized_bg: jnp.ndarray # (3,)

    @staticmethod
    def from_state(st: imu_mod.PreintState) -> "ImuFactorTerms":
        return ImuFactorTerms(st.delta_p, st.delta_q, st.delta_v, st.jacobian,
                              st.covariance, st.sum_dt,
                              st.linearized_ba, st.linearized_bg)


def imu_residual(terms: ImuFactorTerms, g, Pi, Qi, Vi, Bai, Bgi,
                 Pj, Qj, Vj, Baj, Bgj):
    """(edge_imu.cc:13-36 → integration_base.h:160-186)."""
    st = imu_mod.PreintState(
        delta_p=terms.delta_p, delta_q=terms.delta_q, delta_v=terms.delta_v,
        jacobian=terms.jacobian, covariance=terms.covariance,
        sum_dt=terms.sum_dt, linearized_ba=terms.linearized_ba,
        linearized_bg=terms.linearized_bg,
        acc_last=jnp.zeros(3, terms.delta_p.dtype),
        gyr_last=jnp.zeros(3, terms.delta_p.dtype))
    return imu_mod.evaluate(st, g, Pi, Qi, Vi, Bai, Bgi, Pj, Qj, Vj, Baj, Bgj)


def imu_jacobians(terms: ImuFactorTerms, g, Pi, Qi, Vi, Bai, Bgi,
                  Pj, Qj, Vj, Baj, Bgj):
    """Analytic Jacobians of the 15-dim residual w.r.t. the four vertex
    local parameterizations (edge_imu.cc:38-157).

    Returns (J_pose_i (15,6), J_sb_i (15,9), J_pose_j (15,6), J_sb_j (15,9)).
    """
    dtype = Pi.dtype
    J = terms.jacobian
    dp_dba = J[0:3, 9:12]
    dp_dbg = J[0:3, 12:15]
    dq_dbg = J[3:6, 12:15]
    dv_dba = J[6:9, 9:12]
    dv_dbg = J[6:9, 12:15]
    sdt = terms.sum_dt

    Qi_inv = lie.quat_conj(Qi)
    Ri_inv = lie.quat_to_mat(Qi_inv)
    corrected_q = lie.quat_mul(
        terms.delta_q, lie.delta_q(dq_dbg @ (Bgi - terms.linearized_bg)))

    Jpi = jnp.zeros((15, 6), dtype)
    Jpi = Jpi.at[0:3, 0:3].set(-Ri_inv)
    Jpi = Jpi.at[0:3, 3:6].set(lie.so3_hat(
        lie.quat_rotate(Qi_inv, 0.5 * g * sdt * sdt + Pj - Pi - Vi * sdt)))
    q_ji = lie.quat_mul(lie.quat_conj(Qj), Qi)
    Jpi = Jpi.at[3:6, 3:6].set(
        -(lie.q_left_corner(q_ji) @ lie.q_right_corner(corrected_q)))
    Jpi = Jpi.at[6:9, 3:6].set(lie.so3_hat(lie.quat_rotate(Qi_inv, g * sdt + Vj - Vi)))

    Jsbi = jnp.zeros((15, 9), dtype)
    Jsbi = Jsbi.at[0:3, 0:3].set(-Ri_inv * sdt)
    Jsbi = Jsbi.at[0:3, 3:6].set(-dp_dba)
    Jsbi = Jsbi.at[0:3, 6:9].set(-dp_dbg)
    q_jid = lie.quat_mul(lie.quat_mul(lie.quat_conj(Qj), Qi), terms.delta_q)
    Jsbi = Jsbi.at[3:6, 6:9].set(-(lie.q_left_corner(q_jid) @ dq_dbg))
    Jsbi = Jsbi.at[6:9, 0:3].set(-Ri_inv)
    Jsbi = Jsbi.at[6:9, 3:6].set(-dv_dba)
    Jsbi = Jsbi.at[6:9, 6:9].set(-dv_dbg)
    Jsbi = Jsbi.at[9:12, 3:6].set(-jnp.eye(3, dtype=dtype))
    Jsbi = Jsbi.at[12:15, 6:9].set(-jnp.eye(3, dtype=dtype))

    Jpj = jnp.zeros((15, 6), dtype)
    Jpj = Jpj.at[0:3, 0:3].set(Ri_inv)
    q_cij = lie.quat_mul(lie.quat_conj(corrected_q), lie.quat_mul(Qi_inv, Qj))
    Jpj = Jpj.at[3:6, 3:6].set(lie.q_left_corner(q_cij))

    Jsbj = jnp.zeros((15, 9), dtype)
    Jsbj = Jsbj.at[6:9, 0:3].set(Ri_inv)
    Jsbj = Jsbj.at[9:12, 3:6].set(jnp.eye(3, dtype=dtype))
    Jsbj = Jsbj.at[12:15, 6:9].set(jnp.eye(3, dtype=dtype))

    return Jpi, Jsbi, Jpj, Jsbj


# ---------------------------------------------------------------------------
# Inverse-depth reprojection factor (2-dim; vertices invdep(1), pose_i(6),
# pose_j(6), extrinsic(6))
# ---------------------------------------------------------------------------

def reproj_residual(inv_dep_i, Pi, Qi, Pj, Qj, tic, qic, pts_i, pts_j):
    """(edge_reprojection.cc:18-44).  pts_* are unit-plane bearing vectors
    (x, y, 1) in the two camera frames."""
    pts_cam_i = pts_i / inv_dep_i
    pts_imu_i = lie.quat_rotate(qic, pts_cam_i) + tic
    pts_w = lie.quat_rotate(Qi, pts_imu_i) + Pi
    pts_imu_j = lie.quat_rotate(lie.quat_conj(Qj), pts_w - Pj)
    pts_cam_j = lie.quat_rotate(lie.quat_conj(qic), pts_imu_j - tic)
    dep_j = pts_cam_j[..., 2]
    return pts_cam_j[..., :2] / dep_j[..., None] - pts_j[..., :2]


def reproj_jacobians(inv_dep_i, Pi, Qi, Pj, Qj, tic, qic, pts_i, pts_j):
    """Analytic Jacobians (edge_reprojection.cc:51-108).

    Returns (J_invdep (2,1), J_pose_i (2,6), J_pose_j (2,6), J_ext (2,6))."""
    pts_cam_i = pts_i / inv_dep_i
    pts_imu_i = lie.quat_rotate(qic, pts_cam_i) + tic
    pts_w = lie.quat_rotate(Qi, pts_imu_i) + Pi
    pts_imu_j = lie.quat_rotate(lie.quat_conj(Qj), pts_w - Pj)
    pts_cam_j = lie.quat_rotate(lie.quat_conj(qic), pts_imu_j - tic)
    dep_j = pts_cam_j[2]

    Ri = lie.quat_to_mat(Qi)
    Rj = lie.quat_to_mat(Qj)
    ric = lie.quat_to_mat(qic)
    dtype = Pi.dtype

    inv_dj = 1.0 / dep_j
    reduce = jnp.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], dtype) * inv_dj
    reduce = reduce.at[0, 2].set(-pts_cam_j[0] * inv_dj * inv_dj)
    reduce = reduce.at[1, 2].set(-pts_cam_j[1] * inv_dj * inv_dj)

    RicT_RjT = ric.T @ Rj.T
    jaco_i = jnp.concatenate(
        [RicT_RjT, RicT_RjT @ Ri @ (-lie.so3_hat(pts_imu_i))], axis=1)
    J_pose_i = reduce @ jaco_i

    jaco_j = jnp.concatenate(
        [-RicT_RjT, ric.T @ lie.so3_hat(pts_imu_j)], axis=1)
    J_pose_j = reduce @ jaco_j

    J_invdep = (reduce @ (RicT_RjT @ Ri @ ric @ pts_i))[:, None] * \
        (-1.0 / (inv_dep_i * inv_dep_i))

    tmp_r = RicT_RjT @ Ri @ ric
    jaco_ex_t = ric.T @ (Rj.T @ Ri - jnp.eye(3, dtype=dtype))
    jaco_ex_r = (-tmp_r @ lie.so3_hat(pts_cam_i)
                 + lie.so3_hat(tmp_r @ pts_cam_i)
                 + lie.so3_hat(ric.T @ (Rj.T @ (Ri @ tic + Pi - Pj) - tic)))
    J_ext = reduce @ jnp.concatenate([jaco_ex_t, jaco_ex_r], axis=1)

    return J_invdep, J_pose_i, J_pose_j, J_ext


# ---------------------------------------------------------------------------
# XYZ-landmark reprojection (2-dim; vertices xyz(3), pose(6)) — used by the
# SfM bootstrap BA (reference: edge_reprojection.cc:130-180 ReprojectionXYZ)
# ---------------------------------------------------------------------------

def reproj_xyz_residual(pts_w, Pi, Qi, tic, qic, obs):
    pts_imu_i = lie.quat_rotate(lie.quat_conj(Qi), pts_w - Pi)
    pts_cam_i = lie.quat_rotate(lie.quat_conj(qic), pts_imu_i - tic)
    return pts_cam_i[..., :2] / pts_cam_i[..., 2:3] - obs[..., :2]


def reproj_xyz_jacobians(pts_w, Pi, Qi, tic, qic, obs):
    pts_imu_i = lie.quat_rotate(lie.quat_conj(Qi), pts_w - Pi)
    pts_cam_i = lie.quat_rotate(lie.quat_conj(qic), pts_imu_i - tic)
    dep = pts_cam_i[2]
    Ri = lie.quat_to_mat(Qi)
    ric = lie.quat_to_mat(qic)
    inv_d = 1.0 / dep
    reduce = jnp.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0]], pts_w.dtype) * inv_d
    reduce = reduce.at[0, 2].set(-pts_cam_i[0] * inv_d * inv_d)
    reduce = reduce.at[1, 2].set(-pts_cam_i[1] * inv_d * inv_d)
    jaco_pose = jnp.concatenate(
        [ric.T @ (-Ri.T), ric.T @ lie.so3_hat(pts_imu_i)], axis=1)
    J_pose = reduce @ jaco_pose
    J_xyz = reduce @ ric.T @ Ri.T
    return J_xyz, J_pose


# ---------------------------------------------------------------------------
# SE3 prior factor (6-dim; vertex pose(6)) — gauge handling
# (reference: edge_prior.cpp:39-80, used by TestMonoBA)
# ---------------------------------------------------------------------------

def se3_prior_residual(Pi, Qi, Pp, Qp):
    r_rot = lie.quat_log(lie.quat_mul(lie.quat_conj(Qp), Qi))
    return jnp.concatenate([r_rot, Pi - Pp])


def se3_prior_jacobian(Pi, Qi, Pp, Qp):
    r_rot = lie.quat_log(lie.quat_mul(lie.quat_conj(Qp), Qi))
    J = jnp.zeros((6, 6), Pi.dtype)
    J = J.at[0:3, 3:6].set(lie.so3_jacobian_r_inv(r_rot))
    J = J.at[3:6, 0:3].set(jnp.eye(3, dtype=Pi.dtype))
    return J


# ---------------------------------------------------------------------------
# Robust loss kernels (reference: src/backend/loss_function.cc:10-47)
# ---------------------------------------------------------------------------

def cauchy_rho(e2, delta):
    """Returns (rho, rho', rho'') of the Cauchy kernel at squared error e2."""
    d2 = delta * delta
    aux = e2 / d2 + 1.0
    # log1p, not log(aux): in float32 1 + e2/d2 rounds to 1 below
    # e2/d2 ~ 6e-8, which zeroes the cost of a nearly converged problem and
    # stops LM short of the optimum
    rho0 = d2 * jnp.log1p(e2 / d2)
    rho1 = 1.0 / aux
    rho2 = -(rho1 * rho1) / d2
    return rho0, rho1, rho2


def huber_rho(e2, delta):
    d2 = delta * delta
    sqrte = jnp.sqrt(jnp.maximum(e2, 1e-300))
    inlier = e2 <= d2
    rho0 = jnp.where(inlier, e2, 2.0 * sqrte * delta - d2)
    rho1 = jnp.where(inlier, 1.0, delta / sqrte)
    rho2 = jnp.where(inlier, 0.0, -0.5 * (delta / sqrte) / e2)
    return rho0, rho1, rho2


def tukey_rho(e2, delta):
    d2 = delta * delta
    e = jnp.sqrt(jnp.maximum(e2, 1e-300))
    aux = e2 / d2
    inlier = e <= delta
    rho0 = jnp.where(inlier, d2 * (1.0 - (1.0 - aux) ** 3) / 3.0, d2 / 3.0)
    rho1 = jnp.where(inlier, (1.0 - aux) ** 2, 0.0)
    rho2 = jnp.where(inlier, -2.0 * (1.0 - aux) / d2, 0.0)
    return rho0, rho1, rho2


def trivial_rho(e2, delta=None):
    return e2, jnp.ones_like(e2), jnp.zeros_like(e2)


LOSSES = {"cauchy": cauchy_rho, "huber": huber_rho, "tukey": tukey_rho,
          "none": trivial_rho}
