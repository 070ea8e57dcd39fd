"""Online camera-IMU extrinsic rotation calibration (hand-eye).

Re-derivation in JAX of the reference's InitialEXRotation
(reference: vins-mono/src/initial/initial_ex_rotation.cpp:11-110
CalibrationExRotation): stack the quaternion Sylvester constraint
L(q_cam) − R(q_imu) over frame pairs, Huber-weight by the angular
disagreement under the current estimate, and read the rotation off the
SVD null vector.  Accept when the second-smallest singular value of the
stacked system exceeds 0.25 with ≥ window_size pairs.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..utils import lie


def _qleft(q):
    """Full 4x4 left-multiplication matrix in (x,y,z,w) layout:
    q ⊗ p = L(q) p."""
    x, y, z, w = q
    return np.array([
        [w, -z, y, x],
        [z, w, -x, y],
        [-y, x, w, z],
        [-x, -y, -z, w],
    ])


def _qright(p):
    """Full 4x4 right-multiplication matrix: q ⊗ p = R(p) q."""
    x, y, z, w = p
    return np.array([
        [w, z, -y, x],
        [-z, w, x, y],
        [y, -x, w, z],
        [-x, -y, -z, w],
    ])


def _np_mat_to_quat(R):
    """Rotation matrix → quaternion (x, y, z, w), w ≥ 0, plain numpy (host
    per-pair path — no per-call jit dispatch)."""
    m00, m01, m02 = R[0]
    m10, m11, m12 = R[1]
    m20, m21, m22 = R[2]
    tr = m00 + m11 + m22
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2.0
        q = np.array([(m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s,
                      0.25 * s])
    elif m00 >= m11 and m00 >= m22:
        s = np.sqrt(1.0 + m00 - m11 - m22) * 2.0
        q = np.array([0.25 * s, (m01 + m10) / s, (m02 + m20) / s,
                      (m21 - m12) / s])
    elif m11 >= m22:
        s = np.sqrt(1.0 + m11 - m00 - m22) * 2.0
        q = np.array([(m01 + m10) / s, 0.25 * s, (m12 + m21) / s,
                      (m02 - m20) / s])
    else:
        s = np.sqrt(1.0 + m22 - m00 - m11) * 2.0
        q = np.array([(m02 + m20) / s, (m12 + m21) / s, 0.25 * s,
                      (m10 - m01) / s])
    return q if q[3] >= 0 else -q


class ExtrinsicRotationCalibrator:
    """Accumulates camera/IMU relative-rotation pairs and solves R_ic."""

    def __init__(self, window_size: int = 10):
        self.window_size = window_size
        self.R_imu = []     # relative body rotations (preintegrated delta_q)
        self.q_cam = []     # cached quaternions of the camera rotations
        self.q_imu = []
        self.blocks = []    # cached unweighted 4x4 Sylvester blocks
        self.ric = np.eye(3)

    def add_pair(self, R_cam_rel: np.ndarray, R_imu_rel: np.ndarray):
        R_cam_rel = np.asarray(R_cam_rel)
        R_imu_rel = np.asarray(R_imu_rel)
        self.R_imu.append(R_imu_rel)
        qc = _np_mat_to_quat(R_cam_rel)
        qi = _np_mat_to_quat(R_imu_rel)
        self.q_cam.append(qc)
        self.q_imu.append(qi)
        self.blocks.append(_qleft(qc) - _qright(qi))

    def solve(self, reweight_iters: int = 2):
        """Returns (ok, R_ic).  (initial_ex_rotation.cpp:11-66).

        The reference re-solves once per incoming frame, so its Huber
        weights always use the previous frame's estimate; a one-shot call
        here iterates `reweight_iters` times to the same effect.

        Acceptance: ≥ window_size pairs AND observability — either the
        reference's absolute σ₃ > 0.25 gate (initial_ex_rotation.cpp:62-65,
        tuned for fast handheld rotation) OR, for slow-rotation streams
        where σ₃ grows only ~√n·θ, the gap σ₃ − σ₄ > 0.1: with consistent
        pairs the residual singular value σ₄ stays ≈ 0 while σ₃ measures
        excitation, whereas rotation-estimate noise inflates σ₄ alongside
        σ₃ (an inconsistent system) — the gap only opens when the pairs
        are both exciting AND consistent."""
        n = len(self.q_cam)
        if n < 1:
            return False, self.ric
        ok = False
        for _ in range(reweight_iters):
            ok = self._solve_once()
        return ok, self.ric

    def _solve_once(self):
        n = len(self.q_cam)
        q_cam = np.stack(self.q_cam)                       # (n, 4)
        q_imu = np.stack(self.q_imu)
        # predicted camera quaternion under current ric:
        # q_pred = q_cb ⊗ q_imu ⊗ q_cb⁻¹ where R_cb = ric.T
        q_cb = _np_mat_to_quat(self.ric.T)
        Lw = _qleft(q_cb)
        Rw = _qright(np.array([-q_cb[0], -q_cb[1], -q_cb[2], q_cb[3]]))
        q_pred = q_imu @ (Rw @ Lw).T                        # (n, 4)
        cosang = np.minimum(1.0, np.abs(np.sum(q_pred * q_cam, axis=1)))
        ang_deg = np.degrees(2.0 * np.arccos(cosang))
        huber = np.where(ang_deg <= 5.0, 1.0, 5.0 / np.maximum(ang_deg, 1e-9))
        A = (np.stack(self.blocks) * huber[:, None, None]).reshape(4 * n, 4)
        _, s, Vt = np.linalg.svd(A, full_matrices=False)
        # null vector x satisfies q_cam = x ⊗ q_imu ⊗ x⁻¹, i.e. x = q_cb
        # (imu→camera); ric (camera→imu) is its inverse
        # (initial_ex_rotation.cpp:58-60)
        q_cb = Vt[-1] / np.linalg.norm(Vt[-1])
        R_cb = np.asarray(lie.quat_to_mat(jnp.asarray(q_cb)))
        self.ric = R_cb.T
        if n < self.window_size:
            return False
        return bool(s[2] > 0.25
                    or (n >= 2 * self.window_size and s[2] - s[3] > 0.1))
