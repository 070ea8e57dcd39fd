"""Visual-IMU alignment: gyro bias, velocities, gravity, and metric scale.

Re-derivation in JAX of the reference alignment
(reference: vins-mono/src/initial/initial_aligment.cpp:3-207 —
solveGyroscopeBias, TangentBasis, RefineGravity, LinearAlignment,
VisualIMUAlignment).  The per-frame-pair blocks are built batched in jnp;
the tiny dense normal systems are solved host-side (they run once).

Inputs are arrays over the N+1 image frames collected before init:
  R (N+1, 3, 3)  body→c0 rotation of each frame (from SfM ∘ extrinsic)
  T (N+1, 3)     CAMERA position in c0 (visual scale)
plus per consecutive-pair preintegrated terms (delta_q/p/v, sum_dt,
dq_dbg from the 15x15 bias Jacobian).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import lie


def excitation_std(delta_vs, sum_dts) -> float:
    """IMU-observability statistic for init gating: the RMS deviation of
    the per-interval mean specific force ``delta_v / sum_dt`` around its
    average (reference estimator.cpp:243-263 — "check imu observibility").
    Under pure gravity (no motion) every interval yields the same vector,
    so the statistic is ~sensor noise; the reference compares it to 0.25
    m/s^2 (warn-only, its early-return is commented out)."""
    delta_vs = np.asarray(delta_vs, np.float64)
    sum_dts = np.asarray(sum_dts, np.float64)
    tmp_g = delta_vs / sum_dts[:, None]
    d = tmp_g - tmp_g.mean(axis=0)
    return float(np.sqrt(np.mean(np.sum(d * d, axis=1))))


def solve_gyroscope_bias(R, delta_q, dq_dbg):
    """LS gyro bias from SfM-vs-preintegrated rotation
    (initial_aligment.cpp:3-37).  Host numpy float64 (once per init).

    R (N+1,3,3) body->c0; delta_q (N,4) preintegrated rotation per pair;
    dq_dbg (N,3,3) rotation-block bias Jacobian.  Returns delta_bg (3,)."""
    from ..utils.lie_np import mat_to_quat_np
    R = np.asarray(R, np.float64)
    q_wb = mat_to_quat_np(R)                                   # (N+1, 4)

    def qmul(a, b):
        x1, y1, z1, w1 = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
        x2, y2, z2, w2 = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
        return np.stack([
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2], -1)

    def qconj(q):
        return q * np.array([-1.0, -1.0, -1.0, 1.0])

    q_ij = qmul(qconj(q_wb[:-1]), q_wb[1:])                    # (N, 4)
    r = 2.0 * qmul(qconj(np.asarray(delta_q, np.float64)), q_ij)[:, :3]
    J = np.asarray(dq_dbg, np.float64)                         # (N, 3, 3)
    A = np.einsum("nij,nik->jk", J, J)
    b = np.einsum("nij,ni->j", J, r)
    return np.linalg.solve(A, b)


def tangent_basis(g0):
    """Two unit vectors spanning the tangent plane of g0
    (initial_aligment.cpp:40-53)."""
    a = g0 / np.linalg.norm(g0)
    tmp = np.array([0.0, 0.0, 1.0]) if abs(a[2]) < 0.9 else np.array([1.0, 0.0, 0.0])
    b = tmp - a * (a @ tmp)
    b /= np.linalg.norm(b)
    c = np.cross(a, b)
    return np.stack([b, c], axis=1)                             # (3, 2)


def _pair_blocks(R, T, delta_p, delta_v, dts, tic):
    """Per-pair (6 x [vi(3) vj(3) g(3) s(1)]) design blocks + rhs
    (the kinematic constraints of LinearAlignment, initial_aligment.cpp:
    137-160).  Plain numpy FLOAT64 regardless of the device dtype regime:
    this runs once per init attempt on the host, and the (g, s, v) system
    is ill-conditioned enough that float32 block formation distorts the
    solved scale and poisons the residual-based acceptance gate (a float32
    600-frame run diverged before this ran on the host).  Returns
    (A6 (N,6,10), b6 (N,6))."""
    R = np.asarray(R, np.float64)
    T = np.asarray(T, np.float64)
    delta_p = np.asarray(delta_p, np.float64)
    delta_v = np.asarray(delta_v, np.float64)
    dts = np.asarray(dts, np.float64)
    tic = np.asarray(tic, np.float64)
    Ri = R[:-1]                                                 # (N,3,3)
    Rj = R[1:]
    RiT = np.swapaxes(Ri, -1, -2)
    RiT_Rj = RiT @ Rj
    N = Ri.shape[0]
    I3 = np.broadcast_to(np.eye(3), (N, 3, 3))

    A = np.zeros((N, 6, 10))
    b = np.zeros((N, 6))
    # position rows
    A[:, 0:3, 0:3] = -dts[:, None, None] * I3
    A[:, 0:3, 6:9] = RiT * (0.5 * dts ** 2)[:, None, None]
    A[:, 0:3, 9] = np.einsum("nij,nj->ni", RiT, T[1:] - T[:-1]) / 100.0
    b[:, 0:3] = delta_p + np.einsum("nij,j->ni", RiT_Rj, tic) - tic
    # velocity rows
    A[:, 3:6, 0:3] = -I3
    A[:, 3:6, 3:6] = RiT_Rj
    A[:, 3:6, 6:9] = RiT * dts[:, None, None]
    b[:, 3:6] = delta_v
    return A, b


def _solve_overlapped(A6, b6, n_frames, n_tail, return_var=False):
    """Assemble the pair blocks into the global banded normal system and
    solve (the A += r_A pattern of initial_aligment.cpp:162-188).
    State: [v_0..v_n (3 each) | tail (n_tail)].

    With return_var, also returns the marginal variance of the LAST state
    entry (the scale), estimated as sigma² · (Aᵀ A)⁻¹[-1, -1] with sigma²
    from the post-fit residuals — the statistic the init acceptance gate
    needs (see linear_alignment)."""
    A6 = np.asarray(A6)
    b6 = np.asarray(b6)
    n_state = 3 * n_frames + n_tail
    A = np.zeros((n_state, n_state))
    b = np.zeros(n_state)
    for i in range(n_frames - 1):
        cols = np.r_[3 * i:3 * i + 6, n_state - n_tail:n_state]
        Ai = A6[i][:, np.r_[0:6, 10 - n_tail:10]]
        rA = Ai.T @ Ai
        rb = Ai.T @ b6[i]
        A[np.ix_(cols, cols)] += rA
        b[cols] += rb
    A *= 1000.0
    b *= 1000.0
    try:
        x = np.linalg.solve(A, b)
    except np.linalg.LinAlgError:
        # rank-deficient pairs (degenerate motion / fp32 underflow on a
        # bad attempt): least-squares keeps the attempt alive — the
        # ‖g‖/scale acceptance gates downstream reject garbage
        x = np.linalg.lstsq(A, b, rcond=None)[0]
    if not return_var:
        return x
    chi2 = 0.0
    for i in range(n_frames - 1):
        cols = np.r_[3 * i:3 * i + 6, n_state - n_tail:n_state]
        Ai = A6[i][:, np.r_[0:6, 10 - n_tail:10]]
        r = Ai @ x[cols] - b6[i]
        chi2 += float(r @ r)
    dof = max(6 * (n_frames - 1) - n_state, 1)
    sigma2 = chi2 / dof
    # A was scaled by 1000: (1000·N)⁻¹ = N⁻¹/1000
    var_last = sigma2 * 1000.0 * float(np.linalg.solve(
        A, np.eye(n_state)[:, -1])[-1])
    return x, max(var_last, 0.0)


def linear_alignment(R, T, delta_p, delta_v, dts, tic, g_norm=9.81,
                     max_scale_rel_std=0.02, g_band=1.0):
    """Velocities + gravity + scale (LinearAlignment,
    initial_aligment.cpp:125-197).  Returns (ok, x, g, s) where x holds the
    per-frame body-frame velocities.

    Beyond the reference's ‖g‖±1.0 / s>0 gates, acceptance also requires
    the marginal relative std of the solved scale (from the refined
    system's normal-matrix covariance) to be below `max_scale_rel_std`.
    The (g, s, v) system is ill-conditioned until the window has rotated
    w.r.t. gravity enough; with sub-pixel visual noise the raw solve can
    drift 30 %+ along the degenerate direction while ‖g‖ still lands
    inside the reference's band — the covariance gate waits for actual
    observability instead."""
    n_frames = np.asarray(R).shape[0]
    A6, b6 = _pair_blocks(R, T, delta_p, delta_v, dts, tic)
    x = _solve_overlapped(A6, b6, n_frames, 4)
    s = x[-1] / 100.0
    g = x[-4:-1]
    if abs(np.linalg.norm(g) - g_norm) > g_band or s < 0:
        return False, None, None, None
    g, x, var_s = refine_gravity(R, T, delta_p, delta_v, dts, tic, g, g_norm)
    s = x[-1] / 100.0
    if s < 0:
        return False, None, None, None
    rel_std = float(np.sqrt(var_s)) / 100.0 / max(s, 1e-12)
    if rel_std > max_scale_rel_std:
        return False, None, None, None
    return True, x, g, s


def refine_gravity(R, T, delta_p, delta_v, dts, tic, g, g_norm=9.81,
                   iterations=4):
    """2-dof tangent-space gravity refinement (RefineGravity,
    initial_aligment.cpp:55-123)."""
    n_frames = np.asarray(R).shape[0]
    A6, b6 = _pair_blocks(R, T, delta_p, delta_v, dts, tic)
    g0 = g / np.linalg.norm(g) * g_norm
    x = None
    var_s = 0.0
    for it in range(iterations):
        lxly = tangent_basis(g0)                                # (3, 2)
        # substitute g = g0 + lxly·dg into the original blocks
        A_g = A6[:, :, 6:9]                                     # (N, 6, 3)
        A_it = np.concatenate([A6[:, :, 0:6], A_g @ lxly, A6[:, :, 9:10]],
                              axis=2)                           # (N, 6, 9)
        b_it = b6 - A_g @ g0
        # reuse the overlapped solver with a 10-wide layout (pad one col)
        A_pad = np.zeros((A6.shape[0], 6, 10))
        A_pad[:, :, 0:6] = A_it[:, :, 0:6]
        A_pad[:, :, 7:10] = A_it[:, :, 6:9]
        x, var_s = _solve_overlapped(A_pad, b_it, n_frames, 3,
                                     return_var=True)
        dg = x[-3:-1]
        g0 = g0 + lxly @ dg
        g0 = g0 / np.linalg.norm(g0) * g_norm
    return g0, x, var_s


def recover_velocities(R, T, delta_p, delta_v, dts, tic, g, s):
    """Per-frame body-frame velocities given solved (g, s), in closed form
    from each pair's position row (and the last velocity row for the final
    frame).  Replaces the joint LS over velocities once gravity and scale
    are known — each v_i is directly determined by its own pair.

    R (N+1,3,3) body→c0, T (N+1,3) camera positions (visual units),
    delta_p/delta_v (N,3), dts (N,).  Returns v (N+1, 3)."""
    R = np.asarray(R, np.float64)
    T = np.asarray(T, np.float64)
    delta_p = np.asarray(delta_p, np.float64)
    delta_v = np.asarray(delta_v, np.float64)
    dts = np.asarray(dts, np.float64)
    Ri = R[:-1]
    Rj = R[1:]
    RiT = np.swapaxes(Ri, -1, -2)
    RiT_Rj = RiT @ Rj
    b_pos = delta_p + np.einsum("nij,j->ni", RiT_Rj, tic) - tic
    dT = np.einsum("nij,nj->ni", RiT, T[1:] - T[:-1]) * s
    g_i = np.einsum("nij,j->ni", RiT, g)
    v = np.zeros((R.shape[0], 3))
    v[:-1] = (dT + 0.5 * (dts ** 2)[:, None] * g_i - b_pos) / dts[:, None]
    # last frame from the final velocity row:
    # −v_i + RiT_Rj v_j + RiT·dt·g = Δv  →  v_j = (RiT_Rj)ᵀ(Δv + v_i − RiT·dt·g)
    v[-1] = RiT_Rj[-1].T @ (delta_v[-1] + v[-2] - dts[-1] * g_i[-1])
    return v


def visual_imu_alignment(R, T, delta_p, delta_v, delta_q, dq_dbg, dts, tic,
                         g_norm=9.81):
    """Full alignment driver (VisualIMUAlignment, initial_aligment.cpp:199).

    NOTE: the caller must repropagate the preintegrations with the solved
    gyro bias BEFORE calling linear_alignment — this function only solves
    the bias; mirroring the reference's two-stage flow."""
    dbg = solve_gyroscope_bias(R, delta_q, dq_dbg)
    return np.asarray(dbg)
