"""Fused per-frame device program: preintegrate → LM solve → yaw-gauge
re-fix → outlier errors → marginalization Hessian, in ONE jitted call.

The estimator's per-frame host loop previously issued 4+ separate device
programs (preintegrate_batch, solve_window, feature_reproj_errors, the
marg assemble) plus dozens of small host↔device transfers, each costing
dispatch latency.  This module traces the whole frame as one XLA
program (reference per-frame flow: vins-mono/src/estimator.cpp:492-503
solveOdometry → :549-600 double2vector gauge re-fix → :1075-1143
backendOptimization/marginalization), so per-frame device work is a
single dispatch + one result fetch.

The marginalization prior CHAIN (Schur of the evicted block, eigh
pseudo-inverse, sqrt form) is NOT here: it runs on the host in float64
(solver/marginalize.py marginalize_*_host) because the prior is the
window's long-memory state and f32 rounding there compounds over a run.
This program only produces the marg subproblem's landmark-eliminated
(Hpp, bp) at the gauge-fixed solution — a single f32 linearization.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import factors, imu
from ..utils import lie
from . import lm
from . import window as W


class FrameOut(NamedTuple):
    states: W.WindowStates      # gauge-fixed solution
    b_prior: jnp.ndarray        # first-order-updated prior rhs
    err_prior: jnp.ndarray
    chi2: jnp.ndarray
    chi2_init: jnp.ndarray
    iterations: jnp.ndarray
    lam: jnp.ndarray
    feat_errs: jnp.ndarray      # (F,) mean reproj error per feature
    marg_Hpp: jnp.ndarray       # (P, P) marg subproblem, landmarks eliminated
    marg_bp: jnp.ndarray        # (P,)


def _gauge_fix(origin_Ps, origin_Qs, s: W.WindowStates) -> W.WindowStates:
    """Yaw-gauge re-fix on device (double2vector, estimator.cpp:549-600):
    rotate the solved window so frame 0 keeps its pre-solve yaw and
    position.  Gimbal-lock (pitch ≈ ±90°) falls back to full rotation
    transfer, branch-free via jnp.where."""
    R0_orig = lie.quat_to_mat(origin_Qs[0])
    R0_new = lie.quat_to_mat(s.Qs[0])
    origin_ypr = lie.mat_to_ypr(R0_orig)
    opt_ypr = lie.mat_to_ypr(R0_new)
    y_diff = origin_ypr[0] - opt_ypr[0]
    rot_diff = lie.ypr_to_mat(
        jnp.stack([y_diff, jnp.zeros_like(y_diff), jnp.zeros_like(y_diff)]))
    gimbal = jnp.logical_or(jnp.abs(jnp.abs(origin_ypr[1]) - 90.0) < 1.0,
                            jnp.abs(jnp.abs(opt_ypr[1]) - 90.0) < 1.0)
    rot_diff = jnp.where(gimbal, R0_orig @ R0_new.T, rot_diff)

    q_diff = lie.mat_to_quat(rot_diff)
    Ps = (s.Ps - s.Ps[0]) @ rot_diff.T + origin_Ps[0]
    Qs = lie.quat_normalize(lie.quat_mul(jnp.broadcast_to(q_diff, s.Qs.shape),
                                         s.Qs))
    Vs = s.Vs @ rot_diff.T
    return s._replace(Ps=Ps, Qs=Qs, Vs=Vs)


@partial(jax.jit, static_argnames=("max_iter", "fix_ext", "loss_delta",
                                   "n_obs", "marg_old", "exact_noise"))
def frame_step(states: W.WindowStates,
               dts, accs, gyrs, mask, acc0, gyr0, imu_valid,
               pts_i, pts_j, start, obs_mask, feat_valid,
               H_prior, b_prior, err_prior, Jt_prior_inv,
               g, noise_diag, proj_sqrt_info,
               max_iter: int = 10, fix_ext: bool = True,
               loss_delta: float = 1.0, n_obs: int | None = None,
               marg_old: bool = True, exact_noise: bool = True) -> FrameOut:
    """One full estimator frame on device.  All array args are raw host
    data (numpy) — one transfer set, one dispatch, one fetch."""
    W1 = states.Ps.shape[0]

    # ---- batched preintegration at the current start-frame biases ----
    st = imu.preintegrate_batch(dts, accs, gyrs, mask, acc0, gyr0,
                                states.Bas[:W1 - 1], states.Bgs[:W1 - 1],
                                noise_diag, exact_noise)
    eye15 = jnp.eye(15, dtype=st.covariance.dtype)
    cov = jnp.where(imu_valid[:, None, None], st.covariance, eye15)
    terms = factors.ImuFactorTerms(
        delta_p=st.delta_p, delta_q=st.delta_q, delta_v=st.delta_v,
        jacobian=st.jacobian, covariance=cov, sum_dt=st.sum_dt,
        linearized_ba=st.linearized_ba, linearized_bg=st.linearized_bg)

    f = W.WindowFactors(
        imu_terms=terms, imu_valid=imu_valid,
        pts_i=pts_i, pts_j=pts_j, start=start, obs_mask=obs_mask,
        feat_valid=feat_valid, H_prior=H_prior, b_prior=b_prior,
        err_prior=err_prior, Jt_prior_inv=Jt_prior_inv, g=g,
        proj_sqrt_info=proj_sqrt_info)

    # ---- LM solve ----
    solved, b_out, err_out, stats = lm.solve_window(
        states, f, max_iter=max_iter, fix_ext=fix_ext,
        loss_delta=loss_delta, n_obs=n_obs)

    # ---- yaw-gauge re-fix ----
    fixed = _gauge_fix(states.Ps, states.Qs, solved)

    # ---- per-feature outlier errors at the solution ----
    errs = W.feature_reproj_errors(fixed, f)

    # ---- marginalization subproblem at the gauge-fixed states ----
    P = W.num_pose_params(W1 - 1)
    if marg_old:
        f_m = f._replace(
            feat_valid=jnp.logical_and(feat_valid, start == 0),
            imu_valid=jnp.logical_and(imu_valid, jnp.arange(W1 - 1) == 0),
            b_prior=b_out, err_prior=err_out)
        n = W.assemble(fixed, f_m, fix_ext=False, loss_delta=loss_delta,
                       n_obs=n_obs)
        mf = f_m.feat_valid
        Hmm_inv = jnp.where(jnp.logical_and(jnp.abs(n.Hmm) > 1e-30, mf),
                            1.0 / jnp.where(jnp.abs(n.Hmm) > 1e-30,
                                            n.Hmm, 1.0), 0.0)
        tempH = n.Hpm * Hmm_inv[None, :]
        marg_Hpp = n.Hpp - tempH @ n.Hpm.T
        marg_bp = n.bp - tempH @ n.bm
    else:
        dt_ = states.Ps.dtype
        marg_Hpp = jnp.zeros((P, P), dt_)
        marg_bp = jnp.zeros((P,), dt_)

    return FrameOut(states=fixed, b_prior=b_out, err_prior=err_out,
                    chi2=stats["chi2"], chi2_init=stats["chi2_init"],
                    iterations=stats["iterations"], lam=stats["lam"],
                    feat_errs=errs, marg_Hpp=marg_Hpp, marg_bp=marg_bp)
