"""Marginalization of evicted keyframes into an eigendecomposed Hessian prior.

Re-derivation of Problem::Marginalize
(reference: vins-mono/src/backend/problem.cc:617-795): build the Hessian over
the marg frame's factors, Schur-eliminate its landmarks, fold the old prior,
permute the marginalized pose+speedbias block to the bottom-right, eliminate
it with an eigh-based pseudo-inverse (eps=1e-8), and recover the sqrt-form
(Jt_prior_inv, err_prior) via the eigenvalue square root.

All permutations are static gathers (the marg block position is fixed by the
window policy), so everything jits with fixed shapes.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from . import window as W

EPS = 1e-8


def _eigh_schur(H, b, n_keep):
    """Eliminate the trailing block of H (rows/cols n_keep:) with the
    eigendecomposed pseudo-inverse (problem.cc:747-764)."""
    Amm = 0.5 * (H[n_keep:, n_keep:] + H[n_keep:, n_keep:].T)
    w, V = jnp.linalg.eigh(Amm)
    w_inv = jnp.where(w > EPS, 1.0 / jnp.where(w > EPS, w, 1.0), 0.0)
    Amm_inv = (V * w_inv[None, :]) @ V.T
    Arm = H[:n_keep, n_keep:]
    tempB = Arm @ Amm_inv
    H_new = H[:n_keep, :n_keep] - tempB @ H[n_keep:, :n_keep]
    b_new = b[:n_keep] - tempB @ b[n_keep:]
    return H_new, b_new


def _sqrt_form(H, b):
    """(Jt_prior_inv, err_prior, H_clean) via eigh square-root
    (problem.cc:766-779)."""
    w, V = jnp.linalg.eigh(H)
    S = jnp.where(w > EPS, w, 0.0)
    S_inv = jnp.where(w > EPS, 1.0 / jnp.where(w > EPS, w, 1.0), 0.0)
    Jt_inv = jnp.sqrt(S_inv)[:, None] * V.T
    err = -(Jt_inv @ b)
    J = jnp.sqrt(S)[:, None] * V.T
    H_clean = J.T @ J
    H_clean = jnp.where(jnp.abs(H_clean) > 1e-9, H_clean, 0.0)
    return Jt_inv, err, H_clean


def _finalize(H_perm, b_perm, P):
    """Eliminate the trailing 15-dim marg block, then zero-pad everything
    back to the static size P (the reference's ExtendHessiansPriorSize(15)
    at the next solve, problem.cc:82-91)."""
    n_keep = P - 15
    H_new, b_new = _eigh_schur(H_perm, b_perm, n_keep)
    Jt_inv, err, H_clean = _sqrt_form(H_new, b_new)
    Hp = jnp.zeros((P, P), H_new.dtype).at[:n_keep, :n_keep].set(H_clean)
    bp = jnp.zeros((P,), b_new.dtype).at[:n_keep].set(b_new)
    errp = jnp.zeros((P,), b_new.dtype).at[:n_keep].set(err)
    Jtp = jnp.zeros((P, P), H_new.dtype).at[:n_keep, :n_keep].set(Jt_inv)
    return Hp, bp, errp, Jtp


def _perm_drop_frame(P: int, k: int):
    """Permutation moving frame k's 15-dim block to the end (static)."""
    i0 = 6 + 15 * k
    idx = list(range(0, i0)) + list(range(i0 + 15, P)) + list(range(i0, i0 + 15))
    return jnp.asarray(idx, jnp.int32)


@partial(jax.jit, static_argnames=("loss_delta",))
def marginalize_old(states: W.WindowStates, f: W.WindowFactors,
                    loss_delta: float = 1.0):
    """Marginalize frame 0 (MargOldFrame, estimator.cpp:693-829):
    factors = IMU interval 0 + all observations of landmarks hosted by
    frame 0 (Cauchy loss); landmarks Schur-eliminated; prior folded; frame-0
    pose+speedbias eliminated.  Returns (H_prior, b_prior, err_prior,
    Jt_prior_inv) zero-padded to the static pose-param size."""
    W1 = states.Ps.shape[0]
    P = W.num_pose_params(W1 - 1)

    marg_feat = jnp.logical_and(f.feat_valid, f.start == 0)
    f_marg = f._replace(
        feat_valid=marg_feat,
        imu_valid=jnp.logical_and(
            f.imu_valid, jnp.arange(W1 - 1) == 0),
    )
    # assemble WITHOUT fixed-vertex zeroing (Marginalize has none); the prior
    # fold inside assemble matches problem.cc:711-715 since the prior is
    # additive to the pose block only.
    n = W.assemble(states, f_marg, fix_ext=False, loss_delta=loss_delta)

    # landmark Schur (problem.cc:686-708)
    Hmm_inv = jnp.where(jnp.abs(n.Hmm) > 1e-30, 1.0 / n.Hmm, 0.0)
    Hmm_inv = jnp.where(marg_feat, Hmm_inv, 0.0)
    tempH = n.Hpm * Hmm_inv[None, :]
    Hpp = n.Hpp - tempH @ n.Hpm.T
    bp = n.bp - tempH @ n.bm

    perm = _perm_drop_frame(P, 0)
    H_perm = Hpp[perm][:, perm]
    b_perm = bp[perm]
    return _finalize(H_perm, b_perm, P)


@jax.jit
def marginalize_new(f: W.WindowFactors):
    """Marginalize frame W-1 out of the prior only (MargNewFrame,
    estimator.cpp:830-901 — the problem there contains no edges).  The
    window size is recovered from the prior's static shape."""
    P = f.H_prior.shape[0]
    W1 = (P - 6) // 15
    perm = _perm_drop_frame(P, W1 - 2)
    H_perm = f.H_prior[perm][:, perm]
    b_perm = f.b_prior[perm]
    return _finalize(H_perm, b_perm, P)


# ---------------------------------------------------------------------------
# Host-f64 twin of the prior chain
# ---------------------------------------------------------------------------
# The marginalization prior is the window's only long-memory state: its
# eigh pseudo-inverse + sqrt-form is re-folded every frame, so f32
# rounding there compounds over a full run (the reference needed
# f64-class care at exactly this step, problem.cc:747-779).  The factor
# LINEARIZATION stays on device (one f32 assemble — single-shot rounding,
# harmless); the Schur/perm/eigh/sqrt chain runs on the host in float64.
# P is tiny (6+15·(W+1) = 171 at W=10): microseconds in numpy.

import numpy as _np


def _eigh_schur_np(H, b, n_keep):
    Amm = 0.5 * (H[n_keep:, n_keep:] + H[n_keep:, n_keep:].T)
    w, V = _np.linalg.eigh(Amm)
    w_inv = _np.where(w > EPS, 1.0 / _np.where(w > EPS, w, 1.0), 0.0)
    Amm_inv = (V * w_inv[None, :]) @ V.T
    tempB = H[:n_keep, n_keep:] @ Amm_inv
    return (H[:n_keep, :n_keep] - tempB @ H[n_keep:, :n_keep],
            b[:n_keep] - tempB @ b[n_keep:])


def _sqrt_form_np(H, b):
    w, V = _np.linalg.eigh(H)
    S = _np.where(w > EPS, w, 0.0)
    S_inv = _np.where(w > EPS, 1.0 / _np.where(w > EPS, w, 1.0), 0.0)
    Jt_inv = _np.sqrt(S_inv)[:, None] * V.T
    err = -(Jt_inv @ b)
    J = _np.sqrt(S)[:, None] * V.T
    H_clean = J.T @ J
    H_clean = _np.where(_np.abs(H_clean) > 1e-9, H_clean, 0.0)
    return Jt_inv, err, H_clean


def _finalize_np(H_perm, b_perm, P):
    n_keep = P - 15
    H_new, b_new = _eigh_schur_np(H_perm, b_perm, n_keep)
    Jt_inv, err, H_clean = _sqrt_form_np(H_new, b_new)
    Hp = _np.zeros((P, P))
    bp = _np.zeros(P)
    errp = _np.zeros(P)
    Jtp = _np.zeros((P, P))
    Hp[:n_keep, :n_keep] = H_clean
    bp[:n_keep] = b_new
    errp[:n_keep] = err
    Jtp[:n_keep, :n_keep] = Jt_inv
    return Hp, bp, errp, Jtp


def _perm_np(P, k):
    i0 = 6 + 15 * k
    return _np.asarray(list(range(0, i0)) + list(range(i0 + 15, P)) +
                       list(range(i0, i0 + 15)), _np.int64)


def marginalize_old_host(states: W.WindowStates, f: W.WindowFactors,
                         loss_delta: float = 1.0, n_obs: int | None = None):
    """marginalize_old with the prior chain in host float64.  The Hessian
    of the marg frame's factors is assembled on device (device dtype),
    everything after runs in numpy f64.  Returns host float64 arrays."""
    W1 = states.Ps.shape[0]
    P = W.num_pose_params(W1 - 1)
    marg_feat = jnp.logical_and(f.feat_valid, f.start == 0)
    f_marg = f._replace(
        feat_valid=marg_feat,
        imu_valid=jnp.logical_and(f.imu_valid, jnp.arange(W1 - 1) == 0))
    n = W.assemble(states, f_marg, fix_ext=False, loss_delta=loss_delta,
                   n_obs=n_obs)
    Hpp = _np.asarray(n.Hpp, _np.float64)
    bp = _np.asarray(n.bp, _np.float64)
    Hpm = _np.asarray(n.Hpm, _np.float64)
    Hmm = _np.asarray(n.Hmm, _np.float64)
    bm = _np.asarray(n.bm, _np.float64)
    mf = _np.asarray(marg_feat)

    Hmm_inv = _np.where((_np.abs(Hmm) > 1e-30) & mf, 1.0 /
                        _np.where(_np.abs(Hmm) > 1e-30, Hmm, 1.0), 0.0)
    tempH = Hpm * Hmm_inv[None, :]
    Hpp = Hpp - tempH @ Hpm.T
    bp = bp - tempH @ bm

    perm = _perm_np(P, 0)
    return _finalize_np(Hpp[perm][:, perm], bp[perm], P)


def marginalize_new_host(H_prior: _np.ndarray, b_prior: _np.ndarray):
    """marginalize_new entirely on the host (the problem contains no
    edges — prior only, estimator.cpp:830-901): zero device calls."""
    P = H_prior.shape[0]
    W1 = (P - 6) // 15
    perm = _perm_np(P, W1 - 2)
    H_perm = _np.asarray(H_prior, _np.float64)[perm][:, perm]
    b_perm = _np.asarray(b_prior, _np.float64)[perm]
    return _finalize_np(H_perm, b_perm, P)


def finalize_old_from_blocks(marg_Hpp, marg_bp):
    """Host-f64 prior chain from the fused frame_step's marg subproblem
    blocks (landmarks already Schur-eliminated on device): permute the
    evicted frame-0 block to the bottom-right, eigh-eliminate it, and
    recover the sqrt form.  Returns host float64 (Hp, bp, errp, Jtp)."""
    P = marg_Hpp.shape[0]
    perm = _perm_np(P, 0)
    H_perm = _np.asarray(marg_Hpp, _np.float64)[perm][:, perm]
    b_perm = _np.asarray(marg_bp, _np.float64)[perm]
    return _finalize_np(H_perm, b_perm, P)
