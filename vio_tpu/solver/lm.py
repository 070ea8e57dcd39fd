"""Levenberg-Marquardt (Nielsen) solver for the sliding window, fully jitted.

Re-derivation of the reference's Problem::Solve
(reference: vins-mono/src/backend/problem.cc:169-250 outer/inner loops,
:394-451 SolveLinearSystem with landmark Schur, :497-522 ComputeLambdaInitLM,
:541-573 IsGoodStepInLM Nielsen rule).  The nested retry loop is flattened
into a single ``lax.while_loop`` whose body performs one λ-attempt; state
rollback is free because states are immutable pytrees.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import window as W
from ..ops import linsolve


class LMState(NamedTuple):
    states: W.WindowStates
    b_prior: jnp.ndarray
    err_prior: jnp.ndarray
    normal: W.Normal
    lam: jnp.ndarray
    ni: jnp.ndarray
    chi: jnp.ndarray
    last_chi: jnp.ndarray
    it: jnp.ndarray
    false_cnt: jnp.ndarray
    stop: jnp.ndarray


def schur_solve(normal: W.Normal, lam, feat_valid):
    """Landmark Schur elimination + damped pose solve + back-substitution
    (problem.cc:409-446).  λ is added to the pose block diagonal only,
    exactly like the reference."""
    Hmm_inv = jnp.where(jnp.abs(normal.Hmm) > 1e-30, 1.0 / normal.Hmm, 0.0)
    Hmm_inv = jnp.where(feat_valid, Hmm_inv, 0.0)
    tempH = normal.Hpm * Hmm_inv[None, :]                    # Hpm · Hmm⁻¹
    Hpp_schur = normal.Hpp - tempH @ normal.Hpm.T            # ← GEMM
    bp_schur = normal.bp - tempH @ normal.bm
    P = Hpp_schur.shape[0]
    Hpp_schur = Hpp_schur + lam * jnp.eye(P, dtype=Hpp_schur.dtype)
    dx_p = linsolve.spd_solve(Hpp_schur, bp_schur)
    dx_m = Hmm_inv * (normal.bm - normal.Hpm.T @ dx_p)
    return dx_p, dx_m


@partial(jax.jit, static_argnames=("max_iter", "fix_ext", "loss_delta",
                                   "n_obs"))
def solve_window(states: W.WindowStates, f: W.WindowFactors,
                 max_iter: int = 10, fix_ext: bool = True,
                 loss_delta: float = 1.0, n_obs: int | None = None):
    """Run LM on the window problem.  Returns (states, b_prior, err_prior,
    stats dict).  b_prior/err_prior carry the first-order prior update
    accumulated over accepted steps (problem.cc:466-478).  n_obs: optional
    static live-observation cap — see window.assemble."""
    # IMU information matrices are constant across iterations: invert once.
    imu_infos = W._imu_infos(f)
    normal0 = W.assemble(states, f, fix_ext=fix_ext, loss_delta=loss_delta,
                         imu_infos=imu_infos, n_obs=n_obs)

    # λ0 = 1e-5 · min(max |diag|, 5e10) over the FULL diagonal (poses+landmarks)
    max_diag = jnp.maximum(jnp.max(jnp.abs(jnp.diagonal(normal0.Hpp))),
                           jnp.max(jnp.abs(normal0.Hmm)))
    lam0 = 1e-5 * jnp.minimum(max_diag, 5e10)

    init = LMState(
        states=states, b_prior=f.b_prior, err_prior=f.err_prior,
        normal=normal0, lam=lam0,
        ni=jnp.asarray(2.0, normal0.chi2.dtype),
        chi=normal0.chi2,
        last_chi=jnp.asarray(1e20, normal0.chi2.dtype),
        it=jnp.asarray(0, jnp.int32),
        false_cnt=jnp.asarray(0, jnp.int32),
        stop=jnp.asarray(False),
    )

    def cond(s: LMState):
        return jnp.logical_and(~s.stop, s.it < max_iter)

    def body(s: LMState):
        dx_p, dx_m = schur_solve(s.normal, s.lam, f.feat_valid)
        cand = W.apply_delta(s.states, dx_p, dx_m)

        # first-order prior update (problem.cc:466-478)
        cand_b_prior = s.b_prior - f.H_prior @ dx_p
        cand_err = -(f.Jt_prior_inv @ cand_b_prior)

        f_cand = f._replace(b_prior=cand_b_prior, err_prior=cand_err)
        # One assembly per attempt: its chi2 IS the candidate cost, and on
        # accept the normal equations are already built for the next step
        # (the reference evaluates chi then re-runs MakeHessian; fused here).
        normal_cand = W.assemble(cand, f_cand, fix_ext=fix_ext,
                                 loss_delta=loss_delta, imu_infos=imu_infos,
                                 n_obs=n_obs)
        temp_chi = normal_cand.chi2

        dx_full = jnp.concatenate([dx_p, dx_m])
        b_full = jnp.concatenate([s.normal.bp, s.normal.bm])
        scale = 0.5 * jnp.dot(dx_full, s.lam * dx_full + b_full) + 1e-6
        rho = (s.chi - temp_chi) / scale
        good = jnp.logical_and(rho > 0, jnp.isfinite(temp_chi))

        def accept(s):
            alpha = jnp.minimum(1.0 - (2.0 * rho - 1.0) ** 3, 2.0 / 3.0)
            lam = s.lam * jnp.maximum(1.0 / 3.0, alpha)
            stop = (s.last_chi - temp_chi) < 1e-5
            return s._replace(
                states=cand, b_prior=cand_b_prior, err_prior=cand_err,
                normal=normal_cand, lam=lam, ni=jnp.asarray(2.0, s.ni.dtype),
                chi=temp_chi, last_chi=temp_chi,
                it=s.it + 1, false_cnt=jnp.asarray(0, jnp.int32), stop=stop)

        def reject(s):
            overflow = s.false_cnt + 1 >= 10
            stop = jnp.logical_and(overflow, (s.last_chi - s.chi) < 1e-5)
            return s._replace(
                lam=s.lam * s.ni, ni=s.ni * 2.0,
                it=jnp.where(overflow, s.it + 1, s.it),
                false_cnt=jnp.where(overflow, 0, s.false_cnt + 1),
                last_chi=jnp.where(overflow, s.chi, s.last_chi),
                stop=stop)

        return jax.lax.cond(good, accept, reject, s)

    out = jax.lax.while_loop(cond, body, init)
    stats = dict(chi2=out.chi, iterations=out.it, lam=out.lam,
                 chi2_init=normal0.chi2)
    return out.states, out.b_prior, out.err_prior, stats
