"""Sliding-window BA problem in structure-of-arrays form + GEMM assembly.

Batched replacement for the reference's per-edge Hessian accumulation
(reference: vins-mono/src/backend/problem.cc:303-389 MakeHessian — the
author's own "TODO:: accelate, accelate, accelate" hot loop).

Design: instead of scattering per-edge JᵀWJ blocks into a dense H, every
reprojection factor lives on a dense ``(F, W+1)`` grid with a validity mask.
Per-factor Jacobians are expanded over the frame axis with one-hot outer
products (no dynamic scatter), flattened into a single row-stacked Jacobian
``J ∈ R^{R×P}``, and the pose Hessian is ONE matmul ``JᵀWJ``.
The landmark block is diagonal by construction, so the Schur complement is
an elementwise inverse + one more matmul.

Pose-parameter packing (P = 6 + 15·(W+1)), identical ordering to the
reference's vertex insertion order (estimator.cpp:914-953):
  [ext(0:6) | frame k: pose(6+15k : 12+15k), speedbias(12+15k : 21+15k)]
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import factors
from ..utils import lie


class WindowStates(NamedTuple):
    """Optimizable states (the vertices)."""
    ext_t: jnp.ndarray   # (3,)
    ext_q: jnp.ndarray   # (4,)
    Ps: jnp.ndarray      # (W1, 3)
    Qs: jnp.ndarray      # (W1, 4)
    Vs: jnp.ndarray      # (W1, 3)
    Bas: jnp.ndarray     # (W1, 3)
    Bgs: jnp.ndarray     # (W1, 3)
    inv_dep: jnp.ndarray # (F,)


class WindowFactors(NamedTuple):
    """Static-shape factor data (the edges)."""
    # IMU factors: interval k connects frames k and k+1
    imu_terms: factors.ImuFactorTerms  # batched (W,)
    imu_valid: jnp.ndarray             # (W,) bool
    # Reprojection grid
    pts_i: jnp.ndarray      # (F, 3) bearing in the start (host) frame
    pts_j: jnp.ndarray      # (F, W1, 3) bearing per observing frame
    start: jnp.ndarray      # (F,) int32 start frame index
    obs_mask: jnp.ndarray   # (F, W1) bool; False at j == start and invalid
    feat_valid: jnp.ndarray # (F,) bool — feature participates in the solve
    # Prior (zero-padded to (P, P)/(P,))
    H_prior: jnp.ndarray
    b_prior: jnp.ndarray
    err_prior: jnp.ndarray      # (P,) active in first P-15 entries
    Jt_prior_inv: jnp.ndarray   # (P, P) active in top-left (P-15)²
    # scalars
    g: jnp.ndarray          # (3,) gravity (0, 0, +g_norm)
    proj_sqrt_info: jnp.ndarray  # () focal/1.5


def num_pose_params(window_size: int) -> int:
    return 6 + 15 * (window_size + 1)


def pose_plus(Ps, Qs, dp, dtheta):
    """Batched right-multiplicative pose update (vertex_pose.cc:7-19)."""
    return Ps + dp, lie.quat_normalize(
        lie.quat_mul(Qs, lie.so3_exp_quat(dtheta)))


def apply_delta(states: WindowStates, delta_pose: jnp.ndarray,
                delta_lm: jnp.ndarray) -> WindowStates:
    """Apply a packed local update (UpdateStates, problem.cc:453-463)."""
    W1 = states.Ps.shape[0]
    d_ext = delta_pose[0:6]
    d_frames = delta_pose[6:].reshape(W1, 15)
    ext_t, ext_q = pose_plus(states.ext_t, states.ext_q, d_ext[:3], d_ext[3:6])
    Ps, Qs = pose_plus(states.Ps, states.Qs, d_frames[:, 0:3], d_frames[:, 3:6])
    return WindowStates(
        ext_t=ext_t, ext_q=ext_q, Ps=Ps, Qs=Qs,
        Vs=states.Vs + d_frames[:, 6:9],
        Bas=states.Bas + d_frames[:, 9:12],
        Bgs=states.Bgs + d_frames[:, 12:15],
        inv_dep=states.inv_dep + delta_lm,
    )


# ---------------------------------------------------------------------------
# Residual / chi² evaluation (no Jacobians) — used by the LM accept test
# ---------------------------------------------------------------------------

def _safe_inv_dep(states: WindowStates, f: WindowFactors):
    """Inverse depths with masked-out features clamped to 1.0 — a padded
    slot's 1/0 would otherwise produce inf, and inf·mask(0) = NaN poisons
    the Hessian GEMMs even though chi² itself is masked."""
    return jnp.where(f.feat_valid, states.inv_dep, 1.0)


def _reproj_residuals(states: WindowStates, f: WindowFactors):
    """All reprojection residuals on the (F, W1) grid → (F, W1, 2)."""
    Pi = states.Ps[f.start]          # (F, 3)
    Qi = states.Qs[f.start]          # (F, 4)

    def per_obs(inv_dep, Pi_, Qi_, pts_i, Pj, Qj, pts_j):
        return factors.reproj_residual(inv_dep, Pi_, Qi_, Pj, Qj,
                                       states.ext_t, states.ext_q, pts_i, pts_j)

    # vmap over frames j then features f
    fn = jax.vmap(jax.vmap(per_obs, in_axes=(None, None, None, None, 0, 0, 0)),
                  in_axes=(0, 0, 0, 0, None, None, 0))
    return fn(_safe_inv_dep(states, f), Pi, Qi, f.pts_i,
              states.Ps, states.Qs, f.pts_j)


@jax.jit
def feature_reproj_errors(states: WindowStates, f: WindowFactors):
    """Mean reprojection error per feature over its observed frames, in
    normalized-plane units (F,).  Multiply by the focal length for pixels.
    Drives post-solve outlier rejection (the full VINS-Mono's
    FeatureManager::removeOutlier step — features whose constant
    measurement offset is inconsistent with any rigid 3D point show up
    here and would otherwise bias the window scale)."""
    r = _reproj_residuals(states, f)                    # (F, W1, 2)
    e = jnp.linalg.norm(r, axis=-1)                     # (F, W1)
    m = f.obs_mask & f.feat_valid[:, None]
    n = jnp.maximum(jnp.sum(m, axis=1), 1)
    return jnp.sum(jnp.where(m, e, 0.0), axis=1) / n


def _imu_residuals(states: WindowStates, f: WindowFactors):
    """(W, 15) IMU residuals for intervals k → k+1."""
    W1 = states.Ps.shape[0]

    def per_interval(terms, Pi, Qi, Vi, Bai, Bgi, Pj, Qj, Vj, Baj, Bgj):
        return factors.imu_residual(terms, f.g, Pi, Qi, Vi, Bai, Bgi,
                                    Pj, Qj, Vj, Baj, Bgj)

    fn = jax.vmap(per_interval)
    i = slice(0, W1 - 1)
    j = slice(1, W1)
    return fn(f.imu_terms,
              states.Ps[i], states.Qs[i], states.Vs[i], states.Bas[i], states.Bgs[i],
              states.Ps[j], states.Qs[j], states.Vs[j], states.Bas[j], states.Bgs[j])


def _imu_infos(f: WindowFactors):
    """(W, 15, 15) information = covariance⁻¹ (edge_imu.cc:35)."""
    eye = jnp.eye(15, dtype=f.imu_terms.covariance.dtype)
    return jax.vmap(lambda C: jnp.linalg.solve(C, eye))(f.imu_terms.covariance)


def robust_chi2(states: WindowStates, f: WindowFactors,
                loss_delta: float = 1.0, imu_infos=None) -> jnp.ndarray:
    """0.5 · (Σ robust chi² over edges + ‖err_prior‖)
    (reference problem.cc:497-507 / 549-556)."""
    rr = _reproj_residuals(states, f)                       # (F, W1, 2)
    info = f.proj_sqrt_info ** 2
    e2 = info * jnp.sum(rr * rr, axis=-1)                   # (F, W1)
    rho0, _, _ = factors.cauchy_rho(e2, loss_delta)
    m = f.obs_mask & f.feat_valid[:, None]
    chi = jnp.sum(jnp.where(m, rho0, 0.0))

    ir = _imu_residuals(states, f)                          # (W, 15)
    infos = _imu_infos(f) if imu_infos is None else imu_infos
    imu_e2 = jnp.einsum("wr,wrs,ws->w", ir, infos, ir)
    chi = chi + jnp.sum(jnp.where(f.imu_valid, imu_e2, 0.0))

    chi = chi + jnp.linalg.norm(f.err_prior)
    return 0.5 * chi


# ---------------------------------------------------------------------------
# Hessian assembly (MakeHessian, problem.cc:303-389) — the GEMM path
# ---------------------------------------------------------------------------

class Normal(NamedTuple):
    """Block normal equations with diagonal landmark block."""
    Hpp: jnp.ndarray   # (P, P)
    bp: jnp.ndarray    # (P,)
    Hpm: jnp.ndarray   # (P, F)
    Hmm: jnp.ndarray   # (F,)
    bm: jnp.ndarray    # (F,)
    chi2: jnp.ndarray  # () current robust chi² (0.5-scaled)


@partial(jax.jit, static_argnames=("fix_ext", "loss_delta", "n_obs"))
def assemble(states: WindowStates, f: WindowFactors,
             fix_ext: bool = True, loss_delta: float = 1.0,
             imu_infos=None, n_obs: int | None = None) -> Normal:
    """imu_infos: optional precomputed (W, 15, 15) information matrices —
    they depend only on the preintegration covariances, which are constant
    across LM iterations, so callers in a solve loop compute them once.

    n_obs: optional static live-observation cap.  When set, the (F, W1)
    grid is compacted to the first n_obs live cells (static-size
    ``jnp.nonzero`` gather) before Jacobian evaluation, so the row count
    of the JᵀWJ GEMM scales with LIVE factors, not grid capacity — at the
    reference's F=1024 EuRoC shape (parameters.h:37) only ~8 % of grid
    cells are live and the grid path pays ~3× pure padding tax.  Callers
    must ensure the live count fits (overflow silently drops factors);
    None keeps the exact dense-grid path."""
    W1 = states.Ps.shape[0]
    F = states.inv_dep.shape[0]
    P = num_pose_params(W1 - 1)
    dtype = states.Ps.dtype

    ext_scale = jnp.asarray(0.0 if fix_ext else 1.0, dtype)
    s2 = f.proj_sqrt_info ** 2
    eye2 = jnp.eye(2, dtype=dtype)
    eyeW = jnp.eye(W1, dtype=dtype)                              # (W1, W1) [j]

    def per_obs(inv_dep, Pi_, Qi_, pts_i, Pj, Qj, pts_j):
        r = factors.reproj_residual(inv_dep, Pi_, Qi_, Pj, Qj,
                                    states.ext_t, states.ext_q, pts_i, pts_j)
        Jd, Jpi, Jpj, Jext = factors.reproj_jacobians(
            inv_dep, Pi_, Qi_, Pj, Qj, states.ext_t, states.ext_q, pts_i, pts_j)
        return r, Jd, Jpi, Jpj, Jext

    if n_obs is None:
        # ---------------- reprojection factors: dense (F, W1) grid ------
        Pi = states.Ps[f.start]
        Qi = states.Qs[f.start]
        fn = jax.vmap(jax.vmap(per_obs,
                               in_axes=(None, None, None, None, 0, 0, 0)),
                      in_axes=(0, 0, 0, 0, None, None, 0))
        r, Jd, Jpi, Jpj, Jext = fn(_safe_inv_dep(states, f), Pi, Qi, f.pts_i,
                                   states.Ps, states.Qs, f.pts_j)
        # shapes: r (F,W1,2), Jd (F,W1,2,1), Jpi/Jpj/Jext (F,W1,2,6)

        mask = (f.obs_mask & f.feat_valid[:, None]).astype(dtype)   # (F, W1)

        # robust Cauchy weighting (edge.cc RobustInfo)
        e2 = s2 * jnp.sum(r * r, axis=-1)                            # (F, W1)
        rho0, rho1, rho2 = factors.cauchy_rho(e2, loss_delta)
        w_err = f.proj_sqrt_info * r                                 # sqrt_info · r
        guard = (rho1 + 2.0 * rho2 * e2 > 0.0).astype(dtype)
        # robust_info = (rho1·I + guard·2·rho2·w_err w_errᵀ) · (s²·I)
        rinfo = (rho1[..., None, None] * eye2 +
                 (guard * 2.0 * rho2)[..., None, None] *
                 (w_err[..., :, None] * w_err[..., None, :])) * s2   # (F,W1,2,2)

        # expand per-frame pose Jacobians over the frame axis with one-hots
        onehot_i = jax.nn.one_hot(f.start, W1, dtype=dtype)          # (F, W1)
        Jframes6 = (jnp.einsum("fjab,fk->fjakb", Jpi, onehot_i) +
                    jnp.einsum("fjab,jk->fjakb", Jpj, eyeW))         # (F,W1,2,W1,6)
        # embed pose(6) into frame-block(15) columns, speed-bias cols stay zero
        Jframes = jnp.zeros((F, W1, 2, W1, 15), dtype)
        Jframes = Jframes.at[..., 0:6].set(Jframes6)
        Jfull = jnp.concatenate(
            [Jext * ext_scale, Jframes.reshape(F, W1, 2, W1 * 15)], axis=-1)  # (F,W1,2,P)
        Jfull = Jfull * mask[..., None, None]

        WJ = jnp.einsum("fjrs,fjsp->fjrp", rinfo, Jfull)             # robust_info · J
        Jmat = Jfull.reshape(F * W1 * 2, P)
        WJmat = WJ.reshape(F * W1 * 2, P)
        Hpp = Jmat.T @ WJmat                                          # ← GEMM

        # b = -Σ drho · Jᵀ · info · r   (info = s²·I, drho = rho1)
        info_r = (s2 * rho1[..., None] * mask[..., None]) * r         # (F,W1,2)
        bp = -jnp.einsum("fjrp,fjr->p", Jfull, info_r)

        # landmark (inverse-depth) blocks
        Jd2 = Jd[..., 0] * mask[..., None]                            # (F,W1,2)
        WJd = jnp.einsum("fjrs,fjs->fjr", rinfo, Jd2)
        Hpm = jnp.einsum("fjrp,fjr->pf", Jfull, WJd)                  # (P, F)
        Hmm = jnp.einsum("fjr,fjr->f", Jd2, WJd)                      # (F,)
        bm = -jnp.einsum("fjr,fjr->f", Jd2, info_r)

        chi = jnp.sum(jnp.where(mask > 0, rho0, 0.0))
    else:
        # ------------- reprojection factors: compacted live list --------
        grid_mask = f.obs_mask & f.feat_valid[:, None]               # (F, W1)
        flat = grid_mask.reshape(-1)
        cnt = jnp.sum(flat)
        (idx,) = jnp.nonzero(flat, size=n_obs, fill_value=0)         # (n_obs,)
        fo = idx // W1                                               # (n_obs,)
        jo = idx % W1
        ovalid = (jnp.arange(n_obs) < cnt).astype(dtype)             # (n_obs,)

        inv_all = _safe_inv_dep(states, f)
        fn = jax.vmap(per_obs)
        r, Jd, Jpi, Jpj, Jext = fn(
            inv_all[fo], states.Ps[f.start[fo]], states.Qs[f.start[fo]],
            f.pts_i[fo], states.Ps[jo], states.Qs[jo], f.pts_j[fo, jo])
        # shapes: r (n_obs,2), Jd (n_obs,2,1), Jpi/Jpj/Jext (n_obs,2,6)

        e2 = s2 * jnp.sum(r * r, axis=-1)                            # (n_obs,)
        rho0, rho1, rho2 = factors.cauchy_rho(e2, loss_delta)
        w_err = f.proj_sqrt_info * r
        guard = (rho1 + 2.0 * rho2 * e2 > 0.0).astype(dtype)
        rinfo = (rho1[..., None, None] * eye2 +
                 (guard * 2.0 * rho2)[..., None, None] *
                 (w_err[..., :, None] * w_err[..., None, :])) * s2   # (n_obs,2,2)

        oh_i = jax.nn.one_hot(f.start[fo], W1, dtype=dtype)          # (n_obs, W1)
        oh_j = jax.nn.one_hot(jo, W1, dtype=dtype)
        Jframes6 = (jnp.einsum("oab,ok->oakb", Jpi, oh_i) +
                    jnp.einsum("oab,ok->oakb", Jpj, oh_j))           # (n_obs,2,W1,6)
        Jframes = jnp.zeros((n_obs, 2, W1, 15), dtype)
        Jframes = Jframes.at[..., 0:6].set(Jframes6)
        Jfull = jnp.concatenate(
            [Jext * ext_scale, Jframes.reshape(n_obs, 2, W1 * 15)],
            axis=-1)                                                 # (n_obs,2,P)
        Jfull = Jfull * ovalid[:, None, None]

        WJ = jnp.einsum("ors,osp->orp", rinfo, Jfull)
        Hpp = Jfull.reshape(n_obs * 2, P).T @ WJ.reshape(n_obs * 2, P)  # GEMM

        info_r = (s2 * rho1[..., None] * ovalid[:, None]) * r        # (n_obs,2)
        bp = -jnp.einsum("orp,or->p", Jfull, info_r)

        Jd2 = Jd[..., 0] * ovalid[:, None]                           # (n_obs,2)
        WJd = jnp.einsum("ors,os->or", rinfo, Jd2)
        ohf = jax.nn.one_hot(fo, F, dtype=dtype) * ovalid[:, None]   # (n_obs,F)
        Hpm = jnp.einsum("orp,or->op", Jfull, WJd).T @ ohf           # (P, F)
        Hmm = ohf.T @ jnp.einsum("or,or->o", Jd2, WJd)               # (F,)
        bm = -(ohf.T @ jnp.einsum("or,or->o", Jd2, info_r))

        chi = jnp.sum(rho0 * ovalid)

    # ---------------- IMU factors ----------------
    def per_interval(terms, Pi_, Qi_, Vi, Bai, Bgi, Pj, Qj, Vj, Baj, Bgj):
        res = factors.imu_residual(terms, f.g, Pi_, Qi_, Vi, Bai, Bgi,
                                   Pj, Qj, Vj, Baj, Bgj)
        Js = factors.imu_jacobians(terms, f.g, Pi_, Qi_, Vi, Bai, Bgi,
                                   Pj, Qj, Vj, Baj, Bgj)
        return res, Js

    i = slice(0, W1 - 1)
    j = slice(1, W1)
    ir, (Jpi_m, Jsbi_m, Jpj_m, Jsbj_m) = jax.vmap(per_interval)(
        f.imu_terms,
        states.Ps[i], states.Qs[i], states.Vs[i], states.Bas[i], states.Bgs[i],
        states.Ps[j], states.Qs[j], states.Vs[j], states.Bas[j], states.Bgs[j])

    W = W1 - 1
    imu_m = f.imu_valid.astype(dtype)
    Ji = jnp.concatenate([Jpi_m, Jsbi_m], axis=-1)                # (W, 15, 15)
    Jj = jnp.concatenate([Jpj_m, Jsbj_m], axis=-1)
    oh_i = eyeW[:W]                                               # (W, W1)
    oh_j = eyeW[1:]                                               # (W, W1)
    Jfr = (jnp.einsum("wab,wk->wakb", Ji, oh_i) +
           jnp.einsum("wab,wk->wakb", Jj, oh_j)).reshape(W, 15, W1 * 15)
    Jimu = jnp.concatenate([jnp.zeros((W, 15, 6), dtype), Jfr], axis=-1)
    Jimu = Jimu * imu_m[:, None, None]

    infos = _imu_infos(f) if imu_infos is None else imu_infos     # (W, 15, 15)
    WJi = jnp.einsum("wrs,wsp->wrp", infos, Jimu)
    Hpp = Hpp + jnp.einsum("wrp,wrq->pq", Jimu, WJi)
    info_ir = jnp.einsum("wrs,ws->wr", infos, ir) * imu_m[:, None]
    bp = bp - jnp.einsum("wrp,wr->p", Jimu, info_ir)
    chi = chi + jnp.sum(jnp.where(f.imu_valid,
                                  jnp.einsum("wr,wr->w", ir, info_ir), 0.0))

    # ---------------- prior fold (problem.cc:365-384) ----------------
    free = jnp.ones((P,), dtype)
    if fix_ext:
        free = free.at[0:6].set(0.0)
    Hp = f.H_prior * free[:, None] * free[None, :]
    Hpp = Hpp + Hp
    bp = bp + f.b_prior * free

    chi = chi + jnp.linalg.norm(f.err_prior)
    return Normal(Hpp=Hpp, bp=bp, Hpm=Hpm, Hmm=Hmm, bm=bm, chi2=0.5 * chi)
