"""Structure-from-motion bootstrap: DLT triangulation, GN PnP, RANSAC
relative pose, and incremental global SfM over the init window.

Re-derivation in JAX of the reference initialization pipeline
(reference: vins-mono/src/initial/initial_sfm.cpp:5-313 GlobalSFM,
initial/solve_5pts.cpp:5-230 MotionEstimator, and the GN-PnP of
05-frontend-feature-matching/03-pnp/GN-BA.cpp:64-157).  The geometry
kernels are pure vmappable jnp; RANSAC is a fixed-size batched hypothesis
sweep (no data-dependent loop).  The final windowed BA runs on the generic
LM solver — no Ceres anywhere (the reference's only Ceres use in the solve
path, initial_sfm.cpp:254-302, is replaced).

Camera-pose convention throughout: (R, t) = world→camera, x_cam = R X + t.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..utils import lie
from ..solver import generic


# ---------------------------------------------------------------------------
# Multi-view DLT triangulation (initial_sfm.cpp:5-19, feature_manager.cpp:243)
# ---------------------------------------------------------------------------

def triangulate_dlt(Rs, ts, obs, mask):
    """Triangulate one point from K masked views.

    Rs (K,3,3), ts (K,3): world→camera.  obs (K,2) normalized coords.
    mask (K,): which views observe the point.  Returns (X (3,), sv_ratio)
    where sv_ratio = sigma3/sigma4 — the triangulation quality measure of
    the reference (16-visual-frontend/src/triangulate.cpp:111-178)."""
    P = jnp.concatenate([Rs, ts[..., None]], axis=-1)          # (K, 3, 4)
    m = mask[:, None].astype(Rs.dtype)
    rows = jnp.concatenate([
        (obs[:, 0:1] * P[:, 2] - P[:, 0]) * m,                  # (K, 4)
        (obs[:, 1:2] * P[:, 2] - P[:, 1]) * m,
    ], axis=0)                                                  # (2K, 4)
    # SVD of the design matrix; solution = right singular vector of sigma_min
    _, s, Vt = jnp.linalg.svd(rows, full_matrices=False)
    X_h = Vt[-1]
    X = X_h[:3] / X_h[3]
    sv_ratio = s[2] / jnp.maximum(s[3], 1e-30)
    return X, sv_ratio


triangulate_dlt_batch = jax.vmap(triangulate_dlt, in_axes=(None, None, 0, 0))


def triangulate_two_frames(R0, t0, R1, t1, xy0, xy1):
    """Two-view DLT (initial_sfm.cpp:74-110), vmappable over points."""
    Rs = jnp.stack([R0, R1])
    ts = jnp.stack([t0, t1])
    obs = jnp.stack([xy0, xy1])
    X, _ = triangulate_dlt(Rs, ts, obs, jnp.ones(2, bool))
    return X


# ---------------------------------------------------------------------------
# Gauss-Newton PnP (solveFrameByPnP, initial_sfm.cpp:22-72; GN math per the
# 05-pnp reference) — fixed-iteration, jittable, robust to masked points
# ---------------------------------------------------------------------------

@jax.jit
def pnp_dlt(X, obs, mask):
    """Linear PnP (direct linear transform): world→camera (R, t) from ≥6
    correspondences, no initial guess needed.  Solves the 12-parameter
    projective pose by SVD, fixes the cheirality sign, and projects onto
    SO(3).  Accuracy is a few percent — intended as the INITIALIZER for
    pnp_gn when no trustworthy pose guess exists (e.g. loop verification
    across large accumulated drift, where the odometry relative pose can
    be meters off and plain GN diverges).

    X (N,3) world points, obs (N,2) normalized coords, mask (N,)."""
    n = X.shape[0]
    w = mask.astype(X.dtype)[:, None]
    Xh = jnp.concatenate([X, jnp.ones((n, 1), X.dtype)], axis=1)   # (N,4)
    z4 = jnp.zeros_like(Xh)
    r1 = jnp.concatenate([Xh, z4, -obs[:, 0:1] * Xh], axis=1)      # (N,12)
    r2 = jnp.concatenate([z4, Xh, -obs[:, 1:2] * Xh], axis=1)
    A = jnp.concatenate([r1 * w, r2 * w], axis=0)                  # (2N,12)
    _, _, Vt = jnp.linalg.svd(A, full_matrices=False)
    P = Vt[-1].reshape(3, 4)
    # cheirality: majority of masked depths positive
    depth = X @ P[:, :3].T + P[:, 3]
    s = jnp.where(jnp.sum(jnp.where(mask, jnp.sign(depth[:, 2]), 0.0)) < 0,
                  -1.0, 1.0)
    P = P * s
    U, S, Vt2 = jnp.linalg.svd(P[:, :3])
    R = U @ Vt2
    R = jnp.where(jnp.linalg.det(R) < 0, -R, R)
    t = P[:, 3] / jnp.maximum(jnp.mean(S), 1e-12)
    return R, t


@partial(jax.jit, static_argnames=("iters",))
def pnp_gn(X, obs, mask, R0, t0, iters: int = 10):
    """Minimize sum ||proj(R X + t) - obs||² over (R, t) world→camera.

    X (N,3) world points, obs (N,2) normalized coords, mask (N,) validity.
    (R0, t0) initial guess.  Left-multiplicative update R ← exp(dθ)·R.
    Returns (R, t, mean_sq_err)."""
    w = mask.astype(X.dtype)

    def body(_, carry):
        R, t = carry
        pc = X @ R.T + t                                        # (N, 3)
        z = jnp.maximum(pc[:, 2], 1e-6)
        r = (pc[:, :2] / z[:, None] - obs) * w[:, None]         # (N, 2)
        # d(proj)/d(pc) (2x3) chain with d(pc)/d[dt,dθ] = [I, -hat(pc)]
        inv_z = 1.0 / z
        J_proj = jnp.zeros(X.shape[:1] + (2, 3), X.dtype)
        J_proj = J_proj.at[:, 0, 0].set(inv_z)
        J_proj = J_proj.at[:, 1, 1].set(inv_z)
        J_proj = J_proj.at[:, 0, 2].set(-pc[:, 0] * inv_z * inv_z)
        J_proj = J_proj.at[:, 1, 2].set(-pc[:, 1] * inv_z * inv_z)
        J_pt = jnp.concatenate(
            [jnp.broadcast_to(jnp.eye(3, dtype=X.dtype), X.shape + (3,)).reshape(-1, 3, 3),
             -lie.so3_hat(pc)], axis=-1)                        # (N, 3, 6)
        J = jnp.einsum("nij,njk->nik", J_proj, J_pt) * w[:, None, None]
        H = jnp.einsum("nip,niq->pq", J, J) + 1e-9 * jnp.eye(6, dtype=X.dtype)
        b = -jnp.einsum("nip,ni->p", J, r)
        dx = jnp.linalg.solve(H, b)
        R_new = lie.so3_exp_mat(dx[3:6]) @ R
        t_new = t + dx[0:3]
        return R_new, t_new

    R, t = jax.lax.fori_loop(0, iters, body, (R0, t0))
    pc = X @ R.T + t
    r = (pc[:, :2] / jnp.maximum(pc[:, 2:3], 1e-6) - obs)
    msq = jnp.sum(jnp.sum(r * r, -1) * w) / jnp.maximum(jnp.sum(w), 1.0)
    return R, t, msq


# ---------------------------------------------------------------------------
# Essential matrix: batched 8-point RANSAC + cheirality decomposition
# (solve_5pts.cpp:5-230 — the reference re-implements decomposeEssentialMat /
#  recoverPose and wraps cv::findFundamentalMat RANSAC; here the hypothesis
#  sweep is one vmapped batch on device)
# ---------------------------------------------------------------------------

def _eight_point(x0, x1, w):
    """Weighted least-squares E from correspondences (N,2)+(N,2), w (N,)."""
    a = jnp.stack([
        x1[:, 0] * x0[:, 0], x1[:, 0] * x0[:, 1], x1[:, 0],
        x1[:, 1] * x0[:, 0], x1[:, 1] * x0[:, 1], x1[:, 1],
        x0[:, 0], x0[:, 1], jnp.ones_like(x0[:, 0]),
    ], axis=-1) * w[:, None]                                    # (N, 9)
    # A and its (9, 9) R factor share their right singular vectors; the
    # SVD of a batch of tall (N, 9) blocks runs one solver call per block
    # on a GPU, the SVD of the small R factors one batched call
    r = jnp.linalg.qr(a, mode="r")
    _, _, Vt = jnp.linalg.svd(r, full_matrices=False)
    E = Vt[-1].reshape(3, 3)
    # project onto the essential manifold (rank 2, equal singular values)
    U, s, Vt2 = jnp.linalg.svd(E)
    return U @ jnp.diag(jnp.array([1.0, 1.0, 0.0], E.dtype)) @ Vt2


def _epipolar_err(E, x0, x1):
    """Sampson distance of normalized correspondences to E."""
    h0 = jnp.concatenate([x0, jnp.ones_like(x0[:, :1])], -1)
    h1 = jnp.concatenate([x1, jnp.ones_like(x1[:, :1])], -1)
    Ex0 = h0 @ E.T                                              # (N, 3)
    Etx1 = h1 @ E
    num = jnp.sum(h1 * Ex0, axis=-1) ** 2
    den = Ex0[:, 0] ** 2 + Ex0[:, 1] ** 2 + Etx1[:, 0] ** 2 + Etx1[:, 1] ** 2
    return num / jnp.maximum(den, 1e-30)


@partial(jax.jit, static_argnames=("n_hyp",))
def essential_ransac(x0, x1, valid, key, thresh=0.3 / 460.0, n_hyp: int = 256):
    """RANSAC E over masked correspondences; returns (E, inlier_mask, count).

    x0/x1 (N,2) normalized coords in the two frames (x1 in the second),
    valid (N,) which rows are real.  thresh follows the reference's
    cv::findFundamentalMat(..., 0.3 / 460, 0.99) (solve_5pts.cpp:199)."""
    N = x0.shape[0]
    # rows that are not real may hold NaN (lost tracks); NaN * 0 weight is
    # still NaN, and a NaN block can stall a GPU SVD indefinitely
    x0 = jnp.where(valid[:, None], x0, 0.0)
    x1 = jnp.where(valid[:, None], x1, 0.0)
    p = valid.astype(jnp.float32) + 1e-9
    idx = jax.vmap(lambda k: jax.random.choice(k, N, (8,), replace=False,
                                               p=p / jnp.sum(p)))(
        jax.random.split(key, n_hyp))                           # (n_hyp, 8)

    def hyp(sample_idx):
        w = jnp.zeros((N,), x0.dtype).at[sample_idx].set(1.0) * valid
        E = _eight_point(x0, x1, w)
        err = _epipolar_err(E, x0, x1)
        inl = (err < thresh * thresh) & valid
        return E, jnp.sum(inl)

    Es, scores = jax.vmap(hyp)(idx)
    best = jnp.argmax(scores)
    E0 = Es[best]
    # refit on the consensus set
    inl = (_epipolar_err(E0, x0, x1) < thresh ** 2) & valid
    E = _eight_point(x0, x1, inl.astype(x0.dtype))
    inl = (_epipolar_err(E, x0, x1) < thresh ** 2) & valid
    return E, inl, jnp.sum(inl)


@jax.jit
def recover_pose(E, x0, x1, mask):
    """Decompose E into (R, t) with x1 = R x0 + t via the 4-way cheirality
    vote (solve_5pts.cpp:5-80): triangulate under each candidate, count
    points with positive depth in both views."""
    U, _, Vt = jnp.linalg.svd(E)
    # keep proper rotations
    U = U * jnp.sign(jnp.linalg.det(U))
    Vt = Vt * jnp.sign(jnp.linalg.det(Vt))
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], E.dtype)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    I3 = jnp.eye(3, dtype=E.dtype)
    z3 = jnp.zeros(3, E.dtype)

    def count_cheirality(R, tt):
        tri = jax.vmap(lambda a, b: triangulate_two_frames(I3, z3, R, tt, a, b))
        X = tri(x0, x1)
        z0 = X[:, 2]
        z1 = (X @ R.T + tt)[:, 2]
        ok = (z0 > 0) & (z1 > 0) & mask
        return jnp.sum(ok)

    cands_R = jnp.stack([R1, R1, R2, R2])
    cands_t = jnp.stack([t, -t, t, -t])
    votes = jax.vmap(count_cheirality)(cands_R, cands_t)
    k = jnp.argmax(votes)
    return cands_R[k], cands_t[k], votes[k]


def relative_rotation(x0, x1, seed=0, thresh=0.3 / 460.0):
    """Relative camera rotation R with x_0 ≈ R x_1 from ≥9 normalized
    correspondences — the extrinsic calibrator's per-pair input
    (solveRelativeR, initial_ex_rotation.cpp:68-110).  Unlike
    solve_relative_rt there is NO inlier/parallax gate: consecutive-frame
    pairs have tiny baselines and the calibrator's Huber weighting handles
    the noisy ones.  Returns None only when the solve is degenerate."""
    x0 = np.asarray(x0)
    x1 = np.asarray(x1)
    if len(x0) < 9:
        return None
    key = jax.random.PRNGKey(seed)
    valid = jnp.ones(len(x0), bool)
    E, inl, n_inl = essential_ransac(jnp.asarray(x0), jnp.asarray(x1),
                                     valid, key, thresh)
    if not bool(jnp.all(jnp.isfinite(E))):
        return None
    R, t, votes = recover_pose(E, jnp.asarray(x0), jnp.asarray(x1), inl)
    R = np.asarray(R)
    if not np.all(np.isfinite(R)):
        return None
    # recover_pose returns R with x1 = R x0 + t; the calibrator wants the
    # rotation of frame 1 expressed in frame 0 (x_0 = R_rel x_1)
    return R.T


def solve_relative_rt(x0, x1, valid, seed=0, thresh=0.3 / 460.0):
    """Full relative-pose solve (solveRelativeRT, solve_5pts.cpp:193-230).

    Returns (ok, R_01, t_01) where (R_01, t_01) is the pose of camera 1
    expressed in camera 0's frame (x_0 = R_01 x_1 + t_01), matching the
    reference's `Rotation = R.transpose(); Translation = -R.T @ t`."""
    n_valid = int(np.sum(np.asarray(valid)))
    if n_valid < 15:
        return False, None, None
    key = jax.random.PRNGKey(seed)
    E, inl, n_inl = essential_ransac(jnp.asarray(x0), jnp.asarray(x1),
                                     jnp.asarray(valid), key, thresh)
    R, t, votes = recover_pose(E, jnp.asarray(x0), jnp.asarray(x1), inl)
    if int(votes) > 12:
        R = np.asarray(R)
        t = np.asarray(t)
        return True, R.T, -R.T @ t
    return False, None, None


# ---------------------------------------------------------------------------
# Global SfM over the window (GlobalSFM::construct, initial_sfm.cpp:117-313)
# ---------------------------------------------------------------------------

def construct(obs, valid, l, R_init, t_init, seed=0):
    """Incremental SfM over K frames.

    obs (K, F, 2) normalized observations, valid (K, F) mask, l = anchor
    frame (world = camera l), (R_init, t_init) = pose of frame K-1 in frame
    l's coordinates (x_l = R_init x_{K-1} + t_init).

    Returns (ok, Rs (K,3,3) world→camera, ts (K,3), X (F,3), tri_mask (F,)).
    """
    obs = np.asarray(obs)
    valid = np.asarray(valid)
    K, F, _ = obs.shape
    Rs = np.zeros((K, 3, 3))
    ts = np.zeros((K, 3))
    have_pose = np.zeros(K, bool)
    Rs[l] = np.eye(3)
    have_pose[l] = True
    # world→camera of the newest frame
    Rs[K - 1] = R_init.T
    ts[K - 1] = -R_init.T @ t_init
    have_pose[K - 1] = True

    X = np.zeros((F, 3))
    tri = np.zeros(F, bool)

    def tri_pair(i, j):
        """Triangulate all shared, untriangulated features of frames i, j."""
        sel = valid[i] & valid[j] & ~tri
        if not sel.any():
            return
        f = jax.vmap(lambda a, b: triangulate_two_frames(
            jnp.asarray(Rs[i]), jnp.asarray(ts[i]),
            jnp.asarray(Rs[j]), jnp.asarray(ts[j]), a, b))
        pts = np.asarray(f(jnp.asarray(obs[i][sel]), jnp.asarray(obs[j][sel])))
        X[sel] = pts
        tri[sel] = True

    def pnp(i, R0, t0):
        sel = valid[i] & tri
        if sel.sum() < 6:
            return False
        pad = int(np.sum(sel))
        R, t, msq = pnp_gn(jnp.asarray(X[sel]), jnp.asarray(obs[i][sel]),
                           jnp.ones(pad, bool), jnp.asarray(R0), jnp.asarray(t0))
        if not np.isfinite(float(msq)):
            return False
        Rs[i] = np.asarray(R)
        ts[i] = np.asarray(t)
        have_pose[i] = True
        return True

    # 1) l ↔ newest bootstrap, then march l+1..K-2 with PnP + triangulation
    tri_pair(l, K - 1)
    for i in range(l + 1, K - 1):
        if not pnp(i, Rs[i - 1], ts[i - 1]):
            return False, None, None, None, None
        tri_pair(i, K - 1)
    # 2) fill in triangulations against the anchor
    for i in range(l + 1, K - 1):
        tri_pair(l, i)
    # 3) march l-1..0 backwards
    for i in range(l - 1, -1, -1):
        if not pnp(i, Rs[i + 1], ts[i + 1]):
            return False, None, None, None, None
        tri_pair(i, l)
    # 4) whatever is left: first/last observing frame pair
    for f_id in np.where(~tri & (valid.sum(0) >= 2))[0]:
        frames = np.where(valid[:, f_id] & have_pose)[0]
        if len(frames) < 2:
            continue
        i, j = frames[0], frames[-1]
        pt = triangulate_two_frames(
            jnp.asarray(Rs[i]), jnp.asarray(ts[i]),
            jnp.asarray(Rs[j]), jnp.asarray(ts[j]),
            jnp.asarray(obs[i, f_id]), jnp.asarray(obs[j, f_id]))
        X[f_id] = np.asarray(pt)
        tri[f_id] = True

    if tri.sum() < 10:
        return False, None, None, None, None

    # 5) full-window BA on the generic LM solver (replaces the reference's
    #    only in-path Ceres solve, initial_sfm.cpp:254-302). Gauge: pose l
    #    fixed, translation of frame K-1 fixed (scale).
    Rs, ts, X = _sfm_ba(obs, valid & tri[None, :], l, Rs, ts, X, tri)
    return True, Rs, ts, X, tri


def _sfm_ba(obs, use, l, Rs, ts, X, tri):
    """Windowed BA: quaternion poses + XYZ points, dense LM."""
    K, F, _ = obs.shape
    fidx = np.where(tri)[0]
    nf = len(fidx)
    q0 = np.stack([np.asarray(lie.mat_to_quat(jnp.asarray(Rs[k]))) for k in range(K)])
    obs_j = jnp.asarray(obs[:, fidx])          # (K, nf, 2)
    use_j = jnp.asarray(use[:, fidx])          # (K, nf)
    q0_j = jnp.asarray(q0)
    last = K - 1

    # params: [dθ,dt per frame (6K), X (3nf)]; pose l and t_last fixed by
    # zeroing their update columns inside residual evaluation
    x0 = jnp.concatenate([jnp.zeros(6 * K), jnp.asarray(X[fidx]).reshape(-1)])
    ts0 = jnp.asarray(ts)

    fdt = jnp.result_type(float)  # f64 on x64 CPU tests, f32 on the GPU
    free_rot = jnp.asarray([(k != l) for k in range(K)], fdt)
    free_t = jnp.asarray([(k != l and k != last) for k in range(K)], fdt)

    def residuals(x):
        dpose = x[:6 * K].reshape(K, 6)
        pts = x[6 * K:].reshape(nf, 3)
        dth = dpose[:, 0:3] * free_rot[:, None]
        dt = dpose[:, 3:6] * free_t[:, None]
        q = lie.quat_mul(q0_j, lie.so3_exp_quat(dth))
        t = ts0 + dt

        pc = jax.vmap(lambda qk, tk: lie.quat_rotate(
            jnp.broadcast_to(qk, (nf, 4)), pts) + tk[None, :])(q, t)  # (K,nf,3)
        z = jnp.maximum(pc[..., 2], 1e-6)
        r = (pc[..., :2] / z[..., None] - obs_j) * use_j[..., None]
        return r.reshape(-1)

    @jax.jit
    def normal_fn(x):
        r = residuals(x)
        J = jax.jacfwd(residuals)(x)
        return J.T @ J, -J.T @ r, 0.5 * jnp.sum(r * r)

    @jax.jit
    def chi2_fn(x):
        r = residuals(x)
        return 0.5 * jnp.sum(r * r)

    x, _ = generic.lm_solve_dense(normal_fn, chi2_fn, lambda a, d: a + d,
                                  x0, max_iter=25)
    x = np.asarray(x)
    dpose = x[:6 * K].reshape(K, 6)
    pts = x[6 * K:].reshape(nf, 3)
    Rs_out = Rs.copy()
    ts_out = ts.copy()
    for k in range(K):
        dth = dpose[k, 0:3] * float(free_rot[k])
        Rs_out[k] = Rs[k] @ np.asarray(lie.so3_exp_mat(jnp.asarray(dth)))
        ts_out[k] = ts[k] + dpose[k, 3:6] * float(free_t[k])
    X_out = X.copy()
    X_out[fidx] = pts
    return Rs_out, ts_out, X_out
