"""Large-window / global bundle adjustment, sharded over a device mesh.

This is the scale-out generalization of the sliding-window solver — the
capability the reference has no counterpart for (its window is fixed at 11
keyframes, vins-mono/include/parameters.h:35) and the BASELINE.json north
star asks for: hundreds of keyframes and tens of thousands of landmarks
solved collectively, with the observation axis sharded across devices.

Structure (all static shapes):
- poses (N, 3)+(N, 4), 6-dof local updates; landmarks are inverse depths
  (M,) anchored in a host frame (the VINS parameterization, so the
  landmark Hessian block is DIAGONAL and its Schur elimination is
  embarrassingly parallel).
- observations are a flat batch (O,): landmark index, observing frame
  index, bearing; the landmark's host frame and host bearing live in
  (M,) tables.
- Assembly avoids the small-window one-hot expansion (O(F*W^2) memory,
  solver/window.py) entirely: per-observation 6-dof pose Jacobian blocks
  are scatter-added with ``segment_sum`` into block-pair (N, N, 6, 6),
  pose-landmark (N*M sparse -> dense (6N, M)) and diagonal landmark terms.
- Reduced camera system S = Hpp - Hpm diag(Hmm)^-1 Hpm^T is ONE GEMM;
  the damped solve is ops/linsolve.spd_solve (a direct solve up to
  P = 6N = 1024, Jacobi-PCG above).
- Sharding: shard the observation axis (and the landmark tables) across
  the mesh with NamedSharding; GSPMD turns the segment-sums and the
  S GEMM's contractions into a psum.  No hand-written collectives.

Reference lineage for the math: reprojection factor edge_reprojection.cc,
Schur solve problem.cc:409-446 — re-derived at scale.
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import factors
from ..ops import linsolve
from ..solver import pcg
from ..utils import lie


class GlobalBA(NamedTuple):
    # states
    Ps: jnp.ndarray        # (N, 3)
    Qs: jnp.ndarray        # (N, 4)
    inv_dep: jnp.ndarray   # (M,)
    # landmark tables
    host: jnp.ndarray      # (M,) int32 host frame
    bearing0: jnp.ndarray  # (M, 3) unit-plane bearing in host frame
    lm_valid: jnp.ndarray  # (M,) bool
    # observations
    lm_idx: jnp.ndarray    # (O,) int32
    frame: jnp.ndarray     # (O,) int32 observing frame (!= host)
    bearing: jnp.ndarray   # (O, 3)
    valid: jnp.ndarray     # (O,) bool
    # config
    sqrt_info: jnp.ndarray  # () projection sqrt information


class GlobalNormal(NamedTuple):
    Hpp: jnp.ndarray   # (6N, 6N)
    bp: jnp.ndarray    # (6N,)
    Hpm: jnp.ndarray   # (6N, M)
    Hmm: jnp.ndarray   # (M,)
    bm: jnp.ndarray    # (M,)
    chi2: jnp.ndarray  # ()


def _identity_ext(dtype):
    return jnp.zeros(3, dtype), lie.quat_identity(dtype)


@partial(jax.jit, static_argnames=("N", "M", "fix_frames", "loss_delta"))
def assemble(p: GlobalBA, N: int, M: int, fix_frames: int = 1,
             loss_delta: float = 1.0) -> GlobalNormal:
    dtype = p.Ps.dtype
    tic, qic = _identity_ext(dtype)
    inv_dep = jnp.where(p.lm_valid, p.inv_dep, 1.0)

    hi = p.host[p.lm_idx]                       # (O,) host frame per obs
    d = inv_dep[p.lm_idx]
    b0 = p.bearing0[p.lm_idx]

    def per_obs(d_, Pi, Qi, Pj, Qj, b0_, bj):
        r = factors.reproj_residual(d_, Pi, Qi, Pj, Qj, tic, qic, b0_, bj)
        Jd, Jpi, Jpj, _ = factors.reproj_jacobians(
            d_, Pi, Qi, Pj, Qj, tic, qic, b0_, bj)
        return r, Jd, Jpi, Jpj

    r, Jd, Jpi, Jpj = jax.vmap(per_obs)(
        d, p.Ps[hi], p.Qs[hi], p.Ps[p.frame], p.Qs[p.frame], b0, p.bearing)
    # r (O,2), Jd (O,2,1), Jpi/Jpj (O,2,6)

    m = (p.valid & p.lm_valid[p.lm_idx] & (hi != p.frame)).astype(dtype)
    s2 = p.sqrt_info ** 2
    e2 = s2 * jnp.sum(r * r, axis=-1)
    rho0, rho1, rho2 = factors.cauchy_rho(e2, loss_delta)
    w_err = p.sqrt_info * r
    guard = (rho1 + 2.0 * rho2 * e2 > 0.0).astype(dtype)
    eye2 = jnp.eye(2, dtype=dtype)
    rinfo = (rho1[..., None, None] * eye2 +
             (guard * 2.0 * rho2)[..., None, None] *
             (w_err[..., :, None] * w_err[..., None, :])) * s2   # (O,2,2)
    rinfo = rinfo * m[:, None, None]
    chi2 = jnp.sum(jnp.where(m > 0, rho0, 0.0))

    # fixed-frame gauge zeroing
    free_i = (hi >= fix_frames).astype(dtype)
    free_j = (p.frame >= fix_frames).astype(dtype)
    Jpi = Jpi * free_i[:, None, None]
    Jpj = Jpj * free_j[:, None, None]
    Jd2 = Jd[..., 0]                                              # (O,2)

    WJi = jnp.einsum("ors,osa->ora", rinfo, Jpi)                  # (O,2,6)
    WJj = jnp.einsum("ors,osa->ora", rinfo, Jpj)
    WJd = jnp.einsum("ors,os->or", rinfo, Jd2)                    # (O,2)
    # b uses drho * J^T * info * r with info = s2*I (reference MakeHessian)
    info_r = (s2 * rho1[:, None] * m[:, None]) * r                # (O,2)

    # ---- pose-pose blocks: scatter (i,i),(i,j),(j,i),(j,j) ----
    ii = hi.astype(jnp.int32) * N + hi.astype(jnp.int32)
    ij = hi.astype(jnp.int32) * N + p.frame.astype(jnp.int32)
    ji = p.frame.astype(jnp.int32) * N + hi.astype(jnp.int32)
    jj = p.frame.astype(jnp.int32) * N + p.frame.astype(jnp.int32)
    Bii = jnp.einsum("ora,orb->oab", Jpi, WJi)
    Bij = jnp.einsum("ora,orb->oab", Jpi, WJj)
    Bji = jnp.einsum("ora,orb->oab", Jpj, WJi)
    Bjj = jnp.einsum("ora,orb->oab", Jpj, WJj)
    blocks = jnp.concatenate([Bii, Bij, Bji, Bjj], axis=0)
    segs = jnp.concatenate([ii, ij, ji, jj], axis=0)
    Hpp_blk = jax.ops.segment_sum(blocks, segs, num_segments=N * N)
    Hpp = Hpp_blk.reshape(N, N, 6, 6).transpose(0, 2, 1, 3).reshape(6 * N, 6 * N)

    bp_blk = jax.ops.segment_sum(
        jnp.concatenate([-jnp.einsum("ora,or->oa", Jpi, info_r),
                         -jnp.einsum("ora,or->oa", Jpj, info_r)], axis=0),
        jnp.concatenate([hi.astype(jnp.int32), p.frame.astype(jnp.int32)]),
        num_segments=N)
    bp = bp_blk.reshape(6 * N)

    # ---- pose-landmark coupling (6N, M) ----
    col_i = hi.astype(jnp.int32) * M + p.lm_idx.astype(jnp.int32)
    col_j = p.frame.astype(jnp.int32) * M + p.lm_idx.astype(jnp.int32)
    Wi = jnp.einsum("ora,or->oa", Jpi, WJd)                       # (O,6)
    Wj = jnp.einsum("ora,or->oa", Jpj, WJd)
    Hpm_flat = jax.ops.segment_sum(
        jnp.concatenate([Wi, Wj], axis=0),
        jnp.concatenate([col_i, col_j], axis=0), num_segments=N * M)
    Hpm = Hpm_flat.reshape(N, M, 6).transpose(0, 2, 1).reshape(6 * N, M)

    # ---- landmark diagonal ----
    Hmm = jax.ops.segment_sum(jnp.einsum("or,or->o", Jd2, WJd),
                              p.lm_idx, num_segments=M)
    bm = jax.ops.segment_sum(-jnp.einsum("or,or->o", Jd2, info_r),
                             p.lm_idx, num_segments=M)

    # unit diagonal on fixed poses keeps the reduced system SPD
    free_pose = (jnp.arange(N) >= fix_frames).astype(dtype)
    fixed_diag = jnp.repeat(1.0 - free_pose, 6)
    Hpp = Hpp + jnp.diag(fixed_diag)

    return GlobalNormal(Hpp=Hpp, bp=bp, Hpm=Hpm, Hmm=Hmm, bm=bm,
                        chi2=0.5 * chi2)


def schur_step(n: GlobalNormal, lam, lm_valid, use_pcg: bool = False):
    """Landmark Schur + damped pose solve + back-substitution.

    ``use_pcg=True`` solves the reduced system with Jacobi-PCG instead of
    the direct solve — the scalable path: under a map-axis sharding
    the CG matvec is a row-block GEMV whose partial products GSPMD reduces
    with one psum (the reference's own answer at scale, PCGSolver
    problem.cc:580-610)."""
    P6 = n.Hpp.shape[0]
    Hmm_inv = jnp.where(n.Hmm > 1e-12, 1.0 / jnp.maximum(n.Hmm, 1e-12), 0.0)
    Hmm_inv = jnp.where(lm_valid, Hmm_inv, 0.0)
    tempH = n.Hpm * Hmm_inv[None, :]
    S = n.Hpp - tempH @ n.Hpm.T                      # <- GEMM (6N,M,6N)
    rhs = n.bp - tempH @ n.bm
    S = S + lam * jnp.eye(P6, dtype=S.dtype)
    if use_pcg:
        dxp, _ = pcg.pcg_solve(S, rhs, rtol=1e-8)
    else:
        dxp = linsolve.spd_solve(S, rhs)
    dxm = Hmm_inv * (n.bm - n.Hpm.T @ dxp)
    return dxp, dxm


def apply_delta(p: GlobalBA, dxp, dxm, fix_frames: int = 1) -> GlobalBA:
    N = p.Ps.shape[0]
    d = dxp.reshape(N, 6)
    mask = (jnp.arange(N) >= fix_frames).astype(p.Ps.dtype)
    d = d * mask[:, None]
    Qs = lie.quat_normalize(jax.vmap(lie.quat_mul)(
        p.Qs, jax.vmap(lie.so3_exp_quat)(d[:, 3:6])))
    # inverse depth stays positive: a sign flip puts the landmark behind
    # its host camera, where the robust kernel saturates and the landmark
    # is stranded at zero gradient
    inv_dep = jnp.maximum(p.inv_dep + dxm, 1e-3)
    return p._replace(Ps=p.Ps + d[:, 0:3], Qs=Qs, inv_dep=inv_dep)


def _solve_impl(p: GlobalBA, max_iter: int, fix_frames: int,
                loss_delta: float, use_pcg: bool = False, constrain=None):
    """Nielsen-LM over the global problem (lax.while_loop, same control
    flow as solver/lm.py).  ``constrain`` re-shards each assembled normal
    system (map-axis row blocks) before the Schur/CG step."""
    N = p.Ps.shape[0]
    M = p.inv_dep.shape[0]
    if constrain is None:
        constrain = lambda n: n
    n0 = constrain(assemble(p, N, M, fix_frames, loss_delta))
    max_diag = jnp.maximum(jnp.max(jnp.abs(jnp.diagonal(n0.Hpp))),
                           jnp.max(jnp.abs(n0.Hmm)))
    lam0 = 1e-5 * jnp.minimum(max_diag, 5e10)

    def cond(s):
        p_, n, lam, ni, chi, it, stop = s
        return jnp.logical_and(~stop, it < max_iter)

    def body(s):
        p_, n, lam, ni, chi, it, stop = s
        dxp, dxm = schur_step(n, lam, p_.lm_valid, use_pcg)
        cand = apply_delta(p_, dxp, dxm, fix_frames)
        n_cand = constrain(assemble(cand, N, M, fix_frames, loss_delta))
        dx = jnp.concatenate([dxp, dxm])
        b = jnp.concatenate([n.bp, n.bm])
        scale = 0.5 * jnp.dot(dx, lam * dx + b) + 1e-9
        rho = (chi - n_cand.chi2) / scale
        good = jnp.logical_and(rho > 0, jnp.isfinite(n_cand.chi2))

        def accept(_):
            alpha = jnp.minimum(1.0 - (2.0 * rho - 1.0) ** 3, 2.0 / 3.0)
            stop_ = (chi - n_cand.chi2) < 1e-10 * jnp.maximum(chi, 1.0)
            return (cand, n_cand, lam * jnp.maximum(1.0 / 3.0, alpha),
                    jnp.asarray(2.0, lam.dtype), n_cand.chi2, it + 1, stop_)

        def reject(_):
            return (p_, n, lam * ni, ni * 2.0, chi, it + 1,
                    lam * ni > 1e16)

        return jax.lax.cond(good, accept, reject, None)

    init = (p, n0, lam0, jnp.asarray(2.0, lam0.dtype), n0.chi2,
            jnp.asarray(0, jnp.int32), jnp.asarray(False))
    p_out, n_out, lam, _, chi, it, _ = jax.lax.while_loop(cond, body, init)
    return p_out, dict(chi2=chi, chi2_init=n0.chi2, iterations=it, lam=lam)


@partial(jax.jit, static_argnames=("max_iter", "fix_frames", "loss_delta",
                                   "use_pcg"))
def solve(p: GlobalBA, max_iter: int = 20, fix_frames: int = 1,
          loss_delta: float = 1.0, use_pcg: bool = False):
    """Jitted Nielsen-LM over the global problem.  Returns (p, stats)."""
    return _solve_impl(p, max_iter, fix_frames, loss_delta, use_pcg)


# ---------------------------------------------------------------------------
# Sharding
# ---------------------------------------------------------------------------

def shard_problem(p: GlobalBA, mesh: Mesh, axis: str = "factor") -> GlobalBA:
    """Shard the observation axis and landmark tables across the mesh;
    poses replicate.  O and M must divide the mesh size."""
    r = NamedSharding(mesh, P())
    o = NamedSharding(mesh, P(axis))
    sh = GlobalBA(Ps=r, Qs=r, inv_dep=o, host=o, bearing0=o, lm_valid=o,
                  lm_idx=o, frame=o, bearing=o, valid=o, sqrt_info=r)
    return jax.tree.map(jax.device_put, p, sh)


def make_mesh_2d(n_map: int, n_factor: int, devices=None) -> Mesh:
    """2-D device mesh: keyframe blocks over "map" (the reduced camera
    system's row partition), observations over "factor" (SURVEY.md §2.5
    map-block sharding).  The cards of one host are joined all to all
    (NVLink), so the split follows the algorithm: "map" is the row
    partition of the reduced system, "factor" the observation shards.
    Across hosts under jax.distributed, keep "map" on the host axis."""
    devs = devices if devices is not None else jax.devices()
    assert len(devs) >= n_map * n_factor, (len(devs), n_map, n_factor)
    arr = np.asarray(devs[: n_map * n_factor]).reshape(n_map, n_factor)
    return Mesh(arr, ("map", "factor"))


def shard_problem_2d(p: GlobalBA, mesh: Mesh) -> GlobalBA:
    """Observation/landmark axes over BOTH mesh axes (flattened) so every
    device owns an observation shard; pose arrays replicate.  The map-axis
    row partition of the assembled Hpp/Hpm/bp is applied inside
    ``solve_sharded`` via sharding constraints."""
    n_all = mesh.devices.size
    r = NamedSharding(mesh, P())
    o = NamedSharding(mesh, P(("map", "factor")))
    for name, ax in (("observations", p.lm_idx.shape[0]),
                     ("landmarks", p.inv_dep.shape[0])):
        assert ax % n_all == 0, f"{name} axis {ax} must divide mesh {n_all}"
    sh = GlobalBA(Ps=r, Qs=r, inv_dep=o, host=o, bearing0=o, lm_valid=o,
                  lm_idx=o, frame=o, bearing=o, valid=o, sqrt_info=r)
    return jax.tree.map(jax.device_put, p, sh)


def align_by_landmark(p: GlobalBA, n_shards: int) -> GlobalBA:
    """Regroup observations so every landmark's observations live on ONE
    shard: landmarks are blocked contiguously (M/n_shards per shard) and
    the observation stream is sorted by landmark then padded per shard to
    a common length with masked rows.  This is what makes the landmark
    Schur elimination shard-LOCAL in ``solve_sharded`` — the only
    cross-device data is the reduced (6N)^2 camera system.

    Host-side problem preparation (numpy); call once before
    ``prepare_sharded``.  M must divide n_shards."""
    M = int(p.inv_dep.shape[0])
    assert M % n_shards == 0, (M, n_shards)
    M_loc = M // n_shards
    lm_idx = np.asarray(p.lm_idx)
    frame = np.asarray(p.frame)
    bearing = np.asarray(p.bearing)
    valid = np.asarray(p.valid)

    order = np.argsort(lm_idx, kind="stable")
    lm_s, fr_s, be_s, va_s = (lm_idx[order], frame[order], bearing[order],
                              valid[order])
    shard_of = lm_s // M_loc
    counts = np.bincount(shard_of, minlength=n_shards)
    cap = int(((counts.max() + 7) // 8) * 8)

    O_new = n_shards * cap
    lm_n = np.zeros(O_new, np.int32)
    fr_n = np.zeros(O_new, np.int32)
    be_n = np.tile(np.array([0.0, 0.0, 1.0]), (O_new, 1))
    va_n = np.zeros(O_new, bool)
    host = np.asarray(p.host)
    for s in range(n_shards):
        rows = np.nonzero(shard_of == s)[0]
        dst = slice(s * cap, s * cap + len(rows))
        lm_n[dst] = lm_s[rows]
        fr_n[dst] = fr_s[rows]
        be_n[dst] = be_s[rows]
        va_n[dst] = va_s[rows]
        # padding rows: first landmark of the shard, host==frame → masked
        pad = slice(s * cap + len(rows), (s + 1) * cap)
        lm_n[pad] = s * M_loc
        fr_n[pad] = host[s * M_loc]
    dtype = p.bearing.dtype
    return p._replace(lm_idx=jnp.asarray(lm_n), frame=jnp.asarray(fr_n),
                      bearing=jnp.asarray(be_n, dtype),
                      valid=jnp.asarray(va_n))


def prepare_sharded(p: GlobalBA, mesh: Mesh) -> GlobalBA:
    """align_by_landmark + device placement for ``solve_sharded``."""
    aligned = align_by_landmark(p, int(mesh.devices.size))
    return jax.tree.map(jax.device_put, aligned, _obs_shardings(p, mesh))


def _obs_shardings(p: GlobalBA, mesh: Mesh):
    axes = tuple(mesh.axis_names)
    r = NamedSharding(mesh, P())
    o = NamedSharding(mesh, P(axes if len(axes) > 1 else axes[0]))
    return GlobalBA(Ps=r, Qs=r, inv_dep=o, host=o, bearing0=o, lm_valid=o,
                    lm_idx=o, frame=o, bearing=o, valid=o, sqrt_info=r)


def _psum_hi(x, ax):
    """High-precision psum of f32 partials (the fix for a 2-process
    solution drift: at 262k obs the f32 psum ordering changed the LM
    accept path enough to change the final chi² — SCALING.md).  With x64
    enabled (CPU/Gloo scaling runs) the payload rides the wire in float64
    — the reduction order then no longer perturbs the LM accept
    decisions.  In the production regime x64 is off, so no float64 array
    exists in the program: the payload is Dekker-split into high/low
    mantissa halves reduced separately — each half carries ~12
    significant bits, so the recombined sum keeps ~twice the effective
    mantissa of a plain f32 psum at the cost of doubling one small
    (0.59 MB) collective."""
    if x.dtype == jnp.float64:
        return jax.lax.psum(x, ax)
    if jax.config.jax_enable_x64:
        return jax.lax.psum(x.astype(jnp.float64), ax).astype(x.dtype)
    # Dekker split: hi = x rounded to 12 mantissa bits, lo = exact remainder
    c = jnp.float32(4097.0) * x          # 2^12 + 1
    hi = c - (c - x)
    lo = x - hi
    return jax.lax.psum(hi, ax) + jax.lax.psum(lo, ax)


def solve_sharded(p: GlobalBA, mesh: Mesh, max_iter: int = 20,
                  fix_frames: int = 1, loss_delta: float = 1.0,
                  use_pcg: bool = False):
    """Distributed global BA via ``shard_map``: landmark-aligned
    observation shards (``prepare_sharded``) make assembly AND the
    landmark Schur elimination fully shard-local, so the only collective
    is ONE psum of the reduced (6N)^2 camera system (+ scalar chi2/LM
    bookkeeping) per LM iteration.  The damped pose solve is replicated
    compute on every device (no communication); landmark back-substitution
    and state update stay local.

    This replaces an earlier GSPMD-constraint design that materialized
    and re-sharded the dense (6N, M) pose-landmark coupling every
    iteration (18% two-process efficiency — collective traffic swamped
    compute).  Reference hot-spot lineage:
    problem.cc:311-313,420,696 (MakeHessian accumulation + Schur).

    Identical math to ``solve`` — tests assert trajectory agreement."""
    axes = tuple(mesh.axis_names)
    ax = axes if len(axes) > 1 else axes[0]
    D = int(mesh.devices.size)
    N = int(p.Ps.shape[0])
    M = int(p.inv_dep.shape[0])
    assert M % D == 0 and int(p.lm_idx.shape[0]) % D == 0, (M, D)
    M_loc = M // D
    P6 = 6 * N
    dtype = p.Ps.dtype

    rep = P()
    osh = P(ax)
    in_specs = GlobalBA(Ps=rep, Qs=rep, inv_dep=osh, host=osh,
                        bearing0=osh, lm_valid=osh, lm_idx=osh, frame=osh,
                        bearing=osh, valid=osh, sqrt_info=rep)
    out_specs = (GlobalBA(Ps=rep, Qs=rep, inv_dep=osh, host=osh,
                          bearing0=osh, lm_valid=osh, lm_idx=osh,
                          frame=osh, bearing=osh, valid=osh, sqrt_info=rep),
                 dict(chi2=rep, chi2_init=rep, iterations=rep, lam=rep))

    free_pose = (jnp.arange(N) >= fix_frames)
    fixed_diag = jnp.repeat(1.0 - free_pose.astype(dtype), 6)

    def shard_ofs():
        # flattened shard index over the mesh axes, row-major (matches the
        # PartitionSpec axis-tuple flattening order)
        idx = jax.lax.axis_index(axes[0])
        for a in axes[1:]:
            idx = idx * mesh.shape[a] + jax.lax.axis_index(a)
        return idx * M_loc

    def assemble_local(p_loc, ofs):
        """Per-shard partial normal equations.  Returns (Hpp_part (6N,6N),
        bp_part (6N,), hpm (6N, M_loc), Hmm (M_loc,), bm (M_loc,),
        chi_part ())."""
        tic, qic = _identity_ext(dtype)
        lm_loc = jnp.clip(p_loc.lm_idx - ofs, 0, M_loc - 1)
        inv_dep = jnp.where(p_loc.lm_valid, p_loc.inv_dep, 1.0)

        hi = p_loc.host[lm_loc]
        d = inv_dep[lm_loc]
        b0 = p_loc.bearing0[lm_loc]

        def per_obs(d_, Pi, Qi, Pj, Qj, b0_, bj):
            r = factors.reproj_residual(d_, Pi, Qi, Pj, Qj, tic, qic,
                                        b0_, bj)
            Jd, Jpi, Jpj, _ = factors.reproj_jacobians(
                d_, Pi, Qi, Pj, Qj, tic, qic, b0_, bj)
            return r, Jd, Jpi, Jpj

        r, Jd, Jpi, Jpj = jax.vmap(per_obs)(
            d, p_loc.Ps[hi], p_loc.Qs[hi], p_loc.Ps[p_loc.frame],
            p_loc.Qs[p_loc.frame], b0, p_loc.bearing)

        m = (p_loc.valid & p_loc.lm_valid[lm_loc] &
             (hi != p_loc.frame)).astype(dtype)
        s2 = p_loc.sqrt_info ** 2
        e2 = s2 * jnp.sum(r * r, axis=-1)
        rho0, rho1, rho2 = factors.cauchy_rho(e2, loss_delta)
        w_err = p_loc.sqrt_info * r
        guard = (rho1 + 2.0 * rho2 * e2 > 0.0).astype(dtype)
        eye2 = jnp.eye(2, dtype=dtype)
        rinfo = (rho1[..., None, None] * eye2 +
                 (guard * 2.0 * rho2)[..., None, None] *
                 (w_err[..., :, None] * w_err[..., None, :])) * s2
        rinfo = rinfo * m[:, None, None]
        chi = jnp.sum(jnp.where(m > 0, rho0, 0.0))

        free_i = (hi >= fix_frames).astype(dtype)
        free_j = (p_loc.frame >= fix_frames).astype(dtype)
        Jpi_f = Jpi * free_i[:, None, None]
        Jpj_f = Jpj * free_j[:, None, None]
        Jd2 = Jd[..., 0]

        WJi = jnp.einsum("ors,osa->ora", rinfo, Jpi_f)
        WJj = jnp.einsum("ors,osa->ora", rinfo, Jpj_f)
        WJd = jnp.einsum("ors,os->or", rinfo, Jd2)
        info_r = (s2 * rho1[:, None] * m[:, None]) * r

        ii = hi * N + hi
        ij = hi * N + p_loc.frame
        ji = p_loc.frame * N + hi
        jj = p_loc.frame * N + p_loc.frame
        blocks = jnp.concatenate([
            jnp.einsum("ora,orb->oab", Jpi_f, WJi),
            jnp.einsum("ora,orb->oab", Jpi_f, WJj),
            jnp.einsum("ora,orb->oab", Jpj_f, WJi),
            jnp.einsum("ora,orb->oab", Jpj_f, WJj)], axis=0)
        segs = jnp.concatenate([ii, ij, ji, jj], axis=0)
        Hpp = jax.ops.segment_sum(blocks, segs, num_segments=N * N) \
            .reshape(N, N, 6, 6).transpose(0, 2, 1, 3).reshape(P6, P6)

        bp = jax.ops.segment_sum(
            jnp.concatenate([-jnp.einsum("ora,or->oa", Jpi_f, info_r),
                             -jnp.einsum("ora,or->oa", Jpj_f, info_r)],
                            axis=0),
            jnp.concatenate([hi, p_loc.frame]),
            num_segments=N).reshape(P6)

        col_i = hi * M_loc + lm_loc
        col_j = p_loc.frame * M_loc + lm_loc
        hpm = jax.ops.segment_sum(
            jnp.concatenate([jnp.einsum("ora,or->oa", Jpi_f, WJd),
                             jnp.einsum("ora,or->oa", Jpj_f, WJd)], axis=0),
            jnp.concatenate([col_i, col_j]), num_segments=N * M_loc) \
            .reshape(N, M_loc, 6).transpose(0, 2, 1).reshape(P6, M_loc)

        Hmm = jax.ops.segment_sum(jnp.einsum("or,or->o", Jd2, WJd),
                                  lm_loc, num_segments=M_loc)
        bm = jax.ops.segment_sum(-jnp.einsum("or,or->o", Jd2, info_r),
                                 lm_loc, num_segments=M_loc)
        return Hpp, bp, hpm, Hmm, bm, 0.5 * chi

    def body_fn(p_loc: GlobalBA):
        ofs = shard_ofs()

        def schur_pieces(norm):
            """One psum: the reduced camera system + rhs + chi2."""
            Hpp, bp, hpm, Hmm, bm, chi = norm
            Hmm_inv = jnp.where(Hmm > 1e-12,
                                1.0 / jnp.maximum(Hmm, 1e-12), 0.0)
            Hmm_inv = jnp.where(p_loc.lm_valid, Hmm_inv, 0.0)
            tempH = hpm * Hmm_inv[None, :]
            S_loc = Hpp - tempH @ hpm.T
            rhs_loc = bp - tempH @ bm
            packed = jnp.concatenate(
                [S_loc, rhs_loc[:, None],
                 jnp.full((P6, 1), chi / P6, dtype)], axis=1)
            packed = _psum_hi(packed, ax)
            S = packed[:, :P6] + jnp.diag(fixed_diag)
            rhs = packed[:, P6]
            chi_tot = jnp.sum(packed[:, P6 + 1])
            return S, rhs, chi_tot, Hmm_inv

        def damped_solve(S, rhs, lam):
            Sd = S + lam * jnp.eye(P6, dtype=dtype)
            if use_pcg:
                dxp, _ = pcg.pcg_solve(Sd, rhs, rtol=1e-8)
            else:
                dxp = linsolve.spd_solve(Sd, rhs)
            return dxp

        def update(pl, dxp, dxm):
            dmat = dxp.reshape(N, 6) * free_pose[:, None].astype(dtype)
            Qs = lie.quat_normalize(jax.vmap(lie.quat_mul)(
                pl.Qs, jax.vmap(lie.so3_exp_quat)(dmat[:, 3:6])))
            inv_dep = jnp.maximum(pl.inv_dep + dxm, 1e-3)
            return pl._replace(Ps=pl.Ps + dmat[:, 0:3], Qs=Qs,
                               inv_dep=inv_dep)

        norm0 = assemble_local(p_loc, ofs)
        S0, rhs0, chi0, Hmm_inv0 = schur_pieces(norm0)
        # lam0 parity with ``solve``: max |diag| of the PRE-Schur global
        # Hpp (incl. the unit gauge diagonal) and the landmark diagonal
        diag_pre = _psum_hi(jnp.diagonal(norm0[0]), ax) + fixed_diag
        diag_max = jnp.maximum(jnp.max(jnp.abs(diag_pre)),
                               jax.lax.pmax(jnp.max(jnp.abs(norm0[3])), ax))
        lam0 = 1e-5 * jnp.minimum(diag_max, 5e10)

        def cond(s):
            return jnp.logical_and(~s[-1], s[-2] < max_iter)

        def body(s):
            (pl, S, rhs, chi, norm, Hmm_inv, lam, ni, it, stop) = s
            dxp = damped_solve(S, rhs, lam)
            _, bp, hpm, Hmm, bm, _ = norm
            dxm = Hmm_inv * (bm - hpm.T @ dxp)
            cand = update(pl, dxp, dxm)
            norm_c = assemble_local(cand, ofs)
            S_c, rhs_c, chi_c, Hmm_inv_c = schur_pieces(norm_c)

            # scale parity with ``solve``: dx^T (lam dx + b) with the
            # PRE-Schur gradient b = (bp, bm); bp is a shard partial so
            # dxp^T bp rides the same psum as the landmark terms
            dot_sh = _psum_hi(
                jnp.dot(dxp, bp) + jnp.dot(dxm, lam * dxm + bm), ax)
            scale = 0.5 * (lam * jnp.dot(dxp, dxp) + dot_sh) + 1e-9
            rho = (chi - chi_c) / scale
            good = jnp.logical_and(rho > 0, jnp.isfinite(chi_c))

            def accept(_):
                alpha = jnp.minimum(1.0 - (2.0 * rho - 1.0) ** 3, 2.0 / 3.0)
                stop_ = (chi - chi_c) < 1e-10 * jnp.maximum(chi, 1.0)
                return (cand, S_c, rhs_c, chi_c, norm_c, Hmm_inv_c,
                        lam * jnp.maximum(1.0 / 3.0, alpha),
                        jnp.asarray(2.0, dtype), it + 1, stop_)

            def reject(_):
                return (pl, S, rhs, chi, norm, Hmm_inv, lam * ni, ni * 2.0,
                        it + 1, lam * ni > 1e16)

            return jax.lax.cond(good, accept, reject, None)

        init = (p_loc, S0, rhs0, chi0, norm0, Hmm_inv0, lam0,
                jnp.asarray(2.0, dtype), jnp.asarray(0, jnp.int32),
                jnp.asarray(False))
        out = jax.lax.while_loop(cond, body, init)
        p_out, chi, lam, it = out[0], out[3], out[6], out[8]
        return p_out, dict(chi2=chi, chi2_init=chi0, iterations=it, lam=lam)

    fn = jax.jit(jax.shard_map(body_fn, mesh=mesh, in_specs=(in_specs,),
                               out_specs=out_specs, check_vma=False))
    return fn(p)
