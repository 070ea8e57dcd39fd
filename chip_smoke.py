"""Smoke run of the VIO main path on NVIDIA GPUs.

Run from the root of a checkout:

    python chip_smoke.py               # one card
    python chip_smoke.py --four-cards  # the sharded solvers on four cards

With no option the script checks each device program of the main path
against a plain float64 reference at its real width (the damped pose
solve, KLT patch sampling and tracking, the window LM solve, the
100-keyframe global BA), then drives the two end-to-end runs: the
600-frame tracker-bypass simulation through the CLI, and 420 rendered,
distorted 640x640 frames through CLAHE, the tracker and the estimator.
With ``--four-cards`` it runs only the sharded window solve and the
shard_map global BA on four cards, each against the same solve on one.

Everything runs in this one process, in float32 with full-precision
matmuls.  The script exits non-zero, and prints no result line, when JAX
finds no GPU, when a check misses its tolerance, or when a phase raises.
On success its last line is ``{"ok": true, "device": {...}}``.
"""
import argparse
import contextlib
import io
import json
import sys
import time

import numpy as np

import vio_tpu  # noqa: F401  (pins float32 matmul precision to "highest")
from vio_tpu import compile_cache

import jax
import jax.numpy as jnp

import bench


class Checks:
    """Collects named pass/fail comparisons and prints each one."""

    def __init__(self):
        self.failed = []

    def __call__(self, name, ok, **values):
        print(json.dumps({"check": name, "pass": bool(ok), **values}),
              flush=True)
        if not ok:
            self.failed.append(name)


def phase0(n_cards: int) -> dict:
    """Stop unless JAX sees at least n_cards GPUs; print the setup."""
    info = bench.require_gpu()
    if info["count"] < n_cards:
        raise SystemExit(f"{n_cards} GPUs needed, JAX sees {info['count']}")
    print(bench.gpu_name_and_power(), flush=True)
    print(json.dumps(dict(
        jax=jax.__version__, device=info,
        jax_enable_x64=bool(jax.config.jax_enable_x64),
        default_matmul_precision=jax.config.jax_default_matmul_precision,
        compile_cache=compile_cache.enable())), flush=True)
    return info


# ---------------------------------------------------------------------------
# kernel comparisons (one card)
# ---------------------------------------------------------------------------

def _spd(key, P):
    """The SPD test matrices of tests/test_ops.py, in float32."""
    M = jax.random.normal(key, (P, P), jnp.float32)
    return M @ M.T + P * jnp.eye(P, dtype=jnp.float32)


def window_reduced_system(W: int = 10, F: int = 256):
    """The damped reduced camera system of the headline window problem as
    the LM solves it after convergence: (S + lambda I, rhs) at the solved
    states with the LM's final lambda, float32.  (At the initial lambda,
    1e-5 max|diag|, the gauge directions carry only the damping and the
    float32 system is indefinite; spd_solve then returns NaN, which the LM
    rejects.)"""
    from vio_tpu import testing
    from vio_tpu.solver import lm
    from vio_tpu.solver import window as Wn

    states, f, _ = testing.make_window_problem(
        window_size=W, max_features=F, imu_per_interval=16,
        dtype=jnp.float32)
    solved, _, _, stats = lm.solve_window(states, f, max_iter=15)
    n = Wn.assemble(solved, f, fix_ext=True)
    Hmm_inv = jnp.where(jnp.abs(n.Hmm) > 1e-30, 1.0 / n.Hmm, 0.0)
    Hmm_inv = jnp.where(f.feat_valid, Hmm_inv, 0.0)
    tempH = n.Hpm * Hmm_inv[None, :]
    S = n.Hpp - tempH @ n.Hpm.T
    rhs = n.bp - tempH @ n.bm
    return S + stats["lam"] * jnp.eye(S.shape[0], dtype=S.dtype), rhs


def check_spd_solve(check):
    """spd_solve against a numpy float64 solve of the same float32-rounded
    system.  Gate: the normwise relative residual (backward error)
    ||A x - b|| / (||A|| ||x|| + ||b||) <= 1e-4.  Cholesky is backward
    stable, so a float32 solve reaches ~n eps = 1e-5 at P=171 whatever the
    conditioning; ||A x - b|| / ||b|| and the error against the float64
    solution are printed beside it, and grow with the condition number of
    the reduced camera system."""
    from vio_tpu.ops import linsolve

    systems = []
    for P in (17, 171, 321):
        key = jax.random.PRNGKey(3 + P)
        systems.append((f"spd_P{P}", _spd(key, P),
                        jax.random.normal(key, (P,), jnp.float32)))
    systems.append(("window_W10_F256_damped_reduced",
                    *window_reduced_system()))
    solve = jax.jit(linsolve.spd_solve)
    for name, A, b in systems:
        x = np.asarray(solve(A, b), np.float64)
        A64 = np.asarray(A, np.float64)
        b64 = np.asarray(b, np.float64)
        ref = np.linalg.solve(A64, b64)
        r = np.linalg.norm(A64 @ x - b64)
        eta = r / (np.linalg.norm(A64, 2) * np.linalg.norm(x) +
                   np.linalg.norm(b64))
        check(f"spd_solve/{name}", eta <= 1e-4, P=int(A.shape[0]),
              backward_error=eta, residual_over_b=r / np.linalg.norm(b64),
              rel_err_vs_f64=np.linalg.norm(x - ref) / np.linalg.norm(ref),
              limit=1e-4)


def _bilinear_np(img, xy):
    """float64 bilinear sample with the same edge clamp as
    pyramid.bilinear_sample."""
    H, W = img.shape
    x = np.clip(xy[..., 0], 0.0, W - 1.001)
    y = np.clip(xy[..., 1], 0.0, H - 1.001)
    x0 = np.floor(x).astype(int)
    y0 = np.floor(y).astype(int)
    fx, fy = x - x0, y - y0
    return ((1 - fy) * ((1 - fx) * img[y0, x0] + fx * img[y0, x0 + 1]) +
            fy * ((1 - fx) * img[y0 + 1, x0] + fx * img[y0 + 1, x0 + 1]))


def _klt_images(seed: int = 0):
    """The bench.py KLT scene: smoothed noise on 0-255, 640x640, and the
    same image shifted by (dy, dx) = (2, 3) px."""
    rng = np.random.default_rng(seed)
    img0 = rng.standard_normal((640, 640)).astype(np.float32)
    for _ in range(2):
        img0 = (np.roll(img0, 1, 0) + np.roll(img0, -1, 0) +
                np.roll(img0, 1, 1) + np.roll(img0, -1, 1) + img0) / 5.0
    img0 = (img0 - img0.min()) / (img0.max() - img0.min()) * 255.0
    pts = rng.uniform(40, 600, (150, 2)).astype(np.float32)
    return img0, np.roll(img0, (2, 3), axis=(0, 1)), pts


def check_klt(check):
    """KLT patch sampling against float64 numpy at the same float32 sample
    positions (gate: 1e-3 on 0-255 intensities; float32 rounding of a
    2x2 bilinear blend is ~3e-5), and
    forward-backward tracking of a known (2, 3) px shift (gate: within
    0.05 px on >= 95 % of the features it marks ok)."""
    from vio_tpu.features import klt, pyramid

    img0, img1, pts = _klt_images()
    half = klt.HALF
    patches = jax.jit(pyramid.patch_sample_multi, static_argnums=2)(
        jnp.asarray(img0)[None], jnp.asarray(pts), half)[0]
    g = np.arange(-half, half + 1, dtype=np.float32)
    dx, dy = np.meshgrid(g, g)
    grid = np.stack([dx, dy], -1).reshape(-1, 2)
    # the sample positions as the device forms them: centre + offset,
    # rounded to float32 (an ulp at x ~ 600 moves a sample by 6e-5 px)
    xy = (pts[:, None, :] + grid[None]).astype(np.float64)
    ref = _bilinear_np(img0.astype(np.float64), xy)
    err = float(np.abs(np.asarray(patches, np.float64) - ref).max())
    check("klt/patch_sample_150x21x21_640px", err <= 1e-3,
          max_abs_err=err, limit=1e-3)

    p1, ok, _ = klt.track_fb(jnp.asarray(img0), jnp.asarray(img1),
                             jnp.asarray(pts), jnp.ones(len(pts), bool))
    ok = np.asarray(ok)
    d = np.abs(np.asarray(p1) - (pts + np.array([3.0, 2.0])))
    within = float((d[ok].max(axis=1) < 0.05).mean()) if ok.any() else 0.0
    check("klt/track_fb_known_shift", ok.sum() > 0 and within >= 0.95,
          n_ok=int(ok.sum()), n=len(pts), frac_within_0p05px=within,
          limit=0.95)


def window_pose_error(out, gt) -> float:
    """Max position error after re-anchoring the 4-dof VIO gauge (yaw +
    translation) on frame 0, as tests/test_window.py does."""
    from vio_tpu.utils import lie

    ypr0_gt = np.asarray(lie.mat_to_ypr(lie.quat_to_mat(gt.Qs[0])))
    ypr0 = np.asarray(lie.mat_to_ypr(lie.quat_to_mat(out.Qs[0])))
    rot = np.asarray(lie.ypr_to_mat(jnp.asarray(
        [ypr0_gt[0] - ypr0[0], 0.0, 0.0])))
    Ps = np.asarray(out.Ps, np.float64)
    Ps_fix = (Ps - Ps[0]) @ rot.T + np.asarray(gt.Ps)[0]
    return float(np.abs(Ps_fix - np.asarray(gt.Ps)).max())


def check_window_solve(check):
    """LM window solve of the perturbed W=10 problem at F=256 and at the
    F=1024 EuRoC capacity.  Gates: chi2 reduced by at least 1e8 (a
    float32 solve that loses the reduced system's accuracy stalls near
    5e-7 of the initial chi2), and max pose error after the gauge
    re-anchor < 0.02 m.  Scale and the gauge-adjacent directions are
    weakly observable over a 0.33 s window: the float64 optimum of this
    problem lies 0.0115 m from ground truth (CPU, float64), and float32
    reaches 0.0122 m on the CPU.  tests/test_window.py's 5e-3 m holds for
    its W=6 problem in float64 only."""
    from vio_tpu import testing
    from vio_tpu.solver import lm

    for F in (256, 1024):
        states, f, gt = testing.make_window_problem(
            window_size=10, max_features=F, imu_per_interval=16,
            dtype=jnp.float32)
        out, _, _, stats = lm.solve_window(states, f, max_iter=15)
        err = window_pose_error(out, gt)
        chi2, chi2_0 = float(stats["chi2"]), float(stats["chi2_init"])
        check(f"window_lm/W10_F{F}", err < 0.02 and chi2 <= 1e-8 * chi2_0,
              max_pose_err_m=err, chi2=chi2, chi2_init=chi2_0,
              iterations=int(stats["iterations"]), limit=0.02)


def global_problem():
    """The bench.py 100-keyframe global BA problem, float32."""
    from vio_tpu import testing

    gt, _ = testing.make_global_problem(N=100, M=400, obs_per_lm=8,
                                        dtype=jnp.float32)
    return gt, testing.perturb_global(gt, pose_sigma=0.02, rot_sigma=0.005)


def check_global_ba(check):
    """100-keyframe global BA to ground truth (gate: every pose within
    1e-3 m; the perturbation is 2 cm)."""
    from vio_tpu.parallel import global_ba

    gt, noisy = global_problem()
    opt, stats = global_ba.solve(noisy, max_iter=25, fix_frames=2,
                                 loss_delta=50.0)
    err = float(np.abs(np.asarray(opt.Ps) - np.asarray(gt.Ps)).max())
    check("global_ba/N100_M400", err < 1e-3, max_pose_err_m=err,
          chi2=float(stats["chi2"]), chi2_init=float(stats["chi2_init"]),
          limit=1e-3)


# ---------------------------------------------------------------------------
# end-to-end runs (one card)
# ---------------------------------------------------------------------------

def run_sim_cli(check, info):
    """The run_vio_simulation analog through the CLI: 600 noise-free
    frames, W=10, F=256 (gate: APE RMSE <= 0.0409 m, the reference's
    published noise-free number, BASELINE.md; no failures)."""
    from vio_tpu import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        cli.main(["run", "--dataset", "sim", "--frames", "600"])
    wall = time.perf_counter() - t0
    out = buf.getvalue()
    print(out, end="", flush=True)
    res = json.loads(out.strip().splitlines()[-1])
    print(json.dumps(dict(smoke_reading="sim_600_wall_frames_per_s",
                          value=600 / wall,
                          note="compilation included",
                          device_kind=info["kind"])), flush=True)
    ape = res["ape"]["rmse"]
    check("e2e/sim_600_cli", res["initialized"] and res["failures"] == 0
          and ape <= 0.0409, ape_rmse_m=ape, failures=res["failures"],
          initialized=res["initialized"], limit=0.0409)


def run_euroc_proxy(check, info):
    """The full pixel path on the EuRoC proxy of
    tests/test_image_pipeline.py: 420 rendered 640x640 frames with
    EuRoC-magnitude radtan distortion, CLAHE on, 10 Hz publishing (gate:
    APE RMSE < 0.05 m, no failures)."""
    from vio_tpu import metrics, runner, sim
    from vio_tpu.config import sim_images_config

    distort = dict(k1=-0.28, k2=0.07, p1=1.0e-4, p2=-2.0e-4)
    data = sim.generate(**distort)
    cfg = sim_images_config(equalize=True, freq=10, **distort)
    t0 = time.perf_counter()
    est, traj = runner.run_images(
        runner.sim_image_frames(data, n_frames=420),
        data.imu_t, data.acc, data.gyr, cfg)
    wall = time.perf_counter() - t0
    print(json.dumps(dict(smoke_reading="euroc_proxy_420_wall_frames_per_s",
                          value=420 / wall, note="compilation included",
                          device_kind=info["kind"])), flush=True)
    gt_p, _ = runner.sim_ground_truth_at(data, traj["t"])
    ape = float(metrics.ape_rmse(traj["p"], gt_p)["rmse"])
    check("e2e/euroc_proxy_420_images", est.initialized
          and est.failure_count == 0 and ape < 0.05, ape_rmse_m=ape,
          failures=est.failure_count, initialized=bool(est.initialized),
          limit=0.05)


def frame_step_memory():
    """memory_analysis() of the fused frame_step program at W=10, F=256,
    lowered with the inputs of a post-init frame of the sim run."""
    from vio_tpu import runner, sim
    from vio_tpu.solver import frame_step

    est, _ = runner.run_sim(sim.generate(noise=False), n_frames=40)
    if not est.initialized:
        raise RuntimeError("the 40-frame sim run did not initialize")
    inputs = est.frame_step_inputs()
    mem = frame_step.frame_step.lower(**inputs).compile().memory_analysis()
    fields = ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes", "generated_code_size_in_bytes",
              "alias_size_in_bytes")
    print(json.dumps(dict(
        frame_step_memory_analysis={k: getattr(mem, k, None)
                                    for k in fields},
        window=est.W, max_features=est.cfg.max_features)), flush=True)


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def check_four_cards(check, n: int = 4):
    """The sharded solvers on an n-device mesh against one device.

    - shard_map global BA (100 keyframes) vs ``global_ba.solve``: gate
      max pose difference <= 1e-4 m, and both runs reduce chi2 to the
      same level: |chi2_sh - chi2_1| <= 1e-6 chi2_init (float32 sums in
      another order; the high-precision psum keeps the LM accept path).
    - GSPMD window solve at W=10, F=256 vs ``lm.solve_window``: gate max
      pose difference <= 1e-3 m (the virtual-device test's bound) and
      |chi2_sh - chi2_1| <= 1e-8 chi2_init (both end near the float32
      floor, ~2e-9 of chi2_init, where a plain ratio is noise)."""
    from vio_tpu import testing
    from vio_tpu.parallel import global_ba, sharded
    from vio_tpu.solver import lm

    devs = jax.devices()[:n]
    mesh = sharded.make_mesh(n)

    _, noisy = global_problem()
    kw = dict(max_iter=10, fix_frames=2, loss_delta=50.0)
    with jax.default_device(devs[0]):
        ref, s1 = global_ba.solve(noisy, **kw)
    out, s2 = global_ba.solve_sharded(
        global_ba.prepare_sharded(noisy, mesh), mesh, **kw)
    dp = float(np.abs(np.asarray(out.Ps) - np.asarray(ref.Ps)).max())
    c1, c2, c0 = (float(s1["chi2"]), float(s2["chi2"]),
                  float(s1["chi2_init"]))
    check(f"four_cards/global_ba_shard_map_{n}dev",
          dp <= 1e-4 and abs(c2 - c1) <= 1e-6 * c0,
          max_pose_diff_m=dp, chi2_sharded=c2, chi2_one=c1, chi2_init=c0,
          iterations=(int(s2["iterations"]), int(s1["iterations"])))

    states, f, _ = testing.make_window_problem(
        window_size=10, max_features=256, imu_per_interval=16,
        dtype=jnp.float32)
    with jax.default_device(devs[0]):
        ref_states, _, _, ref_stats = lm.solve_window(states, f, max_iter=10)
    s_sh, f_sh = sharded.shard_problem(states, f, mesh)
    new_states, chi2 = sharded.training_step(s_sh, f_sh, max_iter=10)
    dp = float(np.abs(np.asarray(new_states.Ps) -
                      np.asarray(ref_states.Ps)).max())
    c1, c2, c0 = (float(ref_stats["chi2"]), float(chi2),
                  float(ref_stats["chi2_init"]))
    check(f"four_cards/window_gspmd_{n}dev_W10_F256",
          dp <= 1e-3 and abs(c2 - c1) <= 1e-8 * c0,
          max_pose_diff_m=dp, chi2_sharded=c2, chi2_one=c1, chi2_init=c0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded solvers on four cards")
    args = ap.parse_args(argv)

    n_cards = 4 if args.four_cards else 1
    info = phase0(n_cards)
    check = Checks()
    if args.four_cards:
        phases = [lambda: check_four_cards(check, n_cards)]
    else:
        phases = [lambda: check_spd_solve(check),
                  lambda: check_klt(check),
                  lambda: check_window_solve(check),
                  lambda: check_global_ba(check),
                  frame_step_memory,
                  lambda: run_sim_cli(check, info),
                  lambda: run_euroc_proxy(check, info)]
    for phase in phases:
        t0 = time.perf_counter()
        phase()
        print(json.dumps(dict(phase_s=time.perf_counter() - t0)), flush=True)
    if check.failed:
        print(json.dumps({"failed": check.failed}), flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": n_cards}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
