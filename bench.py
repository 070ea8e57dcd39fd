"""Single-GPU benchmarks of the VIO hot paths.

Stages, each printed as one JSON line when it finishes:

- ``window_ba_F256``: an LM solve (at most 10 iterations) of a W=10 window
  with 256 reprojection factors (Hessian assembly + landmark Schur + damped
  pose solve + state update), from a perturbed start so the LM loop has
  real work; ``lm_iterations`` says how many it ran.  The reference's per-frame solver budget is 0.04 s
  (euroc_config.yaml max_solver_time / estimator.cpp:1037), i.e. 25 solved
  frames/s, which ``vs_baseline`` divides by.
- ``klt_150feat_640px_3lvl``: forward-backward KLT, the reference's
  per-frame cv::calcOpticalFlowPyrLK shape.
- ``window_ba_F1024``: the window solve at the EuRoC feature capacity.
- ``global_ba_100kf``: 100-keyframe global BA, 10 LM iterations.
- ``e2e_sim_120frames``: the estimator over the tracker-bypass sim stream.
- ``fp32_600frame_sim_ape`` (with ``VIO_BENCH_FULL=1``): full-length APE.

Times are host-clock medians of calls that end in ``block_until_ready``.
Device busy time is read from a profiler trace of a separate window: the
union of the intervals in which a kernel or copy ran on the GPU's streams.
The benchmark needs a GPU and stops when there is none; a failed stage
fails the run.
"""
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import jax
import jax.numpy as jnp

BASELINE_FPS = 25.0  # reference solver budget: 0.04 s/frame


def gpu_name_and_power() -> str:
    """``name, power.limit`` of the card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def device_info() -> dict:
    devs = jax.devices()
    return dict(platform=devs[0].platform, kind=devs[0].device_kind,
                count=len(devs))


def require_gpu() -> dict:
    info = device_info()
    if info["platform"] != "gpu":
        raise SystemExit(f"no GPU found (JAX platform {info['platform']!r})")
    return info


def busy_ns(intervals) -> int:
    """Length of the union of (start_ns, duration_ns) intervals."""
    total = 0
    end = None
    for s, d in sorted(intervals):
        e = s + d
        if end is None or s > end:
            total += d
            end = e
        elif e > end:
            total += e - end
            end = e
    return int(total)


def device_intervals(planes):
    """(start_ns, duration_ns) of every event on the GPU stream lines.

    ``planes`` is an iterable of (plane_name, [(line_name, [(start_ns,
    duration_ns), ...]), ...]).  Device planes are named ``/device:GPU:<i>``;
    their ``Stream #...`` lines carry the kernels and copies.  The derived
    lines (``XLA Modules``, ``XLA Ops``, ...) span groups of kernels and
    are left out, so that gaps between kernels count as idle."""
    out = []
    for plane_name, lines in planes:
        if not plane_name.startswith("/device:GPU:"):
            continue
        for line_name, events in lines:
            if line_name.startswith("Stream"):
                out.extend(events)
    return out


def read_trace(trace_dir):
    """The newest profiler trace under trace_dir in ``device_intervals``'s
    plain form."""
    files = sorted(glob.glob(os.path.join(
        trace_dir, "plugins", "profile", "*", "*.xplane.pb")))
    if not files:
        raise RuntimeError(f"no profiler trace under {trace_dir}")
    pd = jax.profiler.ProfileData.from_file(files[-1])
    return [(pl.name, [(ln.name, [(ev.start_ns, ev.duration_ns)
                                  for ev in ln.events])
                       for ln in pl.lines])
            for pl in pd.planes]


def traced_busy_ms(run, n_calls: int) -> float:
    """Device busy time (ms) per call over a traced window of ``run()``."""
    with tempfile.TemporaryDirectory(prefix="viobench_") as tmp:
        jax.profiler.start_trace(tmp)
        run()
        jax.profiler.stop_trace()
        ivs = device_intervals(read_trace(tmp))
    if not ivs:
        raise RuntimeError("the trace holds no GPU kernel events")
    return busy_ns(ivs) / 1e6 / n_calls


def time_call(fn, args, n: int = 10) -> dict:
    """Wall (median, ms) and device busy (ms) per call of fn(*args)."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))             # compile + warm
    compile_s = time.perf_counter() - t0
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)

    def window():
        for _ in range(n):
            jax.block_until_ready(fn(*args))

    return dict(wall_ms=float(np.median(ts)) * 1e3,
                device_busy_ms=traced_busy_ms(window, n),
                first_call_s=compile_s)


def bench_window(max_features: int, n: int = 10):
    from vio_tpu import testing
    from vio_tpu.solver import lm

    states, f, _ = testing.make_window_problem(
        window_size=10, max_features=max_features, imu_per_interval=16,
        dtype=jnp.float32)
    live = int(np.asarray(f.obs_mask).sum())
    # live-observation compaction (window.assemble n_obs): GEMM rows scale
    # with live factors, not the (F, W1) grid — the production estimator
    # path (estimator._obs_cap)
    n_obs = max(256, ((live + 255) // 256) * 256)
    rng = np.random.default_rng(0)
    pert = jnp.asarray(rng.normal(0.0, 0.01, states.Ps.shape), jnp.float32)

    def step(states, pert):
        # perturb so the Nielsen loop has work to do (a converged fixed
        # point would early-stop after 1 and flatter the number)
        s = states._replace(Ps=states.Ps + pert)
        new_states, _, _, stats = lm.solve_window(s, f, max_iter=10,
                                                  n_obs=n_obs)
        return new_states.Ps, stats["chi2"], stats["iterations"]

    jitted = jax.jit(step)
    out = time_call(jitted, (states, pert), n=n)
    out["lm_iterations"] = int(np.asarray(jitted(states, pert)[2]))
    out["live_factors"] = live
    out["fps"] = 1e3 / out["wall_ms"]
    return out


def bench_klt(n: int = 10):
    """Batched KLT frame-to-frame fb-tracking: 150 features, 640², 3
    levels — the reference's per-frame cv::calcOpticalFlowPyrLK shape."""
    from vio_tpu.features import klt

    rng = np.random.default_rng(0)
    img0 = rng.standard_normal((640, 640)).astype(np.float32)
    for _ in range(2):
        img0 = (np.roll(img0, 1, 0) + np.roll(img0, -1, 0) +
                np.roll(img0, 1, 1) + np.roll(img0, -1, 1) + img0) / 5.0
    img0 = (img0 - img0.min()) / (img0.max() - img0.min()) * 255.0
    img1 = np.roll(img0, (2, 3), axis=(0, 1))
    a0 = jnp.asarray(img0)
    a1 = jnp.asarray(img1)
    pp = jnp.asarray(rng.uniform(40, 600, (150, 2)), jnp.float32)
    vv = jnp.ones(150, bool)

    # all three outputs: the backward pass feeds only ``ok``, and XLA drops
    # what no output needs
    step = jax.jit(lambda a0, a1, pp, vv: klt.track_fb(a0, a1, pp, vv))
    return time_call(step, (a0, a1, pp, vv), n=n)


def bench_global_ba(n: int = 5):
    """100-keyframe global BA (the scale-out configuration), full solve."""
    from vio_tpu import testing
    from vio_tpu.parallel import global_ba

    gt, _ = testing.make_global_problem(N=100, M=400, obs_per_lm=8,
                                        dtype=jnp.float32)
    noisy = testing.perturb_global(gt, pose_sigma=0.02, rot_sigma=0.005)

    def step(p):
        opt, stats = global_ba.solve(p, max_iter=10, fix_frames=2,
                                     loss_delta=50.0)
        return opt.Ps, stats["chi2"]

    return time_call(jax.jit(step), (noisy,), n=n)


def bench_e2e_sim(n_frames: int = 120, trace_frames: int = 8):
    """Full estimator pipeline frames/s over the tracker-bypass sim stream
    (IMU feed + feature packaging + init + per-frame fused frame_step +
    host-f64 marg chain + slide — everything but image tracking).

    wall_fps is the whole run after a warm-up run that compiles every
    program; device_busy_ms_per_frame comes from a trace of
    ``trace_frames`` consecutive post-init frames of a second estimator."""
    from vio_tpu import runner, sim
    from vio_tpu.config import sim_config
    from vio_tpu.estimator import Estimator

    data = sim.generate(noise=False)
    runner.run_sim(data, n_frames=n_frames)         # compile every program
    t0 = time.perf_counter()
    est, _ = runner.run_sim(data, n_frames=n_frames)
    wall = time.perf_counter() - t0

    est2 = Estimator(sim_config())
    frames = iter(range(len(data.cam_t)))
    imu_i = 0
    t_prev = None

    def feed_one():
        nonlocal imu_i, t_prev
        k = next(frames)
        t = data.cam_t[k] + est2.td
        if t_prev is not None:
            imu_i = runner.feed_interval(est2, data.imu_t, data.acc,
                                         data.gyr, t_prev, t, imu_i)
        t_prev = t
        feats = {int(lid): (np.array([*data.obs_xy[k, lid], 1.0]),
                            data.obs_uv[k, lid], np.zeros(2))
                 for lid in np.where(data.obs_valid[k])[0]}
        est2.process_image(feats, t)

    while not est2.initialized:
        feed_one()
    for _ in range(2):                               # post-init warm frames
        feed_one()

    def window():
        for _ in range(trace_frames):
            feed_one()

    dev_ms = traced_busy_ms(window, trace_frames)
    return dict(wall_fps=n_frames / wall,
                device_busy_ms_per_frame=dev_ms,
                frames_traced=trace_frames,
                initialized=bool(est.initialized), n_frames=n_frames)


def bench_fp32_ape(n_frames: int = 600):
    """Full-length noise-free sim APE in on-device float32 (the reference
    publishes 0.0409 m, doc/noise-free/results.zip::stats.json)."""
    from vio_tpu import metrics, runner, sim

    data = sim.generate(noise=False)
    est, traj = runner.run_sim(data, n_frames=n_frames)
    gt_p, _ = runner.sim_ground_truth_at(data, traj["t"])
    ape = metrics.ape_rmse(traj["p"], gt_p)
    return dict(ape_rmse_m=float(ape["rmse"]),
                failures=int(est.failure_count),
                initialized=bool(est.initialized))


def main():
    from vio_tpu import compile_cache

    compile_cache.enable()
    info = require_gpu()
    print(gpu_name_and_power(), flush=True)

    def emit(stage, result):
        print(json.dumps({"stage": stage, "device": info, **result}),
              flush=True)

    w = bench_window(256)
    emit("window_ba_F256", {**w, "vs_baseline": w["fps"] / BASELINE_FPS})
    emit("klt_150feat_640px_3lvl", bench_klt())
    emit("window_ba_F1024", bench_window(1024))
    emit("global_ba_100kf", bench_global_ba())
    emit("e2e_sim_120frames", bench_e2e_sim())
    if os.environ.get("VIO_BENCH_FULL", "") == "1":
        emit("fp32_600frame_sim_ape", bench_fp32_ape())


if __name__ == "__main__":
    sys.exit(main())
