"""Command-line entry points: `python -m vio_tpu.cli <cmd>`.

Replaces the reference's executables (reference:
vins-mono/test/run_euroc.cpp, run_vio_simulation.cpp,
simulator/src/main.cpp) with one CLI:

  run   — play a dataset through the estimator, dump TUM trajectory + APE
  sim   — generate the analytic dataset (optionally reference-format CSVs)
  bench — single-GPU benchmarks (same as bench.py)
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def _dump_telemetry(est, path):
    if not path:
        return
    with open(path, "w") as fh:
        for rec in est.pop_telemetry():
            fh.write(json.dumps(rec) + "\n")


class _MaybeProfile:
    """jax.profiler trace context when a directory is given."""

    def __init__(self, trace_dir):
        self.trace_dir = trace_dir

    def __enter__(self):
        if self.trace_dir:
            import jax
            jax.profiler.start_trace(self.trace_dir)
        return self

    def __exit__(self, *exc):
        if self.trace_dir:
            import jax
            jax.profiler.stop_trace()
        return False


def cmd_run(args):
    from . import metrics, runner, sim
    from .config import sim_config, euroc_config

    if args.dataset == "sim":
        data = sim.generate(noise=args.noise, pixel_noise=args.pixel_noise)
        cfg = sim_config()
        t0 = time.time()
        with _MaybeProfile(args.profile):
            est, traj = runner.run_sim(data, cfg, n_frames=args.frames,
                                       progress=args.verbose)
        wall = time.time() - t0
        _dump_telemetry(est, args.log_jsonl)
        gt_p, gt_R = runner.sim_ground_truth_at(data, traj["t"])
        ape = metrics.ape_rmse(traj["p"], gt_p)
        if args.out:
            metrics.write_tum(args.out, traj["t"], traj["p"], traj["R"])
        print(json.dumps(dict(
            dataset="sim", noise=bool(args.noise), frames=len(traj["t"]),
            initialized=bool(est.initialized), failures=est.failure_count,
            wall_s=round(wall, 1),
            fps=round(est.frame_solved / max(wall, 1e-9), 2), ape=ape)))
    elif args.dataset == "euroc":
        cfg = euroc_config()
        t0 = time.time()
        with _MaybeProfile(args.profile):
            est, traj, data = runner.run_euroc(args.path, cfg,
                                               n_frames=args.frames,
                                               progress=args.verbose)
        wall = time.time() - t0
        _dump_telemetry(est, args.log_jsonl)
        if args.out:
            metrics.write_tum(args.out, traj["t"], traj["p"], traj["R"])
        result = dict(dataset="euroc", path=args.path, frames=len(traj["t"]),
                      failures=est.failure_count, wall_s=round(wall, 1),
                      fps=round(est.frame_solved / max(wall, 1e-9), 2))
        if data.gt_t is not None and len(traj["t"]) > 0:
            # associate by nearest GT timestamp (evo's default pairing)
            idx = np.clip(np.searchsorted(data.gt_t, traj["t"]), 0,
                          len(data.gt_t) - 1)
            result["ape"] = metrics.ape_rmse(traj["p"], data.gt_p[idx])
        print(json.dumps(result))
    elif args.dataset == "sim-images":
        # the full image pipeline against rendered simulator frames
        from .config import sim_images_config
        data = sim.generate(noise=args.noise, pixel_noise=args.pixel_noise)
        cfg = sim_images_config()
        t0 = time.time()
        with _MaybeProfile(args.profile):
            est, traj = runner.run_images(
                runner.sim_image_frames(data, n_frames=args.frames),
                data.imu_t, data.acc, data.gyr, cfg, progress=args.verbose)
        wall = time.time() - t0
        _dump_telemetry(est, args.log_jsonl)
        gt_p, gt_R = runner.sim_ground_truth_at(data, traj["t"])
        ape = metrics.ape_rmse(traj["p"], gt_p)
        if args.out:
            metrics.write_tum(args.out, traj["t"], traj["p"], traj["R"])
        print(json.dumps(dict(
            dataset="sim-images", frames=len(traj["t"]),
            failures=est.failure_count, wall_s=round(wall, 1),
            fps=round(est.frame_solved / max(wall, 1e-9), 2), ape=ape)))
    elif args.dataset == "hybrid":
        # hybrid real-sensor flagship: REAL MH-05 IMU + camera stamps,
        # pixels rendered from the IMU-consistent trajectory (hybrid.py);
        # --path points at the directory holding MH_05_imu0.txt/_cam0.txt
        from . import hybrid
        from .config import sim_images_config
        base = args.path or ("/root/reference/workspace/assignments/"
                             "17-vins-initialization/vins-mono/config")
        dist = dict(k1=-0.28, k2=0.07, p1=1.0e-4, p2=-2.0e-4)
        data = hybrid.generate_hybrid(
            os.path.join(base, "MH_05_imu0.txt"),
            os.path.join(base, "MH_05_cam0.txt"),
            duration=30.0 if args.frames is None else args.frames / 20.0,
            **dist)
        cfg = sim_images_config(equalize=True, freq=10,
                                outlier_reproj_px=3.0, **dist)

        def frames():
            for k in range(len(data.cam_t)):
                yield float(data.cam_t[k]), (
                    lambda kk=k: sim.render_image(data, kk))

        t0 = time.time()
        with _MaybeProfile(args.profile):
            est, traj = runner.run_images(frames(), data.imu_t, data.acc,
                                          data.gyr, cfg,
                                          progress=args.verbose)
        wall = time.time() - t0
        _dump_telemetry(est, args.log_jsonl)
        gt_p, _ = runner.sim_ground_truth_at(data, traj["t"])
        ape = metrics.ape_rmse(traj["p"], gt_p)
        if args.out:
            metrics.write_tum(args.out, traj["t"], traj["p"], traj["R"])
        print(json.dumps(dict(
            dataset="hybrid", frames=len(traj["t"]),
            failures=est.failure_count, wall_s=round(wall, 1), ape=ape)))
    else:
        raise SystemExit(f"unknown dataset {args.dataset}")


def cmd_sim(args):
    from . import sim
    from . import io as vio_io
    data = sim.generate(noise=args.noise, pixel_noise=args.pixel_noise)
    if args.out:
        vio_io.write_sim_csvs(data, args.out)
        print(f"wrote reference-format CSVs to {args.out}")


def cmd_bench(args):
    import bench
    bench.main()


def main(argv=None):
    ap = argparse.ArgumentParser(prog="vio_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="run VIO on a dataset")
    p.add_argument("--dataset", default="sim",
                   choices=["sim", "sim-images", "euroc", "hybrid"])
    p.add_argument("--path", default=None, help="EuRoC sequence dir")
    p.add_argument("--frames", type=int, default=None)
    p.add_argument("--noise", action="store_true")
    p.add_argument("--pixel-noise", type=float, default=0.0)
    p.add_argument("--out", default=None, help="TUM trajectory output path")
    p.add_argument("--log-jsonl", default=None,
                   help="per-solve telemetry JSONL output path")
    p.add_argument("--profile", default=None,
                   help="jax.profiler trace directory (view with xprof)")
    p.add_argument("-v", "--verbose", action="store_true")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("sim", help="generate the analytic dataset")
    p.add_argument("--noise", action="store_true")
    p.add_argument("--pixel-noise", type=float, default=0.0)
    p.add_argument("--out", default=None, help="reference-format CSV dir")
    p.set_defaults(fn=cmd_sim)

    p = sub.add_parser("bench", help="single-GPU benchmarks (bench.py)")
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    from . import compile_cache
    compile_cache.enable()
    args.fn(args)


if __name__ == "__main__":
    main()
