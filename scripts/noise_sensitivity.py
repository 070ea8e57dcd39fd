"""Noise-prior sensitivity experiment — the reference's designed study
(reference: 17-vins-initialization/README.md:185-240,
doc/with-noise/comparison/summary.csv): run the noisy simulation with the
matched, 3×-overestimated, and ⅓-underestimated IMU noise priors and
compare APE.  Writes RESULTS.md rows next to BASELINE.md rows 2-4.

Usage: python scripts/noise_sensitivity.py [--frames N] [--out RESULTS.md]
"""
import argparse
import json
import sys
import time

sys.path.insert(0, ".")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--out", default="RESULTS.md")
    args = ap.parse_args()

    import jax
    # accuracy study: run on CPU in float64 (the solver path is numerically
    # happier, and the workload is host-bound)
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import numpy as np
    from vio_tpu import metrics, runner, sim
    from vio_tpu.config import sim_config

    data = sim.generate(noise=True, pixel_noise=0.0)
    # matched continuous-time priors (reference vio_simulation.yaml:
    # acc_n 0.2687 / gyr_n 0.2121 matched to sim sigmas ×√hz scaling)
    base = dict(acc_n=0.2687, gyr_n=0.2121)
    cases = {
        "matched": 1.0,
        "overestimate_3x": 3.0,
        "underestimate_3x": 1.0 / 3.0,
    }
    ref = {"matched": 0.0365, "overestimate_3x": 0.0409,
           "underestimate_3x": 0.1583}

    rows = []
    for name, k in cases.items():
        cfg = sim_config(acc_n=base["acc_n"] * k, gyr_n=base["gyr_n"] * k)
        t0 = time.time()
        est, traj = runner.run_sim(data, cfg, n_frames=args.frames)
        gt_p, _ = runner.sim_ground_truth_at(data, traj["t"])
        ape = metrics.ape_rmse(traj["p"], gt_p)
        rows.append((name, k, ape, est.failure_count, time.time() - t0))
        print(json.dumps(dict(case=name, factor=k, ape=ape,
                              failures=est.failure_count)))

    with open(args.out, "a") as fh:
        fh.write("\n## Noise-prior sensitivity (vs BASELINE.md rows 2-4)\n\n")
        fh.write(f"Frames: {args.frames or 'all 600'}; noisy sim "
                 "(IMU noise only, like the reference's experiment).\n\n")
        fh.write("| prior | APE RMSE (ours) | APE RMSE (reference) | "
                 "max | failures |\n|---|---|---|---|---|\n")
        for name, k, ape, fails, wall in rows:
            fh.write(f"| {name} | {ape['rmse']:.4f} m | {ref[name]:.4f} m "
                     f"| {ape['max']:.4f} m | {fails} |\n")
    print(f"appended results to {args.out}")


if __name__ == "__main__":
    main()
