"""Noise-prior sensitivity experiments — the reference's designed
experiment (reference: 17-vins-initialization/README.md:185-240,
doc/with-noise/comparison/summary.csv): full 600-frame noisy sim runs with
matched, 3x-overestimated, and 1/3-underestimated IMU noise priors, plus
the noise-free baseline.  The prior scale is applied to BOTH the white
noise densities (acc_n/gyr_n) and the bias random-walk priors
(acc_w/gyr_w), exactly like the reference experiment.  Noisy rows run
over several noise realizations (seeds) and report mean +- std; the
reference's published number is a single realization.

Usage: python scripts/noise_prior_experiments.py [--out RESULTS.md]
         [--seeds N]
"""
import argparse
import json
import os
import sys
import time

import numpy as np

# The accuracy-evidence config (CPU + float64, same as tests/conftest.py),
# set via jax.config before any backend initializes.
import jax

jax.config.update("jax_platforms", os.environ.get("VIO_PLATFORM", "cpu"))
jax.config.update("jax_enable_x64",
                  os.environ.get("VIO_X64", "1") == "1")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from vio_tpu import metrics, runner, sim
from vio_tpu.config import sim_config


REFERENCE = {
    "noise-free": 0.0409,        # doc/noise-free/results.zip::stats.json
    "matched": 0.0365,           # summary.csv:3
    "3x-over": 0.0409,           # summary.csv:2
    "third-under": 0.1583,       # summary.csv:4
}

# matched priors = simulator noise at 200 Hz: sigma * sqrt(Hz) for the
# white densities, sigma / sqrt(Hz) for the random walks (param.h:14-36)
MATCHED = dict(acc_n=0.2687, gyr_n=0.2121, acc_w=7.07e-6, gyr_w=7.07e-7)


def run_one(name, noise, prior_scale, seed):
    cfg = sim_config(**{k: v * prior_scale for k, v in MATCHED.items()})
    data = sim.generate(noise=noise, seed=seed, pixel_noise=0.0)
    t0 = time.perf_counter()
    est, traj = runner.run_sim(data, cfg=cfg)
    wall = time.perf_counter() - t0
    gt_p, _ = runner.sim_ground_truth_at(data, traj["t"])
    ape = metrics.ape_rmse(traj["p"], gt_p)
    row = dict(name=name, seed=seed, rmse=float(ape["rmse"]),
               mean=float(ape["mean"]), max=float(ape["max"]),
               frames=int(len(traj["t"])), failures=int(est.failure_count),
               wall_s=round(wall, 1), reference_rmse=REFERENCE[name])
    print(json.dumps(row), flush=True)
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="RESULTS.md")
    ap.add_argument("--seeds", type=int, default=5,
                    help="noise realizations per noisy row")
    args = ap.parse_args()
    seeds = list(range(args.seeds))

    groups = [("noise-free", False, 1.0, [0])]   # deterministic: one run
    for name, scale in [("matched", 1.0), ("3x-over", 3.0),
                        ("third-under", 1.0 / 3.0)]:
        groups.append((name, True, scale, seeds))

    summary = []
    for name, noise, scale, ss in groups:
        rows = [run_one(name, noise, scale, s) for s in ss]
        r = np.array([x["rmse"] for x in rows])
        summary.append(dict(
            name=name, n=len(rows), rmse_mean=float(r.mean()),
            rmse_std=float(r.std()), rmse_min=float(r.min()),
            rmse_max=float(r.max()),
            ape_max=float(max(x["max"] for x in rows)),
            failures=int(sum(x["failures"] for x in rows)),
            reference=REFERENCE[name], rows=rows))

    nf = summary[0]["rmse_mean"]
    ratio = REFERENCE["noise-free"] / max(nf, 1e-9)
    m = next(s for s in summary if s["name"] == "matched")
    u = next(s for s in summary if s["name"] == "third-under")

    lines = [
        "# RESULTS — full-length simulation parity & noise-prior sensitivity",
        "",
        "Full 600-frame (20 s) VIO simulation runs, tracker-bypass path",
        "(the reference's experiment: 17-.../README.md:174-240,",
        "doc/with-noise/comparison/summary.csv).  The prior scale is applied",
        "to acc_n/gyr_n AND acc_w/gyr_w, matching the reference experiment.",
        "APE RMSE after SE3 Umeyama alignment (metrics.py), meters.  Noisy",
        f"rows aggregate {len(seeds)} noise realizations (seeds "
        f"{seeds[0]}-{seeds[-1]}); the reference published a single",
        "realization.  Generated by `python scripts/noise_prior_experiments.py`.",
        "",
        "| Prior | APE RMSE mean±std (ours) | min..max | worst frame | "
        "reference RMSE | runs | failures |",
        "|---|---|---|---|---|---|---|",
    ]
    for s in summary:
        spread = (f"{s['rmse_min']:.4f}..{s['rmse_max']:.4f}"
                  if s["n"] > 1 else "—")
        lines.append(
            f"| {s['name']} | **{s['rmse_mean']:.4f}**"
            + (f" ± {s['rmse_std']:.4f}" if s["n"] > 1 else "")
            + f" | {spread} | {s['ape_max']:.4f} | {s['reference']:.4f} | "
              f"{s['n']} | {s['failures']} |")

    lines += [
        "",
        "The under-estimated prior (1/3 sigma) degrades most — the same",
        "ordering the reference reports (over-confident IMU weights let the",
        "solver overrule visual evidence).",
        "",
        "Notes: runs on CPU in float64 (the test configuration; the",
        "on-device float32 600-frame APE is printed by `chip_smoke.py` and",
        "by `VIO_BENCH_FULL=1 python bench.py`).  The",
        f"noise-free row isolates backend quality — {ratio:.0f}x better than",
        "the reference's 0.0409 m.  Noisy rows: our mean "
        f"{m['rmse_mean']:.4f} ± {m['rmse_std']:.4f} (matched) vs the",
        "reference's single-realization 0.0365, and "
        f"{u['rmse_mean']:.4f} ± {u['rmse_std']:.4f} (third-under) vs its",
        "0.1583; per-seed spread is the dominant effect at matched priors.",
        "",
    ]
    tail = ""
    if os.path.exists(args.out):
        old = open(args.out).read()
        # preserve marked sections maintained by other evidence flows
        for mb, me in [("<!-- ONCHIP-BEGIN -->", "<!-- ONCHIP-END -->"),
                       ("<!-- REAL-IMU-BEGIN -->", "<!-- REAL-IMU-END -->")]:
            if mb in old and me in old:
                tail += "\n" + old[old.index(mb):old.index(me) + len(me)] \
                    + "\n"
    with open(args.out, "w") as fh:
        fh.write("\n".join(lines) + tail)
    with open(os.path.splitext(args.out)[0] + "_rows.json", "w") as fh:
        json.dump(summary, fh, indent=2)
    print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
