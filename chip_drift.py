#!/usr/bin/env python3
"""Run-to-run drift of the convergence study's long fits on one GPU.

    python3 chip_drift.py [--runs 3] [--steps 2000] [--ranges rig,50-250]
                          [--batches 8,1] [--cpu] [--res 512] [--cams 9]
                          [--frames 4] [--out chiprun_out/chip_drift.json]

Fits the convergence study (``fpc_diffrend_tpu_torch.examples.
convergence_study``: the synthetic 9-camera rig, 512^2, 4 frames, 2,000
steps) ``--runs`` times from one seed at each batch size and at each
depth range, the take rendered at that range:

* "rig": the calibration's [0.01, 200], where the head's z_ndc spans
  1.6e-5 below 1, so adjacent triangles tie in depth and the antialias's
  occluder between them is rounding;
* "50-250": the same cameras over [50, 250], where the depths resolve.

Every run samples the same batches from the same seed. On the card the
atomic sums (K4's texture gradient, K5's rows, the setup chain's index
backward) add in another order each run, so the runs part; on the CPU
(``--cpu``: the plain versions) they are bit-equal. For each (range,
batch): each run's final loss and pose error, its minimum pose error and
its mean pose error over the last quarter of the logged points, the
spread (max - min) of each over the runs, and the first logged step at
which any run differs from the first. Prints one JSON line per (range,
batch), then the card's name and power limit
(``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``); the
record goes to ``--out``. Exits non-zero without a CUDA device unless
``--cpu`` is given.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
RANGES = {"rig": None, "50-250": (50.0, 250.0)}


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--ranges", default=",".join(RANGES))
    ap.add_argument("--batches", default="8,1")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--cams", type=int, default=9)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "chip_drift.json"))
    return ap.parse_args(argv)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else (
        f"nvidia-smi exit {r.returncode}")


def spread(xs) -> float:
    return max(xs) - min(xs)


def drift(study: dict, batch: int, runs: int) -> dict:
    """``runs`` fits of ``study`` at ``batch`` samples a step, and how far
    they part."""
    from fpc_diffrend_tpu_torch.examples import convergence_study

    fits, seconds = [], []
    for _ in range(runs):
        t0 = time.perf_counter()
        fits.append(convergence_study.fit_batch(study, batch))
        seconds.append(time.perf_counter() - t0)
    curves = [f["curve"] for f in fits]
    parted = None
    for i, point in enumerate(curves[0]):
        if any(c[i]["loss"] != point["loss"]
               or c[i]["pose_err"] != point["pose_err"] for c in curves[1:]):
            parted = point["step"]
            break
    tail = max(len(curves[0]) // 4, 1)
    out = {
        "final_loss": [f["final_loss"] for f in fits],
        "final_pose_err": [f["final_pose_err"] for f in fits],
        "min_pose_err": [min(p["pose_err"] for p in c) for c in curves],
        "tail_pose_err": [sum(p["pose_err"] for p in c[-tail:]) / tail
                          for c in curves],
        "first_parted_step": parted, "seconds": seconds}
    out["spread"] = {k: spread(out[k]) for k in (
        "final_loss", "final_pose_err", "min_pose_err", "tail_pose_err")}
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    if not args.cpu and not torch.cuda.is_available():
        print("chip_drift: no CUDA device (--cpu runs the plain versions)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from fpc_diffrend_tpu_torch.examples import convergence_study

    if not args.cpu:
        from fpc_diffrend_tpu_torch.kernels import build
        build.build()
    card = "CPU" if args.cpu else card_line()
    batches = [int(b) for b in args.batches.split(",")]
    rec = {"card": card, "args": vars(args), "cells": []}
    with tempfile.TemporaryDirectory(prefix="chip_drift_") as tmp:
        for name in args.ranges.split(","):
            study_args = convergence_study.parse_args(
                ["--res", str(args.res), "--steps", str(args.steps),
                 "--cams", str(args.cams), "--frames", str(args.frames),
                 "--out", os.path.join(tmp, name)]
                + (["--cpu"] if args.cpu else []))
            study = convergence_study.build_study(study_args, RANGES[name])
            for batch in batches:
                cell = dict(depth_range=name, batch=batch,
                            init_pose_err=float(abs(study["gt_t"]).mean()),
                            **drift(study, batch, args.runs))
                rec["cells"].append(cell)
                print(json.dumps(cell), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rec, f, indent=1)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
