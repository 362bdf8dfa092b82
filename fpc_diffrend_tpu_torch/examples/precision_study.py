"""Convergence of the fast gradient-precision modes against exact.

Port of the JAX package's ``examples/precision_study.py``. The modes
(``ops.precision``; JAX's ``FPC_GRAD_PREC`` and ``FPC_TEX_PREC``) round
operands of the backward's K5 and K4 to bf16. The study asks whether that
gradient noise changes what a real fit converges to: the 9-camera rig fit
of ``examples.convergence_study`` (the synthetic rig of ``examples.rig``
unless ``--calib`` names a calibration; 512^2, batch 8) runs once per
precision config from the same init, one after another in this process,
each under ``precision(grad, tex)`` (JAX used a child process a config
because its knobs are read at import). Loss and pose-error curves land in
``<out>/<tag>.json``; ``<out>/precision.md`` holds the comparison table and
JAX's verdict per config against exact: "OK" when its final loss is within
+2 % and its final pose error within +5 % of exact's.

Runs on the CUDA device (the entry cap autotuned), or with ``--cpu`` on the
plain PyTorch versions of the kernels. The default ``--out`` is not JAX's
``results/precision``, whose recorded runs stay as they are.

Usage: python -m fpc_diffrend_tpu_torch.examples.precision_study [--cpu]
       [--res 512] [--steps 3000] [--cams 9] [--frames 4]
       [--out results/torch_precision] [--configs exact,fast,fast2]
       [--seed 0] [--calib PATH]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from fpc_diffrend_tpu_torch.examples import convergence_study
from fpc_diffrend_tpu_torch.ops.precision import precision

# tag -> (gradient precision, texture precision)
CONFIGS = {"exact": ("exact", "exact"), "fast": ("fast", "fast"),
           "fast2": ("fast", "fast2")}
BATCH = 8
# JAX's verdict: a config converges when it ends within these of exact
LOSS_BUDGET = 0.02
POSE_BUDGET = 0.05


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--cams", type=int, default=9)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--out", default="results/torch_precision")
    ap.add_argument("--configs", default=",".join(CONFIGS))
    ap.add_argument("--seed", type=int, default=0,
                    help="fit sampling seed (a second exact run at another "
                    "seed measures SGD trajectory noise, the baseline the "
                    "modes are judged against)")
    ap.add_argument("--calib", default="",
                    help="a calibration.json (default: write the "
                    "synthetic 9-camera rig into --out)")
    args = ap.parse_args(argv)
    tags = [t for t in args.configs.split(",") if t]
    unknown = set(tags) - set(CONFIGS)
    if unknown or "exact" not in tags:
        ap.error(f"--configs must name exact and only {list(CONFIGS)}")
    args.tags = tags
    return args


def fit_config(study: dict, tag: str) -> dict:
    """One fit of the study's take under config ``tag``; writes
    ``<out>/<tag>.json``.

    :return: its record: "tag", "curve", "final_pose_err", "final_loss",
        "init_pose_err", "prec" {"grad", "tex"}.
    """
    args = study["args"]
    grad, tex = CONFIGS[tag]
    with precision(grad, tex):
        fit = convergence_study.fit_batch(study, BATCH, args.seed, tag)
    out = {"tag": tag, **fit,
           "init_pose_err": float(np.abs(study["gt_t"]).mean()),
           "prec": {"grad": grad, "tex": tex}}
    with open(os.path.join(args.out, f"{tag}.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


def verdicts(runs: dict) -> dict:
    """tag -> (converged, the table's "vs exact" cell), JAX's rule."""
    exact = runs["exact"]
    out = {}
    for tag, r in runs.items():
        if tag == "exact":
            out[tag] = (True, "—")
            continue
        dl = (r["final_loss"] - exact["final_loss"]) / max(
            abs(exact["final_loss"]), 1e-9)
        dp = (r["final_pose_err"] - exact["final_pose_err"]) / max(
            exact["final_pose_err"], 1e-9)
        ok = dl <= LOSS_BUDGET and dp <= POSE_BUDGET
        out[tag] = (ok, f"loss {dl:+.2%}, pose {dp:+.2%} -> "
                    + ("OK" if ok else "WORSE"))
    return out


def write_report(args, runs: dict) -> dict:
    """Write ``<out>/precision.md``; :return: :func:`verdicts`."""
    judged = verdicts(runs)
    lines = ["# Precision-mode convergence study "
             f"({args.cams}-cam rig, {args.res}^2, {args.steps} steps, "
             f"batch {BATCH}, same init, seed {args.seed})", "",
             "| config | final loss | final pose err | vs exact |",
             "|---|---|---|---|"]
    lines += [f"| {tag} | {r['final_loss']:.3f} | "
              f"{r['final_pose_err']:.4f} | {judged[tag][1]} |"
              for tag, r in runs.items()]
    lines += ["", f"init pose err {runs['exact']['init_pose_err']:.4f}; "
              "full curves in <tag>.json."]
    md = os.path.join(args.out, "precision.md")
    with open(md, "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines))
    print("wrote", md)
    bad = [t for t, (ok, _) in judged.items() if not ok]
    print("ALL CONVERGED" if not bad else f"NOT CONVERGED: {bad}")
    return judged


def run(args) -> dict:
    """Build the take, fit it under each config, write the report.

    :return: {"runs": tag -> :func:`fit_config`'s record, "verdicts":
        :func:`verdicts`, "study": ``convergence_study.build_study``'s
        take}.
    """
    study = convergence_study.build_study(args)
    runs = {tag: fit_config(study, tag) for tag in args.tags}
    return {"runs": runs, "verdicts": write_report(args, runs),
            "study": study}


def main(argv=None) -> int:
    judged = run(parse_args(argv))["verdicts"]
    return 0 if all(ok for ok, _ in judged.values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
