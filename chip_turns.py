#!/usr/bin/env python3
"""Checkouts of this repository's port timed in turns on one GPU.

    python3 chip_turns.py TREE [TREE ...] [--turns 2] [--paths bench,mip]

Runs the trees in order and then in reverse (OLD, NEW, NEW, OLD for two
trees and ``--turns 2``), each in a process of its own that
imports ``fpc_diffrend_tpu_torch`` from that tree and builds its kernels
there, and times on the same inputs the kernels that phase 6 of
``chip_smoke.py`` times too. On the bench workload as built from its seed,
after the step's stages have run once, and the single view of its camera
0 (``chip_smoke.kernel_pairs``; ``--paths`` "bench"):

* K2 (``antialias``), K3 (``antialias_bwd``) and K4 in wrap mode
  (``texture_bwd``, on K3's colour cotangent) at the bench batch;
* K4 in clamp mode at the single view (``texture_bwd_clamp``, on a
  cotangent where the view is covered), with
  ``grid_sampler_2d_backward`` (border padding: the same function) beside
  it; and on a cotangent on every missed pixel of the view (all at uv
  (0, 0): ``texture_bwd_hot_wrap``, ``texture_bwd_hot_clamp``);
* K7 (``texture_fwd``, ``texture_fwd_clamp``) at the single view, with
  ``grid_sample`` (border padding: the clamp mode's function) beside it.

On the bench-mip workload, after its step's stages have run once
(``chip_smoke.mip_kernel_pairs``; "mip"): K8 (``mip_sample``) and K9
(``mip_sample_bwd``, on K3's colour cotangent) at the bench-mip batch.

Each by CUDA events over back-to-back calls (20 at the bench and
bench-mip batches, 200 at the single view) and by the profiler's device
time of the kernels they ran, and K7 and ``grid_sample`` by the host's
issue of one call. Each kernel is held against its plain version (max abs
error over its outputs; K4's and K9's gtu and gtv only). Each run also
records the ptxas register and spill lines, each after its kernel's
name, of ``antialias``,
``antialias_bwd``, ``texture_bwd``, ``texture_fwd`` and ``texture_mip`` (a
library reused from an earlier build of the tree prints none). Prints one
JSON line a run and ends with the card's name and power limit; the runs
also go to ``chiprun_out/chip_turns.json``.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# calls a window: the bench batch's kernels take 0.2-0.6 ms; the single
# view's 7-90 us, so a window of theirs is longer to reach past the noise
REPS = {"antialias": 20, "antialias_bwd": 20, "texture_bwd": 20,
        "mip_sample": 20, "mip_sample_bwd": 20}
SINGLE_VIEW_REPS = 200
HOST_TIMED = ("texture_fwd", "texture_fwd_clamp", "grid_sample")


def measure(tree: str, paths) -> dict:
    """One tree's numbers (run in a process of its own) on the workloads of
    ``paths`` ("bench", "mip")."""
    import chip_smoke as cs          # this script's sibling: the helpers

    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import fpc_diffrend_tpu_torch as pkg
    from fpc_diffrend_tpu_torch.kernels import build
    from fpc_diffrend_tpu_torch.ops.cuda import rasterize_cuda as rc
    from fpc_diffrend_tpu_torch.profile_forward import step_stages
    from fpc_diffrend_tpu_torch.workload import build_workload

    if not os.path.abspath(pkg.__file__).startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {pkg.__file__}, not from {tree}")
    report = build.build()
    rec = {"tree": tree, "ptxas": {
        name: [ln.strip() for ln in report[name]["log"].splitlines()
               if "registers" in ln or "spill" in ln
               or "Function properties" in ln]
        for name in ("antialias", "antialias_bwd", "texture_bwd",
                     "texture_fwd", "texture_mip")}}
    pairs = {}
    dev = torch.device("cuda")
    if "bench" in paths:
        wl = build_workload(device=dev)
        H, W, B = wl["H"], wl["W"], wl["B"]
        ph, pw = rc.pad_resolution(H, W)
        # the step's first batch (its stages need autograd)
        sstate = {}
        for _, fn in step_stages(wl, sstate):
            fn()
        with torch.no_grad():
            tex = wl["params"]["tex"].detach()
            k1 = rc.fused_raster(sstate["bins"], tex, B * ph, pw)
            k1s = rc.fused_raster(cs.view_bins(wl), tex, ph, pw)
            pairs.update(cs.kernel_pairs(tex, k1, sstate["g_aa"], k1s, H, W,
                                         ph)[0])
    if "mip" in paths:
        # the mip step's first batch: K9 on K3's colour cotangent
        wlm = build_workload(mip=True, device=dev)
        mstate = {}
        for _, fn in step_stages(wlm, mstate):
            fn()
        ph, _ = rc.pad_resolution(wlm["H"], wlm["W"])
        pairs.update(cs.mip_kernel_pairs(
            mstate["k1"], wlm["params"]["tex"].detach(), mstate["k3"][0],
            wlm["H"], wlm["W"], ph)[0])
    with torch.no_grad():
        for name, (fn, plain) in pairs.items():
            reps = REPS.get(name, SINGLE_VIEW_REPS)
            r = {"ms": cs.cuda_ms(fn, reps),
                 "device_ms": cs.device_ms(fn, reps)}
            if plain is not None:
                got, want = fn(), plain()
                got, want = ((got,), (want,)) if torch.is_tensor(got) else (
                    got, want)
                if name.startswith("texture_bwd") or name.endswith(
                        "mip_sample_bwd"):
                    # gtu, gtv only: gtex and gpyr sum with atomics
                    # (chip_smoke.py checks them)
                    got, want = got[1:], want[1:]
                r["max_abs_err"] = max(cs.max_err(a, b)
                                       for a, b in zip(got, want))
            if name in HOST_TIMED:
                r["host_issue_us"] = cs.host_us(fn, 200)
            rec[name] = r
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--paths", default="bench,mip",
                    help="workloads whose kernels to time: bench, mip")
    ap.add_argument("--one", help="measure this tree (internal)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_turns: no CUDA device", file=sys.stderr)
        return 1
    if args.one:
        print(json.dumps(measure(args.one, args.paths.split(","))),
              flush=True)
        return 0
    if len(args.trees) < 2:
        ap.error("give two trees or more")
    trees = [os.path.abspath(t) for t in args.trees]
    order = []
    for _ in range(args.turns):
        order += trees + trees[::-1]
    order = order[:len(trees) * args.turns]
    runs = []
    for tree in order:
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", tree, "--paths", args.paths], cwd=HERE,
                           capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            print(r.stdout + r.stderr, file=sys.stderr)
            return 1
        runs.append(json.loads(r.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_turns.json"), "w") as f:
        json.dump({"card": card, "runs": runs}, f, indent=1)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
