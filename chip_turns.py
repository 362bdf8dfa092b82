#!/usr/bin/env python3
"""Checkouts of this repository's port timed in turns on one GPU.

    python3 chip_turns.py TREE [TREE ...] [--turns 2]

Runs the trees in order and then in reverse (OLD, NEW, NEW, OLD for two
trees and ``--turns 2``), each in a process of its own that
imports ``fpc_diffrend_tpu_torch`` from that tree and builds its kernels
there, and times on the same inputs (the bench workload as built from its
seed; the single view of its camera 0):

* K3 (``antialias_planes_bwd``) at the bench batch, after the step's
  stages have run once;
* K7 (``texture_planes``, wrap and clamp) at the single view, with
  ``grid_sample`` (border padding: the clamp mode's function) beside it;

each by CUDA events over 20 back-to-back calls, by the profiler's device
time of the kernels they ran, and (K7, ``grid_sample``) by the host's issue
of one call. Each kernel is held against its plain version (max abs
error). Prints one JSON line a run and ends with the card's name and power
limit; the runs also go to ``chiprun_out/chip_turns.json``.
"""

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def measure(tree: str) -> dict:
    """One tree's numbers (run in a process of its own)."""
    import chip_smoke as cs          # this script's sibling: the helpers

    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import fpc_diffrend_tpu_torch as pkg
    from fpc_diffrend_tpu_torch.fit import loop
    from fpc_diffrend_tpu_torch.kernels import build
    from fpc_diffrend_tpu_torch.models.camera import transform_clip
    from fpc_diffrend_tpu_torch.ops.cuda import antialias_cuda as ac
    from fpc_diffrend_tpu_torch.ops.cuda import rasterize_cuda as rc
    from fpc_diffrend_tpu_torch.ops.cuda import texture_cuda as tc
    from fpc_diffrend_tpu_torch.ops.rasterize import bin_stacked
    from fpc_diffrend_tpu_torch.profile_forward import step_stages
    from fpc_diffrend_tpu_torch.workload import build_workload

    if not os.path.abspath(pkg.__file__).startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {pkg.__file__}, not from {tree}")
    report = build.build()
    dev = torch.device("cuda")
    wl = build_workload(device=dev)
    H, W, B = wl["H"], wl["W"], wl["B"]
    ph, pw = rc.pad_resolution(H, W)
    rec = {"tree": tree, "ptxas": {
        name: [ln.strip() for ln in report[name]["log"].splitlines()
               if "registers" in ln or "spill" in ln]
        for name in ("antialias_bwd", "texture_fwd")}}
    # K3 at the bench batch: the step's first batch (its stages need
    # autograd)
    sstate = {}
    for _, fn in step_stages(wl, sstate):
        fn()
    with torch.no_grad():
        tex = wl["params"]["tex"].detach()
        idbuf, _, payload, _, colour = rc.fused_raster(sstate["bins"], tex,
                                                       B * ph, pw)
        g_aa = sstate["g_aa"]

        def k3():
            return ac.antialias_planes_bwd(idbuf, payload, colour, g_aa, H,
                                           W, ph)

        got = k3()
        want = ac.antialias_planes_bwd_plain(idbuf, payload, colour, g_aa,
                                             H, W, ph)
        rec["K3"] = {"max_abs_err": max(cs.max_err(a, b)
                                        for a, b in zip(got, want)),
                     "ms": cs.cuda_ms(k3, 20),
                     "device_ms": cs.device_ms(k3, 20)}
        del got, want
        # K7 at the single view of camera 0
        scene, params = wl["scene"], wl["params"]
        idx = torch.tensor([0, 0], device=dev)
        mvp = loop.build_mvp(scene, params, idx[:1], idx[1:])[0]
        verts3 = loop.sample_clip_positions(wl["config"], scene, params,
                                            idx[:1], idx[1:])[1][0]
        _, _, bins1 = bin_stacked(transform_clip(mvp, verts3)[None],
                                  scene.faces, scene.uv, scene.uv_idx,
                                  scene.face_neighbors, (H, W))
        k1 = rc.fused_raster(bins1, tex, ph, pw)
        tu, tv = k1[2][3], k1[2][4]
        tex_nchw = tex.permute(2, 0, 1)[None].contiguous()
        grid = torch.stack([tu * 2.0 - 1.0, tv * 2.0 - 1.0], -1)[None]

        def grid_sample():
            return torch.nn.functional.grid_sample(
                tex_nchw, grid, mode="bilinear", padding_mode="border",
                align_corners=False)

        for mode in ("wrap", "clamp"):
            def k7(mode=mode):
                return tc.texture_planes(tex, tu, tv, mode)

            rec[f"K7 {mode}"] = {
                "max_abs_err": cs.max_err(k7(), tc.texture_planes_plain(
                    tex, tu, tv, mode)),
                "ms": cs.cuda_ms(k7, 20), "device_ms": cs.device_ms(k7, 20),
                "host_issue_us": cs.host_us(k7, 200)}
        rec["grid_sample"] = {"ms": cs.cuda_ms(grid_sample, 20),
                              "device_ms": cs.device_ms(grid_sample, 20),
                              "host_issue_us": cs.host_us(grid_sample, 200)}
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--one", help="measure this tree (internal)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_turns: no CUDA device", file=sys.stderr)
        return 1
    if args.one:
        print(json.dumps(measure(args.one)), flush=True)
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
                            "--one", tree], cwd=HERE, capture_output=True,
                           text=True, timeout=900)
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
