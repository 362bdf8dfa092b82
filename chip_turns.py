#!/usr/bin/env python3
"""Checkouts of this repository's port timed in turns on one GPU.

    python3 chip_turns.py TREE [TREE ...] [--turns 2]
                          [--paths bench,mip,view,place,grad,prec]

Runs the trees in order and then in reverse (OLD, NEW, NEW, OLD for two
trees and ``--turns 2``), each in a process of its own that
imports ``fpc_diffrend_tpu_torch`` from that tree and builds its kernels
there, and times on the same inputs the kernels that phase 6 of
``chip_smoke.py`` times too. On the bench workload as built from its seed,
on its first batch's kernel inputs (``chip_smoke.step_inputs``), and the
single view of its camera 0 (``chip_smoke.kernel_pairs``; ``--paths``
"bench"):

* K2 (``antialias``), K3 (``antialias_bwd``) and K4 in wrap mode
  (``texture_bwd``, on K3's colour cotangent) at the bench batch;
* K4 in clamp mode at the single view (``texture_bwd_clamp``, on a
  cotangent where the view is covered), with
  ``grid_sampler_2d_backward`` (border padding: the same function) beside
  it; and on a cotangent on every missed pixel of the view (all at uv
  (0, 0): ``texture_bwd_hot_wrap``, ``texture_bwd_hot_clamp``);
* K7 (``texture_fwd``, ``texture_fwd_clamp``) at the single view, with
  ``grid_sample`` (border padding: the clamp mode's function) beside it.

At the single view and the bench step's batch
(``chip_smoke.view_place_pairs``; "view", "place"): K10
(``fused_raster_aa``), the "sepaa" route's K1 + K2 (``sepaa``) and K1
alone at the view (``fused_raster_view``), each with the device time of
every kernel it runs, and K1 at the bench batch (``fused_raster``, which
K10 shares its kernel with); K11 (``bin_place``) at the bench step's
batch and the autotuned cap, with the device time of each of its kernels,
its host issue of one call, and the slots, tiles and largest and mean
bin.

At the bench batch, on the step's own cotangents (its K1 planes, K4's and
K3's payload cotangents, K5's rows; "grad"): K5 (``pixel_grad``) and K6
(``fold_entries``), each with the device time of every kernel and memset
it runs and its host issue of one call, and the traffic, search probes
and found rows of K6's gather design (``chip_smoke.k6_design_bytes``;
the same count on either tree: it reads only the bins).

At the bench batch, on the step's own inputs ("prec"): K4 wrap and clamp
in each texture precision and K5 in each gradient precision
(``chip_smoke.precision_pairs``: ``texture_bwd_<exact|fast|fast2>_<wrap|
clamp>``, ``pixel_grad_<exact|fast>``), 20-call windows, and K4's gtex
against its plain version over 5 calls (``gtex_rel``, of the summed
magnitudes as ``chip_smoke.py`` holds it). A tree whose wrappers take no
precision argument cannot run this set.

On the bench-mip workload, on its first batch's kernel inputs
(``chip_smoke.mip_kernel_pairs``; "mip"): K8 deriving the LOD
(``mip_sample_lod``, timed as ``mip_sample``) and K9 (``mip_sample_bwd``,
on K3's colour cotangent) at the bench-mip batch.

Each by CUDA events over back-to-back calls (20 at the bench and
bench-mip batches, 200 at the single view) and by the profiler's device
time of the kernels they ran, and K7 and ``grid_sample`` by the host's
issue of one call. Each kernel is held against its plain version (max abs
error over its outputs; K4's and K9's gtu and gtv only; K5's live rows
only). Each run also records each library's nvcc seconds (all built at once;
0 where reused) and the ptxas register and spill lines, each
after its kernel's name, of ``antialias``, ``antialias_bwd``,
``texture_bwd``, ``texture_fwd``, ``texture_mip``, ``fused_raster``,
``bin_place`` and ``raster_grad`` (a
library reused from an earlier build of the tree prints none). The
device times read a tree's ``ops.cuda.device_events``, so a tree without
it cannot be timed; nor can a tree whose K5 takes its cotangent planes as
one stack (``chip_smoke.step_inputs`` passes them apart). Prints one JSON
line a run and ends with the card's name and power limit; the runs also go
to
``chiprun_out/chip_turns.json``.
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
        "fused_raster": 20, "pixel_grad": 20, "fold_entries": 20,
        "mip_sample": 20, "mip_sample_bwd": 20}
SINGLE_VIEW_REPS = 200
HOST_TIMED = ("texture_fwd", "texture_fwd_clamp", "grid_sample",
              "bin_place", "pixel_grad", "fold_entries")
# the device time of each kernel and memset they run, by name
PER_KERNEL = ("fused_raster_aa", "sepaa", "fused_raster_view", "bin_place",
              "pixel_grad", "fold_entries")


def measure(tree: str, paths) -> dict:
    """One tree's numbers (run in a process of its own) on the workloads of
    ``paths`` ("bench", "mip", "view", "place", "grad", "prec")."""
    import chip_smoke as cs          # this script's sibling: the helpers

    sys.path.insert(0, os.path.abspath(tree))
    import torch

    import fpc_diffrend_tpu_torch as pkg
    from fpc_diffrend_tpu_torch.kernels import build
    from fpc_diffrend_tpu_torch.ops.cuda import rasterize_cuda as rc
    from fpc_diffrend_tpu_torch.workload import build_workload

    if not os.path.abspath(pkg.__file__).startswith(os.path.abspath(tree)):
        raise RuntimeError(f"imported {pkg.__file__}, not from {tree}")
    report = build.build()
    rec = {"tree": tree,
           "build_s": {name: r["seconds"] for name, r in report.items()},
           "ptxas": {
        name: [ln.strip() for ln in report[name]["log"].splitlines()
               if "registers" in ln or "spill" in ln
               or "Function properties" in ln]
        for name in ("antialias", "antialias_bwd", "texture_bwd",
                     "texture_fwd", "texture_mip", "fused_raster",
                     "bin_place", "raster_grad")}}
    pairs = {}
    prec_names = ()
    dev = torch.device("cuda")
    if {"bench", "view", "place", "grad", "prec"} & set(paths):
        wl = build_workload(device=dev)
        H, W, B = wl["H"], wl["W"], wl["B"]
        ph, pw = rc.pad_resolution(H, W)
        # the step's first batch (its cotangents need autograd)
        sstate = cs.step_inputs(wl)
        with torch.no_grad():
            tex = wl["params"]["tex"].detach()
            bins1 = cs.view_bins(wl)
            k1s = rc.fused_raster(bins1, tex, ph, pw)
            if "bench" in paths:
                k1 = rc.fused_raster(sstate["bins"], tex, B * ph, pw)
                pairs.update(cs.kernel_pairs(tex, k1, sstate["g_aa"], k1s, H,
                                             W, ph)[0])
            tile_ids, n_tiles = rc.pair_tile_ids(
                sstate["pc"].detach(), wl["scene"].faces, H, W)
            P = rc.entry_count(B, wl["faces"].shape[0],
                               wl["config"].pair_cap)
            vp = cs.view_place_pairs(tex, bins1, H, W, ph, tile_ids,
                                     n_tiles, P)
            if "view" in paths:
                pairs.update({k: v for k, v in vp.items()
                              if k != "bin_place"})
                # K1 at the bench batch, beside K10 which shares its code
                pairs["fused_raster"] = (
                    lambda: rc.fused_raster(sstate["bins"], tex, B * ph, pw),
                    None)
            if "place" in paths:
                pairs["bin_place"] = vp["bin_place"]
                largest, mean, live = cs.bin_sizes(tile_ids, n_tiles)
                rec["bin_place_shape"] = {
                    "slots": tile_ids.numel(), "P": P, "live": live,
                    "K": tile_ids.shape[2], "n_tiles": n_tiles,
                    "largest_bin": largest, "mean_bin": mean}
            if "prec" in paths:
                prec = cs.precision_pairs(tex, sstate["k1"],
                                          sstate["k3"][0], sstate["bins"],
                                          sstate["k5_cot"])
                pairs.update(prec)
                prec_names = tuple(prec)
                REPS.update(dict.fromkeys(prec, 20))
                payload = sstate["k1"][2]
                gtex_inputs = (tex, payload[3], payload[4], sstate["k3"][0])
            if "grad" in paths:
                pairs.update(grad_pairs(sstate, B * wl["faces"].shape[0]))
                rec["fold_entries_design"] = cs.k6_design_bytes(
                    tile_ids, sstate["bins"])
    if "mip" in paths:
        # the mip step's first batch: K9 on K3's colour cotangent
        wlm = build_workload(mip=True, device=dev)
        mstate = cs.step_inputs(wlm)
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
                if name in prec_names and name.startswith("texture_bwd"):
                    r["gtex_rel"] = gtex_rel(name, fn, want[0], *gtex_inputs)
                if name.startswith("texture_bwd") or name.endswith(
                        "mip_sample_bwd"):
                    # gtu, gtv only: gtex and gpyr are held relative to
                    # their summed magnitudes (chip_smoke.py checks them)
                    got, want = got[1:], want[1:]
                if name.startswith("pixel_grad"):
                    # rows past the live prefix are unspecified
                    live = int(sstate["bins"].bin_start[-1])
                    got, want = ((got[0][:live], got[1]),
                                 (want[0][:live], want[1]))
                r["max_abs_err"] = max(cs.max_err(a, b)
                                       for a, b in zip(got, want))
            if name in HOST_TIMED:
                r["host_issue_us"] = cs.host_us(fn, 200)
            if name in PER_KERNEL:
                r["device_kernels_ms"] = cs.device_kernels_ms(fn, reps)
            rec[name] = r
    return rec


def gtex_rel(name, fn, want, tex, tu, tv, gcolour, calls: int = 5):
    """The largest of ``calls`` K4 calls' gtex errors against its plain
    version ``want`` (``chip_smoke.atomic_err``: of the summed magnitudes
    of the shares), for a ``texture_bwd_<prec>_<wrap|clamp>`` pair."""
    import chip_smoke as cs
    from fpc_diffrend_tpu_torch.ops.cuda import texture_cuda as tc

    prec, bmode = name.split("_")[2:]
    mag = tc.texture_planes_bwd_plain(tex, tu, tv, gcolour.abs(), bmode,
                                      prec)[0]
    return max(cs.atomic_err(fn()[0], want, mag) for _ in range(calls))


def grad_pairs(sstate, n_tris) -> dict:
    """K5 and K6 (kernel call, plain version) on the bench step's own
    inputs: its bins and K1 planes, the payload cotangents K3 and K4 gave,
    and K5's rows for K6."""
    from fpc_diffrend_tpu_torch.ops.cuda import raster_grad_cuda as gc

    bins, k5 = sstate["bins"], sstate["k5"]
    _, entry, payload, extra, _ = sstate["k1"]
    args = (bins, entry, payload[0], payload[1], extra, *sstate["k5_cot"])
    return {
        "pixel_grad": (lambda: gc.pixel_grad(*args),
                       lambda: gc.pixel_grad_plain(*args)),
        "fold_entries": (lambda: gc.fold_entries(*k5, bins, n_tris),
                         lambda: gc.fold_entries_plain(*k5, bins, n_tris))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--paths", default="bench,mip,view,place,grad",
                    help="kernel sets to time: bench, mip, view, place, "
                    "grad, prec")
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
