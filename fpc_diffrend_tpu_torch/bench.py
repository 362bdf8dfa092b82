"""Headline benchmark of the port: the full fit step at the bench workload.

Port of the JAX package's ``bench.py``. Times the complete training step —
blend -> pose -> binning (K11) -> fused rasterize + texture (K1) ->
antialias (K2) -> photometric + regularizer losses -> backward (K3-K6; K9
on the mip path) -> multi-group Adam — on the face-like grid dome of
``workload.build_workload``, batched over (camera, frame) samples, on the
CUDA device (``--cpu``: the plain PyTorch versions, a functional check).

The JAX script's ``FPC_BENCH_*`` knobs are arguments here (the port reads no
environment variable), with the same defaults; ``--grad-prec`` and
``--tex-prec`` set the gradient precision (``ops.precision``) for the run,
as JAX's ``FPC_GRAD_PREC`` and ``FPC_TEX_PREC`` do (JAX defaults to
``fast``/``fast2``, the port to ``exact``). Left out: JAX's attach probe
and supervised retry (``bench.py:128-193``), workarounds for the TPU's
remote attach; a failure here is a failure.

Timing: one warm-up call, then ``--iters`` calls and one host read of the
last loss. With ``--dispatch`` k > 1 a call is ``fit.loop.train_steps`` of
k steps sampled on the device from a generator seeded 0 (JAX scans k steps
a dispatch); with 1 it is ``fit.loop.train_step`` on the workload's fixed
batch.

Prints ONE JSON line: bench.py's keys ``metric``, ``value`` (Mpix/s fwd+bwd
= B*H*W / step), ``unit``, ``vs_baseline`` (value over the same 500 Mpix/s
nvdiffrast-on-A100 proxy), and ``row``, ``step_ms``, ``tris``,
``grad_prec``, ``tex_prec``, the card's ``name`` and ``power_limit`` (as
``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives
them), ``steps`` (timed), ``launches`` (each device kernel's launches over as
many steps again after the timed ones, measured in a ``torch.profiler``
trace: ``ops.cuda.device_launches``, a CUDA graph's replays included),
``loss`` (the last step's) and ``temporal`` (the temporal
term over every frame of the final pose).

Usage: python -m fpc_diffrend_tpu_torch.bench [--res-h 1600] [--res-w 1200]
       [--grid 123] [--batch 8] [--tex 1024] [--cams 3] [--frames 4]
       [--temporal 0] [--mip 0] [--impl auto] [--iters 10] [--dispatch 5]
       [--grad-prec exact] [--tex-prec exact] [--row NAME] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from fpc_diffrend_tpu_torch.device import resolve_device
from fpc_diffrend_tpu_torch.fit import losses as losses_mod
from fpc_diffrend_tpu_torch.fit import loop as fit_loop
from fpc_diffrend_tpu_torch.ops.cuda import device_launches
from fpc_diffrend_tpu_torch.ops.precision import (GRAD_MODES, TEX_MODES,
                                                  precision)
from fpc_diffrend_tpu_torch.workload import build_workload

BASELINE_MPIX_S = 500.0


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="The fit step's Mpix/s at the bench workload.")
    ap.add_argument("--res-h", type=int, default=1600)
    ap.add_argument("--res-w", type=int, default=1200)
    ap.add_argument("--grid", type=int, default=123,
                    help="grid side: 2 (g - 1)^2 triangles")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--tex", type=int, default=1024)
    ap.add_argument("--cams", type=int, default=3)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--temporal", type=float, default=0.0,
                    help="temporal smoothness weight")
    ap.add_argument("--mip", type=int, default=0,
                    help="1: trilinear mipmap sampling, max_mip_level 6")
    ap.add_argument("--impl", default="auto", help="FitConfig.raster_impl")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--dispatch", type=int, default=5,
                    help="steps a call (1: train_step on a fixed batch)")
    ap.add_argument("--grad-prec", default="exact", choices=GRAD_MODES)
    ap.add_argument("--tex-prec", default="exact", choices=TEX_MODES)
    ap.add_argument("--row", default=None, help="the row's name, recorded")
    ap.add_argument("--cpu", action="store_true")
    return ap.parse_args(argv)


def card(dev: torch.device) -> tuple[str, str | None]:
    """(name, power limit) of the card as nvidia-smi gives them; on the
    CPU ("cpu", None)."""
    if dev.type != "cuda":
        return "cpu", None
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    name, limit = r.stdout.strip().splitlines()[0].rsplit(",", 1)
    return name.strip(), limit.strip()


def run(args) -> tuple[dict, dict]:
    """Build the workload, time the step.

    :return: (the JSON line's record, the workload it built and timed:
        ``workload.build_workload``'s dict, its state after the timed
        steps, for a caller that checks the kernels at the row's shapes).
    """
    dev = resolve_device("cpu" if args.cpu else None)
    wl = build_workload(args.res_h, args.res_w, args.grid, args.batch,
                        args.tex, args.cams, args.frames, mip=bool(args.mip),
                        weight_temporal=args.temporal, impl=args.impl,
                        device=dev)
    config, scene, state = wl["config"], wl["scene"], wl["state"]
    H, W, B, n_frames = wl["H"], wl["W"], wl["B"], wl["n_frames"]
    k = args.dispatch
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def call():
        """One dispatch; :return: its last step's loss (on the device)."""
        if k > 1:
            _, met = fit_loop.train_steps(config, scene, state,
                                          wl["frames_u8"], gen, k, n_frames)
            return met["loss"][-1]
        return fit_loop.train_step(config, scene, state, wl["batch"])["loss"]

    with precision(args.grad_prec, args.tex_prec):
        t0 = time.perf_counter()
        float(call())
        warmup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(args.iters):
            loss = call()
        loss = float(loss)
        elapsed = time.perf_counter() - t0
        # the profiler stays out of the timed steps
        with device_launches() as launches:
            for _ in range(args.iters):
                call()
    steps = args.iters * max(k, 1)
    dt = elapsed / steps
    with torch.no_grad():
        temporal = float(losses_mod.temporal_smoothness(
            config, state.params, torch.arange(n_frames, device=dev)))
    mpix = B * H * W / dt / 1e6
    fv_hour = 3600.0 / (H * W / (mpix * 1e6))
    name, power = card(dev)
    tris = int(wl["faces"].shape[0])
    return ({
        "metric": "Mpixels/s fwd+bwd fit step "
                  f"({tris} tris, {H}x{W}, batch {B}, "
                  f"~{fv_hour:.0f} frame-views/hour)",
        "value": round(mpix, 1), "unit": "Mpix/s",
        "vs_baseline": round(mpix / BASELINE_MPIX_S, 3),
        "row": args.row, "step_ms": dt * 1e3, "tris": tris,
        "grad_prec": args.grad_prec, "tex_prec": args.tex_prec,
        "name": name, "power_limit": power, "steps": steps,
        "launches": launches, "loss": loss, "temporal": temporal,
        "warmup_s": warmup_s, "device": dev.type}, wl)


def main(argv=None) -> int:
    rec, _ = run(parse_args(argv))
    print(json.dumps(rec), flush=True)
    print(f"# step={rec['step_ms']:.1f}ms warmup={rec['warmup_s']:.0f}s "
          f"device={rec['device']}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
