#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. the card: name and power limit (nvidia-smi) and torch's device name;
2. build every CUDA kernel from ``fpc_diffrend_tpu_torch/csrc`` (one nvcc
   per source, all started together);
3. kernel checks at a mid size (B = 2 at 256x384, a 3,042-triangle dome and
   a 32-triangle dome whose large triangles fill the global list, 1024^2
   texture): K1 against its plain PyTorch version (ids and entries exactly
   equal, payload/extra/colour within 1e-5) and K2 against its plain
   version on the same planes (within 1e-6);
4. the slice at full width: the benchmarked workload (1600x1200, 29,768
   triangles, 1024^2 texture, batch 8, 3 cameras, 4 frames, free mode,
   Laplacian 1.0) through ``fit.loop.evaluate``: 1 warm-up batch, then 5
   timed batches with the launch counters set to 0 just before; the losses
   must be finite and each kernel launched once per batch; then per-stage
   CUDA-event times of one batch;
5. each kernel at the main path's shapes against its plain version, with
   its time, the plain version's time and its bound, printed as one
   ``{"kernels": [...]}`` line.

The card's line and the kernels line come before the last line, which is
``{"ok": true, "device": {...}}``. The full record also goes to
``chiprun_out/chip_smoke.json``. Exits non-zero with no result line when
there is no CUDA device or the port's package is missing.
"""

import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
K1_ATOL = 1e-5                 # payload / extra / colour; ids exact
K2_ATOL = 1e-6


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0:
        fail(f"nvidia-smi exit {r.returncode}: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls, after one warm-up."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def check_kernels(bins, tex, rows, pw, height, width, sample_ph, label):
    """K1 and K2 against their plain versions on the same inputs."""
    import torch

    from fpc_diffrend_tpu_torch.ops.cuda import antialias_cuda as ac
    from fpc_diffrend_tpu_torch.ops.cuda import rasterize_cuda as rc

    k1 = rc.fused_raster(bins, tex, rows, pw)
    torch.cuda.synchronize()
    p1 = rc.fused_raster_plain(bins, tex, rows, pw)
    names = ("idbuf", "entry", "payload", "extra", "colour")
    errs = {n: max_err(a, b) for n, a, b in zip(names, k1, p1)}
    if errs["idbuf"] != 0 or errs["entry"] != 0:
        bad = int((k1[0] != p1[0]).sum())
        fail(f"{label}: K1 ids/entries differ from the plain version "
             f"({bad} pixels; {errs})")
    if max(errs["payload"], errs["extra"], errs["colour"]) > K1_ATOL:
        fail(f"{label}: K1 planes differ from the plain version: {errs}")
    k2 = ac.antialias_planes(k1[0], k1[2], k1[4], height, width, sample_ph)
    torch.cuda.synchronize()
    p2 = ac.antialias_planes_plain(k1[0], k1[2], k1[4], height, width,
                                   sample_ph)
    e2 = max_err(k2, p2)
    if not e2 <= K2_ATOL:
        fail(f"{label}: K2 differs from the plain version by {e2}")
    hits = int((k1[0] >= 0).sum())
    print(f"check {label}: {rows}x{pw}, n_global={int(bins.n_global[0])}, "
          f"hit px={hits}; K1 max abs err {errs}; K2 max abs err {e2}",
          flush=True)
    return max(errs.values()), e2, k1


def k1_bound_ms(bins, rows, pw, C, tex):
    """Least time for K1's work: each input read once, each output written
    once (bytes), against ~16 flops per (pixel, live entry) coverage test
    plus ~60 per pixel for the payload and texture (operations)."""
    live = int(bins.bin_start[-1])
    ng = int(bins.n_global[0])
    box = bins.global_bbox[:ng].long()
    tiles_g = int(((box[:, 2] - box[:, 0] + 1)
                   * (box[:, 3] - box[:, 1] + 1)).sum()) if ng else 0
    px = rows * pw
    out_bytes = px * (4 + 4 + 4 * 14 + 4 * 8 + 4 * C)
    in_bytes = ((live + ng) * 32 * 4 + bins.bin_start.numel() * 4
                + tex.numel() * 4)
    ops = 16 * 1024 * (live + tiles_g) + 60 * px
    return max((out_bytes + in_bytes) / HBM_BYTES_PER_S,
               ops / FP32_FLOPS) * 1e3, (
        "bytes" if (out_bytes + in_bytes) / HBM_BYTES_PER_S
        >= ops / FP32_FLOPS else "operations"), live


def k2_bound_ms(idbuf, C, height, width, sample_ph):
    """Least time for K2: 11 + C planes read and C written per pixel
    (bytes), against ~60 flops per pixel pair whose ids differ and 2 per
    other pair (operations)."""
    rows, pw = idbuf.shape
    px = rows * pw
    import torch

    h_pairs = int((idbuf[:, :width - 1] != idbuf[:, 1:width]).sum())
    vmask = (torch.arange(rows - 1, device=idbuf.device) % sample_ph
             < height - 1)
    v_pairs = int(((idbuf[:-1] != idbuf[1:]) & vmask[:, None]).sum())
    nbytes = px * 4 * (11 + 2 * C)
    ops = 60 * (h_pairs + v_pairs) + 2 * 2 * px
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device")
    if not os.path.isdir(os.path.join(REPO, "fpc_diffrend_tpu_torch")):
        fail("the fpc_diffrend_tpu_torch package is not beside this script")
    sys.path.insert(0, REPO)
    from fpc_diffrend_tpu_torch.fit import loop
    from fpc_diffrend_tpu_torch.kernels import build
    from fpc_diffrend_tpu_torch.ops.cuda import antialias_cuda as ac
    from fpc_diffrend_tpu_torch.ops.cuda import rasterize_cuda as rc
    from fpc_diffrend_tpu_torch.profile_forward import forward_stages
    from fpc_diffrend_tpu_torch.workload import build_workload

    t_start = time.perf_counter()
    record = {}

    # ---- 1. the card ----
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {kind} ({torch.cuda.device_count()} visible); torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    record["card"] = card

    # ---- 2. build ----
    t0 = time.perf_counter()
    report = build.build()
    record["build_s"] = time.perf_counter() - t0
    for name, r in report.items():
        lines = [ln.strip() for ln in r["log"].splitlines()
                 if "registers" in ln or "spill" in ln or "reused" in ln]
        print(f"build {name}: {r['seconds']:.1f} s; " + " | ".join(lines),
              flush=True)
    print(f"build total: {record['build_s']:.1f} s", flush=True)

    # ---- 3. kernel checks at a mid size ----
    dev = torch.device("cuda")
    for grid in (40, 5):
        wl = build_workload(256, 384, grid=grid, batch=2, tex_size=1024,
                            device=dev)
        state = {}
        for _, fn in forward_stages(wl, state)[:2]:     # prologue, binning
            fn()
        bins = state["bins"]
        ph, pw = rc.pad_resolution(256, 384)
        check_kernels(bins, wl["params"]["tex"], 2 * ph, pw, 256, 384, ph,
                      f"dome grid {grid}, {wl['faces'].shape[0]} tris")
        if grid == 5 and int(bins.n_global[0]) == 0:
            fail("the large-triangle check scene left the global list empty")

    # ---- 4. the slice at full width ----
    t0 = time.perf_counter()
    wl = build_workload(device=dev)
    torch.cuda.synchronize()
    record["workload_build_s"] = time.perf_counter() - t0
    config, scene, params = wl["config"], wl["scene"], wl["params"]
    H, W, B = wl["H"], wl["W"], wl["B"]
    print(f"workload: {H}x{W}, {wl['faces'].shape[0]} tris, batch {B}, "
          f"tex {tuple(params['tex'].shape)}, built in "
          f"{record['workload_build_s']:.1f} s", flush=True)
    gen = torch.Generator().manual_seed(0)
    loop.evaluate(config, scene, params, wl["frames_u8"], 1, gen)
    torch.cuda.synchronize()
    n_batches = 5
    rc.fused_raster.launches = 0
    ac.antialias_planes.launches = 0
    t0 = time.perf_counter()
    metrics = loop.evaluate(config, scene, params, wl["frames_u8"],
                            n_batches, gen)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) / n_batches * 1e3
    launches = {"fused_raster": rc.fused_raster.launches,
                "antialias": ac.antialias_planes.launches}
    metrics = {k: v.tolist() for k, v in metrics.items()}
    print(f"evaluate: {n_batches} batches, forward {fwd_ms:.3f} ms/batch "
          f"(host clock, synchronized); launches {launches}; "
          f"loss {metrics['loss']}", flush=True)
    for k, v in metrics.items():
        if not all(math.isfinite(x) for x in v):
            fail(f"non-finite {k}: {v}")
    if any(n != n_batches for n in launches.values()):
        fail(f"kernel launches {launches} != {n_batches} batches")
    record.update(forward_ms_per_batch=fwd_ms, metrics=metrics,
                  launches=launches)

    # per-stage device times of the workload's first batch
    ph, pw = rc.pad_resolution(H, W)
    state = {}
    stages = {}
    with torch.no_grad():
        for name, fn in forward_stages(wl, state):
            stages[name] = cuda_ms(fn, 5)
    record["stage_ms"] = stages
    print("stages (CUDA events, ms, batch of 8): " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items()), flush=True)

    # ---- 5. kernels at the main path's shapes ----
    bins = state["bins"]
    tex = params["tex"]
    C = tex.shape[2]
    with torch.no_grad():
        k1_err, k2_err, k1_out = check_kernels(bins, tex, B * ph, pw, H, W,
                                               ph, "bench batch")
        idbuf, _, payload, _, colour = k1_out
        k1_ms = cuda_ms(lambda: rc.fused_raster(bins, tex, B * ph, pw), 20)
        k1_plain = cuda_ms(
            lambda: rc.fused_raster_plain(bins, tex, B * ph, pw), 2)
        k2_ms = cuda_ms(lambda: ac.antialias_planes(
            idbuf, payload, colour, H, W, ph), 20)
        k2_plain = cuda_ms(lambda: ac.antialias_planes_plain(
            idbuf, payload, colour, H, W, ph), 3)
    k1_bound, k1_by, live = k1_bound_ms(bins, B * ph, pw, C, tex)
    k2_bound, k2_by = k2_bound_ms(idbuf, C, H, W, ph)
    kernels = [
        {"name": "fused_raster", "route": "cuda",
         "source": "fpc_diffrend_tpu_torch/csrc/fused_raster.cu",
         "replaces": "fpc_diffrend_tpu/ops/pallas/rasterize_tpu.py:1055",
         "launches": launches["fused_raster"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain, "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": None},
        {"name": "antialias", "route": "cuda",
         "source": "fpc_diffrend_tpu_torch/csrc/antialias.cu",
         "replaces": "fpc_diffrend_tpu/ops/pallas/antialias_tpu.py:184",
         "launches": launches["antialias"], "max_abs_err": k2_err,
         "ms": k2_ms, "plain_ms": k2_plain, "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": None},
    ]
    record.update(kernels=kernels, live_bin_entries=live,
                  n_global=int(bins.n_global[0]),
                  total_s=time.perf_counter() - t_start)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"),
              "w") as f:
        json.dump(record, f, indent=1)
    print(f"live bin entries {live}, n_global {record['n_global']}, "
          f"total {record['total_s']:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
