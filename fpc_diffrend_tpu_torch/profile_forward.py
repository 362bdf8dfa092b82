"""Where the forward and the fit step spend their device time, at the
bench workload.

    python -m fpc_diffrend_tpu_torch.profile_forward [--batches 3] [--steps 3]
        [--mip]

Needs a CUDA device. Traces ``fit.loop.evaluate`` and ``fit.loop.
train_steps`` with ``torch.profiler`` (CPU and CUDA activities) on the
bench workload (``--mip``: its trilinear-mipmap variant), inside
``utils.profiling.recording()``, and prints for each:

* the device busy share of the traced window: the summed time of the CUDA
  kernels and copies over the window's wall time (one stream, so device
  work does not overlap);
* the kernels with the most device time;
* per span of the program (``fit.step``, ``raster.bin``, ``K11
  bin_place``, ``fit.backward``, ``raster.bwd``, ...: the layers of the
  very step it traced), its host time and self time per iteration and
  the device time of the kernels launched inside it on any thread (the
  backward launches from autograd's thread while ``fit.backward`` waits);
* for ``train_steps``, the share of the traced steps that replayed the
  state's CUDA graph (``fit.graph_replays`` ÷ steps): a replayed step
  records only ``fit.replay``, and its kernels' device time falls under
  that span.

The record goes to ``chiprun_out/profile_forward.json``
(``profile_forward_mip.json`` with ``--mip``). The spans are the
program's own, so the breakdown is of the very pass the fit runs;
``chip_smoke.py`` reads the stages of one eager step the same way
(:func:`traced`, :func:`span_device_us`).
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile

from fpc_diffrend_tpu_torch.fit import loop
from fpc_diffrend_tpu_torch.ops.cuda import device_events
from fpc_diffrend_tpu_torch.utils import profiling
from fpc_diffrend_tpu_torch.workload import build_workload

_ACTIVITIES = [ProfilerActivity.CPU, ProfilerActivity.CUDA]


def span_device_us(trace_path: str) -> dict:
    """span name -> summed device time (us) of the kernels whose launch
    (the runtime or driver call of the kernel's correlation id) began
    inside one of the span's intervals, on any thread, from a Chrome
    trace of ``torch.profiler``."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    spans, launched, kernels = {}, {}, []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat")
        corr = e.get("args", {}).get("correlation")
        if cat == "user_annotation":
            spans.setdefault(e["name"], []).append((e["ts"],
                                                    e["ts"] + e["dur"]))
        elif cat in ("cuda_runtime", "cuda_driver"):
            launched[corr] = e["ts"]
        elif cat == "kernel":
            kernels.append((corr, e["dur"]))
    ts = sorted((launched[c], d) for c, d in kernels if c in launched)
    starts = [t for t, _ in ts]
    prefix = [0.0]
    for _, d in ts:
        prefix.append(prefix[-1] + d)
    return {name: sum(prefix[bisect.bisect_right(starts, b)]
                      - prefix[bisect.bisect_left(starts, a)]
                      for a, b in ivs)
            for name, ivs in spans.items()}


def traced(fn, trace_path: str):
    """(wall ms, device kernels, span name -> device us) of fn() under the
    profiler; its Chrome trace is written to ``trace_path`` and removed."""
    with profile(activities=_ACTIVITIES) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(trace_path)
    try:
        return wall_ms, device_events(prof), span_device_us(trace_path)
    finally:
        os.remove(trace_path)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--mip", action="store_true",
                    help="the trilinear-mipmap variant of the workload")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward needs a CUDA device")
    wl = build_workload(mip=args.mip, device="cuda")
    config, scene, params = wl["config"], wl["scene"], wl["params"]
    gen = torch.Generator().manual_seed(0)
    dgen = torch.Generator(device="cuda")
    dgen.manual_seed(0)

    def evaluate():
        loop.evaluate(config, scene, params, wl["frames_u8"], args.batches,
                      gen)

    def steps():
        loop.train_steps(config, scene, wl["state"], wl["frames_u8"], dgen,
                         args.steps, wl["n_frames"])

    out = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chiprun_out")
    os.makedirs(out, exist_ok=True)
    stem = "profile_forward_mip" if args.mip else "profile_forward"
    record = {"card": torch.cuda.get_device_name(0), "mip": args.mip}
    for name, fn, n in (("evaluate", evaluate, args.batches),
                        ("train_steps", steps, args.steps)):
        fn()                                            # warm-up
        torch.cuda.synchronize()
        with profiling.recording() as log:
            wall_ms, kernels, span_us = traced(
                fn, os.path.join(out, f"{stem}.{name}.trace.json"))
        busy_ms = sum(r[1] for r in kernels)
        spans = {k: {"count": c, "host_ms": 1e3 * t / n,
                     "self_host_ms": 1e3 * own / n,
                     "device_ms": span_us.get(k, 0.0) / 1e3 / n}
                 for k, (c, t, own) in log.totals().items()}
        replays = log.counters.get("fit.graph_replays", 0)
        record[name] = {"n": n, "wall_ms": wall_ms, "busy_ms": busy_ms,
                        "kernels": kernels[:40], "spans": spans,
                        "counters": log.counters}
        if busy_ms == 0:
            print("the profiler recorded no device time: use CUDA events")
        print(f"{name} x{n}: wall {wall_ms:.3f} ms, device busy "
              f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f} %)"
              + (f"; CUDA graph replays {replays} of {n} steps "
                 f"({100 * replays / n:.1f} %)"
                 if name == "train_steps" else ""))
        for kname, ms, cnt in kernels[:15]:
            print(f"  {ms / n:9.3f} ms/iter  x{cnt // n:<4d} {kname[:100]}")
        print("  spans per iter (host ms, self, device ms): " + ", ".join(
            f"{k} {v['host_ms']:.3f} {v['self_host_ms']:.3f} "
            f"{v['device_ms']:.3f}" for k, v in spans.items()))
    with open(os.path.join(out, stem + ".json"), "w") as f:
        json.dump(record, f, indent=1)


if __name__ == "__main__":
    main()
