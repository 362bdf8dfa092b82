"""The traced slice: ``torch.profiler`` over a bounded steady run of the
cell's loop after the window, its Chrome trace written inside the
checkout, and the timeline read back from that file.

From the device side of the timeline: the union of kernel, copy and set
intervals (busy time), the summed kernel time, and the kernels that took
most time. From the gaps in that union: what the host was doing when the
device went idle, the host operation that began last before each gap.
"""

from __future__ import annotations

import bisect
import collections
import gzip
import json
import os
import time

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


def profile(fn, device, path: str) -> dict:
    """Run ``fn`` under the profiler, synchronized at both ends, and write
    the trace to ``path`` (gzip).

    :return: {"window_s": host-clock length of the slice, "path"}.
    """
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with torch_profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        window = time.perf_counter() - t0
    os.makedirs(os.path.dirname(path), exist_ok=True)
    raw = path[:-3] if path.endswith(".gz") else path
    prof.export_chrome_trace(raw)
    with open(raw, "rb") as f, gzip.open(raw + ".gz", "wb") as g:
        g.write(f.read())
    os.remove(raw)
    return {"window_s": window, "path": raw + ".gz"}


def _union(intervals):
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read(path: str, window_s: float, top: int = 10) -> dict:
    """The slice's timeline from a trace file.

    :return: busy_s (union of device intervals), kernel_s (summed kernel
        time), n_kernels, device_ops [[name, s]] (largest summed kernel
        times), idle_gaps [[host op, s]] (largest summed gaps by what the
        host was doing), window_s; busy_s 0 where no device event ran.
    """
    with gzip.open(path, "rt") as f:
        events = json.load(f).get("traceEvents", [])
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append(e)
        elif cat in HOST_CATS:
            host.append(e)
    merged = _union((e["ts"], e["ts"] + e["dur"]) for e in dev)
    busy_us = sum(e - s for s, e in merged)
    kernels = [e for e in dev if e.get("cat") == "kernel"]
    by_name = collections.Counter()
    for e in kernels:
        by_name[e["name"]] += e["dur"]
    host.sort(key=lambda e: e["ts"])
    starts = [e["ts"] for e in host]
    gaps = collections.Counter()
    for (_, e0), (s1, _) in zip(merged, merged[1:]):
        i = bisect.bisect_right(starts, e0) - 1
        name = host[i]["name"] if i >= 0 else "(none)"
        gaps[name] += s1 - e0
    return {
        "busy_s": busy_us * 1e-6, "window_s": window_s,
        "kernel_s": sum(e["dur"] for e in kernels) * 1e-6,
        "n_kernels": len(kernels),
        "device_ops": [[n, t * 1e-6] for n, t in by_name.most_common(top)],
        "idle_gaps": [[n, t * 1e-6] for n, t in gaps.most_common(top)],
    }
