"""Timing and tracing hooks (port of ``fpc_diffrend_tpu.utils.profiling``).

``time_fn`` waits for the devices the result lives on before it reads
the clock; ``trace`` records the host and, where there is one, the CUDA
device with ``torch.profiler`` and writes a Chrome trace;
``fpc_diffrend_tpu_torch.profile_forward`` breaks a step down by stage.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from fpc_diffrend_tpu_torch.utils.debugging import tree_leaves_with_path


def sync(tree) -> float:
    """Wait for the devices of ``tree``'s tensors; :return: the sum of
    their absolute values in float32 (a checksum)."""
    leaves = [x for _, x in tree_leaves_with_path(tree)
              if isinstance(x, torch.Tensor)]
    if not leaves:
        return 0.0
    for dev in {x.device for x in leaves if x.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    total = sum(torch.sum(torch.abs(x.detach().to(torch.float32))).cpu()
                for x in leaves)
    return float(total)


def time_fn(fn, *args, iters: int = 10, warmup: int = 1):
    """(seconds_per_call, last_result) of ``fn(*args)`` over ``iters``
    calls after ``warmup``, the devices synchronized at both ends."""
    r = None
    for _ in range(warmup):
        r = fn(*args)
    sync(r)
    t0 = time.time()
    for _ in range(iters):
        r = fn(*args)
    sync(r)
    return (time.time() - t0) / iters, r


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the scope; writes ``log_dir/trace.json`` (Chrome trace
    format: chrome://tracing, Perfetto)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named region for profiler timelines."""
    return torch.profiler.record_function(name)


def device_memory_stats() -> dict:
    """Memory stats of each CUDA device (``torch.cuda.memory_stats``);
    ``{"cpu": None}`` where there is none, as JAX gives a device without
    stats."""
    if not torch.cuda.is_available():
        return {"cpu": None}
    return {f"cuda:{i}": torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}
