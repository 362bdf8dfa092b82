"""Where the slice-1 forward spends its device time, at the bench workload.

    python -m fpc_diffrend_tpu_torch.profile_forward [--batches 3]

Needs a CUDA device. Traces ``fit.loop.evaluate`` with ``torch.profiler``
(CPU and CUDA activities) and prints:

* the device busy share of the traced window: the summed time of the CUDA
  kernels and copies over the window's wall time (one stream, so device
  work does not overlap);
* device time per stage (prologue, binning, K1, K2, composite + loss) of
  one batch, each stage traced under its own ``record_function`` label;
* the kernels with the most device time.

The record goes to ``chiprun_out/profile_forward.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from fpc_diffrend_tpu_torch.fit import loop
from fpc_diffrend_tpu_torch.ops.cuda import antialias_cuda as ac
from fpc_diffrend_tpu_torch.ops.cuda import rasterize_cuda as rc
from fpc_diffrend_tpu_torch.ops.pipeline import composite_stacked
from fpc_diffrend_tpu_torch.ops.rasterize import bin_stacked
from fpc_diffrend_tpu_torch.workload import build_workload

_ACTIVITIES = [ProfilerActivity.CPU, ProfilerActivity.CUDA]


def _device_kernels(prof):
    """(name, self device ms, count) of device-side events, largest first."""
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return sorted(rows, key=lambda r: -r[1])


def forward_stages(wl: dict, state: dict):
    """The slice's forward on the workload's first batch, as
    [(stage name, fn)] in order: prologue, binning, K1, K2, composite +
    loss. Each fn reads its inputs from ``state`` and writes its outputs
    there (pc, v3, bins, k1, aa, loss), so a stage can be rerun alone."""
    config, scene, params, batch = (wl["config"], wl["scene"], wl["params"],
                                    wl["batch"])
    H, W, B = wl["H"], wl["W"], wl["B"]
    ph, pw = rc.pad_resolution(H, W)

    def prologue():
        state["pc"], state["v3"] = loop.sample_clip_positions(
            config, scene, params, batch.cam_idx, batch.frame_idx)

    def binning():
        state["bins"] = bin_stacked(state["pc"], scene.faces, scene.uv,
                                    scene.uv_idx, scene.face_neighbors,
                                    config.resolution)

    def k1():
        state["k1"] = rc.fused_raster(state["bins"], params["tex"], B * ph,
                                      pw)

    def k2():
        idbuf, _, payload, _, colour = state["k1"]
        state["aa"] = ac.antialias_planes(idbuf, payload, colour, H, W, ph)

    def tail():
        imgs = composite_stacked(state["k1"][0], state["aa"], B, (H, W))
        state["loss"] = loop.loss_from_render(config, scene, params, batch,
                                              imgs, state["v3"])[0]

    return [("prologue", prologue), ("binning", binning),
            ("K1 fused_raster", k1), ("K2 antialias", k2),
            ("composite+loss", tail)]


def _stages(wl):
    for name, fn in forward_stages(wl, {}):
        with record_function("stage:" + name):
            fn()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward needs a CUDA device")
    wl = build_workload(device="cuda")
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        loop.evaluate(wl["config"], wl["scene"], wl["params"],
                      wl["frames_u8"], 1, gen)       # warm-up
        _stages(wl)
        torch.cuda.synchronize()

        with profile(activities=_ACTIVITIES) as prof:
            t0 = time.perf_counter()
            loop.evaluate(wl["config"], wl["scene"], wl["params"],
                          wl["frames_u8"], args.batches, gen)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = _device_kernels(prof)
        busy_ms = sum(r[1] for r in kernels)

        with profile(activities=_ACTIVITIES) as sprof:
            _stages(wl)
            torch.cuda.synchronize()
    stages = {e.key[len("stage:"):]: e.device_time_total / 1e3
              for e in sprof.key_averages() if e.key.startswith("stage:")}

    print(f"card: {torch.cuda.get_device_name(0)}")
    if busy_ms == 0:
        print("the profiler recorded no device time: use CUDA events")
    print(f"evaluate x{args.batches}: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f} %)")
    print("stage device ms (one batch): " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items()))
    for name, ms, n in kernels[:15]:
        print(f"  {ms / args.batches:9.3f} ms/batch  x{n // args.batches:<4d}"
              f" {name[:100]}")
    out = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "profile_forward.json"), "w") as f:
        json.dump({"card": torch.cuda.get_device_name(0),
                   "batches": args.batches, "wall_ms": wall_ms,
                   "busy_ms": busy_ms, "stage_device_ms": stages,
                   "kernels": kernels[:40]}, f, indent=1)


if __name__ == "__main__":
    main()
