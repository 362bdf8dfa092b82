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
(``profile_forward_mip.json`` with ``--mip``). ``forward_stages`` and
``step_stages`` give the step's stages as functions to run one by one
(``chip_smoke.py`` and ``chip_turns.py`` time them with CUDA events).
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from fpc_diffrend_tpu_torch.fit import loop
from fpc_diffrend_tpu_torch.ops.cuda import antialias_cuda as ac
from fpc_diffrend_tpu_torch.fit import state as state_mod
from fpc_diffrend_tpu_torch.ops.cuda import raster_grad_cuda as gc
from fpc_diffrend_tpu_torch.ops.cuda import rasterize_cuda as rc
from fpc_diffrend_tpu_torch.ops.cuda import texture_cuda as tc
from fpc_diffrend_tpu_torch.ops.cuda import texture_mip_cuda as tmc
from fpc_diffrend_tpu_torch.ops.pipeline import composite_stacked
from fpc_diffrend_tpu_torch.ops.rasterize import bin_stacked
from fpc_diffrend_tpu_torch.ops.texture_mip import mip_pyramid
from fpc_diffrend_tpu_torch.utils import profiling
from fpc_diffrend_tpu_torch.workload import build_workload

_ACTIVITIES = [ProfilerActivity.CPU, ProfilerActivity.CUDA]


def device_kernels(prof):
    """(name, self device ms, count) of device-side events, largest first;
    annotations (``record_function`` ranges mirrored on the device, such as
    ``Optimizer.step``) are spans over kernels, not work, and are left
    out."""
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    return sorted(rows, key=lambda r: -r[1])


def forward_stages(wl: dict, state: dict):
    """The slice's forward on the workload's first batch, as
    [(stage name, fn)] in order: prologue, binning, K1, K2, composite +
    loss; with ``enable_mip``, K1 without its texture tail, then the
    pyramid build and K8 deriving the LOD before K2. Each fn reads its
    inputs from ``state`` and writes its outputs there (pc, v3, data_s,
    aux_s, bins, k1, pyr, lam, colour, aa, loss), so a stage can be rerun
    alone."""
    config, scene, params, batch = (wl["config"], wl["scene"], wl["params"],
                                    wl["batch"])
    H, W, B = wl["H"], wl["W"], wl["B"]
    ph, pw = rc.pad_resolution(H, W)

    def prologue():
        state["pc"], state["v3"] = loop.sample_clip_positions(
            config, scene, params, batch.cam_idx, batch.frame_idx)

    def binning():
        state["data_s"], state["aux_s"], state["bins"] = bin_stacked(
            state["pc"], scene.faces, scene.uv, scene.uv_idx,
            scene.face_neighbors, config.resolution, config.pair_cap)

    mip = config.enable_mip

    def k1():
        state["k1"] = rc.fused_raster(state["bins"],
                                      None if mip else params["tex"],
                                      B * ph, pw)
        state["colour"] = state["k1"][4]

    def pyramid():
        state["pyr"] = mip_pyramid(params["tex"], config.max_mip_level)

    def k8():
        idbuf, _, payload, _, _ = state["k1"]
        pyr, sizes = state["pyr"]
        state["colour"], state["lam"] = tmc.mip_sample_lod(
            pyr.detach(), sizes, payload[3], payload[4], idbuf, H, W, ph)

    def k2():
        idbuf, _, payload, _, _ = state["k1"]
        state["aa"] = ac.antialias_planes(idbuf, payload, state["colour"], H,
                                          W, ph)

    def tail():
        imgs = composite_stacked(state["k1"][0], state["aa"], B, (H, W))
        state["loss"] = loop.loss_from_render(config, scene, params, batch,
                                              imgs, state["v3"])[0]

    raster = [("prologue", prologue), ("binning", binning),
              ("K1 fused_raster", k1)]
    if mip:
        raster += [("mip pyramid", pyramid), ("K8 mip_sample_lod", k8)]
    return raster + [("K2 antialias", k2), ("composite+loss", tail)]


def step_stages(wl: dict, state: dict):
    """One fit step on the workload's first batch, stage by stage, as
    [(stage name, fn)]: the forward stages (run with gradients), the loss's
    backward to the antialiased planes, K3, K4 (K9 on the mip path), K5,
    K6, the backward of the setup chain (shift, setup, clip, pose, blend)
    into the parameters, on the mip path the pyramid's backward into the
    texture, and Adam with the quaternion renorm. Each fn reads and writes
    ``state`` like :func:`forward_stages`; the setup chain and the pyramid
    keep their graphs, so any stage but Adam can be rerun. Gradients
    accumulate across reruns."""
    config, scene, params, batch = (wl["config"], wl["scene"], wl["params"],
                                    wl["batch"])
    H, W, B = wl["H"], wl["W"], wl["B"]
    T = scene.faces.shape[0]
    ph, _ = rc.pad_resolution(H, W)
    for p in params.values():
        p.requires_grad_(True)
    fwd = forward_stages(wl, state)[:-1]

    def tail():
        aa = state["aa"].detach().requires_grad_(True)
        imgs = composite_stacked(state["k1"][0], aa, B, (H, W))
        loss = loop.loss_from_render(config, scene, params, batch, imgs,
                                     state["v3"])[0]
        state["loss"] = loss.detach()
        state["g_aa"], = torch.autograd.grad(loss, aa)

    def k3():
        idbuf, _, payload, _, _ = state["k1"]
        state["k3"] = ac.antialias_planes_bwd(idbuf, payload, state["colour"],
                                              state["g_aa"], H, W, ph)

    def k4():
        payload = state["k1"][2]
        gcolour, gverts = state["k3"]
        gtex, gtu, gtv = tc.texture_planes_bwd(params["tex"].detach(),
                                               payload[3], payload[4],
                                               gcolour)
        state["gtex"] = gtex
        state["gpl"] = torch.cat([torch.zeros((3,) + gtu.shape,
                                              device=gtu.device),
                                  gtu[None], gtv[None], gverts])

    def k9():
        payload = state["k1"][2]
        gcolour, gverts = state["k3"]
        pyr, sizes = state["pyr"]
        gpyr, gtu, gtv = tmc.mip_sample_bwd(pyr.detach(), sizes, payload[3],
                                            payload[4], state["lam"],
                                            gcolour)
        state["gpyr"] = gpyr
        state["gpl"] = torch.cat([torch.zeros((3,) + gtu.shape,
                                              device=gtu.device),
                                  gtu[None], gtv[None], gverts])

    def pyramid_bwd():
        torch.autograd.backward(state["pyr"][0], state["gpyr"],
                                retain_graph=True)

    def k5():
        _, entry, payload, extra, _ = state["k1"]
        state["k5"] = gc.pixel_grad(state["bins"], entry, payload[0],
                                    payload[1], extra, state["gpl"])

    def k6():
        state["k6"] = gc.fold_entries(*state["k5"], state["bins"], B * T)

    def setup_bwd():
        g = state["k6"]
        torch.autograd.backward(
            [state["data_s"], state["aux_s"]],
            [g[:, :16].reshape(B, T, 16), g[:, 16:].reshape(B, T, 16)],
            retain_graph=True)
        if not config.enable_mip:
            tex = params["tex"]
            tex.grad = state["gtex"] if tex.grad is None else (
                tex.grad + state["gtex"])

    def adam():
        for p in params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        state_mod.optimizer_step(config, wl["state"])

    if config.enable_mip:
        return fwd + [("composite+loss fwd+bwd", tail),
                      ("K3 antialias_bwd", k3), ("K9 mip_sample_bwd", k9),
                      ("K5 pixel_grad", k5), ("K6 fold_entries", k6),
                      ("setup chain bwd", setup_bwd),
                      ("mip pyramid bwd", pyramid_bwd), ("Adam", adam)]
    return fwd + [("composite+loss fwd+bwd", tail), ("K3 antialias_bwd", k3),
                  ("K4 texture_bwd", k4), ("K5 pixel_grad", k5),
                  ("K6 fold_entries", k6), ("setup chain bwd", setup_bwd),
                  ("Adam", adam)]


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


def _traced(fn, trace_path: str):
    """(wall ms, device kernels, span name -> device us) of fn() under the
    profiler; its Chrome trace is written to ``trace_path`` and removed."""
    with profile(activities=_ACTIVITIES) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(trace_path)
    try:
        return wall_ms, device_kernels(prof), span_device_us(trace_path)
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
            wall_ms, kernels, span_us = _traced(
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
