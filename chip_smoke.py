#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. the card: name and power limit (nvidia-smi) and torch's device name;
2. build every CUDA kernel from ``fpc_diffrend_tpu_torch/csrc`` (one nvcc
   per source, all started together);
3. kernel checks at a mid size (B = 2 at 256x384, a 3,042-triangle dome and
   a 32-triangle dome whose large triangles fill the global list, 1024^2
   texture), each kernel against its plain PyTorch version on the same
   inputs: K1 (ids and entries exactly equal, payload/extra/colour within
   1e-5; its texture-free mode, which the mip path and K7's route run,
   equal to the textured mode on ids, entries, payload and extra), K2
   (within 1e-6), K10 (ids, entries, payload, extra and colour equal to
   K1's exactly, aa within 1e-6 of K2's and of K2's plain version on those
   planes), K7 (wrap and clamp, exactly, on K1's uv and on random uv past
   every edge, and on a texture of no power-of-two size, three channels,
   an odd-length and an unaligned uv plane; its wrap output equal to K1's
   colour planes), K3 (within 1e-6: deterministic, in the plain version's
   order; it equals it bit for bit), K4
   (gtu/gtv within 1e-6, wrap and clamp), K8 and K9 on the 7-level pyramid
   with the real LOD and with a random LOD plane past both clamps (K8 and
   K9's gtu/gtv within 1e-6: each pixel's own sums, in the plain
   version's order; only the gradient pyramid sums across pixels), and K4's
   gtex, K9's gradient pyramid, K5's and K6's rows, whose atomics sum in
   another order, each element within 1e-5 of the sum of the magnitudes
   it adds up; and K11 (bin placement) equal to its plain version exactly
   (``bin_start``, ``sorted_tri``) uncapped, at the autotuned entry cap and
   at a cap of half the live entries, which drops entries; then K2, K4, K8
   and K9 where the bench's shapes do not take them (``check_k2_edges``,
   ``check_k4_edges``, ``check_mip_edges``: ragged tiles, padding rows
   between samples, three channels; for K4 every pixel at uv (0, 0), the
   wrap edge, random and minified uv, part warps, a zero cotangent; for K8
   and K9 three channels, a chain of no power-of-two sides, a one-level
   chain, planes of a pixel count no multiple of 4 and unaligned ones,
   every pixel at uv (0, 0), random and minified uv over a random LOD, a
   zero cotangent);
4. the forward at full width: the benchmarked workload (1600x1200, 29,768
   triangles, 1024^2 texture, batch 8, 3 cameras, 4 frames, free mode,
   Laplacian 1.0, the entry cap autotuned with no K11 launch) through
   ``fit.loop.evaluate``: 1 warm-up batch, then 5 timed batches with the
   launch counters set to 0 just before; the losses must be finite and K1,
   K2 and K11 launched once per batch (K7 and K10 never: they run on the
   single view only);
5. the fit step at full width through ``fit.loop.train_steps``: 1 warm-up
   dispatch of 5 steps under ``torch.cuda.set_sync_debug_mode("error")``
   (a host sync on the step's path fails it), then 2 timed dispatches of 5
   with the launch counters set to 0 just before; every loss term and
   parameter must be finite and each of K1-K6 and K11 launched once per
   step (K8, K9 never); the same steps uncapped, for information; then
   per-stage CUDA-event times of one batch's forward and one step;
5b. the mip path at full width: the same workload with trilinear mipmap
   sampling (``enable_mip``, ``max_mip_level=6``: 7 levels, 1024..16),
   5 batches through ``fit.loop.evaluate`` (K1, K8, K2 once per batch) and
   2 timed dispatches of 5 steps through ``fit.loop.train_steps`` after a
   warm-up dispatch under sync-debug "error" (K1, K2, K3, K5, K6, K8, K9,
   K11 once per step, K4 never), finite; then its stage times;
5c. ``fit.api.fit_take`` at full width: the bench dome, eight blendshapes,
   the three cameras' calibration and 3 x 4 frames of 1600x1200 as
   uncompressed TIFFs written to a temporary take; a prior-mode fit of 20
   steps (batch 8, 1024^2 texture, log every 5, checkpoint every 10) must
   read its data through the native runtime, load the frames back clipped
   and flipped, autotune the cap, run K1-K6 and K11 once per step, keep a
   finite loss and write metrics.jsonl, result/{0..3}.obj, texture.png,
   pose.json and config.txt that parse; a second fit_take to 25 steps must
   resume from the checkpoint, end at step 25 and write them again, and
   with ``mp4_interval=2`` write three progress frames (camera 0, frame 0
   beside its reference TIFF) that parse;
5d. the single view at full width: ``ops.pipeline.render`` of the bench
   dome through each of the bench's 3 cameras on each route ("sepaa":
   K1 -> K2; "aa_fused": K10; "separate": K1 -> K7 -> K2), forward and
   then forward + backward to the vertices and the texture (the first
   backward of each route under sync-debug "error"); the routes' images
   within 1e-6 of each other, their texture gradients within 1e-5 of the
   largest magnitude and their vertex gradients, and each route's against
   itself, within ``GRAD_SPREAD_RTOL`` of it (atomics reorder the sums:
   the limit of phase 7); K10 launched once per
   render on "aa_fused" only, K7 on "separate" only; ms per render (CUDA
   events, host clock, and the device's work by the profiler); then
   ``tools.render_result`` over 5c's fitted take (4 frames, a grid of the
   3 cameras, and side by side with reference TIFFs the phase writes) and
   ``tools.simple_render`` of one camera, whose PNGs must parse;
6. each kernel at the main path's shapes (K7, K10: the single view's; K8,
   K9: the mip path's; K11 the step's batch at the autotuned cap, checked
   also uncapped and at half the live entries) against its plain version
   (K2, K3, K4 and K7 on the inputs of ``kernel_pairs``, which
   ``chip_turns.py`` times too), with its time, the plain version's time, the library call's time where
   one computes the same function, and its bound, printed as one
   ``{"kernels": [...]}`` line of all eleven; beside it the record
   gather's time capped and uncapped, K11's count step by its
   shared-memory histogram against device-memory atomics, in turns; K3's
   device time (profiler), host issue and the bytes its design moves; at
   the single view K7 (wrap and clamp) beside ``grid_sample`` and K4's
   clamp mode beside ``grid_sampler_2d_backward`` (the same functions),
   each by CUDA events and by the profiler's device time, the host issue
   of K7 and ``grid_sample``, and K1 and K2; K2's device time and the
   bytes its design moves; K4's diagnosis at the bench batch (its live
   pixels, those at uv (0, 0), the distinct texels they touch, the
   reductions its design issues, its time again with the cotangent at uv
   (0, 0) zeroed) and K4 on the missed pixels' hot spot (a cotangent on
   every missed pixel of the single view, wrap and clamp, checked and
   timed); K8's and K9's at the bench-mip batch (``mip_kernel_pairs``,
   which ``chip_turns.py`` times too: the pixels of each level, those that
   blend a second one, the live pixels and those at uv (0, 0), the
   distinct texels of each level, the reductions K9's design issues, and
   K9's time with its reductions left out);
7. one bench step's forward and backward three times from the same state
   on the same batch: every parameter gradient must spread by at most
   ``GRAD_SPREAD_RTOL`` of its largest magnitude (the atomic sums' order;
   checked after the record is written).

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
K3_ATOL = 1e-6                 # deterministic, the plain version's order
K4_ATOL = 1e-6                 # gtu, gtv: one thread per pixel, no atomics
K8_ATOL = 1e-6                 # each pixel in the plain version's order
K9_ATOL = 1e-6                 # gtu, gtv: each pixel's own sums, in order
ATOMIC_RTOL = 1e-5             # gtex, gpyr, K5/K6 rows: atomics reorder sums
K10_ATOL = 1e-6                # aa against K2 on the same planes
MAX_MIP_LEVEL = 6              # the mip path's chain: 1024^2 .. 16^2
# gradients from run to run (phases 5d and 7): the sums that atomics take
# in another order each run (K4's texture, K5, K6, the setup chain's index
# backward) may spread by this much of a gradient's largest magnitude.
# Screen-space terms cancel, so an element's rounding reaches 1e-3 to
# 1.5e-3 of the largest in some runs on the H100 (a vertex gradient, the
# free mode's m3); the limit is ~7x that. The reference nvdiffrast sums
# with atomics too; a fixed order is a TPU layout's, not the function's.
GRAD_SPREAD_RTOL = 1e-2
ROUTES = ("sepaa", "aa_fused", "separate")   # the single view's kernels
N_VIEWS = 3                    # the bench's cameras, one view each


def write_tiff(path: str, img) -> None:
    """Write an (H, W) uint8 image as an uncompressed little-endian
    grayscale TIFF in one strip (the capture rig's export format)."""
    import struct

    h, w = img.shape
    tags = [(256, 4, w), (257, 4, h), (258, 3, 8), (259, 3, 1), (262, 3, 1),
            (273, 4, None), (277, 3, 1), (278, 4, h), (279, 4, h * w)]
    data_at = 8 + 2 + 12 * len(tags) + 4
    ifd = struct.pack("<H", len(tags))
    for tag, kind, value in tags:
        value = data_at if value is None else value
        ifd += (struct.pack("<HHIHH", tag, 3, 1, value, 0) if kind == 3
                else struct.pack("<HHII", tag, 4, 1, value))
    with open(path, "wb") as f:
        f.write(b"II" + struct.pack("<HI", 42, 8) + ifd
                + struct.pack("<I", 0) + img.astype("uint8").tobytes())


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


def device_ms(fn, reps: int) -> float:
    """Device time of fn() a call: the self time of every kernel and memset
    it ran, by the profiler, over reps calls after one warm-up (the event
    times of :func:`cuda_ms` read the host's issue where that is slower)."""
    import torch

    from fpc_diffrend_tpu_torch.profile_forward import device_kernels

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(ms for _, ms, _ in device_kernels(prof)) / reps


def host_us(fn, reps: int) -> float:
    """Host time to issue fn() a call, in microseconds: reps calls on the
    host clock with no synchronize inside (the card keeps up when its work
    is shorter)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


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
    k0 = rc.fused_raster(bins, None, rows, pw)
    torch.cuda.synchronize()
    if not (all(torch.equal(a, b) for a, b in zip(k0[:4], k1[:4]))
            and k0[4].shape == (0, rows, pw)):
        fail(f"{label}: K1 without its texture tail differs from K1")
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


def atomic_err(a, b, mag) -> float:
    """Max over elements of |a - b| / mag, where mag is the sum of the
    magnitudes of the terms the element adds up: a float sum taken in
    another order errs by a few ulp of that (and by 0 where it is 0)."""
    if not a.numel():
        return 0.0
    d = (a.double() - b.double()).abs()
    return float((d / mag.double().clamp_min(1e-30)).max())


def k5_magnitudes(bins, entry, u, v, extra, gpl):
    """K5's rows summed over |coefficient| (the plain version's sums)."""
    import torch

    from fpc_diffrend_tpu_torch.ops.cuda import raster_grad_cuda as gc

    rows, pw = entry.shape
    x = torch.arange(pw, device=entry.device) + 0.5
    y = (torch.arange(rows, device=entry.device) + 0.5)[:, None]
    coeff = gc.coefficient_planes(u, v, extra, gpl, x, y).abs()
    coeff = coeff.reshape(coeff.shape[0], -1).T
    e = entry.reshape(-1).long()
    ent = torch.zeros((bins.gbase, coeff.shape[1]), device=entry.device)
    glob = torch.zeros((gc.MAX_GLOBAL, coeff.shape[1]), device=entry.device)
    binned = (e >= 0) & (e < bins.gbase)
    ent.index_add_(0, e[binned], coeff[binned])
    ge = e >= bins.gbase
    glob.index_add_(0, e[ge] - bins.gbase, coeff[ge])
    return ent, glob


def check_backward(k1, bins, tex, g_aa, gtuv, height, width, sample_ph,
                   n_tris, label):
    """K3-K6 against their plain versions on the same inputs.

    :param k1: K1's outputs; g_aa: (C, rows, pw) cotangent of K2's output;
    gtuv: (3, rows, pw) cotangents of payload u, v, z for K5 (zero on the
    main path). :return: (the checked errors, kernel name -> max abs
    error over its outputs, the kernels' outputs).
    """
    import torch

    from fpc_diffrend_tpu_torch.ops.cuda import antialias_cuda as ac
    from fpc_diffrend_tpu_torch.ops.cuda import raster_grad_cuda as gc
    from fpc_diffrend_tpu_torch.ops.cuda import texture_cuda as tc

    idbuf, entry, payload, extra, colour = k1
    k3 = ac.antialias_planes_bwd(idbuf, payload, colour, g_aa, height,
                                 width, sample_ph)
    torch.cuda.synchronize()
    p3 = ac.antialias_planes_bwd_plain(idbuf, payload, colour, g_aa, height,
                                       width, sample_ph)
    errs = {"K3 gcolour": max_err(k3[0], p3[0]),
            "K3 gverts": max_err(k3[1], p3[1])}
    if not max(errs.values()) <= K3_ATOL:
        fail(f"{label}: K3 differs from the plain version: {errs}")
    gcolour, gverts = k3
    k4 = tc.texture_planes_bwd(tex, payload[3], payload[4], gcolour)
    torch.cuda.synchronize()
    p4 = tc.texture_planes_bwd_plain(tex, payload[3], payload[4], gcolour)
    m4 = tc.texture_planes_bwd_plain(tex, payload[3], payload[4],
                                     gcolour.abs())[0]
    errs.update({"K4 gtu": max_err(k4[1], p4[1]),
                 "K4 gtv": max_err(k4[2], p4[2]),
                 "K4 gtex rel": atomic_err(k4[0], p4[0], m4)})
    if not (max(errs["K4 gtu"], errs["K4 gtv"]) <= K4_ATOL
            and errs["K4 gtex rel"] <= ATOMIC_RTOL):
        fail(f"{label}: K4 differs from the plain version: {errs}")
    gpl = torch.cat([gtuv, k4[1][None], k4[2][None], gverts])
    k5 = gc.pixel_grad(bins, entry, payload[0], payload[1], extra, gpl)
    torch.cuda.synchronize()
    p5 = gc.pixel_grad_plain(bins, entry, payload[0], payload[1], extra, gpl)
    m5 = k5_magnitudes(bins, entry, payload[0], payload[1], extra, gpl)
    live = int(bins.bin_start[-1])
    errs.update({
        "K5 entries rel": atomic_err(k5[0][:live], p5[0][:live],
                                     m5[0][:live]),
        "K5 global rel": atomic_err(k5[1], p5[1], m5[1])})
    k6 = gc.fold_entries(*k5, bins, n_tris)
    torch.cuda.synchronize()
    p6 = gc.fold_entries_plain(*k5, bins, n_tris)
    errs["K6 rel"] = atomic_err(k6, p6, gc.fold_entries_plain(
        k5[0].abs(), k5[1].abs(), bins, n_tris))
    if not max(errs["K5 entries rel"], errs["K5 global rel"],
               errs["K6 rel"]) <= ATOMIC_RTOL:
        fail(f"{label}: K5/K6 differ from the plain versions: {errs}")
    print(f"check {label}: backward max err {errs}", flush=True)
    abs_errs = {
        "antialias_bwd": max(errs["K3 gcolour"], errs["K3 gverts"]),
        "texture_bwd": max(errs["K4 gtu"], errs["K4 gtv"],
                           max_err(k4[0], p4[0])),
        "pixel_grad": max(max_err(k5[0][:live], p5[0][:live]),
                          max_err(k5[1], p5[1])),
        "fold_entries": max_err(k6, p6)}
    return errs, abs_errs, (k3, k4, k5, k6, gpl)


def check_mip(k1, tex, g, lam_random, height, width, sample_ph, label):
    """K8 and K9 against their plain versions on K1's uv, with the LOD of
    the mip path and, where ``lam_random`` is given, with that plane too.

    :param g: (C, rows, pw) cotangent of K8's output.
    :return: (the checked errors, kernel name -> max abs error, (pyramid,
        sizes, the real LOD)).
    """
    import torch

    from fpc_diffrend_tpu_torch.ops.cuda import texture_mip_cuda as tmc

    pyr, sizes, lam = mip_inputs(k1, tex, height, width, sample_ph)
    tu, tv = k1[2][3], k1[2][4]
    errs, abs_errs = {}, {"mip_sample": 0.0, "mip_sample_bwd": 0.0}
    planes = {"LOD": lam}
    if lam_random is not None:
        planes["random LOD"] = lam_random
    for name, lp in planes.items():
        k8 = tmc.mip_sample(pyr, sizes, tu, tv, lp)
        torch.cuda.synchronize()
        e8 = max_err(k8, tmc.mip_sample_plain(pyr, sizes, tu, tv, lp))
        k9 = tmc.mip_sample_bwd(pyr, sizes, tu, tv, lp, g)
        torch.cuda.synchronize()
        p9 = tmc.mip_sample_bwd_plain(pyr, sizes, tu, tv, lp, g)
        m9 = tmc.mip_sample_bwd_plain(pyr, sizes, tu, tv, lp, g.abs())[0]
        e9 = {"gtu": max_err(k9[1], p9[1]), "gtv": max_err(k9[2], p9[2]),
              "gpyr rel": atomic_err(k9[0], p9[0], m9)}
        errs[f"K8 {name}"] = e8
        errs.update({f"K9 {k} {name}": v for k, v in e9.items()})
        if not (e8 <= K8_ATOL and max(e9["gtu"], e9["gtv"]) <= K9_ATOL
                and e9["gpyr rel"] <= ATOMIC_RTOL):
            fail(f"{label}: K8/K9 differ from the plain versions: {errs}")
        abs_errs["mip_sample"] = max(abs_errs["mip_sample"], e8)
        abs_errs["mip_sample_bwd"] = max(abs_errs["mip_sample_bwd"],
                                         e9["gtu"], e9["gtv"],
                                         max_err(k9[0], p9[0]))
    print(f"check {label}: mip max err {errs}", flush=True)
    return errs, abs_errs, (pyr, sizes, lam)


def mip_inputs(k1, tex, height, width, sample_ph):
    """The mip path's pyramid of ``tex`` (7 levels), its sizes, and the LOD
    plane of K1's uv planes ``k1``, as the step computes them."""
    from fpc_diffrend_tpu_torch.ops import texture_mip as tm

    idbuf, _, payload, _, _ = k1
    pyr, sizes = tm.mip_pyramid(tex, MAX_MIP_LEVEL)
    lam = tm.lod_from_texc(payload[3], payload[4], idbuf, *sizes[0], height,
                           width, sample_ph)
    return pyr, sizes, lam


def mip_kernel_pairs(k1, tex, gcolour, height, width, sample_ph):
    """K8 and K9 on one state's inputs, as phase 6 and ``chip_turns.py``
    both time them: the bench-mip batch's uv planes (K1's ``k1``), the
    pyramid of ``tex``, their LOD (:func:`mip_inputs`), and K3's colour
    cotangent ``gcolour`` for K9.

    :return: ({name: (kernel call, its plain version)}, (pyramid, sizes,
        LOD)).
    """
    from fpc_diffrend_tpu_torch.ops.cuda import texture_mip_cuda as tmc

    pyr, sizes, lam = mip_inputs(k1, tex, height, width, sample_ph)
    tu, tv = k1[2][3], k1[2][4]
    pairs = {
        "mip_sample": (
            lambda: tmc.mip_sample(pyr, sizes, tu, tv, lam),
            lambda: tmc.mip_sample_plain(pyr, sizes, tu, tv, lam)),
        "mip_sample_bwd": (
            lambda: tmc.mip_sample_bwd(pyr, sizes, tu, tv, lam, gcolour),
            lambda: tmc.mip_sample_bwd_plain(pyr, sizes, tu, tv, lam,
                                             gcolour))}
    return pairs, (pyr, sizes, lam)


def check_texture(k1, tex, g, gen, label):
    """K7 against its plain version, wrap and clamp, exactly, on K1's uv and
    on a random uv plane past every edge of the texture, and on the
    instantiations the main path does not take (a texture of no
    power-of-two size, three channels, an odd-length and an unaligned uv
    plane); K7's wrap output equal to K1's colour planes on K1's uv; K4's
    clamp mode against its plain version (K4's wrap mode is
    :func:`check_backward`'s).

    :param g: (C, rows, pw) cotangent for K4.
    :return: (the checked errors, K7's max abs error).
    """
    import torch

    from fpc_diffrend_tpu_torch.ops.cuda import texture_cuda as tc

    _, _, payload, _, colour = k1
    rows, pw = payload.shape[1:]
    ruv = (torch.rand((2, rows, pw), device=g.device, generator=gen) * 1.5
           - 0.25)
    uvs = {"K1 uv": (payload[3], payload[4]), "random uv": (ruv[0], ruv[1])}
    errs = {}
    for name, (u, v) in uvs.items():
        for mode in ("wrap", "clamp"):
            k7 = tc.texture_planes(tex, u, v, mode)
            torch.cuda.synchronize()
            errs[f"K7 {mode} {name}"] = max_err(
                k7, tc.texture_planes_plain(tex, u, v, mode))
            if name == "K1 uv" and mode == "wrap" and not torch.equal(
                    k7, colour):
                fail(f"{label}: K7's wrap samples differ from K1's colour "
                     f"planes by {max_err(k7, colour)}")
        k4 = tc.texture_planes_bwd(tex, u, v, g, "clamp")
        torch.cuda.synchronize()
        p4 = tc.texture_planes_bwd_plain(tex, u, v, g, "clamp")
        m4 = tc.texture_planes_bwd_plain(tex, u, v, g.abs(), "clamp")[0]
        errs.update({f"K4 clamp gtu {name}": max_err(k4[1], p4[1]),
                     f"K4 clamp gtv {name}": max_err(k4[2], p4[2]),
                     f"K4 clamp gtex rel {name}": atomic_err(k4[0], p4[0],
                                                             m4)})
    # K7's other instantiations, exactly: a texture of no power-of-two
    # size (the remainder wrap) with one channel and with three, a uv plane
    # of odd length (one channel: the vector path's scalar tail) and one
    # that starts 4 bytes past a 16-byte boundary (the scalar path)
    tex3 = torch.rand((300, 200, 3), device=g.device, generator=gen)
    flat = (torch.rand((2, 4 * 1001 + 3), device=g.device, generator=gen)
            * 1.5 - 0.25)
    cases = {"1024x1000 texture": (tex[:, :1000].contiguous(), ruv[0],
                                   ruv[1]),
             "300x200x3 texture": (tex3, ruv[0], ruv[1]),
             "odd length": (tex, flat[0], flat[1]),
             "unaligned, 3 channels": (tex3, flat[0][1:], flat[1][1:])}
    for name, (t, u, v) in cases.items():
        for mode in ("wrap", "clamp"):
            k7 = tc.texture_planes(t, u, v, mode)
            torch.cuda.synchronize()
            errs[f"K7 {mode} {name}"] = max_err(
                k7, tc.texture_planes_plain(t, u, v, mode))
    e7 = max(v for k, v in errs.items() if k.startswith("K7"))
    e4 = max(v for k, v in errs.items()
             if k.startswith("K4") and "rel" not in k)
    e4_rel = max(v for k, v in errs.items() if "rel" in k)
    if e7 != 0 or e4 > K4_ATOL or e4_rel > ATOMIC_RTOL:
        fail(f"{label}: K7/K4 clamp differ from the plain versions: {errs}")
    print(f"check {label}: K7 equals its plain version and K1's colour "
          f"exactly; K4 clamp max err {errs}", flush=True)
    return errs, e7


def check_k2_edges(dev, gen):
    """K2 where the bench's shapes do not take it, against its plain
    version: two samples of 40 x 70 at a pitch of 45 rows (padding rows
    between them) in 90 x 75 planes (rows no multiple of K2's 8-row tiles,
    width no multiple of its 32 columns), three colour channels, ids in
    3 x 3 blocks and corners scattered about each pixel, so that many
    pairs blend. :return: K2's max abs error."""
    import torch

    from fpc_diffrend_tpu_torch.ops.cuda import antialias_cuda as ac

    H, W, sph, pw, C = 40, 70, 45, 75, 3
    rows = 2 * sph
    ids = torch.randint(-1, 6, (rows // 3, pw // 3 + 1), device=dev,
                        generator=gen)
    idbuf = ids.repeat_interleave(3, 0).repeat_interleave(3, 1)[:, :pw]
    idbuf = idbuf.to(torch.int32).contiguous()
    y = torch.arange(rows, device=dev)[:, None] + 0.5
    x = torch.arange(pw, device=dev)[None] + 0.5
    payload = torch.rand((14, rows, pw), device=dev, generator=gen)
    noise = torch.randn((6, rows, pw), device=dev, generator=gen) * 2.0
    for k in range(3):
        payload[5 + 2 * k] = x + noise[2 * k]
        payload[6 + 2 * k] = y + noise[2 * k + 1]
    payload[11:14] = torch.randint(-1, 6, (3, rows, pw), device=dev,
                                   generator=gen).float()
    colour = torch.rand((C, rows, pw), device=dev, generator=gen)
    got = ac.antialias_planes(idbuf, payload, colour, H, W, sph)
    torch.cuda.synchronize()
    want = ac.antialias_planes_plain(idbuf, payload, colour, H, W, sph)
    err = max_err(got, want)
    blended = int((want != colour).any(dim=0).sum())
    if not (err <= K2_ATOL and blended > 100):
        fail(f"K2 edge case: {err} from its plain version ({blended} "
             "pixels blended)")
    print(f"check K2 edges: {rows}x{pw}, H {H} at pitch {sph}, C {C}: max "
          f"abs err {err} ({'bit-equal' if err == 0 else 'not bit-equal'}; "
          f"{blended} pixels blended)", flush=True)
    return err


def check_k4_edges(dev, gen):
    """K4 (wrap and clamp) where the bench does not take it, against its
    plain version, on uv planes of 36 x 84 and 37 x 83 (part warps at the
    end) and textures of one channel (64 x 48: the remainder wrap) and
    three (32 x 64: the mask wrap): every pixel at uv (0, 0), the missed
    pixels' hot spot; uv across the wrap edge; random uv (no coherence
    between neighbours); uv minified to ~12 texels a pixel; and an
    all-zero cotangent (all outputs exactly 0). :return: name -> error
    (gtu/gtv: max abs; gtex: over the summed magnitudes)."""
    import torch

    from fpc_diffrend_tpu_torch.ops.cuda import texture_cuda as tc

    errs = {}
    for rows, pw in ((36, 84), (37, 83)):
        ys = torch.linspace(0, 1, rows, device=dev)[:, None].expand(rows, pw)
        xs = torch.linspace(0, 1, pw, device=dev)[None].expand(rows, pw)
        zero = torch.zeros((rows, pw), device=dev)
        rnd = (torch.rand((2, rows, pw), device=dev, generator=gen) * 1.5
               - 0.25)
        uvs = {"one uv": (zero, zero),
               "wrap edge": (xs * 0.1 - 0.05, ys * 0.1 - 0.05),
               "random": (rnd[0], rnd[1]),
               "minified": (xs * 20.0, ys * 20.0 + 0.3)}
        for tex_shape in ((64, 48, 1), (32, 64, 3)):
            tex = torch.rand(tex_shape, device=dev, generator=gen)
            C = tex_shape[2]
            for name, (u, v) in uvs.items():
                u, v = u.contiguous(), v.contiguous()
                g = torch.randn((C, rows, pw), device=dev, generator=gen)
                for mode in ("wrap", "clamp"):
                    got = tc.texture_planes_bwd(tex, u, v, g, mode)
                    torch.cuda.synchronize()
                    want = tc.texture_planes_bwd_plain(tex, u, v, g, mode)
                    mag = tc.texture_planes_bwd_plain(tex, u, v, g.abs(),
                                                      mode)[0]
                    key = f"{name}, {rows}x{pw}, C {C}, {mode}"
                    errs[f"gtuv {key}"] = max(max_err(got[1], want[1]),
                                              max_err(got[2], want[2]))
                    errs[f"gtex rel {key}"] = atomic_err(got[0], want[0], mag)
                zeros = tc.texture_planes_bwd(tex, u, v, torch.zeros_like(g))
                if not all(bool((z == 0).all()) for z in zeros):
                    fail(f"K4 edge case {name}, {rows}x{pw}, C {C}: a zero "
                         "cotangent gave non-zero outputs")
    bad = {k: e for k, e in errs.items()
           if not e <= (ATOMIC_RTOL if "rel" in k else K4_ATOL)}
    if bad:
        fail(f"K4 edge cases differ from the plain version: {bad}")
    print(f"check K4 edges: 36x84 and 37x83 uv, wrap and clamp, C 1 and 3, "
          f"zero cotangent exact; max err gtu/gtv "
          f"{max(e for k, e in errs.items() if 'rel' not in k)}, gtex rel "
          f"{max(e for k, e in errs.items() if 'rel' in k)}", flush=True)
    return errs


# check_mip_edges' level chains: level 0's (th, tw, C) and the most levels
# after it (``ops.texture_mip.level_sizes`` halves the sides down to 1)
MIP_EDGE_CHAINS = {
    "64x64 C 1": ((64, 64, 1), 6),          # the mask wrap, 7 levels
    "32x64 C 3": ((32, 64, 3), 5),          # three channels, 6 levels
    "96x80 C 1": ((96, 80, 1), 6),          # the remainder wrap, 7 levels
    "48x40 C 2, one level": ((48, 40, 2), 0),
}


def check_mip_edges(dev, gen):
    """K8 and K9 where the bench-mip batch does not take them, against their
    plain versions (K8 and K9's gtu/gtv within K8_ATOL and K9_ATOL, the
    gradient pyramid within ATOMIC_RTOL of the summed magnitudes), on
    random pyramids of the chains of ``MIP_EDGE_CHAINS`` (three channels; a
    chain of no power-of-two sides, the remainder wrap; a one-level chain),
    on planes of 36 x 84 and 37 x 83 (part warps; a pixel count no multiple
    of 4, the scalar tail and, at C > 1, the one-pixel path) and on planes
    that start 4 bytes past a 16-byte boundary (the one-pixel path): every
    pixel at uv (0, 0), the missed pixels' hot spot; random uv past every
    edge; uv minified to ~12 texels a pixel; each with a random LOD plane
    over every level and past both clamps. An all-zero cotangent gives
    all-zero outputs. :return: name -> error (K8 and gtu/gtv: max abs;
    gpyr: over the summed magnitudes)."""
    import torch

    from fpc_diffrend_tpu_torch.ops.cuda import texture_mip_cuda as tmc
    from fpc_diffrend_tpu_torch.ops.texture_mip import level_sizes

    def plane(t, aligned):
        if aligned:
            return t.contiguous()
        buf = torch.empty(t.numel() + 1, device=dev)
        buf[1:] = t.reshape(-1)
        return buf[1:].view(t.shape)

    errs = {}
    for rows, pw in ((36, 84), (37, 83)):
        ys = torch.linspace(0, 1, rows, device=dev)[:, None].expand(rows, pw)
        xs = torch.linspace(0, 1, pw, device=dev)[None].expand(rows, pw)
        zero = torch.zeros((rows, pw), device=dev)
        rnd = (torch.rand((2, rows, pw), device=dev, generator=gen) * 1.5
               - 0.25)
        uvs = {"one uv": (zero, zero), "random": (rnd[0], rnd[1]),
               "minified": (xs * 20.0, ys * 20.0 + 0.3)}
        for chain, ((th, tw, C), n_more) in MIP_EDGE_CHAINS.items():
            sizes = level_sizes(th, tw, n_more)
            n = sum(h * w for h, w in sizes)
            pyr = torch.rand((n, C), device=dev, generator=gen)
            lam = (torch.rand((rows, pw), device=dev, generator=gen)
                   * (len(sizes) + 2) - 1.5)
            for name, (u, v) in uvs.items():
                g = torch.randn((C, rows, pw), device=dev, generator=gen)
                for aligned in (True, False):
                    a = (plane(u, aligned), plane(v, aligned),
                         plane(lam, aligned))
                    key = (f"{name}, {rows}x{pw}, {chain}"
                           + ("" if aligned else ", unaligned"))
                    got8 = tmc.mip_sample(pyr, sizes, *a)
                    got9 = tmc.mip_sample_bwd(pyr, sizes, *a, g)
                    torch.cuda.synchronize()
                    want9 = tmc.mip_sample_bwd_plain(pyr, sizes, *a, g)
                    mag = tmc.mip_sample_bwd_plain(pyr, sizes, *a,
                                                   g.abs())[0]
                    errs[f"K8 {key}"] = max_err(
                        got8, tmc.mip_sample_plain(pyr, sizes, *a))
                    errs[f"K9 gtuv {key}"] = max(
                        max_err(got9[1], want9[1]),
                        max_err(got9[2], want9[2]))
                    errs[f"K9 gpyr rel {key}"] = atomic_err(got9[0],
                                                            want9[0], mag)
                zeros = tmc.mip_sample_bwd(pyr, sizes, u.contiguous(),
                                           v.contiguous(), lam,
                                           torch.zeros_like(g))
                if not all(bool((z == 0).all()) for z in zeros):
                    fail(f"K9 edge case {name}, {rows}x{pw}, {chain}: a "
                         "zero cotangent gave non-zero outputs")

    def limit(k):
        return (ATOMIC_RTOL if "rel" in k else K8_ATOL if k.startswith("K8")
                else K9_ATOL)

    bad = {k: e for k, e in errs.items() if not e <= limit(k)}
    if bad:
        fail(f"K8/K9 edge cases differ from the plain versions: {bad}")
    print(f"check K8/K9 edges: 36x84 and 37x83 planes, aligned and not, "
          f"chains {list(MIP_EDGE_CHAINS)}, zero cotangent exact; max err "
          f"K8 {max(e for k, e in errs.items() if k.startswith('K8'))}, "
          f"gtu/gtv "
          f"{max(e for k, e in errs.items() if 'gtuv' in k)}, gpyr rel "
          f"{max(e for k, e in errs.items() if 'rel' in k)}", flush=True)
    return errs


def check_aa_fused(bins, tex, rows, pw, height, width, sample_ph, k1,
                   label):
    """K10 against K1 and K2 on the same bins, and against its plain
    version: ids, entries, payload, extra and colour equal to K1's exactly,
    aa within K10_ATOL of K2 (kernel and plain version) on those planes;
    against the plain version's own planes, ids and entries exactly and
    the rest within K1's tolerance.

    :return: (K10's outputs, its max abs error against its plain version).
    """
    import torch

    from fpc_diffrend_tpu_torch.ops.cuda import antialias_cuda as ac
    from fpc_diffrend_tpu_torch.ops.cuda import rasterize_cuda as rc

    k10 = rc.fused_raster_aa(bins, tex, rows, pw, height, width, sample_ph)
    torch.cuda.synchronize()
    names = ("idbuf", "entry", "payload", "extra", "colour")
    for n, a, b in zip(names, k10, k1):
        if not torch.equal(a, b):
            fail(f"{label}: K10's {n} differs from K1's by {max_err(a, b)}")
    e_k2 = max_err(k10[5], ac.antialias_planes(k1[0], k1[2], k1[4], height,
                                               width, sample_ph))
    e_p2 = max_err(k10[5], ac.antialias_planes_plain(k1[0], k1[2], k1[4],
                                                     height, width,
                                                     sample_ph))
    p10 = rc.fused_raster_aa_plain(bins, tex, rows, pw, height, width,
                                   sample_ph)
    errs = {n: max_err(a, b) for n, a, b in zip(names, k10, p10)}
    if (errs["idbuf"] or errs["entry"]
            or max(errs["payload"], errs["extra"], errs["colour"]) > K1_ATOL
            or max(e_k2, e_p2) > K10_ATOL):
        fail(f"{label}: K10 differs: against K2 {e_k2}, K2's plain version "
             f"{e_p2}; against its plain version {errs}")
    print(f"check {label}: K10 equals K1 exactly, aa against K2 {e_k2}, K2's "
          f"plain version {e_p2}; against its plain version {errs}",
          flush=True)
    return k10, max(e_p2, *errs.values())


def check_place(pc, faces, height, width, autotuned, label):
    """K11 against its plain version, exactly, uncapped, at the autotuned
    per-sample cap and at P = half the live entries, which drops entries.

    :return: (tile_ids, n_tiles, cap name -> P, live entries).
    """
    import torch

    from fpc_diffrend_tpu_torch.ops.cuda import bin_place_cuda as bp
    from fpc_diffrend_tpu_torch.ops.cuda import rasterize_cuda as rc

    tile_ids, n_tiles = rc.pair_tile_ids(pc.detach(), faces, height, width)
    B, T, _ = tile_ids.shape
    live = int((tile_ids < n_tiles).sum())
    Ps = {"uncapped": rc.entry_count(B, T),
          "autotuned": rc.entry_count(B, T, autotuned),
          "half live": max(live // 2, 1)}
    for name, P in Ps.items():
        got = bp.place_pairs(tile_ids, n_tiles, P)
        torch.cuda.synchronize()
        want = bp.place_pairs_plain(tile_ids, n_tiles, P)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                             want[1])):
            fail(f"{label}: K11 differs from its plain version at P = {P} "
                 f"({name}): {int((got[0] != want[0]).sum())} offsets, "
                 f"{int((got[1] != want[1]).sum())} entries")
        if name == "half live" and live > 1 and not int(got[0][-1]) == P:
            fail(f"{label}: the half-live cap dropped no entry")
    print(f"check {label}: K11 equals its plain version exactly at P = "
          f"{Ps} ({live} live of {tile_ids.numel()} pair slots)", flush=True)
    return tile_ids, n_tiles, Ps, live


def check_place_synthetic(dev):
    """K11 where the bench does not take it, exactly against its plain
    version: a bin of 6,000 entries (past a warp's shared-memory cache of
    the in-bin sort) and 70,000 tiles (past the shared-memory histogram:
    the count adds in device memory), uncapped and at half the live
    entries."""
    import numpy as np
    import torch

    from fpc_diffrend_tpu_torch.ops.cuda import bin_place_cuda as bp

    rng = np.random.default_rng(5)
    K = 8
    for n_tiles, T, hot in ((600, 3000, True), (70000, 20000, False)):
        base = rng.integers(8, n_tiles - K, size=(2, T, 1))
        tid = base + np.arange(K)
        n_live = rng.integers(0, K + 1, size=(2, T, 1))
        tid = np.where(np.arange(K) < n_live, tid, n_tiles)
        if hot:
            tid[:, :, 0] = 7
        tile_ids = torch.as_tensor(tid.astype(np.int32), device=dev)
        live = int((tid < n_tiles).sum())
        for P in (tid.size, live // 2):
            got = bp.place_pairs(tile_ids, n_tiles, P)
            torch.cuda.synchronize()
            want = bp.place_pairs_plain(tile_ids, n_tiles, P)
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                fail(f"K11 differs from its plain version at {n_tiles} "
                     f"tiles, P = {P}")
        print(f"check K11 synthetic: {n_tiles} tiles, {live} live, largest "
              f"bin {int(np.bincount(tid[tid < n_tiles]).max())}: exact",
              flush=True)


def k11_bound_ms(tile_ids, n_tiles, P):
    """K11's function: the pair slots read once, bin_start and the P
    entries written (bytes); one comparison a slot (operations, at the fp32
    rate). The two-pass design moves more (:func:`k11_design_bytes`)."""
    n = tile_ids.numel()
    return _bound(n * 4 + (n_tiles + 1) * 4 + P * 4, n)


def k11_design_bytes(tile_ids, n_tiles, P, live):
    """Bytes K11's count-then-place design moves: the slots read twice, the
    counts written and read thrice, the live entries through the scratch
    and back, bin_start and the P entries written."""
    n = tile_ids.numel()
    return 2 * n * 4 + 4 * (n_tiles + 1) * 4 + 2 * live * 4 + P * 4


def write_take(root, wl):
    """The bench workload as a take on disk: the dome as basemesh.obj
    (shifted by -170 in y, which the calibration's baked +170 undoes),
    eight blendshapes of it with small seeded offsets, calibration.json
    with the bench's three cameras, and 3 x 4 frames as uncompressed TIFFs
    (``{imdir}/take_camC/take_camC_FF.tif``).

    :return: (FitConfig keyword arguments for the paths, the frames written
        (C, F, H, W) uint8, the camera directory names).
    """
    import numpy as np

    from fpc_diffrend_tpu_torch.data.obj import save_obj
    from fpc_diffrend_tpu_torch.models import camera

    scene, H, W = wl["scene"], wl["H"], wl["W"]
    verts = scene.v_base.cpu().numpy().reshape(-1, 3).copy()
    verts[:, 1] -= 170.0
    uv = scene.uv.cpu().numpy()
    faces = scene.faces.cpu().numpy()
    fuv = scene.uv_idx.cpu().numpy()
    paths = {k: os.path.join(root, v) for k, v in (
        ("basemeshpath", "basemesh.obj"), ("localblpath", "blendshapes"),
        ("calibpath", "calibration.json"), ("imdir", "take"))}
    save_obj(paths["basemeshpath"], verts, uv, faces, fuv)
    os.makedirs(paths["localblpath"])
    rng = np.random.default_rng(1)
    for i in range(8):
        offset = rng.normal(scale=0.05, size=verts.shape).astype(np.float32)
        save_obj(os.path.join(paths["localblpath"], f"bs{i:02d}.obj"),
                 verts + offset, uv, faces, fuv)
    calib = {}
    for c in range(3):
        intr = [[7000.0 * H / 1600.0, 0.0, W * 0.5],
                [0.0, 7000.0 * H / 1600.0, H * 0.5], [0.0, 0.0, 1.0]]
        calib[f"cam{c}"] = {
            "intrinsic": intr, "distortion": [[0.0]] * 5,
            "rotation": camera.rotate_y(0.3 * (c - 1))[:3, :3].tolist(),
            "translation": [[0.0], [0.0], [100.0]]}
    with open(paths["calibpath"], "w") as f:
        json.dump(calib, f)
    frames = rng.integers(0, 256, size=(3, 4, H, W), dtype=np.uint8)
    cams = [f"take_cam{c}" for c in range(3)]
    for c, cam in enumerate(cams):
        os.makedirs(os.path.join(paths["imdir"], cam))
        for fi in range(4):
            write_tiff(os.path.join(paths["imdir"], cam,
                                    f"{cam}_{fi:02d}.tif"), frames[c, fi])
    return paths, frames, cams


def check_fit_outputs(cfg, n_verts, n_tris, n_frames, label):
    """The files fit_take writes exist and parse; :return: the
    metrics.jsonl records."""
    import numpy as np

    from fpc_diffrend_tpu_torch.data.obj import load_obj
    from fpc_diffrend_tpu_torch.utils.image import load_image

    with open(os.path.join(cfg.out_dir, "metrics.jsonl")) as f:
        records = [json.loads(ln) for ln in f]
    result = os.path.join(cfg.out_dir, "result")
    for i in range(n_frames):
        mesh = load_obj(os.path.join(result, f"{i}.obj"))
        if (mesh.vertices.shape != (3 * n_verts,)
                or mesh.faces.shape != (n_tris, 3)
                or not np.isfinite(mesh.vertices).all()):
            fail(f"{label}: result/{i}.obj holds {mesh.vertices.shape} "
                 f"coordinates and {mesh.faces.shape} faces")
    tex = load_image(os.path.join(result, "texture.png"))
    if tex.shape != tuple(cfg.texshape):
        fail(f"{label}: texture.png is {tex.shape}, not {cfg.texshape}")
    with open(os.path.join(result, "pose.json")) as f:
        pose = json.load(f)
    t = np.asarray(pose["translation"])
    q = np.asarray(pose["rotation"])
    if (t.shape != (n_frames, 3) or q.shape != (n_frames, 4)
            or not (np.isfinite(t).all() and np.isfinite(q).all())):
        fail(f"{label}: pose.json holds {t.shape} and {q.shape}")
    with open(os.path.join(cfg.out_dir, "config.txt")) as f:
        conf = dict(ln.rstrip("\n").split(": ", 1) for ln in f)
    if conf.get("mode") != "'prior'" or int(conf["pair_cap"][1:-1]) <= 0:
        fail(f"{label}: config.txt records mode {conf.get('mode')} and "
             f"pair_cap {conf.get('pair_cap')}")
    return records


def _rel_err(a, b) -> float:
    """max |a - b| over the largest magnitude of b."""
    return max_err(a, b) / max(float(b.abs().max()), 1e-30)


def single_view(wl, counters, gen, take):
    """Phase 5d: ``ops.pipeline.render`` of each of the bench's cameras at
    full width on every route, forward and then forward + backward to the
    vertices and the texture (the first backward of each route under
    sync-debug "error"), held equal across routes; each route's launches;
    CUDA-event ms per render; then ``render_result`` over the fitted take
    (grid over the three cameras, side by side with TIFF references) and
    ``simple_render`` of one camera.

    :param take: (the fit's FitConfig, the take's paths, the frames
        written (C, F, H, W) uint8, a scratch directory).
    :return: the phase's record.
    """
    import numpy as np
    import torch

    from fpc_diffrend_tpu_torch.fit import loop
    from fpc_diffrend_tpu_torch.ops.pipeline import render
    from fpc_diffrend_tpu_torch.profile_forward import device_kernels
    from fpc_diffrend_tpu_torch.tools.render_result import render_result
    from fpc_diffrend_tpu_torch.tools.simple_render import simple_render
    from fpc_diffrend_tpu_torch.utils.image import load_image

    config, scene, params = wl["config"], wl["scene"], wl["params"]
    H, W = wl["H"], wl["W"]
    tex = params["tex"].detach()
    dev = tex.device
    views = []
    with torch.no_grad():
        for c in range(N_VIEWS):
            idx = torch.tensor([c, 0], device=dev)
            mvp = loop.build_mvp(scene, params, idx[:1], idx[1:])[0]
            verts3 = loop.sample_clip_positions(config, scene, params,
                                                idx[:1], idx[1:])[1][0]
            views.append((mvp, verts3))
    mesh = (scene.faces, scene.uv, scene.uv_idx)
    g = torch.randn((H, W, tex.shape[2]), device=dev, generator=gen)

    def draw(route, mvp, pos, t):
        return render(mvp, pos, *mesh, t, (H, W), scene.face_neighbors,
                      route=route)

    out, spread, rec = {}, {}, {"launches": {}, "ms": {}}
    for route in ROUTES:
        for f in counters.values():
            f.launches = 0
        imgs, grads = [], []
        for c, (mvp, pos) in enumerate(views):
            with torch.no_grad():
                imgs.append(draw(route, mvp, pos, tex))
            p = pos.clone().requires_grad_(True)
            t = tex.clone().requires_grad_(True)
            if c == 0:
                torch.cuda.set_sync_debug_mode("error")
            (draw(route, mvp, p, t) * g).sum().backward()
            torch.cuda.set_sync_debug_mode("default")
            grads.append((p.grad, t.grad))
        torch.cuda.synchronize()
        launches = {k: f.launches for k, f in counters.items()}
        # each camera again: how far the atomics' order moves the gradients
        spread[route] = [0.0, 0.0]
        for (mvp, pos), first in zip(views, grads):
            p = pos.clone().requires_grad_(True)
            t = tex.clone().requires_grad_(True)
            (draw(route, mvp, p, t) * g).sum().backward()
            spread[route] = [max(s, _rel_err(a, b)) for s, a, b in zip(
                spread[route], (p.grad, t.grad), first)]
        want = dict.fromkeys(counters, 0)
        want.update(bin_place=2 * N_VIEWS, antialias_bwd=N_VIEWS,
                    texture_bwd=N_VIEWS, pixel_grad=N_VIEWS,
                    fold_entries=N_VIEWS)
        if route == "aa_fused":
            want.update(fused_raster_aa=2 * N_VIEWS)
        else:
            want.update(fused_raster=2 * N_VIEWS, antialias=2 * N_VIEWS)
        if route == "separate":
            want.update(texture_fwd=2 * N_VIEWS)
        if launches != want:
            fail(f"single view, route {route}: launches {launches} != "
                 f"{want}")
        for img in imgs:
            if img.shape != (H, W, tex.shape[2]) or not bool(
                    torch.isfinite(img).all()):
                fail(f"single view, route {route}: image {img.shape} "
                     "not finite or of the wrong shape")
        out[route] = (imgs, grads)
        rec["launches"][route] = launches
        # device time of one render, forward and forward + backward
        mvp, pos = views[0]
        p = pos.clone().requires_grad_(True)
        t = tex.clone().requires_grad_(True)
        with torch.no_grad():
            fwd = cuda_ms(lambda: draw(route, mvp, pos, tex), 5)
        both = cuda_ms(lambda: (draw(route, mvp, p, t) * g).sum().backward(),
                       5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            for mvp_c, pos_c in views:
                draw(route, mvp_c, pos_c, tex)
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) / N_VIEWS * 1e3
        # the device's work in a forward render, by the profiler
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            with torch.no_grad():
                for mvp_c, pos_c in views:
                    draw(route, mvp_c, pos_c, tex)
            torch.cuda.synchronize()
        busy = sum(ms for _, ms, _ in device_kernels(prof)) / N_VIEWS
        rec["ms"][route] = {"forward": fwd, "forward_backward": both,
                            "forward_host": host, "forward_device": busy}
    # The routes' planes are equal bit for bit (phase 3), so their
    # gradients differ only by the order of the atomic sums (K4, K5, K6,
    # the index backward of the setup chain). The texture's sums have
    # terms of one size: within ATOMIC_RTOL of the largest magnitude. The
    # vertex gradient sums terms of screen-coordinate size that cancel:
    # within the stated spread of a sum taken with atomics,
    # GRAD_SPREAD_RTOL of the largest magnitude, as is each route against
    # itself.
    pos_tol = GRAD_SPREAD_RTOL
    if not max(v[0] for v in spread.values()) <= pos_tol:
        fail(f"single view: a route's vertex gradients spread past "
             f"{pos_tol} against itself: {spread}")
    errs = {}
    for route in ROUTES[1:]:
        (imgs, grads), (ref_imgs, ref_grads) = out[route], out[ROUTES[0]]
        e_img = max(max_err(a, b) for a, b in zip(imgs, ref_imgs))
        e_pos = max(_rel_err(a[0], b[0]) for a, b in zip(grads, ref_grads))
        e_tex = max(_rel_err(a[1], b[1]) for a, b in zip(grads, ref_grads))
        errs[route] = {"image": e_img, "vertex grad rel": e_pos,
                       "texture grad rel": e_tex}
        if e_img > 1e-6 or e_pos > pos_tol or e_tex > ATOMIC_RTOL:
            fail(f"single view: route {route} differs from sepaa: "
                 f"{errs[route]} (vertex tolerance {pos_tol}; spread of "
                 f"each route against itself {spread})")
    rec.update(route_errs=errs, grad_spread=spread)
    print(f"single view ({N_VIEWS} cameras, {H}x{W}): routes agree with "
          f"sepaa {errs}; each route against itself (vertex, texture "
          f"gradient) {spread}; launches {rec['launches']}; ms per render "
          f"(CUDA events, camera 0; host clock forward, synchronized; "
          f"device work of a forward, profiler) {rec['ms']}", flush=True)

    # render_result over the fitted take, then simple_render
    fcfg, paths, written, tmp = take
    result_dir = os.path.join(fcfg.out_dir, "result")
    refdir = os.path.join(tmp, "refs")
    os.makedirs(refdir)
    for i in range(written.shape[1]):
        write_tiff(os.path.join(refdir, f"cam0_{i:03d}.tif"), written[0, i])
    n_frames = written.shape[1]
    per_frame = {}
    for mode, cams, shape in (
            ("grid", ["cam0", "cam1", "cam2"], (2 * H, 2 * W, 1)),
            ("side-by-side", ["cam0"], (H, 2 * W, 1))):
        t0 = time.perf_counter()
        render_result(result_dir, paths["calibpath"], paths["basemeshpath"],
                      cams, n_frames, refdir=refdir, resolution=(H, W),
                      mode=mode, y_offset=170.0, write_imgs=True)
        torch.cuda.synchronize()
        per_frame[mode] = (time.perf_counter() - t0) / n_frames
        for i in range(n_frames):
            png = load_image(os.path.join(result_dir,
                                          f"frame{i}_{mode}.png"))
            if png.shape != shape:
                fail(f"render_result {mode}: frame {i} is {png.shape}, "
                     f"not {shape}")
            if mode == "side-by-side" and not np.array_equal(
                    png[:, :W, 0], written[0, i]):
                fail(f"render_result: frame {i}'s reference half differs "
                     "from the TIFF written")
            if not (png > 45).any():
                fail(f"render_result {mode}: frame {i} shows no mesh")
    out_png = os.path.join(tmp, "simple_render.png")
    t0 = time.perf_counter()
    arr = simple_render(paths["calibpath"], "cam0",
                        os.path.join(result_dir, "0.obj"),
                        os.path.join(result_dir, "texture.png"), (H, W),
                        out_png, y_offset=170.0)
    simple_s = time.perf_counter() - t0
    png = load_image(out_png)
    covered = float((png > 0).mean())
    if png.shape != (H, W, 1) or not np.array_equal(png, arr) or covered < 0.01:
        fail(f"simple_render wrote {png.shape}, {covered:.3f} covered")
    rec.update(render_result_s_per_frame=per_frame, simple_render_s=simple_s)
    print(f"render_result: {n_frames} frames of the fitted take, "
          f"s per frame {per_frame} (grid of {N_VIEWS} cameras; "
          f"side by side with TIFF references), PNGs parse; simple_render "
          f"{simple_s:.2f} s, {covered:.3f} of the view covered", flush=True)
    return rec


def view_bins(wl):
    """The bins of the single view that phase 6 and ``chip_turns.py`` time
    kernels on: camera 0, frame 0 of the bench workload at full width (the
    first view of phase 5d)."""
    import torch

    from fpc_diffrend_tpu_torch.fit import loop
    from fpc_diffrend_tpu_torch.models.camera import transform_clip
    from fpc_diffrend_tpu_torch.ops.rasterize import bin_stacked

    scene, params = wl["scene"], wl["params"]
    idx = torch.tensor([0, 0], device=params["tex"].device)
    with torch.no_grad():
        mvp = loop.build_mvp(scene, params, idx[:1], idx[1:])[0]
        verts3 = loop.sample_clip_positions(wl["config"], scene, params,
                                            idx[:1], idx[1:])[1][0]
        return bin_stacked(transform_clip(mvp, verts3)[None], scene.faces,
                           scene.uv, scene.uv_idx, scene.face_neighbors,
                           (wl["H"], wl["W"]))[2]


def kernel_pairs(tex, k1, g_aa, k1s, height, width, sample_ph):
    """The kernels that phase 6 and ``chip_turns.py`` both time, on one
    state's inputs. At the bench batch (K1's planes ``k1``, the composite's
    cotangent ``g_aa``): K2, K3, and K4 wrap on K3's colour cotangent. At the
    single view (K1's planes ``k1s``): K4 clamp on a cotangent where the
    view is covered (the composite passes none to the missed pixels, which
    all sample uv (0, 0)) beside ``grid_sampler_2d_backward`` (border
    padding: the same function); K4 wrap and clamp on a cotangent on every
    missed pixel (the hot spot); K7 wrap and clamp beside ``grid_sample``
    (border padding: the clamp mode's function). The cotangents come from a
    generator seeded 0.

    :return: ({name: (kernel call, its plain version, or None beside a
        library call)}, {name: cotangent}).
    """
    import torch

    from fpc_diffrend_tpu_torch.ops.cuda import antialias_cuda as ac
    from fpc_diffrend_tpu_torch.ops.cuda import texture_cuda as tc

    H, W, ph = height, width, sample_ph
    idbuf, _, payload, _, colour = k1
    gcolour = ac.antialias_planes_bwd(idbuf, payload, colour, g_aa, H, W,
                                      ph)[0]
    tu_b, tv_b = payload[3], payload[4]
    tu, tv = k1s[2][3], k1s[2][4]
    gen = torch.Generator(device=tex.device)
    gen.manual_seed(0)
    noise = torch.randn(k1s[4].shape, device=tex.device, generator=gen)
    cot = {"gcolour": gcolour, "g1": noise * (k1s[0] >= 0),
           "g_hot": noise * (k1s[0] < 0)}
    tex_nchw = tex.permute(2, 0, 1)[None].contiguous()
    grid = torch.stack([tu * 2.0 - 1.0, tv * 2.0 - 1.0], -1)[None]
    pairs = {
        "antialias": (
            lambda: ac.antialias_planes(idbuf, payload, colour, H, W, ph),
            lambda: ac.antialias_planes_plain(idbuf, payload, colour, H, W,
                                              ph)),
        "antialias_bwd": (
            lambda: ac.antialias_planes_bwd(idbuf, payload, colour, g_aa, H,
                                            W, ph),
            lambda: ac.antialias_planes_bwd_plain(idbuf, payload, colour,
                                                  g_aa, H, W, ph)),
        "texture_bwd": (
            lambda: tc.texture_planes_bwd(tex, tu_b, tv_b, gcolour),
            lambda: tc.texture_planes_bwd_plain(tex, tu_b, tv_b, gcolour)),
        "texture_bwd_clamp": (
            lambda: tc.texture_planes_bwd(tex, tu, tv, cot["g1"], "clamp"),
            lambda: tc.texture_planes_bwd_plain(tex, tu, tv, cot["g1"],
                                                "clamp")),
        "grid_sampler_2d_backward": (
            lambda: torch.ops.aten.grid_sampler_2d_backward(
                cot["g1"][None], tex_nchw, grid, 0, 1, False, [True, True]),
            None),
        "grid_sample": (
            lambda: torch.nn.functional.grid_sample(
                tex_nchw, grid, mode="bilinear", padding_mode="border",
                align_corners=False),
            None)}
    for mode in ("wrap", "clamp"):
        pairs[f"texture_bwd_hot_{mode}"] = (
            lambda mode=mode: tc.texture_planes_bwd(tex, tu, tv, cot["g_hot"],
                                                    mode),
            lambda mode=mode: tc.texture_planes_bwd_plain(
                tex, tu, tv, cot["g_hot"], mode))
        name = "texture_fwd" + ("" if mode == "wrap" else "_clamp")
        pairs[name] = (
            lambda mode=mode: tc.texture_planes(tex, tu, tv, mode),
            lambda mode=mode: tc.texture_planes_plain(tex, tu, tv, mode))
    return pairs, cot


def grad_spread(wl, n_runs: int = 3):
    """Phase 7: one bench step's forward and backward, ``n_runs`` times from
    the same state on the same batch (no optimizer update between them).
    The sums taken with atomics (K4's texture, K5, K6, the setup chain's
    index backward) add in another order each run.

    :return: parameter name -> the largest |g_run - g_first| over the runs,
        over the largest magnitude of g_first.
    """
    import torch

    from fpc_diffrend_tpu_torch.fit import loop

    config, scene, state = wl["config"], wl["scene"], wl["state"]
    params = state.params
    dev = scene.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    cams = torch.tensor(config.cam_idxs, dtype=torch.int64, device=dev)
    B = config.batch_size
    cam = cams[torch.randint(0, cams.shape[0], (B,), generator=gen,
                             device=dev)]
    frame = torch.randint(0, wl["n_frames"], (B,), generator=gen, device=dev)
    batch = loop.Batch(cam, frame, loop.decode_refs(wl["frames_u8"], cam,
                                                    frame))
    runs = []
    for _ in range(n_runs):
        for p in params.values():
            p.grad = None
            p.requires_grad_(True)
        total, _ = loop.loss_fn(params, config, scene, batch, state.step)
        total.backward()
        runs.append({k: p.grad.detach().clone() for k, p in params.items()
                     if p.grad is not None})
    torch.cuda.synchronize()
    for p in params.values():
        p.grad = None
    return {k: max(_rel_err(r[k], runs[0][k]) for r in runs[1:])
            for k in runs[0]}


def _bound(nbytes, ops):
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def k1_work(bins, rows, pw, C, tex):
    """K1's work: each input read once, each output written once (bytes),
    ~16 flops per (pixel, live entry) coverage test plus ~60 per pixel for
    the payload and texture (operations).

    :return: (bytes, operations, live bin entries)."""
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
    return out_bytes + in_bytes, ops, live


def k1_bound_ms(bins, rows, pw, C, tex):
    """Least time for K1's work (:func:`k1_work`)."""
    return _bound(*k1_work(bins, rows, pw, C, tex)[:2])


def k10_bound_ms(bins, rows, pw, C, tex, idbuf, height, width, sample_ph):
    """K10: K1's work, plus the C aa planes written (bytes) and K2's ~60
    flops per pixel pair whose ids differ (operations); the planes K2
    would read stay on the chip."""
    nbytes, ops, _ = k1_work(bins, rows, pw, C, tex)
    pairs, _ = _diff_pairs(idbuf, height, width, sample_ph)
    return _bound(nbytes + idbuf.numel() * 4 * C, ops + 60 * pairs)


def k7_bound_ms(tex, tu, tv, boundary_mode):
    """K7: tu and tv read and C planes written per pixel, and each texel
    the pixels touch read once (bytes); 4 taps and 3 lerps a channel and
    the coordinates, ~(7 C + 12) flops a pixel (operations)."""
    import torch

    th, tw, C = tex.shape
    texels = int(torch.unique(texel_taps(tu, tv, th, tw,
                                         boundary_mode)[0]).numel())
    px = tu.numel()
    return _bound(px * 4 * (2 + C) + texels * 4 * C, px * (7 * C + 12))


def texel_taps(tu, tv, th, tw, boundary_mode):
    """(4, ...) texel index of each sample's taps 00, 01, 10, 11, wrapped
    or clamped as K4 and K7 take them; the unwrapped (t0, s0) beside."""
    import torch

    s0 = torch.floor(tu * tw - 0.5).long()
    t0 = torch.floor(tv * th - 0.5).long()
    taps = []
    for dt in (0, 1):
        for ds in (0, 1):
            if boundary_mode == "wrap":
                si, ti = torch.remainder(s0 + ds, tw), torch.remainder(
                    t0 + dt, th)
            else:
                si, ti = (torch.clamp(s0 + ds, 0, tw - 1),
                          torch.clamp(t0 + dt, 0, th - 1))
            taps.append(ti * tw + si)
    return torch.stack(taps), t0, s0


def k2_bound_ms(idbuf, payload, C, height, width, sample_ph):
    """Least time for K2: id and C colour planes read and C written for
    every pixel, and the pair blend's geometry (:func:`pair_geometry_bytes`)
    (bytes); ~60 flops per pair whose ids differ and 2 per other pair
    (operations)."""
    px = idbuf.numel()
    pairs, _ = _diff_pairs(idbuf, height, width, sample_ph)
    geom = pair_geometry_bytes(idbuf, payload, height, width, sample_ph)
    return _bound(px * 4 * (1 + 2 * C) + geom, 60 * pairs + 2 * 2 * px)


def _diff_pairs(idbuf, height, width, sample_ph):
    """(pairs whose ids differ, mask of the pixels in at least one such
    pair), within the pair masks of K2/K3."""
    import torch

    rows, pw = idbuf.shape
    h = torch.zeros_like(idbuf, dtype=torch.bool)
    h[:, :width - 1] = idbuf[:, :width - 1] != idbuf[:, 1:width]
    vmask = (torch.arange(rows, device=idbuf.device) % sample_ph
             < height - 1)[:-1, None]
    v = torch.zeros_like(h)
    v[:-1] = (idbuf[:-1] != idbuf[1:]) & vmask
    px = h.clone()
    px[:, 1:] |= h[:, :-1]
    px |= v
    px[1:] |= v[:-1]
    return int(h.sum() + v.sum()), px


def pair_geometry_bytes(idbuf, payload, height, width, sample_ph):
    """The geometry K2 and K3 must read for the pair blend: z of each
    covered pixel in a pair whose ids differ (a missed pixel's depth is
    infinite without a read), and the 9 corner and neighbour planes of each
    such pair's occluder (:func:`occluder_sectors`, pixel by pixel), which
    are all that ``pair_delta`` reads."""
    _, in_pair = _diff_pairs(idbuf, height, width, sample_ph)
    occluders, _ = occluder_sectors(idbuf, payload, height, width, sample_ph)
    return 4 * int((in_pair & (idbuf >= 0)).sum()) + 4 * 9 * occluders


def k3_bound_ms(idbuf, payload, C, height, width, sample_ph):
    """K3: id, C colour and C gout read and C + 6 planes written for every
    pixel, and the pair blend's geometry (:func:`pair_geometry_bytes`)
    (bytes). ~150 flops per pair whose ids differ for its forward recompute
    and derivative (operations)."""
    px = idbuf.numel()
    pairs, _ = _diff_pairs(idbuf, height, width, sample_ph)
    geom = pair_geometry_bytes(idbuf, payload, height, width, sample_ph)
    return _bound(px * 4 * (1 + 2 * C + C + 6) + geom, 150 * pairs + 8 * px)


def occluder_sectors(idbuf, payload, height, width, sample_ph):
    """The pixels whose 9 corner and neighbour planes K2 and K3 read from
    device memory: the occluder of each pair whose ids differ (as int and
    as float) and whose occluder is covered, under the pair masks; and the
    32-byte sectors (8 pixels of a row) they fall in.

    :return: (occluder pixels, sectors a plane)."""
    import torch

    rows, pw = idbuf.shape
    dev = idbuf.device
    idf = idbuf.float()
    z = torch.where(idbuf >= 0, payload[2], float("inf"))
    flat = torch.arange(rows * pw, device=dev).reshape(rows, pw)
    need = torch.zeros(rows * pw, dtype=torch.bool, device=dev)
    vmask = (torch.arange(rows - 1, device=dev) % sample_ph
             < height - 1)[:, None]
    for sa, sb, mask in (
            ((slice(None), slice(0, width - 1)),
             (slice(None), slice(1, width)), True),
            ((slice(0, rows - 1), slice(None)), (slice(1, rows),
                                                 slice(None)), vmask)):
        a_occ = z[sa] <= z[sb]
        occ_id = torch.where(a_occ, idf[sa], idf[sb])
        live = (idbuf[sa] != idbuf[sb]) & mask & (occ_id >= 0) & (
            idf[sa] != idf[sb])
        need[torch.where(a_occ, flat[sa], flat[sb])[live]] = True
    occluders = int(need.sum())
    sectors = int(torch.unique(torch.nonzero(need)[:, 0] // 8).numel())
    return occluders, sectors


def k2_design_bytes(idbuf, payload, C, height, width, sample_ph):
    """Bytes K2's design moves: id, z and C colour read and C colour
    written for every pixel, and the 9 corner and neighbour planes of each
    differing pair's occluder read a sector at a time
    (:func:`occluder_sectors`); also returns the occluders and sectors."""
    occluders, sectors = occluder_sectors(idbuf, payload, height, width,
                                          sample_ph)
    nbytes = idbuf.numel() * 4 * (2 + 2 * C) + 9 * sectors * 32
    return nbytes, occluders, sectors


def k3_design_bytes(idbuf, payload, C, height, width, sample_ph):
    """Bytes K3's design moves: id, z, C colour and C gout read and C + 6
    planes written for every pixel, and the occluders' 9 planes by sector
    (:func:`occluder_sectors`); also returns the occluders and sectors."""
    occluders, sectors = occluder_sectors(idbuf, payload, height, width,
                                          sample_ph)
    nbytes = idbuf.numel() * 4 * (2 + 2 * C + C + 6) + 9 * sectors * 32
    return nbytes, occluders, sectors


def k4_bound_ms(gcolour, tex):
    """K4: C cotangent planes read and gtu/gtv written for every pixel, tu
    and tv read where the cotangent is not 0, the texture read and gtex
    written (bytes); ~40 flops per such pixel and channel (operations)."""
    C = gcolour.shape[0]
    px = gcolour[0].numel()
    live = int((gcolour != 0).any(dim=0).sum())
    nbytes = px * 4 * (C + 2) + live * 8 + 2 * tex.numel() * 4
    return _bound(nbytes, 40 * live * C)


def k4_design_reductions(tex_shape, tu, tv, gcolour):
    """The device-memory reductions K4's design issues
    (``csrc/texture_bwd.cu``): each warp instruction takes 32 neighbouring
    pixels of the flat plane (from pixel 0). Where all of its live pixels
    (cotangent not 0 in some channel) sample one unwrapped texel (t0, s0) =
    floor(uv * size - 0.5) it adds 4 taps. Otherwise, in each pair of
    pixels (2m, 2m + 1), a live even pixel adds 4 taps and a live odd one
    none where the even one is live and samples the same (t0, s0), 2 where
    it samples (t0, s0 - 1), else 4. Each tap is C reductions.

    :return: (reductions, 32-pixel groups summed across the warp).
    """
    import torch

    th, tw, C = tex_shape
    n = tu.numel()
    live = (gcolour.reshape(C, n) != 0).any(dim=0)
    _, t0, s0 = texel_taps(tu.reshape(n), tv.reshape(n), th, tw, "wrap")
    taps, one = _warp_pair_taps(live, (t0,), s0)
    return taps * C, one


def _warp_pair_taps(live, row_keys, s0):
    """The taps a design of K4's kind adds for 32 neighbouring pixels of a
    flat plane at a time (from pixel 0): 4 where every live one shares its
    row keys and s0; else pair by pair (2m, 2m + 1): 4 for a live even
    pixel; for a live odd one none where the even one is live and shares
    its row keys and s0, 2 where it shares the row keys and samples
    s0 - 1, else 4.

    :param live: (n,) bool; row_keys: (n,) int tensors a merge needs equal
        (the texel row, and the level where there are several); s0: (n,)
        the texel column.
    :return: (taps, 32-pixel groups summed across the warp).
    """
    import torch

    n = live.numel()
    m = -(-n // 32) * 32
    pad = torch.nn.functional.pad
    live = pad(live, (0, m - n))
    keys = [pad(k, (0, m - n)) for k in (*row_keys, s0)]
    big = 1 << 40
    lg = live.reshape(-1, 32)
    one = lg.any(dim=1)
    for k in keys:
        k = k.reshape(-1, 32)
        one &= (torch.where(lg, k, big).amin(1)
                == torch.where(lg, k, -big).amax(1))
    le, lo = live.reshape(-1, 2).unbind(1)
    row = le
    for k in keys[:-1]:
        ke, ko = k.reshape(-1, 2).unbind(1)
        row = row & (ke == ko)
    se, so = keys[-1].reshape(-1, 2).unbind(1)
    odd = torch.where(row & (so == se), 0, torch.where(row & (so == se + 1),
                                                       2, 4))
    pair = 4 * le + torch.where(lo, odd, 0)
    taps = torch.where(one, 4, pair.reshape(-1, 16).sum(dim=1))
    return int(taps.sum()), int(one.sum())


def _mip_levels(lam, n_levels):
    """Each pixel's level lo = floor(lam clamped to [0, L - 1]), and
    whether it blends level lo + 1 (K8's ``pick``)."""
    import torch

    lc = torch.clamp(lam, 0.0, float(n_levels - 1))
    lof = torch.floor(lc)
    return lof.long(), (lof + 1 < n_levels) & (lc != lof)


def _mip_slot_taps(sizes, tu, tv, level):
    """(t0, s0): the unwrapped texel of tap 00 of each pixel at its
    ``level`` (int64 plane), as K8 and K9 compute it."""
    import torch

    dev = tu.device
    th = torch.tensor([h for h, _ in sizes], device=dev)[level]
    tw = torch.tensor([w for _, w in sizes], device=dev)[level]
    s0 = torch.floor(tu * tw.to(torch.float32) - 0.5).long()
    t0 = torch.floor(tv * th.to(torch.float32) - 0.5).long()
    return t0, s0


def mip_level_counts(sizes, tu, tv, lam, gcolour):
    """What K8 and K9 sample at these inputs: the pixels, the live ones
    (cotangent not 0 in some channel) and those of them at uv (0, 0); per
    level, the pixels whose lo is that level (all and live), and the
    distinct texels the live pixels' taps touch there (level lo, and
    lo + 1 where they blend it); the pixels that blend a second level (all
    and live).

    :return: a dict of those counts (per level: lists, finest first).
    """
    import torch

    C = gcolour.shape[0]
    n = tu.numel()
    tu, tv, lam = tu.reshape(n), tv.reshape(n), lam.reshape(n)
    L = len(sizes)
    live = (gcolour.reshape(C, n) != 0).any(dim=0)
    lo, hi = _mip_levels(lam, L)
    texels = []
    for lvl, (th, tw) in enumerate(sizes):
        sel = (live & (lo == lvl)) | (live & hi & (lo + 1 == lvl))
        taps = texel_taps(tu[sel], tv[sel], th, tw, "wrap")[0]
        texels.append(int(torch.unique(taps).numel()))
    return {
        "px": n, "live_px": int(live.sum()),
        "live_px_at_uv_00": int((live & (tu == 0) & (tv == 0)).sum()),
        "lo_px": torch.bincount(lo, minlength=L).tolist(),
        "lo_live_px": torch.bincount(lo[live], minlength=L).tolist(),
        "blend_px": int(hi.sum()), "blend_live_px": int((hi & live).sum()),
        "texels_touched": texels,
        "texels": [th * tw for th, tw in sizes]}


def k9_design_reductions(sizes, tu, tv, lam, gcolour):
    """The device-memory reductions K9's design issues
    (``csrc/texture_mip.cu``): each live pixel (cotangent not 0 in some
    channel) samples level lo and, where it blends it, lo + 1; each of the
    two level slots is reduced as K4's design reduces its one
    (:func:`_warp_pair_taps`), with the level among the keys a merge needs
    equal. Each tap is C reductions.

    :return: (reductions, 32-pixel groups summed across the warp, over
        both slots).
    """
    C = gcolour.shape[0]
    n = tu.numel()
    tu, tv, lam = tu.reshape(n), tv.reshape(n), lam.reshape(n)
    live = (gcolour.reshape(C, n) != 0).any(dim=0)
    lo, hi = _mip_levels(lam, len(sizes))
    taps = groups = 0
    for k, lk in ((0, live), (1, live & hi)):
        level = (lo + k).clamp(max=len(sizes) - 1)
        t0, s0 = _mip_slot_taps(sizes, tu, tv, level)
        t, g = _warp_pair_taps(lk, (level, t0), s0)
        taps, groups = taps + t, groups + g
    return taps * C, groups


def k9_unreduced(pyr, sizes, tu, tv, lam, gcolour):
    """K9 with its gradient-pyramid reductions left out (the library's
    ``mip_bwd_unreduced_launch``, for timing only): gtu and gtv as K9
    gives them, the gradient pyramid zero. Counts no launch."""
    import torch

    from fpc_diffrend_tpu_torch.kernels import build
    from fpc_diffrend_tpu_torch.ops.cuda import texture_mip_cuda as tmc

    rows, pw = tu.shape
    n, C = pyr.shape
    gpyr = torch.empty((n, C), device=tu.device)
    gtu = torch.empty((rows, pw), device=tu.device)
    gtv = torch.empty((rows, pw), device=tu.device)
    fn = build.entry("texture_mip", "mip_bwd_unreduced_launch",
                     tmc._MIP_BWD_ARGS)
    ptr = build.ptr
    build.check(fn(ptr(pyr), ptr(tu), ptr(tv), ptr(lam), ptr(gcolour), rows,
                   pw, *tmc._level_args(sizes), C, n, ptr(gpyr), ptr(gtu),
                   ptr(gtv), build.stream(tu.device)), "k9_unreduced")
    return gpyr, gtu, gtv


def k8_bound_ms(lam, C, pyr, n_levels):
    """K8: tu, tv and lam read and C planes written per pixel, the pyramid
    read once (bytes); ~(12 C + 12) flops for each level a pixel samples,
    4 taps and 3 lerps a channel and the coordinates (operations)."""
    px = lam.numel()
    levels = px + int(_mip_levels(lam, n_levels)[1].sum())
    return _bound(px * 4 * (3 + C) + pyr.numel() * 4, levels * (12 * C + 12))


def k9_bound_ms(lam, gcolour, pyr, n_levels):
    """K9: C cotangent planes read and gtu/gtv written per pixel, tu, tv and
    lam read where the cotangent is not 0, the pyramid read and the
    gradient pyramid written (bytes); ~(24 C + 12) flops for each level
    such a pixel samples (operations)."""
    C = gcolour.shape[0]
    px = lam.numel()
    live = (gcolour != 0).any(dim=0)
    blend = _mip_levels(lam, n_levels)[1]
    levels = int(live.sum()) + int((blend & live).sum())
    nbytes = px * 4 * (C + 2) + int(live.sum()) * 12 + 2 * pyr.numel() * 4
    return _bound(nbytes, levels * (24 * C + 12))


def k5_bound_ms(entry, bins):
    """K5: entry read for every pixel, u, v, 8 extra and 11 cotangent
    planes for every covered pixel, one 128-byte row written per live and
    global entry (bytes); ~110 flops per covered pixel for the
    coefficients and their sums (operations)."""
    hit = int((entry >= 0).sum())
    rows = int(bins.bin_start[-1]) + int(bins.n_global[0])
    nbytes = entry.numel() * 4 + hit * 4 * 21 + rows * 128
    return _bound(nbytes, 110 * hit)


def k6_bound_ms(bins, n_tris):
    """K6: 27 floats and a triangle id read per live and global entry, the
    (B*T, 32) rows written (bytes); 27 adds per entry (operations)."""
    rows = int(bins.bin_start[-1]) + int(bins.n_global[0])
    return _bound(rows * (27 * 4 + 4) + n_tris * 128, 27 * rows)


KERNELS = {       # K1 .. K11
    "fused_raster": ("csrc/fused_raster.cu", "rasterize_tpu.py:1055"),
    "antialias": ("csrc/antialias.cu", "antialias_tpu.py:184"),
    "antialias_bwd": ("csrc/antialias_bwd.cu", "antialias_tpu.py:228"),
    "texture_bwd": ("csrc/texture_bwd.cu", "texture_tpu.py:463"),
    "pixel_grad": ("csrc/raster_grad.cu", "raster_grad_tpu.py:97"),
    "fold_entries": ("csrc/raster_grad.cu", "raster_grad_tpu.py:338"),
    "texture_fwd": ("csrc/texture_fwd.cu", "texture_tpu.py:407"),
    "mip_sample": ("csrc/texture_mip.cu", "texture_mip_tpu.py:163"),
    "mip_sample_bwd": ("csrc/texture_mip.cu", "texture_mip_tpu.py:246"),
    "fused_raster_aa": ("csrc/fused_raster.cu", "rasterize_tpu.py:1514"),
    "bin_place": ("csrc/bin_place.cu", "rasterize_tpu.py:350"),
}
SINGLE_VIEW_ONLY = ("texture_fwd", "fused_raster_aa")   # K7, K10


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
    import dataclasses
    import tempfile

    import numpy as np

    from fpc_diffrend_tpu_torch.data import frames as frames_mod
    from fpc_diffrend_tpu_torch.fit import api as fit_api
    from fpc_diffrend_tpu_torch.fit import checkpoint as ckpt_mod
    from fpc_diffrend_tpu_torch.fit import loop
    from fpc_diffrend_tpu_torch.fit.config import FitConfig
    from fpc_diffrend_tpu_torch.kernels import build
    from fpc_diffrend_tpu_torch.ops.cuda import antialias_cuda as ac
    from fpc_diffrend_tpu_torch.ops.cuda import bin_place_cuda as bp
    from fpc_diffrend_tpu_torch.ops.cuda import raster_grad_cuda as gc
    from fpc_diffrend_tpu_torch.ops.cuda import rasterize_cuda as rc
    from fpc_diffrend_tpu_torch.ops.cuda import texture_cuda as tc
    from fpc_diffrend_tpu_torch.ops.cuda import texture_mip_cuda as tmc
    from fpc_diffrend_tpu_torch.profile_forward import (device_kernels,
                                                        forward_stages,
                                                        step_stages)
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
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for grid in (40, 5):
        wl = build_workload(256, 384, grid=grid, batch=2, tex_size=1024,
                            device=dev)
        state = {}
        for _, fn in forward_stages(wl, state)[:2]:     # prologue, binning
            fn()
        bins = state["bins"]
        ph, pw = rc.pad_resolution(256, 384)
        label = f"dome grid {grid}, {wl['faces'].shape[0]} tris"
        _, _, k1 = check_kernels(bins, wl["params"]["tex"], 2 * ph, pw, 256,
                                 384, ph, label)
        if grid == 5 and int(bins.n_global[0]) == 0:
            fail("the large-triangle check scene left the global list empty")
        check_aa_fused(bins, wl["params"]["tex"].detach(), 2 * ph, pw, 256,
                       384, ph, k1, label)
        # random cotangents, u/v/z ones included, exercise every slot
        g_aa = torch.randn(k1[4].shape, device=dev, generator=gen)
        check_texture(k1, wl["params"]["tex"].detach(), g_aa, gen, label)
        gtuv = torch.randn((3, 2 * ph, pw), device=dev, generator=gen)
        check_backward(k1, bins, wl["params"]["tex"], g_aa, gtuv, 256, 384,
                       ph, 2 * wl["faces"].shape[0], label)
        # a LOD plane over every level of the 7 and past both clamps
        lam_random = (torch.rand((2 * ph, pw), device=dev, generator=gen)
                      * (MAX_MIP_LEVEL + 3) - 1.5)
        check_mip(k1, wl["params"]["tex"].detach(), g_aa, lam_random, 256,
                  384, ph, label)
        check_place(state["pc"], wl["scene"].faces, 256, 384,
                    wl["config"].pair_cap, label)
    check_place_synthetic(dev)
    record["k2_edges_err"] = check_k2_edges(dev, gen)
    record["k4_edges_err"] = check_k4_edges(dev, gen)
    record["mip_edges_err"] = check_mip_edges(dev, gen)

    # ---- 4. the forward at full width ----
    counters = {"fused_raster": rc.fused_raster,
                "antialias": ac.antialias_planes,
                "antialias_bwd": ac.antialias_planes_bwd,
                "texture_bwd": tc.texture_planes_bwd,
                "pixel_grad": gc.pixel_grad,
                "fold_entries": gc.fold_entries,
                "texture_fwd": tc.texture_planes,
                "mip_sample": tmc.mip_sample,
                "mip_sample_bwd": tmc.mip_sample_bwd,
                "fused_raster_aa": rc.fused_raster_aa,
                "bin_place": bp.place_pairs}
    for f in counters.values():
        f.launches = 0
    t0 = time.perf_counter()
    wl = build_workload(device=dev)      # autotunes the cap: raster_stats
    torch.cuda.synchronize()
    record["workload_build_s"] = time.perf_counter() - t0
    if any(f.launches for f in counters.values()):
        fail("building the workload (raster_stats, autotune_caps) launched "
             f"a kernel: { {k: f.launches for k, f in counters.items()} }")
    config, scene, params = wl["config"], wl["scene"], wl["params"]
    H, W, B = wl["H"], wl["W"], wl["B"]
    T = wl["faces"].shape[0]
    print(f"workload: {H}x{W}, {T} tris, batch {B}, "
          f"tex {tuple(params['tex'].shape)}, pair_cap {config.pair_cap} "
          f"(P = {rc.entry_count(B, T, config.pair_cap)} of "
          f"{rc.entry_count(B, T)} pair slots), built in "
          f"{record['workload_build_s']:.1f} s", flush=True)
    cpu_gen = torch.Generator().manual_seed(0)
    loop.evaluate(config, scene, params, wl["frames_u8"], 1, cpu_gen)
    torch.cuda.synchronize()
    n_batches = 5
    for f in counters.values():
        f.launches = 0
    t0 = time.perf_counter()
    metrics = loop.evaluate(config, scene, params, wl["frames_u8"],
                            n_batches, cpu_gen)
    torch.cuda.synchronize()
    fwd_ms = (time.perf_counter() - t0) / n_batches * 1e3
    launches = {k: f.launches for k, f in counters.items()}
    metrics = {k: v.tolist() for k, v in metrics.items()}
    print(f"evaluate: {n_batches} batches, forward {fwd_ms:.3f} ms/batch "
          f"(host clock, synchronized); launches {launches}; "
          f"loss {metrics['loss']}", flush=True)
    for k, v in metrics.items():
        if not all(math.isfinite(x) for x in v):
            fail(f"non-finite {k}: {v}")
    want = dict.fromkeys(counters, 0)
    want.update(fused_raster=n_batches, antialias=n_batches,
                bin_place=n_batches)
    if launches != want:
        fail(f"kernel launches {launches} != {want}")
    record.update(forward_ms_per_batch=fwd_ms, metrics=metrics,
                  launches_evaluate=launches, pair_cap=config.pair_cap)

    # ---- 5. the fit step at full width ----
    state = wl["state"]
    k, n_dispatch = 5, 2
    # the warm-up dispatch: a host sync anywhere on the step's path raises
    torch.cuda.set_sync_debug_mode("error")
    loop.train_steps(config, scene, state, wl["frames_u8"], gen, k,
                     wl["n_frames"])
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for f in counters.values():
        f.launches = 0
    t0 = time.perf_counter()
    runs = [loop.train_steps(config, scene, state, wl["frames_u8"], gen, k,
                             wl["n_frames"])[1] for _ in range(n_dispatch)]
    torch.cuda.synchronize()
    n_steps = k * n_dispatch
    step_ms = (time.perf_counter() - t0) / n_steps * 1e3
    launches = {k: f.launches for k, f in counters.items()}
    losses = {m: torch.cat([r[m] for r in runs]).tolist() for m in runs[0]}
    mpix = B * H * W / step_ms / 1e3
    print(f"train_steps: {n_dispatch} x {k} steps, {step_ms:.3f} ms/step "
          f"(host clock, synchronized), {mpix:.1f} Mpix/s; launches "
          f"{launches}; loss first {losses['loss'][0]} last "
          f"{losses['loss'][-1]}", flush=True)
    for m, v in losses.items():
        if not all(math.isfinite(x) for x in v):
            fail(f"non-finite step {m}: {v}")
    for name, p in params.items():
        if not bool(torch.isfinite(p).all()):
            fail(f"non-finite parameter {name} after the steps")
    want = {k: 0 if k.startswith("mip") or k in SINGLE_VIEW_ONLY else n_steps
            for k in counters}
    if launches != want:
        fail(f"kernel launches {launches} != {want}")
    record.update(step_ms=step_ms, mpix_per_s=mpix, step_losses=losses,
                  launches=launches, steps_taken=state.step)

    # the same steps with the bins uncapped, between two capped runs: for
    # information only (the host binds the step; no claim)
    uncapped = dataclasses.replace(config, pair_cap=0)
    turns = {}
    for name, cfg in (("uncapped", uncapped), ("capped", config),
                      ("uncapped", uncapped), ("capped", config)):
        loop.train_steps(cfg, scene, state, wl["frames_u8"], gen, 1,
                         wl["n_frames"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_dispatch):
            loop.train_steps(cfg, scene, state, wl["frames_u8"], gen, k,
                             wl["n_frames"])
        torch.cuda.synchronize()
        turns.setdefault(name, []).append(
            (time.perf_counter() - t0) / n_steps * 1e3)
    print(f"step ms/step in turns (host clock): capped {turns['capped']} "
          f"(first run {step_ms:.3f}), uncapped {turns['uncapped']}",
          flush=True)
    record["step_ms_turns"] = turns

    # per-stage device times of one batch's forward and one step
    stages = {}
    with torch.no_grad():
        for name, fn in forward_stages(wl, {}):
            stages[name] = cuda_ms(fn, 5)
    record["stage_ms"] = stages
    print("forward stages (CUDA events, ms, batch of 8): " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items()), flush=True)
    sstate = {}
    step_stage_ms = {name: cuda_ms(fn, 3)
                     for name, fn in step_stages(wl, sstate)}
    record["step_stage_ms"] = step_stage_ms
    print("step stages (CUDA events, ms, batch of 8): " + ", ".join(
        f"{k} {v:.3f}" for k, v in step_stage_ms.items()), flush=True)

    # ---- 5b. the mip path at full width ----
    wlm = build_workload(mip=True, device=dev)
    cm, scm, pm = wlm["config"], wlm["scene"], wlm["params"]
    loop.evaluate(cm, scm, pm, wlm["frames_u8"], 1, cpu_gen)
    torch.cuda.synchronize()
    for f in counters.values():
        f.launches = 0
    t0 = time.perf_counter()
    metrics = loop.evaluate(cm, scm, pm, wlm["frames_u8"], n_batches,
                            cpu_gen)
    torch.cuda.synchronize()
    mip_fwd_ms = (time.perf_counter() - t0) / n_batches * 1e3
    launches_fwd = {k: f.launches for k, f in counters.items()}
    metrics = {k: v.tolist() for k, v in metrics.items()}
    print(f"mip evaluate: {n_batches} batches, forward {mip_fwd_ms:.3f} "
          f"ms/batch; launches {launches_fwd}; loss {metrics['loss']}",
          flush=True)
    for m, v in metrics.items():
        if not all(math.isfinite(x) for x in v):
            fail(f"mip: non-finite {m}: {v}")
    want = dict.fromkeys(counters, 0)
    want.update(fused_raster=n_batches, antialias=n_batches,
                mip_sample=n_batches, bin_place=n_batches)
    if launches_fwd != want:
        fail(f"mip: kernel launches {launches_fwd} != {want}")
    mstate = wlm["state"]
    torch.cuda.set_sync_debug_mode("error")
    loop.train_steps(cm, scm, mstate, wlm["frames_u8"], gen, k,
                     wlm["n_frames"])
    torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for f in counters.values():
        f.launches = 0
    t0 = time.perf_counter()
    runs = [loop.train_steps(cm, scm, mstate, wlm["frames_u8"], gen, k,
                             wlm["n_frames"])[1] for _ in range(n_dispatch)]
    torch.cuda.synchronize()
    mip_step_ms = (time.perf_counter() - t0) / n_steps * 1e3
    mip_launches = {k: f.launches for k, f in counters.items()}
    mlosses = {m: torch.cat([r[m] for r in runs]).tolist() for m in runs[0]}
    print(f"mip train_steps: {n_dispatch} x {k} steps, {mip_step_ms:.3f} "
          f"ms/step (host clock, synchronized), "
          f"{B * H * W / mip_step_ms / 1e3:.1f} Mpix/s; launches "
          f"{mip_launches}; loss first {mlosses['loss'][0]} last "
          f"{mlosses['loss'][-1]}", flush=True)
    for m, v in mlosses.items():
        if not all(math.isfinite(x) for x in v):
            fail(f"mip: non-finite step {m}: {v}")
    for name, p in pm.items():
        if not bool(torch.isfinite(p).all()):
            fail(f"mip: non-finite parameter {name} after the steps")
    want = {k: 0 if k == "texture_bwd" or k in SINGLE_VIEW_ONLY else n_steps
            for k in counters}
    if mip_launches != want:
        fail(f"mip: kernel launches {mip_launches} != {want}")
    with torch.no_grad():
        mip_stages = {name: cuda_ms(fn, 5)
                      for name, fn in forward_stages(wlm, {})}
    print("mip forward stages (CUDA events, ms, batch of 8): " + ", ".join(
        f"{k} {v:.3f}" for k, v in mip_stages.items()), flush=True)
    mstage = {}
    mip_step_stages = {name: cuda_ms(fn, 3)
                       for name, fn in step_stages(wlm, mstage)}
    print("mip step stages (CUDA events, ms, batch of 8): " + ", ".join(
        f"{k} {v:.3f}" for k, v in mip_step_stages.items()), flush=True)
    record.update(mip_forward_ms_per_batch=mip_fwd_ms, mip_metrics=metrics,
                  mip_launches_evaluate=launches_fwd, mip_step_ms=mip_step_ms,
                  mip_step_losses=mlosses, mip_launches=mip_launches,
                  mip_stage_ms=mip_stages, mip_step_stage_ms=mip_step_stages)

    # ---- 5c. fit_take at full width: a take on disk, fitted end to end ----
    from fpc_diffrend_tpu_torch.runtime import native

    n_fit = 20
    with tempfile.TemporaryDirectory(prefix="chip_smoke_take_") as tmp:
        paths, written, cams = write_take(tmp, wl)
        fcfg = FitConfig(
            max_iter=n_fit, resolution=(H, W), texshape=(1024, 1024, 1),
            mode="prior", cam_idxs=(0, 1, 2), batch_size=B,
            weight_laplacian=1.0, log_interval=5, checkpoint_interval=10,
            checkpoint_dir=os.path.join(tmp, "ckpt"),
            out_dir=os.path.join(tmp, "out"), **paths)
        native.load_tiffs.files = native.parse_obj_vertices.files = 0
        for f in counters.values():
            f.launches = 0
        t0 = time.perf_counter()
        fstate = fit_api.fit_take(fcfg)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        fit_launches = {k: f.launches for k, f in counters.items()}
        read = (native.load_tiffs.files, native.parse_obj_vertices.files)
        if read != (12, 8):
            fail(f"fit_take read {read} TIFFs and blendshapes through the "
                 "native runtime, not (12, 8): "
                 f"{native.unavailable_reason()}")
        loaded = frames_mod.load_take(paths["imdir"], cams)
        if not np.array_equal(loaded,
                              np.clip(written, 0, 140)[:, :, ::-1, :]):
            fail("the take's frames loaded back differ from those written, "
                 "clipped to 140 and flipped")
        want = {k: 0 if k.startswith("mip") or k in SINGLE_VIEW_ONLY
                else n_fit for k in counters}
        if fit_launches != want or fstate.step != n_fit:
            fail(f"fit_take ran {fstate.step} steps with launches "
                 f"{fit_launches} != {want}")
        nv, nt = scene.n_vertices, T
        records = check_fit_outputs(fcfg, nv, nt, 4, "fit_take")
        if [r["step"] for r in records] != [1, 6, 11, 16]:
            fail(f"metrics.jsonl steps {[r['step'] for r in records]}")
        losses = [r["loss"] for r in records]
        if not all(math.isfinite(x) for x in losses):
            fail(f"fit_take: non-finite loss {losses}")
        for name, p in fstate.params.items():
            if not bool(torch.isfinite(p).all()):
                fail(f"fit_take: non-finite parameter {name}")
        cap, live0 = records[0]["pair_cap"], records[0]["n_valid_pairs"]
        # the health record is taken after the first step; the cap was
        # sized before it, at 1.25 x the entries then
        if not (cap % 128 == 0 and live0 <= cap <= 2 * live0 + 128):
            fail(f"fit_take: pair_cap {cap} is not the autotuned cap of "
                 f"{live0} bin entries")
        latest = ckpt_mod.latest_checkpoint(fcfg.checkpoint_dir)
        if not latest.endswith(f"step_{n_fit:09d}.pt"):
            fail(f"fit_take: latest checkpoint {latest}")
        # ms/step between the loss reads at steps 5 and 15 (each a sync)
        at = {r["step"] - 1: r["step"] / r["it_per_s"] for r in records}
        fit_ms = (at[15] - at[5]) / 10 * 1e3
        print(f"fit_take: {n_fit} steps of a take on disk (prior mode, "
              f"{len(cams)} cameras x 4 frames of {H}x{W}, {nt} tris, 8 "
              f"blendshapes) in {fit_s:.1f} s with set-up and results; "
              f"{fit_ms:.3f} ms/step over steps 5-15 (host clock); "
              f"pair_cap {cap} beside {live0} bin entries of the worst "
              f"camera (P = {rc.entry_count(B, nt, cap)} of NP = "
              f"{rc.entry_count(B, nt)} pair slots); launches "
              f"{fit_launches}; loss {losses}", flush=True)

        # resume: the second call continues from the step-20 checkpoint,
        # writing a progress frame every 2 steps (mp4_interval; PNGs where
        # imageio has no mp4 encoder), each a render of camera 0, frame 0
        # at B = 1 beside its reference
        import shutil

        from fpc_diffrend_tpu_torch.utils.image import load_image

        shutil.rmtree(os.path.join(fcfg.out_dir, "result"))
        os.remove(os.path.join(fcfg.out_dir, "config.txt"))
        for f in counters.values():
            f.launches = 0
        rstate = fit_api.fit_take(dataclasses.replace(
            fcfg, max_iter=n_fit + 5, mp4_interval=2))
        torch.cuda.synchronize()
        resumed = {k: f.launches for k, f in counters.items()}
        n_prog = 3                      # after the resumed run's steps 0, 2, 4
        want = {k: 0 if k.startswith("mip") or k in SINGLE_VIEW_ONLY else 5
                for k in counters}
        for k in ("fused_raster", "antialias", "bin_place"):
            want[k] += n_prog
        if rstate.step != n_fit + 5 or resumed != want:
            fail(f"the resumed fit_take ended at step {rstate.step} with "
                 f"launches {resumed} != {want}")
        check_fit_outputs(fcfg, nv, nt, 4, "resumed fit_take")
        if not ckpt_mod.latest_checkpoint(fcfg.checkpoint_dir).endswith(
                f"step_{n_fit + 5:09d}.pt"):
            fail("the resumed fit_take left no step-25 checkpoint")
        prog = sorted(n for n in os.listdir(fcfg.out_dir)
                      if n.startswith("progress"))
        if prog != [f"progress_{i:05d}.png" for i in range(n_prog)]:
            fail(f"mp4_interval wrote {prog}")
        for name in prog:
            png = load_image(os.path.join(fcfg.out_dir, name))
            if (png.shape != (H, 2 * W, 1) or not np.array_equal(
                    png[:, :W, 0], np.clip(written[0, 0], 0, 140))
                    or not (png[:, W:] != 45).any()):
                fail(f"progress frame {name} is {png.shape}, its reference "
                     "half differs from the take's or it shows no mesh")
        print(f"fit_take resumed from step {n_fit} to {rstate.step}; "
              f"launches {resumed}; progress frames {prog}", flush=True)

        # ---- 5d. the single view at full width, and the result renderers
        # over the fitted take ----
        record["single_view"] = single_view(
            wl, counters, gen, (fcfg, paths, written, tmp))
    record.update(fit_take_s=fit_s, fit_take_ms_per_step=fit_ms,
                  fit_take_launches=fit_launches, fit_take_losses=losses,
                  fit_take_pair_cap=cap, fit_take_live_pairs=live0)

    # ---- 6. kernels at the main path's shapes ----
    bins = sstate["bins"]
    tex = params["tex"].detach()
    C = tex.shape[2]
    ph, pw = rc.pad_resolution(H, W)
    rows = B * ph
    with torch.no_grad():
        k1_err, k2_err, k1_out = check_kernels(bins, tex, rows, pw, H, W,
                                               ph, "bench batch")
        idbuf, entry, payload, extra, colour = k1_out
        g_aa = sstate["g_aa"]
        gtuv = torch.zeros((3, rows, pw), device=dev)
        berr, babs, (k3, k4, k5, _, gpl) = check_backward(
            k1_out, bins, tex, g_aa, gtuv, H, W, ph, B * T, "bench batch")
        # the single view's planes (camera 0 of phase 5d), and the kernels
        # chip_turns.py times too
        bins1 = view_bins(wl)
        k1s = rc.fused_raster(bins1, tex, ph, pw)
        kp, cot = kernel_pairs(tex, k1_out, g_aa, k1s, H, W, ph)
        gcolour = cot["gcolour"]
        t = {
            "fused_raster": (
                lambda: rc.fused_raster(bins, tex, rows, pw),
                lambda: rc.fused_raster_plain(bins, tex, rows, pw)),
            **{k: kp[k] for k in ("antialias", "antialias_bwd", "texture_bwd",
                                  "texture_fwd")},
            "pixel_grad": (
                lambda: gc.pixel_grad(bins, entry, payload[0], payload[1],
                                      extra, gpl),
                lambda: gc.pixel_grad_plain(bins, entry, payload[0],
                                            payload[1], extra, gpl)),
            "fold_entries": (
                lambda: gc.fold_entries(*k5, bins, B * T),
                lambda: gc.fold_entries_plain(*k5, bins, B * T)),
        }
        # K8 and K9 at the mip step's shapes, on K3's colour cotangent (the
        # inputs chip_turns.py times too)
        mg = mstage["k3"][0]
        _, mabs, _ = check_mip(mstage["k1"], pm["tex"].detach(), mg, None, H,
                               W, ph, "bench batch, mip")
        mpairs, (pyr, sizes, lam) = mip_kernel_pairs(
            mstage["k1"], pm["tex"].detach(), mg, H, W, ph)
        t.update(mpairs)
        # K7 and K10 at the single view's shapes
        _, e10 = check_aa_fused(bins1, tex, ph, pw, H, W, ph, k1s,
                                "single view")
        _, e7 = check_texture(k1s, tex, torch.randn(
            k1s[4].shape, device=dev, generator=gen), gen, "single view")
        tu1, tv1 = k1s[2][3], k1s[2][4]
        t["fused_raster_aa"] = (
            lambda: rc.fused_raster_aa(bins1, tex, ph, pw, H, W, ph),
            lambda: rc.fused_raster_aa_plain(bins1, tex, ph, pw, H, W, ph))
        # K7's and K4's clamp modes beside their library calls; K1 and K2
        # at the single view
        lib = ("texture_fwd", "texture_fwd_clamp", "grid_sample",
               "texture_bwd_clamp", "grid_sampler_2d_backward")
        sv_fns = {**{k: kp[k][0] for k in lib},
                  "fused_raster": lambda: rc.fused_raster(bins1, tex, ph, pw),
                  "antialias": lambda: ac.antialias_planes(
                      k1s[0], k1s[2], k1s[4], H, W, ph)}
        single = {f"{k}_ms": cuda_ms(f, 20) for k, f in sv_fns.items()}
        single.update({f"{k}_device_ms": device_ms(sv_fns[k], 20)
                       for k in lib})
        single.update(
            grid_sample_vs_clamp_max_abs=max_err(
                sv_fns["grid_sample"]()[0], sv_fns["texture_fwd_clamp"]()),
            grid_sample_bwd_vs_k4_clamp_gtex_max_abs=max_err(
                sv_fns["grid_sampler_2d_backward"]()[0][0].permute(1, 2, 0),
                sv_fns["texture_bwd_clamp"]()[0]))
        # where K7's event time goes: the host's issue of one call, and of
        # its parts
        single["host_issue_us"] = {
            "texture_fwd": host_us(sv_fns["texture_fwd"], 200),
            "grid_sample": host_us(sv_fns["grid_sample"], 200),
            "torch.empty": host_us(lambda: torch.empty((C, ph, pw),
                                                       device=dev), 200),
            "current stream": host_us(lambda: build.stream(dev), 200)}
        record["single_view_kernels"] = single
        print(f"single view kernels (CUDA events, ms; device ms by the "
              f"profiler): {single}", flush=True)
        # K11 on the step's batch: exact at three caps, timed at the
        # autotuned one
        tile_ids, n_tiles, Ps, live11 = check_place(
            sstate["pc"], scene.faces, H, W, config.pair_cap, "bench batch")
        P = Ps["autotuned"]
        t["bin_place"] = (lambda: bp.place_pairs(tile_ids, n_tiles, P),
                          lambda: bp.place_pairs_plain(tile_ids, n_tiles, P))
        times = {name: (cuda_ms(kf, 20), cuda_ms(pf, 2))
                 for name, (kf, pf) in t.items()}
        k3_device = device_ms(t["antialias_bwd"][0], 20)
        k3_host = host_us(t["antialias_bwd"][0], 20)
        k3_bytes, k3_occ, k3_sectors = k3_design_bytes(idbuf, payload, C, H,
                                                       W, ph)
        record.update(antialias_bwd_device_ms=k3_device,
                      antialias_bwd_host_issue_us=k3_host,
                      antialias_bwd_design_bytes=k3_bytes,
                      antialias_bwd_occluders=k3_occ,
                      antialias_bwd_occluder_sectors=k3_sectors)
        print(f"K3 at the bench batch: {times['antialias_bwd'][0]:.4f} ms "
              f"(CUDA events), {k3_device:.4f} ms of device work, "
              f"{k3_host:.1f} us of host issue a call; its design moves "
              f"{k3_bytes / 1e6:.1f} MB "
              f"({k3_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms at "
              f"{HBM_BYTES_PER_S / 1e12} TB/s): {k3_occ} occluder "
              f"pixels in {k3_sectors} sectors a plane", flush=True)
        # K2 at the bench batch: device time and the bytes its design moves
        k2_device = device_ms(t["antialias"][0], 20)
        k2_bytes, k2_occ, k2_sectors = k2_design_bytes(idbuf, payload, C, H,
                                                       W, ph)
        # K4 at the bench batch: what its live pixels touch, the reductions
        # its design issues, and its time again with the cotangent of the
        # live pixels at uv (0, 0) zeroed (an input change: what the
        # missed pixels' hot spot costs)
        tu_b, tv_b = payload[3], payload[4]
        live4 = (gcolour != 0).any(dim=0)
        at0 = live4 & (tu_b == 0) & (tv_b == 0)
        texels4 = int(torch.unique(texel_taps(
            tu_b[live4], tv_b[live4], tex.shape[0], tex.shape[1],
            "wrap")[0]).numel())
        k4_reductions, k4_warps = k4_design_reductions(tex.shape, tu_b,
                                                       tv_b, gcolour)
        g_cold = gcolour * ~at0

        def k4_cold():
            return tc.texture_planes_bwd(tex, tu_b, tv_b, g_cold)

        k4_diag = {
            "live_px": int(live4.sum()), "live_px_at_uv_00": int(at0.sum()),
            "texels_touched": texels4,
            "design_reductions": k4_reductions,
            "design_groups_summed": k4_warps,
            "one_thread_a_pixel_reductions": 4 * C * int(live4.sum()),
            "ms": times["texture_bwd"][0],
            "device_ms": device_ms(t["texture_bwd"][0], 20),
            "uv_00_zeroed_ms": cuda_ms(k4_cold, 20),
            "uv_00_zeroed_device_ms": device_ms(k4_cold, 20)}
        # the hot spot alone: a cotangent on every missed pixel of the
        # single view (all at uv (0, 0)), wrap and clamp, checked too
        g_hot = cot["g_hot"]
        for mode in ("wrap", "clamp"):
            k4_hot, k4_hot_plain = kp[f"texture_bwd_hot_{mode}"]
            got, want = k4_hot(), k4_hot_plain()
            mag = tc.texture_planes_bwd_plain(tex, tu1, tv1, g_hot.abs(),
                                              mode)[0]
            e_uv = max(max_err(got[1], want[1]), max_err(got[2], want[2]))
            e_tex = atomic_err(got[0], want[0], mag)
            if not (e_uv <= K4_ATOL and e_tex <= ATOMIC_RTOL):
                fail(f"K4 {mode} on the missed pixels' hot spot differs "
                     f"from its plain version: gtu/gtv {e_uv}, gtex {e_tex}")
            k4_diag[f"hot_spot_{mode}"] = {
                "px": int((g_hot != 0).any(dim=0).sum()),
                "ms": cuda_ms(k4_hot, 20), "device_ms": device_ms(k4_hot, 20),
                "gtuv_max_abs_err": e_uv, "gtex_rel_err": e_tex}
        record.update(antialias_device_ms=k2_device,
                      antialias_design_bytes=k2_bytes,
                      antialias_occluders=k2_occ,
                      antialias_occluder_sectors=k2_sectors,
                      texture_bwd_diagnosis=k4_diag)
        print(f"K2 at the bench batch: {times['antialias'][0]:.4f} ms (CUDA "
              f"events), {k2_device:.4f} ms of device work; its design "
              f"moves {k2_bytes / 1e6:.1f} MB "
              f"({k2_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms): {k2_occ} "
              f"occluder pixels in {k2_sectors} sectors a plane", flush=True)
        print(f"K4 at the bench batch: {k4_diag}", flush=True)
        # K8 and K9 at the bench-mip batch: what they sample, the
        # reductions K9's design issues, and K9 without its reductions
        mtu, mtv = mstage["k1"][2][3], mstage["k1"][2][4]
        k9_diag = mip_level_counts(sizes, mtu, mtv, lam, mg)
        k9_red, k9_groups = k9_design_reductions(sizes, mtu, mtv, lam, mg)

        def k9_bare():
            return k9_unreduced(pyr, sizes, mtu, mtv, lam, mg)

        if not all(torch.equal(a, b) for a, b in zip(
                k9_bare()[1:], t["mip_sample_bwd"][0]()[1:])):
            fail("K9 without its reductions gives other gtu/gtv than K9")
        k9_diag.update(
            design_reductions=k9_red, design_groups_summed=k9_groups,
            one_thread_a_pixel_reductions=4 * mg.shape[0] * (
                k9_diag["live_px"] + k9_diag["blend_live_px"]),
            ms=times["mip_sample_bwd"][0],
            device_ms=device_ms(t["mip_sample_bwd"][0], 20),
            unreduced_ms=cuda_ms(k9_bare, 20),
            unreduced_device_ms=device_ms(k9_bare, 20),
            k8_ms=times["mip_sample"][0],
            k8_device_ms=device_ms(t["mip_sample"][0], 20))
        record["mip_sample_diagnosis"] = k9_diag
        print(f"K8 and K9 at the bench-mip batch: {k9_diag}", flush=True)
        # K11's library yardstick: torch.sort and torch.searchsorted of the
        # same keys (the calls it replaces)
        n_tri = B * T
        keys = (tile_ids.long() * n_tri + torch.arange(
            n_tri, device=dev).reshape(B, T, 1)).reshape(-1)
        bounds_k = torch.arange(n_tiles + 1, device=dev) * n_tri
        place_lib = cuda_ms(lambda: torch.searchsorted(
            torch.sort(keys)[0][:P], bounds_k), 20)
        # K11's device time alone: the host takes longer to launch its
        # kernels and small ops than the card takes to run them
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                bp.place_pairs(tile_ids, n_tiles, P)
            torch.cuda.synchronize()
        k11_dev = {name: ms / 20 for name, ms, _ in device_kernels(prof)}
        # the count step's two paths at this batch, in turns: the
        # shared-memory histogram K11 takes here, and one device-memory
        # atomic a slot, its path past the card's shared memory
        counts = bp.count_pairs(tile_ids, n_tiles)
        if not torch.equal(counts, bp.count_pairs(tile_ids, n_tiles, True)):
            fail("K11's two count paths disagree at the bench batch")
        count_ev = {False: [], True: []}
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for in_dev in (False, True, True, False):
                count_ev[in_dev].append(cuda_ms(
                    lambda: bp.count_pairs(tile_ids, n_tiles, in_dev), 50))
            torch.cuda.synchronize()
        count_dev = {name: ms / 102 for name, ms, _ in device_kernels(prof)
                     if "count" in name}
        print(f"K11 count step: shared-memory histogram {count_ev[False]} "
              f"ms, device-memory atomics {count_ev[True]} ms a call (CUDA "
              f"events, in turns); device ms a call: " + ", ".join(
                  f"{k[:30]} {v:.5f}" for k, v in count_dev.items()),
              flush=True)
        # the record gather of the binning, capped and uncapped
        rec = torch.cat([sstate["data_s"].detach(), sstate["aux_s"].detach()],
                        dim=-1).reshape(n_tri, rc.REC)
        gather = {}
        for name in ("autotuned", "uncapped"):
            tri = bp.place_pairs(tile_ids, n_tiles, Ps[name])[1]
            idx = torch.clamp(tri, max=n_tri - 1).long()
            gather[name] = cuda_ms(lambda: rec[idx], 20)
        print(f"K11 {times['bin_place'][0]:.4f} ms (plain "
              f"{times['bin_place'][1]:.4f}, torch.sort + searchsorted "
              f"{place_lib:.4f}); its device work "
              f"{sum(k11_dev.values()):.4f} ms a call: " + ", ".join(
                  f"{k[:40]} {v:.4f}" for k, v in k11_dev.items())
              + f"; record gather {gather['autotuned']:.4f} ms "
              f"at P = {Ps['autotuned']} against {gather['uncapped']:.4f} ms "
              f"uncapped (P = {Ps['uncapped']}); {live11} live", flush=True)
        record.update(gather_ms=gather, place_P=Ps, place_live=live11,
                      bin_place_device_ms=k11_dev,
                      bin_count_event_ms={"shared": count_ev[False],
                                          "device": count_ev[True]},
                      bin_count_device_ms=count_dev,
                      bin_place_design_bytes=k11_design_bytes(
                          tile_ids, n_tiles, P, live11))
        # the library yardstick of K6: one index_add_ of the live rows
        live = int(bins.bin_start[-1])
        idx = bins.sorted_tri[:live].long()
        src = k5[0][:live][:, gc.LIVE_SLOTS].contiguous()
        acc = torch.zeros((B * T, len(gc.LIVE_SLOTS)), device=dev)
        fold_lib = cuda_ms(lambda: acc.index_add_(0, idx, src), 20)
    bounds = {
        "fused_raster": k1_bound_ms(bins, rows, pw, C, tex)[:2],
        "antialias": k2_bound_ms(idbuf, payload, C, H, W, ph),
        "antialias_bwd": k3_bound_ms(idbuf, payload, C, H, W, ph),
        "texture_bwd": k4_bound_ms(gcolour, tex),
        "pixel_grad": k5_bound_ms(entry, bins),
        "fold_entries": k6_bound_ms(bins, B * T),
        "mip_sample": k8_bound_ms(lam, C, pyr, len(sizes)),
        "mip_sample_bwd": k9_bound_ms(lam, mg, pyr, len(sizes)),
        "bin_place": k11_bound_ms(tile_ids, n_tiles, P),
        "texture_fwd": k7_bound_ms(tex, tu1, tv1, "wrap"),
        "fused_raster_aa": k10_bound_ms(bins1, ph, pw, C, tex, k1s[0], H, W,
                                        ph),
    }
    # K11 equals its plain version exactly (check_place fails otherwise)
    errs = {"fused_raster": k1_err, "antialias": k2_err, **babs, **mabs,
            "bin_place": 0.0, "texture_fwd": e7, "fused_raster_aa": e10}
    library = {"fold_entries": fold_lib, "bin_place": place_lib,
               "texture_fwd": single["grid_sample_ms"],
               "texture_bwd": single["grid_sampler_2d_backward_ms"]}
    sv_launches = record["single_view"]["launches"]
    launches = {**launches, "mip_sample": mip_launches["mip_sample"],
                "mip_sample_bwd": mip_launches["mip_sample_bwd"],
                "texture_fwd": sv_launches["separate"]["texture_fwd"],
                "fused_raster_aa": sv_launches["aa_fused"]["fused_raster_aa"]}
    kernels = []
    for name, (src_file, tpu) in KERNELS.items():
        ms, plain = times[name]
        bound, by = bounds[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "fpc_diffrend_tpu_torch/" + src_file,
            "replaces": "fpc_diffrend_tpu/ops/pallas/" + tpu,
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": by,
            "library_ms": library.get(name)})
    # ---- 7. the step's gradients from run to run ----
    spread = grad_spread(wl)
    record["grad_spread"] = spread
    print(f"step gradients, 3 runs from one state: spread over the largest "
          f"magnitude {spread} (limit {GRAD_SPREAD_RTOL})", flush=True)
    record.update(kernels=kernels, backward_check=berr,
                  live_bin_entries=live, n_global=int(bins.n_global[0]),
                  total_s=time.perf_counter() - t_start)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "chip_smoke.json"),
              "w") as f:
        json.dump(record, f, indent=1)
    print(f"live bin entries {live}, n_global {record['n_global']}, "
          f"total {record['total_s']:.1f} s", flush=True)
    # after the record is written, so that a failing run keeps it
    if not all(math.isfinite(v) and v <= GRAD_SPREAD_RTOL
               for v in spread.values()):
        fail(f"the step's gradients spread past {GRAD_SPREAD_RTOL} of their "
             f"largest magnitude from run to run: {spread}")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
