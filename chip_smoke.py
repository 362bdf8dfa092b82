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
   version's order; only the gradient pyramid sums across pixels; K8
   deriving the LOD: its LOD plane equal to ``lod_from_texc``'s on the
   card and its colour to K8 fed that plane), K4's
   gtex (its texel shares summed in float64 and rounded once) each
   element within 1e-6 of the sum of the magnitudes it adds up, K9's
   gradient pyramid and K5's rows, whose atomics sum in another order,
   within 1e-5 of it, K6 (the fold) equal to its plain version exactly
   and bit for bit over two calls; and K11 (bin placement) equal to its
   plain version exactly
   (``bin_start``, ``sorted_tri``) uncapped, at the autotuned entry cap and
   at a cap of half the live entries, which drops entries; then K11, K6,
   K2, K10, K4, K8 and K9 where the bench's shapes do not take them
   (``check_fold_edges``: P = 0, a cap that cuts a bin, every slot dead,
   a full global list, triangles naming fewer than K tiles, global rows,
   B = 1, with NaN rows past the live prefix and past n_global;
   ``check_place_edges``: P = 0, every slot dead, one live triangle, P
   inside the first bin, P equal to the live entries, a 6,000-entry bin,
   70,000 tiles; ``check_k2_edges``, ``check_k10_edges``,
   ``check_k4_edges``, ``check_mip_edges``: ragged tiles, padding rows
   between samples, three channels; for K10 C = 1 to 4, a partial last
   tile column, empty bins and silhouettes across tile rows and columns,
   equal to K1 + K2 exactly; for K4 every pixel at uv (0, 0), the wrap
   edge, random and minified uv, part warps, a zero cotangent; for K8 and
   K9 three channels, a chain of no power-of-two sides, a one-level chain,
   planes of a pixel count no multiple of 4 and unaligned ones, every
   pixel at uv (0, 0), random and minified uv over a random LOD, a zero
   cotangent; ``check_mip_lod``: K8 deriving the LOD on synthetic id and
   uv planes of three samples with padding rows and columns, missed
   pixels and ids across the seams, at the face9-mip batch's 36 x
   1200 x 1664 planes, at a width no multiple of 4 and on unaligned
   planes, its LOD equal to ``lod_from_texc``'s and its colour to K8 fed
   that plane);
4. the forward at full width: the benchmarked workload (1600x1200, 29,768
   triangles, 1024^2 texture, batch 8, 3 cameras, 4 frames, free mode,
   Laplacian 1.0, the entry cap autotuned with no K11 launch) through
   ``fit.loop.evaluate``: 1 warm-up batch, then 5 timed batches with the
   launch counters set to 0 just before; the losses must be finite and K1,
   K2 and K11 launched once per batch (K7 and K10 never: they run on the
   single view only);
4b. each position of a stacked batch of 8 of the workload's samples
   against the same sample rendered alone (B = 1), bilinear and mip,
   uncapped (``stack_positions``): the images equal bit for bit, each
   clip gradient within ``GRAD_SPREAD_RTOL`` of its largest magnitude;
5. the fit step at full width through ``fit.loop.train_steps``: 1 warm-up
   dispatch of 5 steps under ``torch.cuda.set_sync_debug_mode("error")``
   (a host sync on the step's path fails it), then 2 timed dispatches of 5
   with the launch counters set to 0 just before, which must launch
   nothing from the host (every step a replay of the step's CUDA graph),
   and one more dispatch whose kernels ``ops.cuda.device_launches``
   measures on the device; every loss term and parameter must be finite
   and each of K1-K6 and K11 run once per step (K8, K9 never); the same
   steps uncapped, for information; then each stage's device time in one
   eager step, by the program's spans (``step_span_ms``);
5b. the mip path at full width: the same workload with trilinear mipmap
   sampling (``enable_mip``, ``max_mip_level=6``: 7 levels, 1024..16),
   5 batches through ``fit.loop.evaluate`` (K1, K8, K2 once per batch;
   ``mip.lod_fused`` every stacked pixel of each batch; one kernel on the
   device between K1 and K2, K8, where the LOD's torch passes and K8 ran
   70) and
   2 timed dispatches of 5 steps through ``fit.loop.train_steps`` after a
   warm-up dispatch under sync-debug "error", replays all, then one
   measured as in 5 (K1, K2, K3, K5, K6, K8, K9, K11 once per step on the
   device, K4 never), finite; then its stage times by span;
5c. ``fit.api.fit_take`` at full width: the bench dome, eight blendshapes,
   the three cameras' calibration and 3 x 4 frames of 1600x1200 as
   uncompressed TIFFs written to a temporary take; a prior-mode fit of 20
   steps (batch 8, 1024^2 texture, log every 5, checkpoint every 10) must
   read its data through the native runtime, load the frames back clipped
   and flipped, autotune the cap, run K1-K6 and K11 once per step on the
   device (measured as in 5), return its state without the step's CUDA
   graph, keep a finite loss and write metrics.jsonl, result/{0..3}.obj,
   texture.png,
   pose.json and config.txt that parse; a second fit_take to 25 steps must
   resume from the checkpoint, end at step 25 and write them again, and
   with ``mp4_interval=2`` write three progress frames (camera 0, frame 0
   beside its reference TIFF) that parse;
5d. the single view at full width: ``ops.pipeline.render`` of the bench
   dome through each of the bench's 3 cameras on each route ("sepaa":
   K1 -> K2; "aa_fused": K10; "separate": K1 -> K7 -> K2), forward and
   then forward + backward to the vertices and the texture (the first
   backward of each route under sync-debug "error"); the routes' images
   within 1e-6 of each other, their texture gradients, and each route's
   against itself, within ``K4_GTEX_RTOL`` (1e-6) of the largest
   magnitude, their vertex gradients, and each route's against itself,
   within ``GRAD_SPREAD_RTOL`` of it (atomics reorder the sums: the limit
   of phase 7); K10 launched once per
   render on "aa_fused" only, K7 on "separate" only; ms per render (CUDA
   events, host clock, and the device's work by the profiler); then
   ``tools.render_result`` over 5c's fitted take (4 frames, a grid of the
   3 cameras, and side by side with reference TIFFs the phase writes) and
   ``tools.simple_render`` of one camera, whose PNGs must parse;
5e. the nvdiffrast-style primitives at full width: on the bench dome
   through each camera, ``ops.rasterize.rasterize(with_db=True)`` (K11,
   K1 without its texture tail) -> ``ops.interpolate.interpolate(...,
   "all")`` -> ``ops.texture.texture`` (K7) -> ``ops.antialias.antialias``
   (K2 on the winner planes gathered from rast) -> composite, forward and
   forward + backward (K3, K4, K5 with live u, v, z cotangents, K6; the
   first under sync-debug "error"), each of K11, K1, K7, K2 launched once
   a forward and K3-K6 once a backward; held to ``render(route=
   "separate")`` within JAX's limits between two renderers, K5 on the
   composition's cotangents (its instance that reads u, v, z:
   ``k5.uvz_skipped`` 0) and K2/K3 on the gathered planes against
   their plain versions; ms per view beside the "separate" route, for
   information. Then the scan route at mid size (phase 3's B = 1 slice):
   the visibility scan's ids against K1's, the route on the card against
   the CPU, against the kernel route at a resolvable depth range, and one
   scan ``train_step`` (``scan_route``); seconds per view;
5f. the fit examples (``fpc_diffrend_tpu_torch/examples``) at their own
   widths through ``run_fit`` and ``fit_take`` (``examples_phase``):
   ``fit_cube`` (128^2, 300 steps, the 12-triangle cube in the global
   list; its exit rule), ``fit_rig_synthetic`` (256^2, 300 steps, a take
   of the synthetic 9-camera rig written to disk and fitted by
   ``fit_take``; each camera's coverage in [0.05, 0.95], "RECOVERING",
   the result files parse) and the convergence study (512^2, 9 cameras, 4
   frames, 2,000 steps at batch 8 and at batch 1; each batch's logged
   losses finite, its final loss below its first logged one, its pose
   error below its start); K1-K6 and K11 launched from the host once in
   each eager step and capture of each fit, the other steps replays; after
   each fit, one step's inputs of it (the cube's and the rig's fitted
   parameters, the study's init at batch 8 and at batch 1, each at its
   own entry cap, with the batch its first step samples and the step's
   own cotangent) held through K1-K6 and K11 against their plain
   versions at phase 3's limits (``check_fit_step``), the cube's with
   triangles in the global list; ms per step of each; JAX's "CONVERGED"
   rule printed beside JAX's recorded table, not gated;
6. each kernel at the main path's shapes (K7, K10: the single view's; K8,
   K9: the mip path's; K11 the step's batch at the autotuned cap, checked
   also uncapped and at half the live entries) against its plain version
   (K2, K3, K4 and K7 on the inputs of ``kernel_pairs``, which
   ``chip_turns.py`` times too), with its time, the plain version's time, the library call's time where
   one computes the same function, and its bound, printed as one
   ``{"kernels": [...]}`` line of all eleven; beside it K11's device time
   by kernel, its host issue of one call, the slots, tiles and largest and
   mean bin, and the traffic and launches of its design
   (``k11_design_bytes``), the record gather's time capped and uncapped,
   K11's count step by its shared-memory histogram against device-memory
   atomics, in turns; K6's device time and the traffic, search probes and
   found rows of its design (``k6_design_bytes``) beside the time of
   ``index_add_`` of the live rows, and K5 then K6 at the single view
   (B = 1), K6 exactly its plain version; at the single view K10's
   kernels' device time
   beside the "sepaa" route's K1 and K2, and its design's traffic and
   pair evaluations (``k10_design_bytes``); K3's
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
   timed); K8's (deriving the LOD; its plain version ``lod_from_texc``
   then ``mip_sample_plain``) and K9's at the bench-mip batch
   (``mip_kernel_pairs``,
   which ``chip_turns.py`` times too: the pixels of each level, those that
   blend a second one, the live pixels and those at uv (0, 0), the
   distinct texels of each level, the reductions K9's design issues, and
   K9's time with its reductions left out); K5 in both its instances at
   the bench batch (without u, v, z planes, as the backward runs it, and
   with them on zero planes), each by events and device time beside its
   bound (76 and 88 bytes a covered pixel);
6b. K5 at the b36 cells' batch (B = 36, bilinear and mip) on one step's
   own inputs (``k5_instances``): the instance without u, v, z planes
   against the one fed zero planes, exact and fast, bit for bit where K5
   repeats itself bit for bit and within ``ATOMIC_RTOL`` always, and
   ``k5.uvz_skipped`` of one recorded eager step over its stacked pixels
   (1.0);
7. one bench step's forward and backward three times from the same state
   on the same batch: every parameter gradient must spread by at most
   ``GRAD_SPREAD_RTOL`` of its largest magnitude (the atomic sums' order:
   K5's, the setup chain's), and the texture's, K4's float64 sums rounded
   once on a deterministic cotangent, must be bit-equal (checked after
   the record is written);
8. the sharded fit step (``fpc_diffrend_tpu_torch/parallel``) at the
   bench workload's full width (``sharded_phase``): 8a, world size 1 on
   NCCL, mesh (1, 1, 1): the sharded step and ``fit.loop.train_step``
   from one state on the bench batch, losses within 1e-6 relative, every
   gradient within ``GRAD_SPREAD_RTOL`` of its largest magnitude, K11 and
   K1-K6 once in the sharded step, then both timed in turns; 8b, four
   gloo ranks sharing the card (processes this script starts with
   ``--sharded-rank``, after the parent's build, each with its own
   timeout), mesh (2, 1, 2), ``shard_frames`` and the temporal term, 4
   samples and 600 rows a rank: the global loss within 2e-4 of the
   single-process step's, the summed gradients (frame shards gathered)
   within ``GRAD_SPREAD_RTOL``, K11 and K1-K6 once on every rank; 8c,
   mesh (1, 1, 4): one view in four 300-row bands (K11, K1, K2 once a
   rank) stitched against the full-frame render within 2e-3, and the
   count of values that differ by more than 1e-5;
9. the host tools (``tools_phase``, run after 5d while 5c's take is on
   disk): ``tools.undistort.undistort_image_torch`` over the take's 12
   frames on the card against the CPU and ``cv2.undistort``, a
   ``data.seq`` round trip, ``tools.comparisons`` on 5d's renders;
10. the bench entry point and the gradient-precision modes
   (``precision_phase``): 10a, at the bench step's inputs (phase 5's
   stages), K4's "fast" and "fast2" (wrap and clamp) and K5's "fast"
   against their plain versions at phase 3's limits, each unlike the exact
   kernel's output, then every mode of K4 and K5 timed in turns
   (``precision_pairs``, which ``chip_turns.py --paths prec`` times too);
   10b, ``bench_matrix --quick`` (``fpc_diffrend_tpu_torch/
   bench_matrix.py``) over its five rows in the exact mode and the
   headline row in JAX's default modes (grad "fast", tex "fast2"): each
   line parses with a finite Mpix/s, K11 and K1-K6 once a timed step (K8
   and K9 in place of K4 on the mip row), the temporal row's temporal term
   nonzero; after each of the three rows at shapes no earlier phase
   checks (256^2 one camera, 512^2 nine cameras, 512^2 two cameras and
   100 frames), K1-K6 and K11 against their plain versions on one step's
   inputs of its fitted state (``check_fit_step``); 10c, the precision
   study (``examples/precision_study.py``, 512^2, 9 cameras) at 300 steps
   under "exact", "fast" and "fast2": each config's final loss below its
   first logged loss, its pose error below its start (JAX's verdict
   printed, not gated), then K1-K6, K11 and the fast K4 and K5 variants
   on one step's inputs of the study's fit. The counters are set to 0
   after each check.

Each phase prints its seconds.

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
LOD_ULP = 0                    # K8's LOD: lod_from_texc's order and log2f
K9_ATOL = 1e-6                 # gtu, gtv: each pixel's own sums, in order
ATOMIC_RTOL = 1e-5             # gpyr, K5 rows: atomics reorder sums
# K4's gtex, of the summed magnitudes: its texel shares add in float64 and
# round once, so their order moves the result by far less than an ulp
K4_GTEX_RTOL = 1e-6
K10_ATOL = 1e-6                # aa against K2 on the same planes
MAX_MIP_LEVEL = 6              # the mip path's chain: 1024^2 .. 16^2
# gradients from run to run (phases 5d and 7): the sums that atomics take
# in another order each run (K5, the setup chain's index backward; K4's
# texel sums are float64, rounded once) may spread by this much of a
# gradient's largest magnitude.
# Screen-space terms cancel, so an element's rounding reaches 1e-3 to
# 1.5e-3 of the largest in some runs on the H100 (a vertex gradient, the
# free mode's m3); the limit is ~7x that. The reference nvdiffrast sums
# with atomics too; a fixed order is a TPU layout's, not the function's.
GRAD_SPREAD_RTOL = 1e-2
ROUTES = ("sepaa", "aa_fused", "separate")   # the single view's kernels
N_VIEWS = 3                    # the bench's cameras, one view each


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


def device_profile():
    """A ``torch.profiler`` session for the device's work. It traces the
    host as well: on the H100, sessions that traced only the device
    dropped kernels (one of ten launches of a fixed sequence, or all
    ten), sessions that traced both never did."""
    import torch

    acts = torch.profiler.ProfilerActivity
    return torch.profiler.profile(activities=[acts.CPU, acts.CUDA])


def device_kernels_ms(fn, reps: int) -> dict:
    """Device time of fn() a call by kernel: {kernel or memset name: the
    self time it ran, by the profiler, over reps calls after one warm-up}."""
    import torch

    from fpc_diffrend_tpu_torch.ops.cuda import device_events

    fn()
    torch.cuda.synchronize()
    with device_profile() as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {name: ms / reps for name, ms, _ in device_events(prof)}


def device_ms(fn, reps: int) -> float:
    """Device time of fn() a call: the self time of every kernel and memset
    it ran (:func:`device_kernels_ms`; the event times of :func:`cuda_ms`
    read the host's issue where that is slower)."""
    return sum(device_kernels_ms(fn, reps).values())


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


def device_kernel_launches(fn) -> dict:
    """The kernels, copies and memsets one call of fn() runs on the
    device, after one warm-up: {name: launches}, by the profiler."""
    import torch

    from fpc_diffrend_tpu_torch.ops.cuda import device_events

    fn()
    torch.cuda.synchronize()
    with device_profile() as prof:
        fn()
        torch.cuda.synchronize()
    return {name: n for name, _, n in device_events(prof)}


def step_inputs(wl, backward: bool = True) -> dict:
    """The fit step's kernels' inputs on a workload's first batch
    (``wl["batch"]``), for kernels checked or timed alone: the clip
    positions, ``bin_stacked``'s bins and K1's planes (``fused_raster``,
    without its texture tail on the mip path); with ``backward``, the
    cotangent of the program's own pass's antialiased output
    (``rasterize_textured_sepaa_stacked``) from the step's loss
    (``torch.autograd.grad``), then K3 on it (on K8's colour on the mip
    path), K4 (K9) and K5 on their outputs with no u, v, z cotangent, as
    the backward runs it.

    :return: {"pc", "data_s", "aux_s" (the records), "bins", "k1"; with
        ``backward`` also "g_aa", "k3" (gcolour, gverts), "k5_cot" (K5's
        cotangent arguments (gtu, gtv, gcorners, guvz), guvz None), "k5"}.
    """
    import torch

    from fpc_diffrend_tpu_torch.fit import loop
    from fpc_diffrend_tpu_torch.ops.cuda import antialias_cuda as ac
    from fpc_diffrend_tpu_torch.ops.cuda import raster_grad_cuda as gc
    from fpc_diffrend_tpu_torch.ops.cuda import rasterize_cuda as rc
    from fpc_diffrend_tpu_torch.ops.cuda import texture_cuda as tc
    from fpc_diffrend_tpu_torch.ops.cuda import texture_mip_cuda as tmc
    from fpc_diffrend_tpu_torch.ops.pipeline import composite_stacked
    from fpc_diffrend_tpu_torch.ops.rasterize import (
        bin_stacked, rasterize_textured_sepaa_stacked)
    from fpc_diffrend_tpu_torch.ops.texture_mip import mip_pyramid

    config, scene, batch = wl["config"], wl["scene"], wl["batch"]
    H, W, B = wl["H"], wl["W"], wl["B"]
    ph, pw = rc.pad_resolution(H, W)
    params = {k: v.detach() for k, v in wl["params"].items()}
    tex, mip = params["tex"], config.enable_mip
    scene_args = (scene.faces, scene.uv, scene.uv_idx)
    with torch.no_grad():
        pc, v3 = loop.sample_clip_positions(config, scene, params,
                                            batch.cam_idx, batch.frame_idx)
        data_s, aux_s, bins = bin_stacked(pc, *scene_args,
                                          scene.face_neighbors, (H, W),
                                          config.pair_cap)
        k1 = rc.fused_raster(bins, None if mip else tex, B * ph, pw)
    out = {"pc": pc, "data_s": data_s, "aux_s": aux_s, "bins": bins,
           "k1": k1}
    if not backward:
        return out
    idbuf, aa = rasterize_textured_sepaa_stacked(
        pc.clone().requires_grad_(True), *scene_args, tex,
        scene.face_neighbors, (H, W), pair_cap=config.pair_cap,
        enable_mip=mip, max_mip_level=config.max_mip_level)
    loss = loop.loss_from_render(config, scene, params, batch,
                                 composite_stacked(idbuf, aa, B, (H, W)),
                                 v3)[0]
    g_aa, = torch.autograd.grad(loss, aa)
    with torch.no_grad():
        idbuf, entry, payload, extra, colour = k1
        tu, tv = payload[3], payload[4]
        if mip:
            pyr, sizes = mip_pyramid(tex, config.max_mip_level)
            colour, lam = tmc.mip_sample_lod(pyr, sizes, tu, tv, idbuf, H, W,
                                             ph)
        k3 = ac.antialias_planes_bwd(idbuf, payload, colour, g_aa, H, W, ph)
        _, gtu, gtv = (tmc.mip_sample_bwd(pyr, sizes, tu, tv, lam, k3[0])
                       if mip else tc.texture_planes_bwd(tex, tu, tv, k3[0]))
        cot = (gtu, gtv, k3[1], None)
        k5 = gc.pixel_grad(bins, entry, payload[0], payload[1], extra, *cot)
    return dict(out, g_aa=g_aa, k3=k3, k5_cot=cot, k5=k5)


def k5_planes(gpl):
    """K5's cotangent arguments (gtu, gtv, gcorners, guvz) as views of
    one (11, rows, pw) stack ``gpl`` of payload cotangents in the payload's
    order (``rasterize_cuda.PAY_*``)."""
    from fpc_diffrend_tpu_torch.ops.cuda import rasterize_cuda as rc

    return gpl[rc.PAY_TU], gpl[rc.PAY_TV], gpl[rc.PAY_CORNERS], gpl[rc.PAY_UVZ]


def step_span_ms(config, scene, state, batch) -> dict:
    """Each span's device ms in one eager fit step (``fit.loop.
    train_step`` on ``batch``) after a warm-up step: the program's spans
    recorded (``utils.profiling.recording``) in a ``torch.profiler``
    trace, each given the device time of the kernels launched inside it
    (``profile_forward.span_device_us``; the trace is removed)."""
    import torch

    from fpc_diffrend_tpu_torch.fit import loop
    from fpc_diffrend_tpu_torch.profile_forward import traced
    from fpc_diffrend_tpu_torch.utils.profiling import recording

    out = os.path.join(REPO, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with recording():
        loop.train_step(config, scene, state, batch)
        torch.cuda.synchronize()
        _, _, span_us = traced(
            lambda: loop.train_step(config, scene, state, batch),
            os.path.join(out, "chip_smoke_step.trace.json"))
    return {k: us / 1e3 for k, us in span_us.items()}


def mip_kernels_between(wl, cpu_gen):
    """What the mip forward runs on the device between K1 and K2, on the
    workload's first batch (:func:`step_inputs`): K8 deriving
    the LOD, one launch of ``mip_fwd_kernel`` (``ops.cuda.
    device_launches``), against the LOD's torch passes then K8 on a given
    plane, as the step ran them before; and ``mip.lod_fused`` of one
    ``fit.loop.evaluate`` batch against its stacked pixels. Fails unless
    exactly one kernel runs and the counter reads every pixel.

    :return: {"kernels": launches of K8 deriving the LOD (all device
        work), "torch_lod_then_k8": of the torch passes then K8,
        "lod_fused_share": the counter over the batch's stacked pixels}.
    """
    import torch

    from fpc_diffrend_tpu_torch.fit import loop
    from fpc_diffrend_tpu_torch.ops.cuda import device_launches
    from fpc_diffrend_tpu_torch.ops.cuda import rasterize_cuda as rc
    from fpc_diffrend_tpu_torch.ops.cuda import texture_mip_cuda as tmc
    from fpc_diffrend_tpu_torch.ops.texture_mip import mip_pyramid
    from fpc_diffrend_tpu_torch.utils.profiling import recording

    H, W = wl["H"], wl["W"]
    ph, pw = rc.pad_resolution(H, W)
    idbuf, _, payload, _, _ = step_inputs(wl, backward=False)["k1"]
    with torch.no_grad():
        pyr, sizes = mip_pyramid(wl["params"]["tex"].detach(),
                                 wl["config"].max_mip_level)

        def k8():
            return tmc.mip_sample_lod(pyr, sizes, payload[3], payload[4],
                                      idbuf, H, W, ph)

        def torch_lod_then_k8():
            lam = tmc.lod_from_texc(payload[3], payload[4], idbuf,
                                    *sizes[0], H, W, ph)
            return tmc.mip_sample(pyr, sizes, payload[3], payload[4], lam)

        got = device_kernel_launches(k8)
        before = device_kernel_launches(torch_lod_then_k8)
        with device_launches() as named:
            k8()
    with recording() as log:
        loop.evaluate(wl["config"], wl["scene"], wl["params"],
                      wl["frames_u8"], 1, cpu_gen)
    share = log.counters.get("mip.lod_fused", 0) / (wl["B"] * ph * pw)
    out = {"kernels": got, "torch_lod_then_k8": before,
           "lod_fused_share": share}
    if sum(got.values()) != 1 or named["mip_fwd_kernel"] != 1 or share != 1:
        fail(f"mip: K8 deriving the LOD is not the one kernel between K1 "
             f"and K2, or mip.lod_fused missed pixels: {out}")
    return out


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


def k5_instances(dev, mip: bool) -> dict:
    """K5 at the b36 cells' batch (B = 36 at 1600x1200, bilinear or mip)
    on one step's own inputs (:func:`step_inputs`), its two instances
    against each other (:func:`check_k5_instances`), and
    ``k5.uvz_skipped`` over the stacked pixels of one recorded eager step
    (``fit.loop.train_step``): 1.0, else fails.

    :return: {"uvz_skipped_share", "exact", "fast"}.
    """
    import torch

    from fpc_diffrend_tpu_torch.fit import loop
    from fpc_diffrend_tpu_torch.ops.cuda import rasterize_cuda as rc
    from fpc_diffrend_tpu_torch.utils.profiling import recording
    from fpc_diffrend_tpu_torch.workload import build_workload

    label = "B = 36, mip" if mip else "B = 36"
    wl = build_workload(batch=36, mip=mip, device=dev)
    ph, pw = rc.pad_resolution(wl["H"], wl["W"])
    with recording() as log:
        loop.train_step(wl["config"], wl["scene"], wl["state"], wl["batch"])
        torch.cuda.synchronize()
    share = log.counters.get("k5.uvz_skipped", 0) / (wl["B"] * ph * pw)
    if share != 1.0:
        fail(f"{label}: k5.uvz_skipped reads {share} of the stacked pixels")
    out = check_k5_instances(step_inputs(wl), label)
    return dict(out, uvz_skipped_share=share)


def check_k5_instances(state, label, plain=False) -> dict:
    """K5's instance that the backward runs, which reads no u, v, z plane,
    against the instance fed zero planes, which reads them as the backward
    staged them before K5 read its planes in place, on one step's inputs
    (:func:`step_inputs` ``state``), exact and fast, three calls of each:
    some call of one bit for bit some call of the other wherever a call
    repeats another of its instance bit for bit, and within
    ``ATOMIC_RTOL`` of the summed magnitudes always (its atomics may add
    in another order from call to call); with ``plain`` also against its
    plain version within ``ATOMIC_RTOL``. Fails otherwise.

    :return: {"exact", "fast": {"bit_equal", "repeat_bit_equal", "rel",
        "repeat_rel"[, "plain_rel"]}}.
    """
    import torch

    from fpc_diffrend_tpu_torch.ops.cuda import raster_grad_cuda as gc

    bins = state["bins"]
    _, entry, payload, extra, _ = state["k1"]
    args = (bins, entry, payload[0], payload[1], extra,
            *state["k5_cot"][:3])
    zeros = torch.zeros((gc.N_UVZ,) + tuple(entry.shape),
                        device=entry.device)
    live = int(bins.bin_start[-1])

    def same(a, b):
        return torch.equal(a[0][:live], b[0][:live]) and torch.equal(a[1],
                                                                     b[1])

    def rel(a, b):
        return max(atomic_err(a[0][:live], b[0][:live], mag[0][:live]),
                   atomic_err(a[1], b[1], mag[1]))

    out = {}
    with torch.no_grad():
        mag = k5_magnitudes(*args)
        for fast in (False, True):
            runs = [(gc.pixel_grad(*args, None, fast),
                     gc.pixel_grad(*args, zeros, fast)) for _ in range(3)]
            torch.cuda.synchronize()
            skips, feds = zip(*runs)
            m = {"bit_equal": any(same(a, b) for a in skips for b in feds),
                 "repeat_bit_equal": any(
                     same(calls[i], calls[j]) for calls in (skips, feds)
                     for i in range(3) for j in range(i)),
                 "rel": max(rel(a, b) for a, b in runs),
                 "repeat_rel": max(rel(skips[0], a) for a in skips[1:])}
            if plain:
                m["plain_rel"] = rel(skips[0], gc.pixel_grad_plain(
                    *args, None, fast))
            out["fast" if fast else "exact"] = m
    print(f"K5 at {label}: without u, v, z planes against zero planes "
          f"read, {live} live rows: {out} (limit {ATOMIC_RTOL})", flush=True)
    if any(max(m["rel"], m.get("plain_rel", 0.0)) > ATOMIC_RTOL
           or (m["repeat_bit_equal"] and not m["bit_equal"])
           for m in out.values()):
        fail(f"{label}: K5 without u, v, z planes differs from K5 on zero "
             f"planes or from its plain version: {out}")
    return out


def k5_magnitudes(bins, entry, u, v, extra, gtu, gtv, gcorners,
                  guvz=None):
    """K5's rows summed over |coefficient| (the plain version's sums), on
    K5's arguments; a sample at a time, so that a batch of 36 fits."""
    import torch

    from fpc_diffrend_tpu_torch.ops.cuda import raster_grad_cuda as gc

    dev = entry.device
    ph, pw = bins.sample_ph, entry.shape[1]
    x = torch.arange(pw, device=dev) + 0.5
    y = (torch.arange(ph, device=dev) + 0.5)[:, None]
    ent = torch.zeros((bins.gbase, gc.REC), device=dev)
    glob = torch.zeros((gc.MAX_GLOBAL, gc.REC), device=dev)
    for r in range(0, entry.shape[0], ph):
        rows = slice(r, r + ph)
        coeff = gc.coefficient_planes(
            u[rows], v[rows], extra[:, rows], gtu[rows], gtv[rows],
            gcorners[:, rows], None if guvz is None else guvz[:, rows], x,
            y).abs()
        coeff = coeff.reshape(coeff.shape[0], -1).T
        e = entry[rows].reshape(-1).long()
        binned = (e >= 0) & (e < bins.gbase)
        ent.index_add_(0, e[binned], coeff[binned])
        ge = e >= bins.gbase
        glob.index_add_(0, e[ge] - bins.gbase, coeff[ge])
    return ent, glob


def check_backward(k1, bins, tex, g_aa, guvz, height, width, sample_ph,
                   n_tris, label):
    """K3-K6 against their plain versions on the same inputs.

    :param k1: K1's outputs; g_aa: (C, rows, pw) cotangent of K2's output;
    guvz: (3, rows, pw) cotangents of payload u, v, z for K5, or None (the
    main path: K5's instance that reads none). :return: (the checked
    errors, kernel name -> max abs error over its outputs, the kernels'
    outputs and K5's cotangent arguments).
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
            and errs["K4 gtex rel"] <= K4_GTEX_RTOL):
        fail(f"{label}: K4 differs from the plain version: {errs}")
    args5 = (bins, entry, payload[0], payload[1], extra, k4[1], k4[2],
             gverts, guvz)
    k5 = gc.pixel_grad(*args5)
    torch.cuda.synchronize()
    p5 = gc.pixel_grad_plain(*args5)
    m5 = k5_magnitudes(*args5)
    live = int(bins.bin_start[-1])
    errs.update({
        "K5 entries rel": atomic_err(k5[0][:live], p5[0][:live],
                                     m5[0][:live]),
        "K5 global rel": atomic_err(k5[1], p5[1], m5[1])})
    if not max(errs["K5 entries rel"], errs["K5 global rel"]) <= ATOMIC_RTOL:
        fail(f"{label}: K5 differs from the plain version: {errs}")
    k6 = check_fold(k5, bins, n_tris, label)
    errs["K6"] = 0.0                   # check_fold fails unless exact
    print(f"check {label}: backward max err {errs} (K4 gtex rel limit "
          f"{K4_GTEX_RTOL})", flush=True)
    abs_errs = {
        "antialias_bwd": max(errs["K3 gcolour"], errs["K3 gverts"]),
        "texture_bwd": max(errs["K4 gtu"], errs["K4 gtv"],
                           max_err(k4[0], p4[0])),
        "pixel_grad": max(max_err(k5[0][:live], p5[0][:live]),
                          max_err(k5[1], p5[1])),
        "fold_entries": 0.0}
    return errs, abs_errs, (k3, k4, k5, k6, args5[5:])


def check_fold(k5, bins, n_tris, label):
    """K6 on K5's rows ``k5`` against its plain version: equal exactly, and
    bit for bit over two calls on one input, each call one launch.

    :return: K6's output.
    """
    import torch

    from fpc_diffrend_tpu_torch.ops.cuda import raster_grad_cuda as gc

    before = gc.fold_entries.launches
    k6 = gc.fold_entries(*k5, bins, n_tris)
    again = gc.fold_entries(*k5, bins, n_tris)
    torch.cuda.synchronize()
    if gc.fold_entries.launches != before + 2:
        fail(f"{label}: K6 launched {gc.fold_entries.launches - before} "
             "times in two calls")
    p6 = gc.fold_entries_plain(*k5, bins, n_tris)
    if not torch.equal(k6, p6):
        fail(f"{label}: K6 differs from its plain version by "
             f"{max_err(k6, p6)}")
    if not torch.equal(k6.view(torch.int32), again.view(torch.int32)):
        fail(f"{label}: K6 differs from itself over two calls")
    return k6


# K6's edge cases (check_fold_edges, fold_case)
FOLD_EDGE_CASES = ("uncapped", "P = 0", "cap cuts a bin", "all dead",
                   "all dead, global list full", "global rows", "B = 1")


def fold_case(name, dev, seed=11):
    """K6's inputs in one edge case of :data:`FOLD_EDGE_CASES`, from a
    seed: 2 samples (1 for "B = 1") of 901 triangles over 150 tiles each;
    a live triangle names 1 to K tiles of its own sample, most fewer than
    K; placed by K11's plain version at a cap P; the global list holds
    triangles none of whose slots names a tile, ascending. The rows are
    normal draws, NaN past the live prefix and past ``n_global``: no fold
    may read them.

    :return: (grad_entries, grad_global, Bins, n_tris).
    """
    import numpy as np
    import torch

    from fpc_diffrend_tpu_torch.ops.cuda import bin_place_cuda as bp
    from fpc_diffrend_tpu_torch.ops.cuda import raster_grad_cuda as gc
    from fpc_diffrend_tpu_torch.ops.cuda import rasterize_cuda as rc

    rng = np.random.default_rng(seed)
    B, T, K, n_s = (1 if name == "B = 1" else 2), 901, gc.WINDOW, 150
    n_tiles = B * n_s
    base = rng.integers(0, n_s - K, size=(B, T, 1)) + (
        np.arange(B) * n_s)[:, None, None]
    n_slots = rng.integers(0, K + 1, size=(B, T, 1))
    tid = np.where(np.arange(K) < n_slots, base + np.arange(K), n_tiles)
    if name.startswith("all dead"):
        tid[:] = n_tiles
    tile_ids = torch.as_tensor(tid.astype(np.int32), device=dev)
    P = tid.size
    if name == "P = 0":
        P = 0
    elif name == "cap cuts a bin":
        bs = bp.place_pairs_plain(tile_ids, n_tiles, P)[0].cpu().numpy()
        mid = int(np.searchsorted(bs, bs[-1] // 2, side="right")) - 1
        P = int(bs[mid] + (bs[mid + 1] - bs[mid]) // 2)
        if not bs[mid] < P < bs[mid + 1]:
            fail(f"K6 edge case {name}: bin {mid} is too small to cut")
    bin_start, sorted_tri = bp.place_pairs_plain(tile_ids, n_tiles, P)
    n_live = int(bin_start[-1])
    none = np.flatnonzero((tid >= n_tiles).all(-1).reshape(-1))
    n_global = {"all dead, global list full": gc.MAX_GLOBAL,
                "global rows": len(none), "B = 1": 40}.get(name, 0)
    gids = none[:n_global]
    n_global = len(gids)
    gbase = P + rc.CHUNK + (-P) % rc.CHUNK

    def rows(n, live):
        r = rng.standard_normal((n, rc.REC)).astype(np.float32)
        r[live:] = np.nan
        return torch.as_tensor(r, device=dev)

    global_idx = np.full(gc.MAX_GLOBAL, B * T, np.int32)
    global_idx[:n_global] = gids
    bins = rc.Bins(
        sorted_rec=torch.zeros((gbase, rc.REC), device=dev),
        bin_start=bin_start, global_rec=torch.zeros((gc.MAX_GLOBAL, rc.REC),
                                                    device=dev),
        n_global=torch.tensor([n_global], dtype=torch.int32, device=dev),
        sorted_tri=sorted_tri,
        global_idx=torch.as_tensor(global_idx, device=dev),
        global_bbox=torch.zeros((gc.MAX_GLOBAL, 4), dtype=torch.int32,
                                device=dev),
        tile_ids=tile_ids, sample_ph=n_s * rc.TILE_H)
    return rows(gbase, n_live), rows(gc.MAX_GLOBAL, n_global), bins, B * T


def check_fold_edges(dev, names=FOLD_EDGE_CASES):
    """K6's edge cases (:func:`fold_case`), each exactly its plain version,
    bit-equal over two calls and finite (the NaN rows unread)."""
    import torch

    seen = []
    for name in names:
        ge, gg, bins, n_tris = fold_case(name, dev)
        k6 = check_fold((ge, gg), bins, n_tris, f"K6 edge case {name}")
        if not bool(torch.isfinite(k6).all()):
            fail(f"K6 edge case {name}: the fold read a row it must not")
        seen.append(f"{name} (P {bins.sorted_tri.numel()}, live "
                    f"{int(bins.bin_start[-1])}, n_global "
                    f"{int(bins.n_global[0])})")
    print(f"check K6 edges: {seen}: exact, bit-equal over two calls",
          flush=True)


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


def ulp_gap(a, b) -> int:
    """The largest distance between a and b in float32 steps (NaN where
    both are NaN counts as equal)."""
    import torch

    def line(x):
        i = x.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    both = torch.isnan(a) & torch.isnan(b)
    gap = torch.where(both, 0, (line(a) - line(b)).abs())
    return int(gap.max()) if gap.numel() else 0


def mip_lod_errors(pyr, sizes, tu, tv, idbuf, height, width, sample_ph):
    """K8 deriving the LOD (``mip_sample_lod``) against the torch passes
    it replaces: {"lam_ulp": its LOD plane's largest gap to
    ``lod_from_texc``'s on the same device, in float32 steps;
    "colour_given": its colour's largest gap to K8 fed its own LOD plane
    (``mip_sample``); "colour_plain": to ``mip_sample_plain`` of
    ``lod_from_texc``'s plane}."""
    import torch

    from fpc_diffrend_tpu_torch.ops.cuda import texture_mip_cuda as tmc

    colour, lam = tmc.mip_sample_lod(pyr, sizes, tu, tv, idbuf, height,
                                     width, sample_ph)
    torch.cuda.synchronize()
    want = tmc.lod_from_texc(tu, tv, idbuf, *sizes[0], height, width,
                             sample_ph)
    return {"lam_ulp": ulp_gap(lam, want),
            "colour_given": max_err(colour, tmc.mip_sample(pyr, sizes, tu,
                                                           tv, lam)),
            "colour_plain": max_err(colour, tmc.mip_sample_plain(
                pyr, sizes, tu, tv, want))}


def check_lod_errors(errs: dict, label: str) -> None:
    """Fail unless K8's derived LOD is within ``LOD_ULP`` of the torch
    passes' and its colour equals K8's fed that plane exactly and the
    plain version's within ``K8_ATOL``."""
    if not (errs["lam_ulp"] <= LOD_ULP and errs["colour_given"] == 0.0
            and errs["colour_plain"] <= K8_ATOL):
        fail(f"{label}: K8 deriving the LOD differs from the LOD's torch "
             f"passes and K8: {errs}")


# check_mip_lod's planes: (B, height, width, sample_ph, pw, C, aligned);
# the second is the face9-mip batch's stacked image
MIP_LOD_CASES = {
    "3 samples": (3, 20, 100, 24, 128, 1, True),
    "3 samples C 3": (3, 20, 100, 24, 128, 3, True),
    "face9-mip batch": (36, 1200, 1600, 1200, 1664, 1, True),
    "width 83": (2, 17, 80, 20, 83, 1, True),
    "3 samples, unaligned": (3, 20, 100, 24, 128, 1, False),
}


def lod_planes(dev, gen, B, height, width, sample_ph, pw):
    """Synthetic K1 planes for the LOD: (idbuf, tu, tv) of B samples
    stacked ``sample_ph`` rows apart. Ids come in 5 x 7 patches that run
    across the samples' seams and over the padding rows and columns, with
    scattered missed pixels (-1, uv (0, 0)); uv is a slanted ramp with
    noise, so each pair's difference is its own."""
    import torch

    rows = B * sample_ph
    r = torch.arange(rows, device=dev)[:, None]
    c = torch.arange(pw, device=dev)[None]
    miss = (c + 2 * r) % 13 < 3
    ids = torch.where(miss, -1, ((r // 5) * 37 + c // 7) % 11).to(
        torch.int32)
    noise = torch.rand((2, rows, pw), device=dev, generator=gen) * 0.01
    tu = (c + 0.3 * r) / pw * 1.3 + noise[0]
    tv = (r % sample_ph) / sample_ph * 0.9 + 0.05 * c / pw + noise[1]
    tu = torch.where(miss, 0.0, tu).float().contiguous()
    tv = torch.where(miss, 0.0, tv).float().contiguous()
    return ids.contiguous(), tu, tv


def check_mip_lod(dev, gen, cases=MIP_LOD_CASES):
    """K8 deriving the LOD on the synthetic planes of ``cases``
    (:func:`lod_planes`; a 7-level chain of a random 1024^2 texture, 64^2
    below the face9-mip batch), each within :func:`check_lod_errors`'
    limits: three samples with padding rows and columns, missed pixels and
    ids across the seams (one and three channels); the face9-mip batch's
    36 x 1200 x 1664 planes; a width no multiple of 4 and planes 4 bytes
    past a 16-byte boundary (one pixel a thread). :return: case ->
    :func:`mip_lod_errors`."""
    import torch

    from fpc_diffrend_tpu_torch.ops.texture_mip import level_sizes

    def unaligned(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
        buf[1:] = t.reshape(-1)
        return buf[1:].view(t.shape)

    out = {}
    for name, (B, height, width, sample_ph, pw, C, aligned) in cases.items():
        side = 1024 if height >= 1000 else 64
        sizes = level_sizes(side, side, MAX_MIP_LEVEL)
        pyr = torch.rand((sum(h * w for h, w in sizes), C), device=dev,
                         generator=gen)
        planes = lod_planes(dev, gen, B, height, width, sample_ph, pw)
        if not aligned:
            planes = tuple(unaligned(t) for t in planes)
        ids, tu, tv = planes
        out[name] = mip_lod_errors(pyr, sizes, tu, tv, ids, height, width,
                                   sample_ph)
        check_lod_errors(out[name], f"K8 LOD case {name}")
    print(f"check K8 deriving the LOD: {out} (limits: LOD {LOD_ULP} "
          f"float32 steps, colour exactly K8's on that LOD)", flush=True)
    return out


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
    both time them: the bench-mip batch's uv and id planes (K1's ``k1``),
    the pyramid of ``tex``, and for K9 their LOD (:func:`mip_inputs`) and
    K3's colour cotangent ``gcolour``. K8 derives the LOD as the step runs
    it (``mip_sample_lod``); its plain version is the LOD's torch passes
    (``lod_from_texc``), then ``mip_sample_plain``.

    :return: ({name: (kernel call, its plain version)}, (pyramid, sizes,
        LOD)).
    """
    from fpc_diffrend_tpu_torch.ops.cuda import texture_mip_cuda as tmc

    pyr, sizes, lam = mip_inputs(k1, tex, height, width, sample_ph)
    idbuf, tu, tv = k1[0], k1[2][3], k1[2][4]

    def k8_plain():
        lp = tmc.lod_from_texc(tu, tv, idbuf, *sizes[0], height, width,
                               sample_ph)
        return tmc.mip_sample_plain(pyr, sizes, tu, tv, lp), lp

    pairs = {
        "mip_sample": (
            lambda: tmc.mip_sample_lod(pyr, sizes, tu, tv, idbuf, height,
                                       width, sample_ph),
            k8_plain),
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
    if e7 != 0 or e4 > K4_ATOL or e4_rel > K4_GTEX_RTOL:
        fail(f"{label}: K7/K4 clamp differ from the plain versions: {errs}")
    print(f"check {label}: K7 equals its plain version and K1's colour "
          f"exactly; K4 clamp max err {errs} (gtex rel limit "
          f"{K4_GTEX_RTOL})", flush=True)
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


def check_k10_edges(dev, gen):
    """K10 where the bench's shapes do not take it, against K1 + K2 on the
    same bins, exactly (ids, entries, payload, extra, colour and aa): two
    samples of 100 x 1600 at their pitch of 104 rows (padding rows between
    them) in planes of 13 tile columns, the last partial; tiles with an
    empty bin; the dome's silhouettes crossing tile rows 0/7 and columns
    0/127; a binned dome and one whose large triangles fill the global
    list; C = 1 to 4 channels. :return: the largest aa error (0 when
    bit-equal)."""
    import torch

    from fpc_diffrend_tpu_torch.ops.cuda import antialias_cuda as ac
    from fpc_diffrend_tpu_torch.ops.cuda import rasterize_cuda as rc
    from fpc_diffrend_tpu_torch.workload import build_workload

    H, W = 100, 1600
    ph, pw = rc.pad_resolution(H, W)
    rows = 2 * ph
    worst = 0.0
    for grid in (20, 4):
        wl = build_workload(H, W, grid=grid, batch=2, tex_size=64,
                            device=dev)
        bins = step_inputs(wl, backward=False)["bins"]
        sizes = bins.bin_start[1:] - bins.bin_start[:-1]
        for C in (1, 2, 3, 4):
            tex = torch.rand((64, 64, C), device=dev, generator=gen)
            k1 = rc.fused_raster(bins, tex, rows, pw)
            k2 = ac.antialias_planes(k1[0], k1[2], k1[4], H, W, ph)
            k10 = rc.fused_raster_aa(bins, tex, rows, pw, H, W, ph)
            torch.cuda.synchronize()
            for n, a, b in zip(("idbuf", "entry", "payload", "extra",
                                "colour", "aa"), k10, (*k1, k2)):
                if not torch.equal(a, b):
                    fail(f"K10 edge case (grid {grid}, C {C}): its {n} "
                         f"differs from K1 + K2's by {max_err(a, b)}")
            worst = max(worst, max_err(k10[5], k2))
        ids = k1[0]
        cross_rows = int((ids[7::8][:-1] != ids[8::8]).sum())
        cross_cols = int((ids[:, 127::128][:, :-1] != ids[:, 128::128]).sum())
        if not (cross_rows and cross_cols and int((sizes == 0).sum())):
            fail(f"K10 edge scene (grid {grid}) lacks a case: {cross_rows} "
                 f"differing pairs across tile rows, {cross_cols} across "
                 f"tile columns, {int((sizes == 0).sum())} empty bins")
        print(f"check K10 edges, grid {grid}: {rows}x{pw} ({pw // 128} tile "
              f"columns, width {W}), H {H} at pitch {ph}, C 1-4, "
              f"{int((sizes == 0).sum())} empty bins, n_global "
              f"{int(bins.n_global[0])}, {cross_rows} + {cross_cols} "
              f"differing pairs across tile rows + columns: equal to K1 + "
              f"K2", flush=True)
    return worst


def check_place_edges(dev):
    """K11's edge cases, exactly against its plain version, each launched
    once: P = 0; every slot dead; one live triangle; P cut inside the first
    bin; P equal to the live entries; then a 6,000-entry bin and 70,000
    tiles (:func:`check_place_synthetic`)."""
    import numpy as np
    import torch

    from fpc_diffrend_tpu_torch.ops.cuda import bin_place_cuda as bp

    rng = np.random.default_rng(9)
    n_tiles, T, K = 300, 900, 8
    base = rng.integers(0, n_tiles - K, size=(2, T, 1))
    live_tid = np.where(np.arange(K) < rng.integers(0, K + 1, (2, T, 1)),
                        base + np.arange(K), n_tiles)
    dead = np.full((2, T, K), n_tiles)
    one = dead.copy()
    one[1, 417, :5] = [3, 4, 40, 41, 299]
    first = int(np.bincount(live_tid[live_tid < n_tiles],
                            minlength=n_tiles)[np.min(live_tid)])
    n_live = int((live_tid < n_tiles).sum())
    cases = [("P = 0", live_tid, 0), ("all dead", dead, 2 * T * K),
             ("all dead, P = 0", dead, 0),
             ("one live triangle", one, 2 * T * K),
             ("one live triangle, P = 3", one, 3),
             ("P inside the first bin", live_tid, max(first // 2, 1)),
             ("P = live", live_tid, n_live)]
    for name, tid, P in cases:
        tile_ids = torch.as_tensor(tid.astype(np.int32), device=dev)
        before = bp.place_pairs.launches
        got = bp.place_pairs(tile_ids, n_tiles, P)
        torch.cuda.synchronize()
        want = bp.place_pairs_plain(tile_ids, n_tiles, P)
        if not (bp.place_pairs.launches == before + 1
                and torch.equal(got[0], want[0])
                and torch.equal(got[1], want[1])):
            fail(f"K11 edge case {name}: differs from its plain version")
    print(f"check K11 edges: {[c[0] for c in cases]}: exact", flush=True)
    check_place_synthetic(dev)


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
           if not e <= (K4_GTEX_RTOL if "rel" in k else K4_ATOL)}
    if bad:
        fail(f"K4 edge cases differ from the plain version: {bad}")
    print(f"check K4 edges: 36x84 and 37x83 uv, wrap and clamp, C 1 and 3, "
          f"zero cotangent exact; max err gtu/gtv "
          f"{max(e for k, e in errs.items() if 'rel' not in k)}, gtex rel "
          f"{max(e for k, e in errs.items() if 'rel' in k)} (limit "
          f"{K4_GTEX_RTOL})", flush=True)
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
    rate). Its design moves more (:func:`k11_design_bytes`)."""
    n = tile_ids.numel()
    return _bound(n * 4 + (n_tiles + 1) * 4 + P * 4, n)


def k11_blocks(tile_ids, n_tiles):
    """K11's design as plain PyTorch: the block of each slot
    (``bin_place_cuda.place_blocks``), the exclusive prefix of each block
    in each tile over the blocks before it, and each live slot's rank
    among its block's slots of its tile in slot order.

    :return: (G, live mask (np,), tile (np,), block (np,), prefix (np,) of
        the slot's block in its tile, rank (np,), block sizes (G, n_tiles)).
    """
    import torch

    from fpc_diffrend_tpu_torch.ops.cuda import bin_place_cuda as bp

    B, T, K = tile_ids.shape
    G, run = bp.place_blocks(B * T, K)
    t = tile_ids.reshape(-1).long().cpu()
    live = (t >= 0) & (t < n_tiles)
    slot = torch.arange(t.numel())
    block = slot // max(run, 1)
    key = torch.where(live, block * n_tiles + t, G * n_tiles)
    sizes = torch.bincount(key, minlength=G * n_tiles + 1)[:-1].reshape(
        G, n_tiles)
    prefix = torch.cumsum(sizes, 0) - sizes
    order = torch.sort(key, stable=True)[1]
    first = torch.cumsum(torch.bincount(key, minlength=G * n_tiles + 1),
                         0) - torch.bincount(key, minlength=G * n_tiles + 1)
    rank = torch.empty_like(key)
    rank[order] = torch.arange(key.numel()) - first[key[order]]
    pre = prefix.reshape(-1)[torch.clamp(key, max=G * n_tiles - 1)]
    return G, live, t, block, pre, rank, sizes


def k11_model(tile_ids, n_tiles, P):
    """K11's placement by :func:`k11_blocks`: each live slot's triangle at
    its tile's bin offset + its block's prefix + its rank, cut at P, the
    sentinel past the live entries. Equals ``place_pairs_plain``.

    :return: (bin_start (n_tiles + 1,), sorted_tri (P,)) int32."""
    import torch

    B, T, K = tile_ids.shape
    _, live, t, _, pre, rank, sizes = k11_blocks(tile_ids, n_tiles)
    tot = sizes.sum(0)
    start = torch.cumsum(tot, 0) - tot
    pos = start[torch.clamp(t, max=n_tiles - 1)] + pre + rank
    n_live = int(tot.sum())
    sorted_tri = torch.full((P,), B * T, dtype=torch.int32)
    keep = live & (pos < P)
    sorted_tri[pos[keep]] = (torch.arange(t.numel())[keep] // K).int()
    bin_start = torch.clamp(torch.cat([start, torch.tensor([n_live])]),
                            max=P).int()
    return bin_start, sorted_tri


def k11_design_bytes(tile_ids, n_tiles, P):
    """What K11's design moves in device memory a call (its shared-memory
    path), from :func:`k11_blocks`: the slots read twice (count, place);
    the (G, n_tiles) block counts written, read and written by the column
    scan, read three times by the placement (its own row and the next, for
    its counts, then its own again for its prefixes); the tiles' totals
    written and read by every block; bin_start and the P entries written. The staging and the rank
    stay in shared memory.

    :return: {"bytes", "launches", "blocks", "matrix_bytes"}."""
    _, _, _, _, _, _, sizes = k11_blocks(tile_ids, n_tiles)
    G = sizes.shape[0]
    n = tile_ids.numel()
    matrix = 4 * G * n_tiles * (1 + 2 + 3)
    nbytes = (4 * 2 * n + matrix + 4 * (n_tiles + G * n_tiles)
              + 4 * (n_tiles + 1 + P))
    return {"bytes": nbytes, "launches": 3, "blocks": G,
            "matrix_bytes": matrix}


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

    from fpc_diffrend_tpu_torch.data.frames import save_tiff
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
            save_tiff(os.path.join(paths["imdir"], cam,
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


def view_inputs(wl):
    """[(mvp (4, 4), vertices (V, 3))] of frame 0 through each of the
    bench's cameras: the single views of phases 5d and 5e."""
    import torch

    from fpc_diffrend_tpu_torch.fit import loop

    config, scene, params = wl["config"], wl["scene"], wl["params"]
    views = []
    with torch.no_grad():
        for c in range(N_VIEWS):
            idx = torch.tensor([c, 0], device=params["tex"].device)
            mvp = loop.build_mvp(scene, params, idx[:1], idx[1:])[0]
            verts3 = loop.sample_clip_positions(config, scene, params,
                                                idx[:1], idx[1:])[1][0]
            views.append((mvp, verts3))
    return views


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

    from fpc_diffrend_tpu_torch.data.frames import save_tiff
    from fpc_diffrend_tpu_torch.ops.pipeline import render
    from fpc_diffrend_tpu_torch.ops.cuda import device_events
    from fpc_diffrend_tpu_torch.tools.render_result import render_result
    from fpc_diffrend_tpu_torch.tools.simple_render import simple_render
    from fpc_diffrend_tpu_torch.utils.image import load_image

    scene, params = wl["scene"], wl["params"]
    H, W = wl["H"], wl["W"]
    tex = params["tex"].detach()
    dev = tex.device
    views = view_inputs(wl)
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
        with device_profile() as prof:
            with torch.no_grad():
                for mvp_c, pos_c in views:
                    draw(route, mvp_c, pos_c, tex)
            torch.cuda.synchronize()
        busy = sum(ms for _, ms, _ in device_events(prof)) / N_VIEWS
        rec["ms"][route] = {"forward": fwd, "forward_backward": both,
                            "forward_host": host, "forward_device": busy}
    # The routes' planes are equal bit for bit (phase 3), so their
    # gradients differ only by the order of the atomic sums (K5, the
    # index backward of the setup chain). The texture gradient is K4's
    # alone, on equal planes and K3's deterministic cotangent, and K4's
    # texel sums are float64, rounded once: within K4_GTEX_RTOL of the
    # largest magnitude, route against route and each route against
    # itself. The vertex gradient sums terms of screen-coordinate size
    # that cancel: within the stated spread of a sum taken with atomics,
    # GRAD_SPREAD_RTOL of the largest magnitude, as is each route against
    # itself.
    pos_tol = GRAD_SPREAD_RTOL
    if not (max(v[0] for v in spread.values()) <= pos_tol
            and max(v[1] for v in spread.values()) <= K4_GTEX_RTOL):
        fail(f"single view: a route's gradients spread past {pos_tol} "
             f"(vertex) or {K4_GTEX_RTOL} (texture) against itself: "
             f"{spread}")
    errs = {}
    for route in ROUTES[1:]:
        (imgs, grads), (ref_imgs, ref_grads) = out[route], out[ROUTES[0]]
        e_img = max(max_err(a, b) for a, b in zip(imgs, ref_imgs))
        e_pos = max(_rel_err(a[0], b[0]) for a, b in zip(grads, ref_grads))
        e_tex = max(_rel_err(a[1], b[1]) for a, b in zip(grads, ref_grads))
        errs[route] = {"image": e_img, "vertex grad rel": e_pos,
                       "texture grad rel": e_tex}
        if e_img > 1e-6 or e_pos > pos_tol or e_tex > K4_GTEX_RTOL:
            fail(f"single view: route {route} differs from sepaa: "
                 f"{errs[route]} (vertex tolerance {pos_tol}; spread of "
                 f"each route against itself {spread})")
    rec.update(route_errs=errs, grad_spread=spread)
    tex_routes = {r: e["texture grad rel"] for r, e in errs.items()}
    tex_self = {r: v[1] for r, v in spread.items()}
    print(f"single view: texture gradient rel, route against sepaa "
          f"{tex_routes}, each route against itself {tex_self} (limit "
          f"{K4_GTEX_RTOL})", flush=True)
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
        save_tiff(os.path.join(refdir, f"cam0_{i:03d}.tif"), written[0, i])
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


def check_gathered_antialias(colour, rast, pos_clip, faces, fn, g, label):
    """``ops.antialias.antialias`` over every pair (K2 forward, K3
    backward on the winner planes gathered from ``rast``) against the
    plain per-pair ``_pair_blend`` over every pair (``_antialias_compact``
    with a cap above the pair count) on the same inputs: the image within
    K2_ATOL, the colour's gradient within K3_ATOL, the clip positions'
    within 1e-5 of their largest magnitude (both gathers' backwards add
    with atomics); K2 and K3 launched once each.

    :param colour: (H, W, C) shaded image; rast: (H, W, 4); g: (H, W, C)
        cotangent.
    :return: the errors.
    """
    from fpc_diffrend_tpu_torch.ops.antialias import (_antialias_compact,
                                                      antialias)
    from fpc_diffrend_tpu_torch.ops.cuda import antialias_cuda as ac
    from fpc_diffrend_tpu_torch.ops.rasterize import screen_vertices

    H, W = colour.shape[:2]
    out = {}
    before = (ac.antialias_planes.launches,
              ac.antialias_planes_bwd.launches)
    for name in ("gathered", "pair_blend"):
        p = pos_clip.detach().clone().requires_grad_(True)
        col = colour.detach().clone().requires_grad_(True)
        if name == "gathered":
            aa = antialias(col, rast, p, faces, fn)
        else:
            tri = screen_vertices(p, W, H)[faces][..., :2]
            aa = _antialias_compact(col, rast, tri, fn, H * W)
        (aa * g).sum().backward()
        out[name] = (aa.detach(), col.grad, p.grad)
    launched = (ac.antialias_planes.launches - before[0],
                ac.antialias_planes_bwd.launches - before[1])
    (a_k, gc_k, gp_k), (a_p, gc_p, gp_p) = out.values()
    errs = {"K2 gathered": max_err(a_k, a_p),
            "K3 gathered colour": max_err(gc_k, gc_p),
            "K3 gathered vertex rel": _rel_err(gp_k, gp_p)}
    if not (errs["K2 gathered"] <= K2_ATOL
            and errs["K3 gathered colour"] <= K3_ATOL
            and errs["K3 gathered vertex rel"] <= 1e-5
            and launched == (1, 1) and max_err(a_k, colour) > 0):
        fail(f"{label}: K2/K3 on gathered planes differ from the plain "
             f"pair blend: {errs}, launches {launched}")
    return errs


def primitive_views(wl, counters, gen):
    """Phase 5e, at full width: the nvdiffrast-style primitives composed
    as a user composes them, on the bench dome through each of the
    bench's cameras: ``rasterize(with_db=True)`` (K11's bins, K1 without
    its texture tail) -> ``interpolate(..., "all")`` -> ``texture`` (K7)
    -> ``antialias`` (K2 on the winner planes gathered from rast) ->
    composite, forward, then forward + backward to the vertices and the
    texture (K3, K4, K5 with live u, v, z cotangents, K6; the first under
    sync-debug "error"). Held to ``render(route="separate")`` of the same
    view (the same kernels, its uv from K1 rather than interpolate): the
    image within 2e-4 on >= 99.5 % of pixels (JAX's limit between two
    renderers, ``tests/test_pipeline_fused.py``), interpolate's uv within
    1e-6 of K1's, the gradients within 5e-2 relative L2 (JAX's
    per-element limits are recorded: see the texel flips below); the same
    chain on K1's uv (``rasterize_with_uv``) within
    phase 5d's limits between routes (image 1e-6, vertex gradients
    GRAD_SPREAD_RTOL, texture K4_GTEX_RTOL of the largest magnitude); K5 on
    the composition's own cotangents against its plain version (ATOMIC_RTOL
    of the summed magnitudes); K2 and K3 on the gathered planes against
    the plain per-pair ``_pair_blend`` over every pair (K2_ATOL, K3_ATOL
    for the colour's gradient; the vertices' within 1e-5 of the largest
    magnitude, both sums taken with atomics). Launch counts: K11, K1, K7,
    K2 once a forward, K3-K6 once a backward.

    :return: the phase's record.
    """
    import torch

    import fpc_diffrend_tpu_torch.ops.rasterize as rz
    from fpc_diffrend_tpu_torch.models.camera import transform_clip
    from fpc_diffrend_tpu_torch.ops.antialias import antialias
    from fpc_diffrend_tpu_torch.ops.cuda import raster_grad_cuda as gc
    from fpc_diffrend_tpu_torch.ops.interpolate import interpolate
    from fpc_diffrend_tpu_torch.ops.pipeline import BACKGROUND, render
    from fpc_diffrend_tpu_torch.ops.texture import texture
    from fpc_diffrend_tpu_torch.utils import profiling

    scene = wl["scene"]
    H, W = wl["H"], wl["W"]
    tex = wl["params"]["tex"].detach()
    dev = tex.device
    faces, fn = scene.faces, scene.face_neighbors
    views = view_inputs(wl)
    g = torch.randn((H, W, tex.shape[2]), device=dev, generator=gen)

    def compose(mvp, pos, t):
        pc = transform_clip(mvp, pos)
        rast, rast_db = rz.rasterize(pc, faces, (H, W), with_db=True)
        texc, _ = interpolate(scene.uv, rast, scene.uv_idx, rast_db, "all")
        colour = antialias(texture(t, texc), rast, pc, faces, fn)
        return torch.where(rast[..., 3:] > 0, colour, BACKGROUND)

    def separate(mvp, pos, t):
        return render(mvp, pos, faces, scene.uv, scene.uv_idx, t, (H, W),
                      fn, route="separate", device=dev)

    def grads(draw, mvp, pos):
        p = pos.clone().requires_grad_(True)
        t = tex.clone().requires_grad_(True)
        (draw(mvp, p, t) * g).sum().backward()
        return p.grad, t.grad

    for f in counters.values():
        f.launches = 0
    imgs, grad = [], []
    for c, (mvp, pos) in enumerate(views):
        with torch.no_grad():
            imgs.append(compose(mvp, pos, tex))
        if c == 0:
            torch.cuda.set_sync_debug_mode("error")
        grad.append(grads(compose, mvp, pos))
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters.items()}
    want = dict.fromkeys(counters, 0)
    want.update(bin_place=2 * N_VIEWS, fused_raster=2 * N_VIEWS,
                texture_fwd=2 * N_VIEWS, antialias=2 * N_VIEWS,
                antialias_bwd=N_VIEWS, texture_bwd=N_VIEWS,
                pixel_grad=N_VIEWS, fold_entries=N_VIEWS)
    if launches != want:
        fail(f"primitives: launches {launches} != {want}")

    # against render(route="separate") of each view: the composition
    # (its uv from interpolate), and the same with K1's uv
    # (rasterize_with_uv), whose planes are the route's bit for bit
    def compose_k1_uv(mvp, pos, t):
        pc = transform_clip(mvp, pos)
        rast, texc = rz.rasterize_with_uv(pc, faces, scene.uv, scene.uv_idx,
                                          (H, W))
        colour = antialias(texture(t, texc), rast, pc, faces, fn)
        return torch.where(rast[..., 3:] > 0, colour, BACKGROUND)

    def l2(a, b):
        return float((a - b).norm() / b.norm())

    errs = {"image_close": 1.0, "image_max_abs": 0.0, "texture_grad": 0.0,
            "vertex_grad_rel": 0.0, "vertex_grad_l2": 0.0,
            "texture_grad_l2": 0.0, "texel_flips": 0, "texc_max_abs": 0.0,
            "k1_uv_image": 0.0,
            "k1_uv_vertex_grad_rel": 0.0, "k1_uv_texture_grad_rel": 0.0}
    for (mvp, pos), img, (gp, gt) in zip(views, imgs, grad):
        if img.shape != (H, W, tex.shape[2]) or not bool(
                torch.isfinite(img).all()) or not bool(
                torch.isfinite(gp).all() & torch.isfinite(gt).all()):
            fail(f"primitives: image {img.shape} or gradients not finite")
        with torch.no_grad():
            ref = separate(mvp, pos, tex)
            same = compose_k1_uv(mvp, pos, tex)
            pc = transform_clip(mvp, pos)
            rast, texc_k = rz.rasterize_with_uv(pc, faces, scene.uv,
                                                scene.uv_idx, (H, W))
            texc_i = interpolate(scene.uv, rast, scene.uv_idx)[0]
            hit = rast[..., 3] > 0
            size = torch.tensor([tex.shape[1], tex.shape[0]], device=dev)
            flips = int(((torch.floor(texc_i * size - 0.5)
                          != torch.floor(texc_k * size - 0.5)).any(-1)
                         & hit).sum())
        rp, rt = grads(separate, mvp, pos)
        sp, st = grads(compose_k1_uv, mvp, pos)
        close = float(((img - ref).abs() <= 2e-4).float().mean())
        # assert_allclose's test: |a - b| <= atol + rtol |b|
        tex_excess = float(((gt - rt).abs() - 5e-3 * rt.abs()).max())
        new = {"image_close": close, "image_max_abs": max_err(img, ref),
               "texture_grad": tex_excess, "vertex_grad_rel": _rel_err(gp, rp),
               "vertex_grad_l2": l2(gp, rp), "texture_grad_l2": l2(gt, rt),
               "texel_flips": flips,
               "texc_max_abs": max_err(texc_i[hit], texc_k[hit]),
               "k1_uv_image": max_err(same, ref),
               "k1_uv_vertex_grad_rel": _rel_err(sp, rp),
               "k1_uv_texture_grad_rel": _rel_err(st, rt)}
        errs = {k: (min if k == "image_close" else max)(errs[k], v)
                for k, v in new.items()}
    # Interpolate's uv and K1's differ by an ulp (texc_max_abs, within
    # 1e-6); where that moves a sample across a texel edge of the 1024^2
    # noise texture (texel_flips) the bilinear derivative jumps by a texel
    # difference times 1024, so a few pixels move single gradient elements
    # past JAX's per-element limits (recorded): the composition's
    # gradients are held in relative L2 (5e-2; 5.2e-3 and 8.1e-3 measured
    # on an H100), the same chain on K1's uv per element (the limits of
    # phase 5d between routes).
    if not (errs["image_close"] >= 0.995 and errs["texc_max_abs"] <= 1e-6
            and errs["vertex_grad_l2"] <= 5e-2
            and errs["texture_grad_l2"] <= 5e-2
            and errs["k1_uv_image"] <= 1e-6
            and errs["k1_uv_vertex_grad_rel"] <= GRAD_SPREAD_RTOL
            and errs["k1_uv_texture_grad_rel"] <= K4_GTEX_RTOL):
        fail(f"primitives differ from render(route='separate'): {errs}")
    print(f"primitives: texture gradient rel on K1's uv against "
          f"render(route='separate') {errs['k1_uv_texture_grad_rel']} "
          f"(limit {K4_GTEX_RTOL})", flush=True)

    # K5 on the composition's own cotangents (u, v, z live, read by the
    # instance that takes them: k5.uvz_skipped stays 0), view 0
    mvp, pos = views[0]
    seen = []

    def seen_call(*args):
        seen.append(args)
        return gc.pixel_grad(*args)

    rz.pixel_grad = seen_call
    try:
        with profiling.recording() as log:
            grads(compose, mvp, pos)
    finally:
        rz.pixel_grad = gc.pixel_grad
    k5_args = seen[0][:9]
    bins, guvz = k5_args[0], k5_args[8]
    skipped = log.counters.get("k5.uvz_skipped", 0)
    live_uvz = 0 if guvz is None else int((guvz != 0).any(dim=0).sum())
    if live_uvz == 0 or skipped:
        fail(f"primitives: K5 saw no u, v, z cotangent ({live_uvz} live "
             f"pixels; k5.uvz_skipped {skipped})")
    k5 = gc.pixel_grad(*k5_args)
    p5 = gc.pixel_grad_plain(*k5_args)
    m5 = k5_magnitudes(*k5_args)
    n_live = int(bins.bin_start[-1])
    errs["K5 entries rel"] = atomic_err(k5[0][:n_live], p5[0][:n_live],
                                        m5[0][:n_live])
    errs["K5 global rel"] = atomic_err(k5[1], p5[1], m5[1])
    if not max(errs["K5 entries rel"], errs["K5 global rel"]) <= ATOMIC_RTOL:
        fail(f"primitives: K5 on live u, v, z differs from its plain "
             f"version: {errs}")

    # K2/K3 on the gathered planes against the plain per-pair blend
    pc = transform_clip(mvp, pos)
    with torch.no_grad():
        rast = rz.rasterize(pc, faces, (H, W), with_db=False)
        colour = texture(tex, interpolate(scene.uv, rast, scene.uv_idx)[0])
    errs.update(check_gathered_antialias(colour, rast, pc, faces, fn, g,
                                         "primitives"))

    # ms per view beside the "separate" route, for information
    # and the device's work in a forward + backward by kernel (profiler)
    ms = {}
    for name, draw in (("primitives", compose), ("separate", separate)):
        with torch.no_grad():
            fwd = cuda_ms(lambda: draw(mvp, pos, tex), 5)
        both = cuda_ms(lambda: grads(draw, mvp, pos), 5)
        kernels = device_kernels_ms(lambda: grads(draw, mvp, pos), 3)
        ms[name] = {"forward": fwd, "forward_backward": both,
                    "forward_backward_device": sum(kernels.values()),
                    "top_kernels": {k[:60]: v for k, v in sorted(
                        kernels.items(), key=lambda kv: -kv[1])[:6]}}
    rec = {"launches": launches, "errs": errs, "ms": ms,
           "live_uvz_px": live_uvz}
    print(f"primitives ({N_VIEWS} cameras, {H}x{W}): launches {launches}; "
          f"against render(route='separate') and the plain versions "
          f"{errs}; K5 saw {live_uvz} pixels with live u, v, z cotangents; "
          f"ms per view (CUDA events, camera 0; for information) {ms}",
          flush=True)
    return rec


def _depth_flips(rast_a, rast_b):
    """Pixel pairs of differing, covered ids whose nearer side (the
    antialias's occluder) differs between two rast buffers of one view."""
    n = 0
    for sl_a, sl_b in (((slice(None), slice(None, -1)),
                        (slice(None), slice(1, None))),
                       ((slice(None, -1),), (slice(1, None),))):
        ia, ib = rast_a[..., 3][sl_a], rast_a[..., 3][sl_b]
        pair = (ia != ib) & (ia > 0) & (ib > 0)
        near_a = rast_a[..., 2][sl_a] <= rast_a[..., 2][sl_b]
        near_b = rast_b[..., 2][sl_a] <= rast_b[..., 2][sl_b]
        n += int((pair & (near_a != near_b)).sum())
    return n


def scan_card_vs_cpu(scene, pc, tex, g, height, width):
    """``render_from_clip(impl="scan")`` and its gradients to the clip
    positions and the texture on the card against the same call on the
    CPU, from the same inputs: the image within 1e-6 (the scan is the same
    torch ops on both; K7 and K2 equal their plain versions), the
    gradients within 1e-5 of their largest magnitude (the gathers' backward
    adds with atomics on the card, which moves the vertex gradient; K4's
    texel sums are float64, rounded once).

    :return: the errors.
    """
    import torch

    from fpc_diffrend_tpu_torch.ops.pipeline import render_from_clip

    out = []
    for dev in (pc.device, torch.device("cpu")):
        p = pc.detach().to(dev).requires_grad_(True)
        t = tex.detach().to(dev).requires_grad_(True)
        img = render_from_clip(p, scene.faces.to(dev), scene.uv.to(dev),
                               scene.uv_idx.to(dev), t, (height, width),
                               scene.face_neighbors.to(dev), impl="scan")
        (img * g.to(dev)).sum().backward()
        out.append([x.detach().cpu() for x in (img, p.grad, t.grad)])
    (img_c, gp_c, gt_c), (img_p, gp_p, gt_p) = out
    errs = {"image": max_err(img_c, img_p),
            "vertex_grad_rel": _rel_err(gp_c, gp_p),
            "texture_grad_rel": _rel_err(gt_c, gt_p)}
    if not (errs["image"] <= 1e-6 and errs["vertex_grad_rel"] <= 1e-5
            and errs["texture_grad_rel"] <= 1e-5):
        fail(f"scan: the route on the card differs from the CPU's: {errs}")
    print(f"scan route on the card against the CPU: {errs}", flush=True)
    return errs


def scan_route(dev, gen):
    """Phase 5e, at mid size: the O(T·H·W) scan route on phase 3's B = 1
    slice of the 3,042-triangle dome at 256x384, and a B = 2 step.

    Gated: the visibility scan's ids against K1's on >= 99.8 % of pixels
    (``tests/test_rasterize_pallas.py``'s allowance); the scan route on
    the card against the same route on the CPU from the same clip
    positions (:func:`scan_card_vs_cpu`); one ``train_step`` with
    ``raster_impl="scan"`` finite; with the cameras' depth range [50, 150]
    (the dome lies at 88-110), ``render_from_clip`` with impl "scan"
    (every pair antialiased) against "auto": the image within 2e-4 on
    >= 99.5 % of values (JAX's limit between two renderers), and the
    render's and the step's gradients within 2 % relative L2.

    Recorded for information: JAX's per-element gradient limits, and the
    same comparison at the bench's own depth range [0.01, 200]. There
    every z_ndc of the dome lies in [0.99989, 0.99990], adjacent
    triangles' depths differ by an ulp, and the two routes' depth formulas
    pick the other occluder on about half of the pixel pairs the
    antialias blends (``_depth_flips``), so its blends and their
    gradients differ; at [50, 150] a few pairs remain, where the surface
    faces the camera.

    :return: the phase's record.
    """
    import dataclasses

    import torch

    from fpc_diffrend_tpu_torch.fit import loop
    from fpc_diffrend_tpu_torch.ops.pipeline import render_from_clip
    from fpc_diffrend_tpu_torch.ops.rasterize import (rasterize,
                                                      visibility_scan)
    from fpc_diffrend_tpu_torch.workload import build_workload

    H, W = 256, 384
    wl = build_workload(H, W, grid=40, batch=2, tex_size=1024, device=dev)
    config, scene, params, batch = (wl["config"], wl["scene"], wl["params"],
                                    wl["batch"])
    tex = params["tex"].detach()
    zn, zf = 50.0, 150.0
    tight = dataclasses.replace(scene, proj=scene.proj.clone())
    tight.proj[:, 2, 2] = -(zf + zn) / (zf - zn)
    tight.proj[:, 2, 3] = -(2.0 * zf * zn) / (zf - zn)
    scan_cfg = dataclasses.replace(config, raster_impl="scan",
                                   aa_max_pairs=-1)
    g = torch.randn((H, W, tex.shape[2]), device=dev, generator=gen)
    rec = {"tris": int(scene.faces.shape[0]), "depth_range": [zn, zf]}

    def draw(sc, impl, p, t):
        return render_from_clip(p, sc.faces, sc.uv, sc.uv_idx, t, (H, W),
                                sc.face_neighbors, impl=impl)

    for name, sc in (("bench", scene), ("depth_50_150", tight)):
        with torch.no_grad():
            pc = loop.sample_clip_positions(config, sc, params,
                                            batch.cam_idx,
                                            batch.frame_idx)[0][0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids = visibility_scan(pc, sc.faces, H, W)
        torch.cuda.synchronize()
        scan_s = time.perf_counter() - t0
        with torch.no_grad():
            rk = rasterize(pc, sc.faces, (H, W), with_db=False)
            rs = rasterize(pc, sc.faces, (H, W), impl="scan", with_db=False)
        agree = float((ids == rk[..., 3] - 1).float().mean())
        if not agree >= 0.998:
            fail(f"scan ({name}): visibility_scan ids agree with K1's on "
                 f"{agree}")
        out, secs = {}, {}
        for impl in ("scan", "auto"):
            p = pc.clone().requires_grad_(True)
            t = tex.clone().requires_grad_(True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            (draw(sc, impl, p, t) * g).sum().backward()
            torch.cuda.synchronize()
            secs[impl] = time.perf_counter() - t0
            with torch.no_grad():
                out[impl] = (draw(sc, impl, pc, tex), p.grad, t.grad)
        (img_s, gp_s, gt_s), (img_k, gp_k, gt_k) = out.values()
        errs = {"ids_agree": agree,
                "image_close": float(((img_s - img_k).abs() <= 2e-4)
                                     .float().mean()),
                "image_max_abs": max_err(img_s, img_k),
                "texture_grad": float(((gt_s - gt_k).abs()
                                       - 5e-3 * gt_k.abs()).max()),
                "vertex_grad_rel": _rel_err(gp_s, gp_k),
                "occluder_flips": _depth_flips(rs, rk)}
        # the step's gradients on both routes
        step_grads = {}
        for impl, cfg in (("scan", scan_cfg), ("auto", config)):
            p = {k: v.detach().clone().requires_grad_(True)
                 for k, v in params.items()}
            loop.loss_fn(p, cfg, sc, batch)[0].backward()
            step_grads[impl] = {k: v.grad for k, v in p.items()
                                if v.grad is not None and bool(v.grad.any())}
        errs["step_grad_rel"] = {
            k: _rel_err(step_grads["scan"].get(k, torch.zeros_like(v)), v)
            for k, v in step_grads["auto"].items()}
        errs["l2"] = {k: float((a - b).norm() / b.norm()) for k, (a, b) in {
            "vertex": (gp_s, gp_k), "texture": (gt_s, gt_k),
            **{f"step {k}": (step_grads["scan"].get(k, torch.zeros_like(v)),
                             v) for k, v in step_grads["auto"].items()}
        }.items()}
        rec[name] = {"errs": errs, "visibility_scan_s": scan_s,
                     "render_backward_s": secs}
        print(f"scan route, {name} depth range ({rec['tris']} tris, "
              f"{H}x{W}): visibility_scan {scan_s:.3f} s a view; render + "
              f"backward s a view {secs}; against the kernel route {errs}",
              flush=True)
        if name == "bench":
            rec["card_vs_cpu"] = scan_card_vs_cpu(sc, pc, tex, g, H, W)
            continue
        if not (errs["image_close"] >= 0.995
                and set(step_grads["scan"]) == set(step_grads["auto"])
                and max(errs["l2"].values()) <= 0.02):
            fail(f"scan: the scan route differs from the kernel route: "
                 f"{errs}")

    state = wl["state"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = loop.train_step(scan_cfg, scene, state, batch)
    torch.cuda.synchronize()
    rec["train_step_s"] = time.perf_counter() - t0
    if not all(bool(torch.isfinite(v)) for v in metrics.values()) or not all(
            bool(torch.isfinite(v).all()) for v in state.params.values()):
        fail(f"scan: train_step not finite: {metrics}")
    print(f"scan route: one train_step (B = 2, bench depth range) "
          f"{rec['train_step_s']:.3f} s, loss {float(metrics['loss'])}",
          flush=True)
    return rec


STEP_KERNELS = ("fused_raster", "antialias", "antialias_bwd", "texture_bwd",
                "pixel_grad", "fold_entries", "bin_place")   # K1-K6, K11


def example_launches(counters, steps, renders):
    """The launches of ``steps`` default fit steps and ``renders``
    single-sample renders (K11, K1, K2 each) of the examples."""
    want = dict.fromkeys(counters, 0)
    for k in STEP_KERNELS:
        want[k] = steps
    for k in ("fused_raster", "antialias", "bin_place"):
        want[k] += renders
    return want


def check_fit_step(config, scene, params, frames_u8, label, modes=False):
    """K1-K6 and K11 against their plain versions on one step's inputs of
    a fit (an example's, a bench row's): its config (entry cap included),
    scene and parameters, the batch its first step samples (``fit.loop.
    train_steps`` from a generator seeded with ``config.seed``), the
    step's own cotangent of K2's output and no u, v, z cotangent (as on
    the main path). Each at the limits of phases 3 and 6; with ``modes``
    also the fast K4 and K5 variants on the same inputs
    (:func:`check_precision`). The counters are left for the caller to
    reset.
    """
    import torch

    from fpc_diffrend_tpu_torch.fit import loop
    from fpc_diffrend_tpu_torch.ops.cuda import rasterize_cuda as rc

    dev = scene.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(config.seed)
    cams = torch.tensor(config.cam_idxs, dtype=torch.int64, device=dev)
    B = config.batch_size
    pick = torch.randint(0, cams.shape[0], (B,), generator=gen, device=dev)
    frame = torch.randint(0, frames_u8.shape[1], (B,), generator=gen,
                          device=dev)
    cam = cams[pick]
    H, W = config.resolution
    wl = {"config": config, "scene": scene, "B": B, "H": H, "W": W,
          "params": {k: v.detach().clone() for k, v in params.items()},
          "batch": loop.Batch(cam, frame,
                              loop.decode_refs(frames_u8, cam, frame))}
    # the bins and the cotangent of K2's output from the step's loss
    state = step_inputs(wl)
    bins, tex = state["bins"], wl["params"]["tex"].detach()
    ph, pw = rc.pad_resolution(H, W)
    T = scene.faces.shape[0]
    with torch.no_grad():
        _, _, k1 = check_kernels(bins, tex, B * ph, pw, H, W, ph, label)
        _, _, (k3, _, _, _, cot) = check_backward(
            k1, bins, tex, state["g_aa"], None, H, W, ph, B * T, label)
        check_place(state["pc"], scene.faces, H, W, config.pair_cap, label)
        if modes:
            args = (tex, k1, k3[0], bins, cot)
            check_precision(precision_pairs(*args), *args, label)
    return int(bins.n_global[0])


def examples_phase(counters, card):
    """Phase 5f: the three fit examples at their own widths through their
    entry points (``run_fit``, ``fit_take``), each with the launch
    counters set to 0 just before its fit and read just after.

    ``fit_cube`` (128^2, 300 steps, batch 4, 2 cameras, free mode, 12
    triangles in the global list): its exit rule (the last loss below half
    of the first) and finite losses. ``fit_rig_synthetic`` (256^2, 300
    steps, the synthetic 9-camera rig, 2 frames, batch 8, prior mode, 4
    blendshapes), written to disk and fitted with ``fit_take``: each
    camera's frame-0 coverage in [0.05, 0.95], "RECOVERING" (the mean pose
    error below its start), the result files parse. The convergence study
    (512^2, 9 cameras, 4 frames, 25 steps a dispatch) at batch 8 and at
    batch 1, the full 2,000 steps each (~40 s a batch on the H100): every
    logged loss finite, the final loss below the first logged, the final
    pose error below its start. Each fit launches K1-K6 and K11 from the
    host once in each of its eager steps and captures of the step's CUDA
    graph, every other step a replay (``fit.eager_steps`` +
    ``fit.graph_replays`` its steps; phases 5, 5b and 5c measure what a
    replay runs on the device), and the ground-truth renders K11, K1, K2
    once each. After each fit
    (each batch of the study), :func:`check_fit_step` holds K1-K6 and K11
    against their plain versions on one step's inputs of it, the cube's
    with triangles in the global list; the counters are set to 0 after
    it, so each fit's counts are its own. JAX's
    "CONVERGED" rule is printed with its numbers beside JAX's recorded
    table (``results/convergence_512``), not gated: JAX's own run fails
    it, and the rigs differ (a synthetic calibration against the real
    one).

    :return: the phase's record.
    """
    import dataclasses
    import tempfile

    import numpy as np
    import torch

    from fpc_diffrend_tpu_torch.examples import (convergence_study,
                                                 fit_cube, fit_rig_synthetic)
    from fpc_diffrend_tpu_torch.fit.api import (measure_raster_health,
                                                setup_from_config)
    from fpc_diffrend_tpu_torch.utils.profiling import recording

    t_phase = time.perf_counter()
    rec = {}

    def zero():
        for f in counters.values():
            f.launches = 0

    def checked(config, scene, params, frames_u8, label):
        n_global = check_fit_step(config, scene, params, frames_u8, label)
        zero()
        return n_global

    def counted(fn):
        """(fn's result, its seconds, the launches of its wrappers, its
        ``fit.eager_steps``, ``fit.graph_captures`` and
        ``fit.graph_replays``)."""
        zero()
        t0 = time.perf_counter()
        with recording() as log:
            out = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        n = {k: log.counters.get(f"fit.{k}", 0)
             for k in ("eager_steps", "graph_captures", "graph_replays")}
        return (out, sec, {k: f.launches for k, f in counters.items()}, n)

    def host_steps(n, steps, label):
        """The steps of a fit that launched from the host, its eager steps
        and captures of the step's CUDA graph (a replay launches from no
        wrapper), where each of its ``steps`` ran eagerly or replayed."""
        if n["eager_steps"] + n["graph_replays"] != steps:
            fail(f"{label}: {n} do not add up to its {steps} steps")
        return n["eager_steps"] + n["graph_captures"]

    # ---- fit_cube ----
    cube, cube_s, launches, n = counted(
        lambda: fit_cube.run(fit_cube.parse_args([])))
    steps = cube["config"].max_iter
    want = example_launches(counters, host_steps(n, steps, "fit_cube"),
                            cube["renders"])
    losses = cube["losses"]
    if not all(math.isfinite(x) for x in losses) or len(losses) != steps:
        fail(f"fit_cube: {len(losses)} losses, not all finite")
    if launches != want:
        fail(f"fit_cube: launches {launches} != {want}")
    if not cube["ok"]:
        fail(f"fit_cube did not converge: loss {losses[0]} -> {losses[-1]}")
    health = measure_raster_health(cube["config"], cube["scene"],
                                   cube["state"].params)
    n_global = checked(cube["config"], cube["scene"], cube["state"].params,
                       cube["frames"], "fit_cube step")
    if n_global == 0:
        fail("fit_cube: the checked step left the global list empty")
    rec["fit_cube"] = {"ms_per_step": cube["seconds"] / steps * 1e3,
                       "loss_first": losses[0], "loss_last": losses[-1],
                       "n_global": health["n_global"], "launches": launches,
                       "steps": n, "gt_t": cube["gt_t"],
                       "fit_t": cube["fit_t"]}
    print(f"fit_cube: {steps} steps at 128^2, "
          f"{rec['fit_cube']['ms_per_step']:.3f} ms/step (host clock, a "
          f"loss read each step); loss {losses[0]:.2f} -> {losses[-1]:.2f} "
          f"(CONVERGED); {health['n_global']} of 12 triangles in the "
          f"global list; launches from the host {launches}, steps {n}",
          flush=True)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_examples_") as tmp:
        # ---- fit_rig_synthetic: the take on disk, fitted by fit_take ----
        work = os.path.join(tmp, "rig")
        rig_out, rig_s, launches, n = counted(
            lambda: fit_rig_synthetic.run(
                fit_rig_synthetic.parse_args(["--workdir", work])))
        cfg = rig_out["config"]
        want = example_launches(
            counters, host_steps(n, cfg.max_iter, "fit_rig_synthetic"),
            rig_out["renders"])
        if launches != want or rig_out["state"].step != cfg.max_iter:
            fail(f"fit_rig_synthetic: {rig_out['state'].step} steps, "
                 f"launches {launches} != {want}")
        cov = rig_out["coverage"]
        if len(cov) != 9 or not all(0.05 <= c <= 0.95 for c in cov):
            fail(f"fit_rig_synthetic: frame-0 coverage {cov}")
        if not rig_out["ok"]:
            fail(f"fit_rig_synthetic NOT RECOVERING: pose error "
                 f"{rig_out['err0']} -> {rig_out['err']}")
        records = check_fit_outputs(cfg, 1584, 3072, 2, "fit_rig_synthetic")
        if not all(math.isfinite(r["loss"]) for r in records):
            fail(f"fit_rig_synthetic: non-finite loss in {records}")
        scene, frames_u8, _, _ = setup_from_config(cfg, rig_out["state"]
                                                   .params["tex"].device)
        checked(dataclasses.replace(cfg, pair_cap=records[0]["pair_cap"]),
                scene, rig_out["state"].params, frames_u8,
                "fit_rig_synthetic step")
        at = {r["step"] - 1: r["step"] / r["it_per_s"] for r in records}
        lo, hi = sorted(at)[1], sorted(at)[-1]
        rig_ms = (at[hi] - at[lo]) / (hi - lo) * 1e3
        rec["fit_rig_synthetic"] = {
            "ms_per_step": rig_ms, "seconds": rig_s, "coverage": cov,
            "pose_err_init": rig_out["err0"], "pose_err": rig_out["err"],
            "losses": [r["loss"] for r in records],
            "pair_cap": records[0]["pair_cap"], "launches": launches,
            "steps": n}
        print(f"fit_rig_synthetic: fit_take of a 9-camera take on disk "
              f"(256^2, 2 frames, batch 8, 3,072 tris) in {rig_s:.1f} s "
              f"with set-up, renders and results; {rig_ms:.3f} ms/step over "
              f"steps {lo}-{hi} (host clock); coverage {min(cov):.3f}-"
              f"{max(cov):.3f}; pose error {rig_out['err0']:.4f} -> "
              f"{rig_out['err']:.4f} (RECOVERING); pair_cap "
              f"{records[0]['pair_cap']}; launches from the host "
              f"{launches}, steps {n}", flush=True)

        # ---- the convergence study, batch 8 then batch 1 ----
        args = convergence_study.parse_args(["--out",
                                             os.path.join(tmp, "study")])
        study = convergence_study.build_study(args)
        init_err = float(np.abs(study["gt_t"]).mean())
        results, rec["convergence"] = {}, {}
        for batch in convergence_study.BATCHES:
            res, sec, launches, n = counted(
                lambda: convergence_study.fit_batch(study, batch))
            results[f"batch{batch}"] = res
            config, params = convergence_study.initial_state(study, batch)
            checked(config, study["scene"], params, study["frames_u8"],
                    f"convergence batch {batch} step")
            curve = res["curve"]
            want = example_launches(
                counters, host_steps(n, args.steps,
                                     f"convergence batch {batch}"), 0)
            if launches != want:
                fail(f"convergence batch {batch}: launches {launches} != "
                     f"{want}")
            if not all(math.isfinite(p["loss"]) for p in curve):
                fail(f"convergence batch {batch}: non-finite logged loss")
            if not res["final_loss"] < curve[0]["loss"]:
                fail(f"convergence batch {batch}: final loss "
                     f"{res['final_loss']} not below the first logged "
                     f"{curve[0]['loss']}")
            if not res["final_pose_err"] < init_err:
                fail(f"convergence batch {batch}: final pose error "
                     f"{res['final_pose_err']} not below its start "
                     f"{init_err}")
            rec["convergence"][f"batch{batch}"] = {
                "seconds": sec, "ms_per_step": sec / args.steps * 1e3,
                "loss_first": curve[0]["loss"], "loss_final":
                res["final_loss"], "pose_err_first": curve[0]["pose_err"],
                "pose_err_final": res["final_pose_err"],
                "min_pose_err": min(p["pose_err"] for p in curve),
                "launches": launches, "steps": n}
            print(f"convergence batch {batch}: {args.steps} steps at 512^2 "
                  f"in {sec:.1f} s ({sec / args.steps * 1e3:.3f} ms/step, "
                  f"host clock, autotune and a loss read every 25 steps); "
                  f"loss {curve[0]['loss']:.3f} (step {curve[0]['step']}) "
                  f"-> {res['final_loss']:.3f}; pose error {init_err:.4f} "
                  f"-> {res['final_pose_err']:.4f}; launches from the host "
                  f"{launches}, steps {n}", flush=True)
        converged = convergence_study.write_report(study, results)
        with open(os.path.join(args.out, "convergence.md")) as f:
            table = f.read()
        rec["convergence"].update(
            converged=converged, init_pose_err=init_err,
            curves={f"batch{b}": results[f"batch{b}"]["curve"]
                    for b in convergence_study.BATCHES},
            coverage=study["coverage"])
    ref_path = os.path.join(REPO, "results", "convergence_512",
                            "convergence.md")
    with open(ref_path) as f:
        ref = f.read()
    print(f"finding, not gated: JAX's rule says "
          f"{'CONVERGED' if converged else 'NOT CONVERGED'} on the H100 "
          f"({card}; synthetic rig):\n{table}JAX's recorded run "
          f"(results/convergence_512, the reference's real rig):\n{ref}",
          flush=True)
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"phase 5f: {rec['seconds']:.1f} s on {card}", flush=True)
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


def view_place_pairs(tex, bins1, height, width, sample_ph, tile_ids,
                     n_tiles, P):
    """K10 and K11 on one state's inputs, as phase 6 and ``chip_turns.py``
    time them. At the single view (bins ``bins1``): K10
    (``fused_raster_aa``), the "sepaa" route's K1 + K2 on the same bins
    (``sepaa``) and K1 alone (``fused_raster_view``). At the bench step's
    batch and the autotuned cap (``tile_ids``, P): K11 (``bin_place``).

    :return: {name: (kernel call, its plain version, or None)}.
    """
    from fpc_diffrend_tpu_torch.ops.cuda import antialias_cuda as ac
    from fpc_diffrend_tpu_torch.ops.cuda import bin_place_cuda as bp
    from fpc_diffrend_tpu_torch.ops.cuda import rasterize_cuda as rc

    H, W, ph = height, width, sample_ph
    pw = rc.pad_resolution(H, W)[1]

    def sepaa():
        k1 = rc.fused_raster(bins1, tex, ph, pw)
        return (*k1, ac.antialias_planes(k1[0], k1[2], k1[4], H, W, ph))

    return {
        "fused_raster_aa": (
            lambda: rc.fused_raster_aa(bins1, tex, ph, pw, H, W, ph),
            lambda: rc.fused_raster_aa_plain(bins1, tex, ph, pw, H, W, ph)),
        "sepaa": (sepaa, None),
        "fused_raster_view": (lambda: rc.fused_raster(bins1, tex, ph, pw),
                              None),
        "bin_place": (lambda: bp.place_pairs(tile_ids, n_tiles, P),
                      lambda: bp.place_pairs_plain(tile_ids, n_tiles, P)),
    }


def bin_sizes(tile_ids, n_tiles):
    """The live pair slots of each tile (uncapped): (largest bin, mean bin
    over all tiles, live slots)."""
    import torch

    counts = torch.bincount(tile_ids.reshape(-1).long(),
                            minlength=n_tiles + 1)[:n_tiles]
    live = int(counts.sum())
    return int(counts.max()) if n_tiles else 0, live / max(n_tiles, 1), live


def stack_positions(wl, batch: int = 8, seed: int = 17):
    """Phase 4b: each position of a stacked batch of ``batch`` samples
    against the same sample rendered alone (B = 1), bilinear and mip, on
    the bench workload with the bins uncapped (a cap pools B x cap entries
    over the batch, so it cuts a sample's entries at B = 1 and B = 8
    differently). The loss is sum(w * image) with one random weight image
    a position. The image must be equal bit for bit (the kernels evaluate
    a sample's records at its own rows whatever its position), the clip
    gradient within ``GRAD_SPREAD_RTOL`` of its largest magnitude (K3 and
    K5 sum with atomics).

    :return: {"bilinear" | "mip": {"grad_rel": [each position's],
        "img_equal": [...]}}.
    """
    import torch

    from fpc_diffrend_tpu_torch.fit import loop
    from fpc_diffrend_tpu_torch.ops.pipeline import render_batch_stacked

    config, scene, params = wl["config"], wl["scene"], wl["params"]
    dev = scene.device
    H, W = config.resolution
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    cams = torch.tensor(config.cam_idxs, dtype=torch.int64, device=dev)
    cam = cams[torch.randint(0, cams.shape[0], (batch,), generator=gen,
                             device=dev)]
    frame = torch.randint(0, wl["n_frames"], (batch,), generator=gen,
                          device=dev)
    with torch.no_grad():
        clip, _ = loop.sample_clip_positions(config, scene, params, cam,
                                             frame)
    weights = torch.rand((batch, H, W, 1), generator=gen, device=dev)
    tex = params["tex"].detach()

    def render(c, w, mip):
        c = c.clone().requires_grad_(True)
        img = render_batch_stacked(c, scene.faces, scene.uv, scene.uv_idx,
                                   tex, (H, W), scene.face_neighbors,
                                   enable_mip=mip,
                                   max_mip_level=MAX_MIP_LEVEL)
        (img * w).sum().backward()
        return img.detach(), c.grad

    out = {}
    for name, mip in (("bilinear", False), ("mip", True)):
        imgs, grad = render(clip, weights, mip)
        rel, same = [], []
        for b in range(batch):
            img1, grad1 = render(clip[b:b + 1], weights[b:b + 1], mip)
            same.append(bool(torch.equal(imgs[b], img1[0])))
            rel.append(_rel_err(grad[b], grad1[0]))
        out[name] = {"grad_rel": rel, "img_equal": same}
        print(f"stack positions ({name}, B = {batch}, cams "
              f"{cam.tolist()}, frames {frame.tolist()}): images equal "
              f"{same}; clip gradient vs B = 1, of its largest magnitude, "
              f"{['%.3g' % r for r in rel]} (limit {GRAD_SPREAD_RTOL})",
              flush=True)
        if not all(same):
            fail(f"stack positions ({name}): a position's image differs "
                 f"from its sample rendered alone: {same}")
        if max(rel) > GRAD_SPREAD_RTOL:
            fail(f"stack positions ({name}): a position's clip gradient is "
                 f"{max(rel):.3g} of its largest magnitude from its sample "
                 f"rendered alone (limit {GRAD_SPREAD_RTOL})")
    return out


def grad_spread(wl, n_runs: int = 3):
    """Phase 7: one bench step's forward and backward, ``n_runs`` times from
    the same state on the same batch (no optimizer update between them).
    The sums taken with atomics (K5, the setup chain's index backward) add
    in another order each run; K4's texel sums are float64, rounded once.

    :return: (parameter name -> the largest |g_run - g_first| over the
        runs, over the largest magnitude of g_first; parameter name ->
        whether every run's gradient equals the first bit for bit).
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
    return ({k: max(_rel_err(r[k], runs[0][k]) for r in runs[1:])
             for k in runs[0]},
            {k: all(torch.equal(r[k], runs[0][k]) for r in runs[1:])
             for k in runs[0]})


# ----------------------------------------------------------------------------
# Phase 10: the bench entry point, its rows, the precision modes and study
# ----------------------------------------------------------------------------

def precision_pairs(tex, k1, gcolour, bins, cot):
    """K4 (wrap and clamp) and K5 in each precision mode
    (``ops.precision``) on one state's inputs, as phase 10a and
    ``chip_turns.py --paths prec`` time them: at the bench batch, K4 on K1's
    uv planes ``k1`` and K3's colour cotangent ``gcolour``, K5 on the
    step's cotangent arguments ``cot`` (gtu, gtv, gcorners, guvz).

    :return: {"texture_bwd_<prec>_<wrap|clamp>", "pixel_grad_<prec>":
        (kernel call, its plain version)}.
    """
    from fpc_diffrend_tpu_torch.ops.cuda import raster_grad_cuda as gc
    from fpc_diffrend_tpu_torch.ops.cuda import texture_cuda as tc
    from fpc_diffrend_tpu_torch.ops.precision import GRAD_MODES, TEX_MODES

    _, entry, payload, extra, _ = k1
    tu, tv = payload[3], payload[4]
    args5 = (bins, entry, payload[0], payload[1], extra)
    pairs = {}
    for prec in TEX_MODES:
        for bmode in ("wrap", "clamp"):
            pairs[f"texture_bwd_{prec}_{bmode}"] = (
                lambda p=prec, m=bmode: tc.texture_planes_bwd(
                    tex, tu, tv, gcolour, m, p),
                lambda p=prec, m=bmode: tc.texture_planes_bwd_plain(
                    tex, tu, tv, gcolour, m, p))
    for prec in GRAD_MODES:
        fast = prec == "fast"
        pairs[f"pixel_grad_{prec}"] = (
            lambda f=fast: gc.pixel_grad(*args5, *cot, fast=f),
            lambda f=fast: gc.pixel_grad_plain(*args5, *cot, fast=f))
    return pairs


def check_precision(pairs, tex, k1, gcolour, bins, cot, label,
                    names=None):
    """Each fast variant of :func:`precision_pairs` (or those in
    ``names``) against its plain version at phase 3's limits: K4's gtu and
    gtv within ``K4_ATOL``, its gtex within ``K4_GTEX_RTOL`` and K5's live
    rows within ``ATOMIC_RTOL`` of the summed magnitudes. Each must also
    differ from the exact kernel's output (the mode took effect): gtu, gtv
    by more than ``K4_ATOL`` and K5's rows by more than ``ATOMIC_RTOL`` in
    every fast mode, gtex by more than ``ATOMIC_RTOL`` in "fast2" only; in
    "fast" gtex stays the exact one, within ``K4_GTEX_RTOL``.

    :return: {name: its errors}.
    """
    import torch

    from fpc_diffrend_tpu_torch.ops.cuda import texture_cuda as tc

    _, entry, payload, extra, _ = k1
    tu, tv = payload[3], payload[4]
    live = int(bins.bin_start[-1])
    out = {}
    for name, (kf, pf) in pairs.items():
        if name.endswith("exact") or "_exact_" in name or (
                names is not None and name not in names):
            continue
        got, want = kf(), pf()
        torch.cuda.synchronize()
        if name.startswith("texture_bwd"):
            prec, bmode = name.split("_")[2:]
            ex = pairs[f"texture_bwd_exact_{bmode}"][0]()
            mag = tc.texture_planes_bwd_plain(tex, tu, tv, gcolour.abs(),
                                              bmode, prec)[0]
            e = {"gtu/gtv": max(max_err(got[1], want[1]),
                                max_err(got[2], want[2])),
                 "gtex rel": atomic_err(got[0], want[0], mag),
                 "gtu/gtv vs exact": max(max_err(got[1], ex[1]),
                                         max_err(got[2], ex[2])),
                 "gtex rel vs exact": atomic_err(got[0], ex[0], mag),
                 "max_abs_err": max(max_err(a, b) for a, b in zip(got,
                                                                  want))}
            ok = e["gtu/gtv"] <= K4_ATOL and e["gtex rel"] <= K4_GTEX_RTOL
            took = e["gtu/gtv vs exact"] > K4_ATOL and (
                e["gtex rel vs exact"] > ATOMIC_RTOL if prec == "fast2"
                else e["gtex rel vs exact"] <= K4_GTEX_RTOL)
        else:
            ex = pairs["pixel_grad_exact"][0]()
            mag = k5_magnitudes(bins, entry, payload[0], payload[1], extra,
                                *cot)
            e = {"rows rel": max(
                     atomic_err(got[0][:live], want[0][:live], mag[0][:live]),
                     atomic_err(got[1], want[1], mag[1])),
                 "rows rel vs exact": max(
                     atomic_err(got[0][:live], ex[0][:live], mag[0][:live]),
                     atomic_err(got[1], ex[1], mag[1])),
                 "max_abs_err": max(max_err(got[0][:live], want[0][:live]),
                                    max_err(got[1], want[1]))}
            ok = e["rows rel"] <= ATOMIC_RTOL
            took = e["rows rel vs exact"] > ATOMIC_RTOL
        if not ok:
            fail(f"{label}: {name} differs from its plain version: {e}")
        if not took:
            fail(f"{label}: {name} is not its mode against exact: {e}")
        out[name] = e
    print(f"check {label}: precision modes {out} (K4 gtex rel limit "
          f"{K4_GTEX_RTOL})", flush=True)
    return out


def precision_turns(pairs, turns: int = 2) -> dict:
    """The kernels of :func:`precision_pairs` timed in turns, the order
    reversed each turn: {name: {"ms": [per turn], "device_ms": [...]}}
    (CUDA events and the profiler's device time, 20 calls a window)."""
    names = list(pairs)
    out = {n: {"ms": [], "device_ms": []} for n in names}
    for t in range(turns):
        for n in names if t % 2 == 0 else names[::-1]:
            out[n]["ms"].append(cuda_ms(pairs[n][0], 20))
            out[n]["device_ms"].append(device_ms(pairs[n][0], 20))
    return out


def bench_gates(rec, label):
    """Phase 10b's gates on one ``bench`` record: it survives a JSON round
    trip with a finite Mpix/s; K11 and K1-K6 ran on the device once a
    step of its measured launches (K8 and K9 in place of K4 on the mip
    row), K7 and K10 never; the temporal term nonzero exactly where its
    weight is."""
    from fpc_diffrend_tpu_torch.ops.cuda import device_want

    line = json.loads(json.dumps(rec))
    if not (math.isfinite(line["value"]) and line["value"] > 0
            and math.isfinite(line["step_ms"])):
        fail(f"{label}: bench line without a finite Mpix/s: {line}")
    steps, mip = line["steps"], "mip" in label
    want = dict.fromkeys(STEP_KERNELS, steps)
    if mip:
        want.update(texture_bwd=0, mip_sample=steps, mip_sample_bwd=steps)
    want = device_want(want)
    if line["launches"] != want:
        fail(f"{label}: launches {line['launches']} != {want}")
    if (line["temporal"] > 0) != ("temporal" in label):
        fail(f"{label}: temporal term {line['temporal']}")


# the bench rows whose shapes no earlier phase checks the kernels at (the
# headline's and the mip row's are phase 6's)
CHECKED_ROWS = ("256sq-1cam", "512sq-9cam", "temporal-100f-2cam")


def precision_phase(tex, sstate, card):
    """Phase 10: (a) the fast K4 and K5 variants at the bench step's
    inputs against their plain versions and unlike exact
    (:func:`check_precision`), then every mode of K4 and K5 timed in turns;
    (b) ``bench_matrix --quick`` over its five rows in the exact mode, then
    the headline row in JAX's default modes (``--grad-prec fast --tex-prec
    fast2``), each held by :func:`bench_gates`, and the kernels checked
    at the shapes of the rows in ``CHECKED_ROWS`` (:func:`check_fit_step`);
    (c) the precision study (``examples/precision_study.py``) at 300 steps
    under all three configs: each config's final loss below its first
    logged loss and its pose error below its start; JAX's verdict printed,
    not gated; then :func:`check_fit_step` with the fast variants on one
    step's inputs of the study's fit.

    :return: the phase's record.
    """
    import tempfile

    import torch

    from fpc_diffrend_tpu_torch import bench, bench_matrix
    from fpc_diffrend_tpu_torch.examples import (convergence_study,
                                                 precision_study)
    from fpc_diffrend_tpu_torch.ops.cuda import KERNELS as counters

    t_phase = time.perf_counter()
    rec = {}
    # ---- 10a ----
    gcolour = sstate["k3"][0]
    pairs = precision_pairs(tex, sstate["k1"], gcolour, sstate["bins"],
                            sstate["k5_cot"])
    with torch.no_grad():
        rec["checks"] = check_precision(pairs, tex, sstate["k1"], gcolour,
                                        sstate["bins"], sstate["k5_cot"],
                                        "bench batch")
        rec["turns"] = precision_turns(pairs)
    print(f"phase 10a: K4 and K5 by precision mode, in turns (CUDA "
          f"events, ms; device ms by the profiler; {card}): "
          f"{rec['turns']}", flush=True)
    # ---- 10b ----
    def check_row(name, wl):
        """K1-K6 and K11 at the shapes of a row no earlier phase checks,
        on one step's inputs of its fitted state; counters then zeroed."""
        if name not in CHECKED_ROWS:
            return
        check_fit_step(wl["config"], wl["scene"], wl["state"].params,
                       wl["frames_u8"], f"{name} step")
        for f in counters.values():
            f.launches = 0

    rows = bench_matrix.run(quick=True, check=check_row)
    fast, _ = bench.run(bench_matrix.row_args(
        "1600x1200-headline", quick=True, grad_prec="fast",
        tex_prec="fast2"))
    print(json.dumps(fast), flush=True)
    for r in rows:
        bench_gates(r, r["row"])
    bench_gates(fast, "1600x1200-headline, fast/fast2")
    rec["bench_matrix"] = rows
    rec["bench_fast"] = fast
    print(f"phase 10b ({card}):\n" + bench_matrix.table(
        rows + [dict(fast, config="1600x1200-headline fast/fast2")]),
          flush=True)
    # ---- 10c ----
    with tempfile.TemporaryDirectory() as tmp:
        args = precision_study.parse_args(["--steps", "300", "--out", tmp])
        t0 = time.perf_counter()
        study = precision_study.run(args)
        rec["study_s"] = time.perf_counter() - t0
    # the study's fast modes at 512^2: one step's inputs of its fit
    config, params = convergence_study.initial_state(study["study"],
                                                     precision_study.BATCH)
    check_fit_step(config, study["study"]["scene"], params,
                   study["study"]["frames_u8"], "precision study step",
                   modes=True)
    for f in counters.values():
        f.launches = 0
    rec["study"] = {}
    for tag, r in study["runs"].items():
        first = r["curve"][0]
        if not (r["final_loss"] < first["loss"]
                and r["final_pose_err"] < r["init_pose_err"]):
            fail(f"precision study {tag}: loss {first['loss']} -> "
                 f"{r['final_loss']}, pose error {r['init_pose_err']} -> "
                 f"{r['final_pose_err']}")
        rec["study"][tag] = {
            "loss_first": first["loss"], "loss_final": r["final_loss"],
            "pose_err_init": r["init_pose_err"],
            "pose_err_final": r["final_pose_err"],
            "verdict": study["verdicts"][tag][1]}
    print(f"phase 10c: precision study, 300 steps, {rec['study_s']:.1f} s "
          f"on {card}; JAX's verdict printed, not gated: {rec['study']}",
          flush=True)
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"phase 10: {rec['seconds']:.1f} s on {card}", flush=True)
    return rec


# ----------------------------------------------------------------------------
# Phase 8: the sharded fit step (parallel/ on torch.distributed)
# ----------------------------------------------------------------------------

SHARDED_RANKS = 4              # 8b and 8c: gloo ranks sharing the one card
SHARDED_CHILD_TIMEOUT = 600    # seconds a rank may take, build included
SHARDED_LOSS_RTOL = 2e-4       # tests/test_parallel.py's limit for 8b
BAND_ATOL = 2e-3               # tests/test_parallel.py's band limit (8c)
BAND_ATOL_SHARE = 1e-3         # 8c: share of values allowed past BAND_ATOL
SEAM_ROW_FACTOR = 5.0          # 8c: the seam rows' share past BAND_ATOL
SEAM_ROW_SLACK = 2             #     against the other rows' (+ values)
TEMPORAL_WEIGHT = 1.0          # 8b: the temporal term and its pose halo
# 8b and 8c run at the bench's depth range and at one where the dome's
# depths resolve (as phase 5f's examples do)
SHARDED_RANGES = {"bench": None, "50-250": (50.0, 250.0)}


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def sharded_workload(dev, near_far=None):
    """Phase 8b's inputs, built alike in every rank and in the parent: the
    bench workload with the temporal term on, per-frame translations
    drawn from a seed (so the term and its halo have a gradient) and the
    stratified batch of a (2, 1, 2) mesh (each frame shard samples its own
    two frames).

    :param near_far: the cameras' (near, far) depth range; None the
        bench's [0.01, 200].
    :return: (workload dict, config, full parameters, global Batch)."""
    import dataclasses

    import numpy as np
    import torch

    from fpc_diffrend_tpu_torch.fit import loop
    from fpc_diffrend_tpu_torch.workload import build_workload

    wl = build_workload(device=dev)
    if near_far is not None:       # the GL depth terms of another range
        zn, zf = (torch.tensor(v, device=dev) for v in near_far)
        wl["scene"].proj[:, 2, 2] = -(zf + zn) / (zf - zn)
        wl["scene"].proj[:, 2, 3] = -(2.0 * zf * zn) / (zf - zn)
    config = dataclasses.replace(wl["config"],
                                 weight_temporal=TEMPORAL_WEIGHT)
    params = {k: v.detach().clone() for k, v in wl["params"].items()}
    rng = np.random.default_rng(8)
    params["per_frame_t"] = torch.as_tensor(rng.normal(
        0.0, 0.05, (wl["n_frames"], 3)).astype(np.float32), device=dev)
    stand_in = type("Mesh", (), {"mesh_dim_names": ("frame", "view", "tile"),
                                 "mesh": torch.zeros(2, 1, 2)})()
    from fpc_diffrend_tpu_torch.parallel.train import sample_stratified

    cam, frame = sample_stratified(rng, config, stand_in, wl["n_frames"],
                                   len(config.cam_idxs))
    cam, frame = cam.to(dev), frame.to(dev)
    batch = loop.Batch(cam, frame, loop.decode_refs(wl["frames_u8"], cam,
                                                    frame))
    return wl, config, params, batch


def sharded_rank_main(argv) -> int:
    """One gloo rank of phases 8b and 8c (``python3 chip_smoke.py
    --sharded-rank R WORLD HOST:PORT OUT_DIR RANGE``): the frame-sharded
    step at mesh (2, 1, 2), then one view's bands at mesh (1, 1, 4), at
    the depth range ``SHARDED_RANGES[RANGE]``; results to
    ``OUT_DIR/rank{R}.pt``."""
    import torch

    sys.path.insert(0, REPO)
    from fpc_diffrend_tpu_torch.ops.cuda import KERNELS as counters
    from fpc_diffrend_tpu_torch.fit import loop
    from fpc_diffrend_tpu_torch.fit import state as state_mod
    from fpc_diffrend_tpu_torch.models.camera import transform_clip
    from fpc_diffrend_tpu_torch.ops.pipeline import (render,
                                                     render_batch_stacked)
    from fpc_diffrend_tpu_torch.parallel import mesh as pmesh
    from fpc_diffrend_tpu_torch.parallel import multihost, spatial
    from fpc_diffrend_tpu_torch.parallel import train as ptrain

    rank, world, coord, out_dir, depth = (int(argv[0]), int(argv[1]),
                                          argv[2], argv[3], argv[4])
    t0 = time.perf_counter()
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    multihost.initialize(coord, world, rank, backend="gloo")
    wl, config, params, batch = sharded_workload(dev, SHARDED_RANGES[depth])
    out = {"rank": rank, "setup_s": time.perf_counter() - t0}

    # 8b: the frame-sharded step
    mesh = pmesh.make_mesh(("frame", "view", "tile"), (2, 1, 2))
    step = ptrain.make_sharded_train_step(config, wl["scene"], mesh,
                                          shard_frames=True,
                                          params_like=params)
    state = state_mod.init_state(config, ptrain.frame_shard(params, mesh))
    local = ptrain.shard_batch_for(mesh, batch)
    for f in counters.values():
        f.launches = 0
    _, metrics = step(state, local)
    torch.cuda.synchronize()
    out["launches"] = {k: f.launches for k, f in counters.items()}
    grads = ptrain.gather_frame_shards(
        {k: p.grad for k, p in state.params.items()}, mesh)
    out["loss"] = float(metrics["loss"])
    out["coords"] = {a: pmesh.axis_index(mesh, a)
                     for a in ("frame", "view", "tile")}
    out["samples"] = int(local.cam_idx.shape[0])
    out["band_rows"] = int(local.ref.shape[1])
    if rank == 0:
        out["grads"] = {k: v.detach().cpu() for k, v in grads.items()}
    # the same step with the per-frame parameters replicated: the same
    # renders, so the same gradients up to the order of the sums
    rstep = ptrain.make_sharded_train_step(config, wl["scene"], mesh)
    rstate = state_mod.init_state(config, {k: v.clone()
                                           for k, v in params.items()})
    _, rmetrics = rstep(rstate, local)
    out["loss_replicated"] = float(rmetrics["loss"])
    if rank == 0:
        out["grads_replicated"] = {k: p.grad.detach().cpu()
                                   for k, p in rstate.params.items()}
    n = 3
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for _ in range(n):
        step(state, local)
    torch.cuda.synchronize()
    out["step_ms"] = (time.perf_counter() - t1) / n * 1e3

    # 8c: one view in four bands, forward only
    mesh4 = pmesh.make_mesh(("frame", "view", "tile"), (1, 1, 4))
    band = pmesh.axis_index(mesh4, "tile")
    H, W = wl["H"], wl["W"]
    p0 = wl["params"]
    with torch.no_grad():
        idx = torch.zeros(1, dtype=torch.int64, device=dev)
        mvp = loop.build_mvp(wl["scene"], p0, idx, idx)[0]
        verts = loop.sample_clip_positions(config, wl["scene"], p0, idx,
                                           idx)[1][0]
        sc = wl["scene"]
        args = (sc.faces, sc.uv, sc.uv_idx, p0["tex"])
        for f in counters.values():
            f.launches = 0
        img = spatial.render_band(mvp, verts, *args, (H // 4, W),
                                  sc.face_neighbors, band, 4,
                                  group=mesh4.get_group("tile"),
                                  pair_cap=config.pair_cap)
        torch.cuda.synchronize()
        out["band_launches"] = {k: f.launches for k, f in counters.items()}
        out["band"], out["band_img"] = band, img.cpu()
        out["band_img_no_seam"] = spatial.render_band(
            mvp, verts, *args, (H // 4, W), sc.face_neighbors, band, 4,
            pair_cap=config.pair_cap).cpu()
        if rank == 0:
            out["full_img"] = render(mvp, verts, *args, (H, W),
                                     sc.face_neighbors,
                                     pair_cap=config.pair_cap).cpu()
            # the witness: the same view as the second sample of a stack,
            # which moves its rows and so the rounding of its planes
            pc = transform_clip(mvp, verts)
            out["full_img_at_1"] = render_batch_stacked(
                torch.stack([pc, pc]), *args, (H, W), sc.face_neighbors,
                pair_cap=config.pair_cap)[1].cpu()
    out["seconds"] = time.perf_counter() - t0
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()
    return 0


def spawn_sharded_ranks(out_dir, depth):
    """Start phase 8b/8c's ranks, each its own process on the one card,
    and wait for them; fail if one fails, or outlives its timeout (then
    every rank is killed).

    :return: the ranks' results, by rank.
    """
    import torch

    coord = f"localhost:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--sharded-rank",
         str(r), str(SHARDED_RANKS), coord, out_dir, depth],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(SHARDED_RANKS)]
    logs, deadline = [], time.perf_counter() + SHARDED_CHILD_TIMEOUT
    try:
        for p in procs:
            left = max(deadline - time.perf_counter(), 1.0)
            try:
                logs.append(p.communicate(timeout=left)[0])
            except subprocess.TimeoutExpired:
                fail(f"sharded rank {len(logs)} ran past "
                     f"{SHARDED_CHILD_TIMEOUT} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            fail(f"sharded rank {r} exited {p.returncode}:\n{log[-4000:]}")
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(SHARDED_RANKS)]


def sharded_phase(wl, card):
    """Phase 8: the sharded fit step at the bench workload's full width.

    8a: world size 1 (NCCL), mesh (1, 1, 1): the sharded step and
    ``fit.loop.train_step`` from one state on the bench batch (loss within
    1e-6 relative, every gradient within ``GRAD_SPREAD_RTOL`` of its
    largest magnitude, K11, K1-K6 once in the sharded step), then their ms
    per step in turns. 8b: four gloo ranks on the one card, mesh (2, 1,
    2), ``shard_frames`` and the temporal term: the loss within 2e-4 of
    the single-process step's, the summed gradients (frame shards
    gathered) within ``GRAD_SPREAD_RTOL``, K11, K1-K6 once on every rank.
    8c: mesh (1, 1, 4), one view's four 300-row bands stitched against the
    full-frame render, within 2e-3.

    :return: the phase's record.
    """
    import torch
    import torch.distributed as dist

    from fpc_diffrend_tpu_torch.ops.cuda import KERNELS as counters
    from fpc_diffrend_tpu_torch.fit import loop
    from fpc_diffrend_tpu_torch.fit import state as state_mod
    from fpc_diffrend_tpu_torch.kernels import build
    from fpc_diffrend_tpu_torch.parallel import multihost
    from fpc_diffrend_tpu_torch.parallel import train as ptrain

    t_phase = time.perf_counter()
    rec = {}

    # ---- 8a ----
    multihost.initialize(f"localhost:{_free_port()}", 1, 0)
    mesh = multihost.make_pod_mesh()
    config, scene, batch = wl["config"], wl["scene"], wl["batch"]
    start = {k: v.detach().clone() for k, v in wl["params"].items()}

    def fresh():
        return state_mod.init_state(config, {k: v.clone()
                                             for k, v in start.items()})

    step = ptrain.make_sharded_train_step(config, scene, mesh)
    local = ptrain.shard_batch_for(mesh, batch)
    s_sh, s_one = fresh(), fresh()
    for f in counters.values():
        f.launches = 0
    _, m_sh = step(s_sh, local)
    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters.items()}
    m_one = loop.train_step(config, scene, s_one, batch)
    l_sh, l_one = float(m_sh["loss"]), float(m_one["loss"])
    loss_rel = abs(l_sh - l_one) / abs(l_one)
    gerr = {k: _rel_err(s_sh.params[k].grad, p.grad)
            for k, p in s_one.params.items() if float(p.grad.abs().max())}
    want = {k: int(k in STEP_KERNELS) for k in counters}
    if launches != want:
        fail(f"8a: the sharded step's launches {launches} != {want}")
    if not loss_rel <= 1e-6 or not all(
            v <= GRAD_SPREAD_RTOL for v in gerr.values()):
        fail(f"8a: the sharded step (mesh (1, 1, 1)) differs from "
             f"train_step: loss {l_sh} vs {l_one} ({loss_rel:.3g} rel), "
             f"gradients {gerr}")
    turns = {"sharded": [], "unsharded": []}
    n = 5
    for name in ("sharded", "unsharded", "sharded", "unsharded"):
        fn = ((lambda: step(s_sh, local)) if name == "sharded"
              else (lambda: loop.train_step(config, scene, s_one, batch)))
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        turns[name].append((time.perf_counter() - t0) / n * 1e3)
    ratio = sum(turns["sharded"]) / sum(turns["unsharded"])
    dist.destroy_process_group()
    rec["8a"] = {"loss": [l_sh, l_one], "loss_rel": loss_rel,
                 "grad_rel": gerr, "launches": launches,
                 "ms_per_step_turns": turns, "ratio": ratio}
    print(f"phase 8a (world 1, NCCL, mesh (1, 1, 1), bench workload): "
          f"loss {l_sh} vs train_step {l_one} ({loss_rel:.3g} rel); "
          f"gradients over their largest magnitude {gerr}; launches "
          f"{launches}; ms per step in turns (host clock, {n} steps each, "
          f"{card}): sharded {turns['sharded']}, unsharded "
          f"{turns['unsharded']}, ratio {ratio:.4f}", flush=True)

    # ---- 8b, 8c: four ranks on the card, at two depth ranges ----
    build.build()          # the ranks load these libraries, not nvcc's
    torch.cuda.empty_cache()
    for depth in SHARDED_RANGES:
        rec[depth] = sharded_ranks(scene.device, depth, card,
                                   gate=depth == "50-250")
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"phase 8: {rec['seconds']:.1f} s on {card}", flush=True)
    return rec


def _rel_l2(a, b) -> float:
    """||a - b|| over ||b|| (2-norms)."""
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def sharded_ranks(dev, depth, card, gate):
    """Phases 8b and 8c at one depth range.

    8b's ranks take the frame-sharded step, then the same step with the
    per-frame parameters replicated: both render the same bands of the
    same samples, so their losses must agree within 1e-6 relative and
    every summed gradient within ``GRAD_SPREAD_RTOL`` of its largest
    magnitude (the order of the sums aside, the same arithmetic). Against
    the single-process ``train_step`` the global loss must agree within
    2e-4. The gradients against it are printed beside the witness of
    ``train_step`` against itself on the batch in reverse order: a band
    rounds its clip y, and a sample moved in the stack its planes,
    otherwise, which moves the antialias's occluder and the winner of a
    pixel whose centre lies within rounding of an edge; the pose and
    vertex gradients are sums that cancel to a small remainder, which
    such pixels move by tens of percent (the witness shows it). The
    texture gradient does not cancel: with ``gate`` it must agree within
    ``GRAD_SPREAD_RTOL`` in relative L2.

    8c's four bands, stitched, against the full-frame view: with
    ``gate``, at most ``BAND_ATOL_SHARE`` of the values past
    ``BAND_ATOL``, and the rows beside a band's edge (where the seam
    blends) no worse than the others, ``SEAM_ROW_FACTOR`` x their share
    (with ``SEAM_ROW_SLACK`` values more). Printed beside: the view as a
    second sample of a stack, and the bands without the seam.

    :param gate: fail past the limits (else only print them).
    :return: the record.
    """
    import tempfile

    import torch

    from fpc_diffrend_tpu_torch.ops.cuda import KERNELS as counters
    from fpc_diffrend_tpu_torch.fit import loop
    from fpc_diffrend_tpu_torch.fit import state as state_mod

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_") as tmp:
        ranks = spawn_sharded_ranks(tmp, depth)
    ranks_s = time.perf_counter() - t0
    swl, sconfig, sparams, sbatch = sharded_workload(dev,
                                                     SHARDED_RANGES[depth])

    def single_step(batch):
        st = state_mod.init_state(sconfig, {k: v.clone()
                                            for k, v in sparams.items()})
        m = loop.train_step(sconfig, swl["scene"], st, batch)
        return float(m["loss"]), {k: p.grad for k, p in st.params.items()}

    l_ref, g_ref = single_step(sbatch)
    _, g_rev = single_step(loop.Batch(*(x.flip(0) for x in sbatch)))
    losses = [r["loss"] for r in ranks]
    if len(set(losses)) != 1:
        fail(f"8b ({depth}): the ranks' global losses differ: {losses}")
    loss_rel = abs(losses[0] - l_ref) / abs(l_ref)
    l_rep = ranks[0]["loss_replicated"]
    rep_rel = abs(losses[0] - l_rep) / abs(l_rep)
    g_sh = ranks[0]["grads"]
    g_rep = ranks[0]["grads_replicated"]
    live = [k for k, g in g_ref.items() if float(g.abs().max())]
    rep_err = {k: _rel_err(g_sh[k], g_rep[k]) for k in live}
    gerr = {k: {"max_rel": _rel_err(g_sh[k].to(dev), g_ref[k]),
                "l2_rel": _rel_l2(g_sh[k].to(dev), g_ref[k]),
                "reversed_max_rel": _rel_err(g_rev[k], g_ref[k]),
                "reversed_l2_rel": _rel_l2(g_rev[k], g_ref[k])}
            for k in live}
    stray = [k for k in g_ref if k not in live
             and float(g_sh[k].abs().max())]
    print(f"phase 8b (4 gloo ranks on one card, mesh (2, 1, 2), "
          f"shard_frames, weight_temporal {TEMPORAL_WEIGHT}, depth range "
          f"{depth}): ranks {[r['coords'] for r in ranks]}, "
          f"{ranks[0]['samples']} samples and {ranks[0]['band_rows']} rows "
          f"a rank; loss {losses[0]}, with the per-frame parameters "
          f"replicated {l_rep} ({rep_rel:.3g} rel), train_step {l_ref} "
          f"({loss_rel:.3g} rel); summed gradients against the replicated "
          f"step's (max over the largest magnitude) {rep_err}; against "
          f"train_step's (and train_step's own on the batch reversed) "
          f"{gerr}{'' if gate else ' (not gated)'}; launches "
          f"{[r['launches'] for r in ranks]}; ms per step a rank "
          f"{[round(r['step_ms'], 3) for r in ranks]} ({card}); ranks ran "
          f"{ranks_s:.1f} s (each {[round(r['seconds'], 1) for r in ranks]})",
          flush=True)
    bad = [r["rank"] for r in ranks
           if r["launches"] != {k: int(k in STEP_KERNELS) for k in counters}]
    if bad:
        fail(f"8b: ranks {bad} did not launch K11, K1-K6 once: "
             f"{[r['launches'] for r in ranks]}")
    if not rep_rel <= 1e-6 or not all(
            v <= GRAD_SPREAD_RTOL for v in rep_err.values()) or stray:
        fail(f"8b ({depth}): the frame-sharded step differs from the "
             f"replicated one: loss {rep_rel:.3g} rel, gradients {rep_err}; "
             f"nonzero where train_step's are zero: {stray}")
    if not loss_rel <= SHARDED_LOSS_RTOL:
        fail(f"8b ({depth}): loss {losses[0]} vs {l_ref} ({loss_rel:.3g} "
             "rel)")
    if gate and not gerr["tex"]["l2_rel"] <= GRAD_SPREAD_RTOL:
        fail(f"8b ({depth}): the texture gradient differs from "
             f"train_step's: {gerr['tex']}")
    if not float(g_sh["per_frame_t"].abs().max()):
        fail("8b: the per-frame translations got no gradient")

    bands = sorted((r["band"], r["band_img"], r["band_img_no_seam"])
                   for r in ranks)
    if [b[0] for b in bands] != [0, 1, 2, 3]:
        fail(f"8c: the ranks rendered bands {[b[0] for b in bands]}")
    stitched = torch.cat([img for _, img, _ in bands])
    no_seam = torch.cat([img for _, _, img in bands])
    full, witness = ranks[0]["full_img"], ranks[0]["full_img_at_1"]
    hb = full.shape[0] // 4
    edge = torch.zeros(full.shape[0], dtype=torch.bool)
    edge[hb - 1::hb] = True
    edge[hb::hb] = True
    edge[-1] = False
    counts = {}
    for name, img in (("bands", stitched), ("second sample", witness),
                      ("bands without the seam", no_seam)):
        diff = (img - full).abs()
        counts[name] = {"max_abs_err": float(diff.max()),
                        "over_1e-5": int((diff > 1e-5).sum()),
                        "over_atol": int((diff > BAND_ATOL).sum()),
                        "over_atol_seam_rows": int(
                            (diff[edge] > BAND_ATOL).sum())}
    c = counts["bands"]
    n_edge = int(edge.sum()) * full[0].numel()
    n_rest = full.numel() - n_edge
    seam_limit = (SEAM_ROW_FACTOR * (c["over_atol"] - c["over_atol_seam_rows"])
                  / n_rest * n_edge + SEAM_ROW_SLACK)
    blaunch = [r["band_launches"] for r in ranks]
    want = {k: int(k in ("bin_place", "fused_raster", "antialias"))
            for k in counters}
    print(f"phase 8c (mesh (1, 1, 4), {hb}-row bands of camera 0, frame 0, "
          f"depth range {depth}): against the full view ({full.numel()} "
          f"values) {counts}; limits: past {BAND_ATOL} at most "
          f"{BAND_ATOL_SHARE * full.numel():.0f} values, in the "
          f"{int(edge.sum())} rows beside a band's edge at most "
          f"{seam_limit:.1f}{'' if gate else ' (not gated)'}; launches "
          f"{blaunch}", flush=True)
    if gate and (c["over_atol"] > BAND_ATOL_SHARE * full.numel()
                 or c["over_atol_seam_rows"] > seam_limit):
        fail(f"8c ({depth}): the stitched bands differ from the full view: "
             f"{counts}")
    if any(b != want for b in blaunch):
        fail(f"8c: a rank's band launches {blaunch} != {want}")
    return {"8b": {"loss": losses[0], "loss_replicated": l_rep,
                   "loss_train_step": l_ref, "loss_rel": loss_rel,
                   "replicated_grad_max_rel": rep_err, "grad_err": gerr,
                   "launches": [r["launches"] for r in ranks],
                   "step_ms": [r["step_ms"] for r in ranks],
                   "rank_seconds": [r["seconds"] for r in ranks],
                   "ranks_s": ranks_s},
            "8c": {**counts, "seam_row_limit": seam_limit,
                   "launches": blaunch}}


# ----------------------------------------------------------------------------
# Phase 9: the host tools
# ----------------------------------------------------------------------------

UNDISTORT_DIST = (-0.21, 0.08, 0.003, -0.002, 0.01)   # k1 k2 p1 p2 k3
# the card's remap against the CPU's: the map (~15 float32 operations on
# coordinates up to 1,600, whose ulp is 1.2e-4) within 8 ulps, the frame
# within that times its steepest step (255 counts)
UNDISTORT_MAP_ATOL = 1e-3      # pixels
UNDISTORT_DEVICE_ATOL = 0.25   # counts
# cv2.undistort maps integer pixel coordinates (the remap, pixel centres)
# and interpolates at 1/32 pixel, so the two differ by a few counts at
# steep steps; their mean difference stays within
UNDISTORT_CV2_MEAN = 2.0       # counts


def tools_phase(take, card):
    """Phase 9, on 5c's take and 5d's renders (run while they are on
    disk): ``tools.undistort.undistort_image_torch`` on the card over the
    take's frames against the same remap on the CPU (the image within
    ``UNDISTORT_DEVICE_ATOL``, the map within ``UNDISTORT_MAP_ATOL``) and
    against ``cv2.undistort`` (mean within ``UNDISTORT_CV2_MEAN``); a
    ``data.seq`` round trip (``write_seq`` -> ``SeqReader`` ->
    ``extract_to_tif``) of camera 0's frames, exact; ``tools.comparisons``
    on 5d's side-by-side renders against the take's frames (the crop's
    means equal to numpy's, heatmaps that parse).

    :return: the phase's record.
    """
    import json as json_mod
    import tempfile

    import numpy as np
    import torch
    from PIL import Image

    from fpc_diffrend_tpu_torch.data import seq as seqlib
    from fpc_diffrend_tpu_torch.tools import comparisons
    from fpc_diffrend_tpu_torch.tools.undistort import (undistort_image_cv2,
                                                        undistort_image_torch,
                                                        undistort_map)

    fcfg, paths, written, _ = take
    t_phase = time.perf_counter()
    rec = {}
    C, F, H, W = written.shape
    with open(paths["calibpath"]) as f:
        calib = json_mod.load(f)
    dist_c = np.asarray(UNDISTORT_DIST, np.float32)
    keys = sorted(calib)[:C]
    dev_err = map_err = cv_err = cv_mean = 0.0
    t_card = 0.0
    try:
        import cv2  # noqa: F401
        have_cv2 = True
    except ImportError:
        have_cv2 = False
    for c, key in enumerate(keys):
        intr = np.asarray(calib[key]["intrinsic"], np.float32)
        for i in range(F):
            img = written[c, i]
            t0 = time.perf_counter()
            got = undistort_image_torch(img, intr, dist_c)
            torch.cuda.synchronize()
            t_card += time.perf_counter() - t0
            cpu = undistort_image_torch(img, intr, dist_c, device="cpu")
            dev_err = max(dev_err, float((got.cpu() - cpu).abs().max()))
            if i == 0:
                map_err = max(map_err, float((undistort_map(
                    intr, dist_c, H, W).cpu() - undistort_map(
                        intr, dist_c, H, W, "cpu")).abs().max()))
            if have_cv2:
                d = np.abs(got.cpu().numpy()
                           - undistort_image_cv2(img, intr, dist_c))
                cv_err, cv_mean = max(cv_err, float(d.max())), max(
                    cv_mean, float(d.mean()))
    n = C * F
    print(f"phase 9 undistort: {n} frames of {H}x{W}, the card's remap "
          f"against the CPU's max abs err {dev_err:.3g} counts (limit "
          f"{UNDISTORT_DEVICE_ATOL}), its map {map_err:.3g} px (limit "
          f"{UNDISTORT_MAP_ATOL}); against cv2.undistort "
          + (f"max {cv_err:.3g}, mean {cv_mean:.3g} counts (mean limit "
             f"{UNDISTORT_CV2_MEAN})" if have_cv2 else "not run (no cv2)")
          + f"; {t_card / n * 1e3:.2f} ms a frame on the card (host clock, "
          f"{card})", flush=True)
    if (not dev_err <= UNDISTORT_DEVICE_ATOL
            or not map_err <= UNDISTORT_MAP_ATOL
            or (have_cv2 and not cv_mean <= UNDISTORT_CV2_MEAN)):
        fail(f"9: the torch remap differs: card vs CPU {dev_err} ({map_err} "
             f"px in the map), vs cv2 mean {cv_mean}")
    rec["undistort"] = {"frames": n, "card_vs_cpu": dev_err,
                        "map_card_vs_cpu_px": map_err,
                        "vs_cv2_max": cv_err if have_cv2 else None,
                        "vs_cv2_mean": cv_mean if have_cv2 else None,
                        "ms_per_frame": t_card / n * 1e3}

    with tempfile.TemporaryDirectory(prefix="chip_smoke_tools_") as tmp:
        seq = os.path.join(tmp, "cam0.seq")
        seqlib.write_seq(seq, written[0])
        reader = seqlib.SeqReader(seq)
        same = len(reader) == F and all(
            np.array_equal(reader.read_frame(i), written[0, i])
            for i in range(F))
        reader.close()
        n_tif = seqlib.extract_to_tif(seq, os.path.join(tmp, "tif"), "cam0")
        same = same and n_tif == F and all(np.array_equal(
            np.array(Image.open(os.path.join(tmp, "tif",
                                             f"cam0_{i:03d}.tif"))),
            written[0, i]) for i in range(F))
        if not same:
            fail("9: the .seq round trip changed the take's frames")

        inf, refd = os.path.join(tmp, "inf"), os.path.join(tmp, "ref")
        os.makedirs(inf)
        os.makedirs(refd)
        result_dir = os.path.join(fcfg.out_dir, "result")
        renders = []
        for i in range(F):
            png = np.array(Image.open(os.path.join(
                result_dir, f"frame{i}_side-by-side.png")))
            png = png.reshape(H, 2 * W)[:, W:]
            renders.append(png)
            Image.fromarray(png).save(os.path.join(inf,
                                                   f"frame{i}_pose.png"))
            Image.fromarray(written[0, i]).save(os.path.join(
                refd, f"pod2colour_pod2primary_{i:03d}.tif"))
        means = comparisons.compare_sequence_numerical(
            inf, refd, os.path.join(tmp, "num"), F)
        want = [float(np.abs(r[200:1400, 100:1100].astype(np.int32)
                             - written[0, i, 200:1400, 100:1100]).mean())
                for i, r in enumerate(renders)]
        comparisons.compare_sequence(inf, refd, os.path.join(tmp, "heat"),
                                     F)
        heat = np.array(Image.open(os.path.join(tmp, "heat",
                                                "colcomp_0.png")))
        if not np.allclose(means, want, rtol=1e-12) or heat.shape != (
                H, W, 3):
            fail(f"9: comparisons gave {means} (numpy {want}), a heatmap of "
                 f"{heat.shape}")
    rec["seq_frames"] = F
    rec["crop_means"] = means
    rec["seconds"] = time.perf_counter() - t_phase
    print(f"phase 9: .seq round trip of {F} frames exact; comparisons of "
          f"5d's renders against the take: crop means {means}, heatmaps "
          f"{heat.shape}; {rec['seconds']:.1f} s on {card}", flush=True)
    return rec


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


def _diff_pair_masks(idbuf, height, width, sample_ph):
    """(h, v): the pixels whose pair to the right (h) or below (v) has ids
    that differ, within the pair masks of K2/K3."""
    import torch

    rows, pw = idbuf.shape
    h = torch.zeros_like(idbuf, dtype=torch.bool)
    h[:, :width - 1] = idbuf[:, :width - 1] != idbuf[:, 1:width]
    vmask = (torch.arange(rows, device=idbuf.device) % sample_ph
             < height - 1)[:-1, None]
    v = torch.zeros_like(h)
    v[:-1] = (idbuf[:-1] != idbuf[1:]) & vmask
    return h, v


def _diff_pairs(idbuf, height, width, sample_ph):
    """(pairs whose ids differ, mask of the pixels in at least one such
    pair), within the pair masks of K2/K3."""
    h, v = _diff_pair_masks(idbuf, height, width, sample_ph)
    px = h.clone()
    px[:, 1:] |= h[:, :-1]
    px |= v
    px[1:] |= v[:-1]
    return int(h.sum() + v.sum()), px


def k2_pair_evaluations(idbuf, height, width, sample_ph):
    """(pairs whose ids differ, K2's evaluations of them): each such pair
    once by the 32 x 8 tile of its a-pixel, and once more by the tile of
    its b-pixel where that tile's halo holds the a-pixel (a horizontal pair
    across a tile column, a vertical one across a tile row)."""
    import torch

    h, v = _diff_pair_masks(idbuf, height, width, sample_ph)
    rows, pw = idbuf.shape
    dev = idbuf.device
    h_cross = h & ((torch.arange(pw, device=dev) + 1) % 32 == 0)[None]
    v_cross = v & ((torch.arange(rows, device=dev) + 1) % 8 == 0)[:, None]
    pairs = int(h.sum() + v.sum())
    return pairs, pairs + int(h_cross.sum() + v_cross.sum())


def k10_design_bytes(bins, rows, pw, C, tex, idbuf, payload, height, width,
                     sample_ph):
    """What K10's design moves: K1's work (:func:`k1_work`: its inputs
    read, its planes written), then K2's design traffic on those planes
    (:func:`k2_design_bytes`), in two launches; and the differing pairs K2
    evaluates (:func:`k2_pair_evaluations`).

    :return: {"bytes", "k1_bytes", "k2_bytes", "launches",
        "differing_pairs", "pair_evaluations"}."""
    k1_bytes = k1_work(bins, rows, pw, C, tex)[0]
    k2_bytes = k2_design_bytes(idbuf, payload, C, height, width,
                               sample_ph)[0]
    pairs, evals = k2_pair_evaluations(idbuf, height, width, sample_ph)
    return {"bytes": k1_bytes + k2_bytes, "k1_bytes": k1_bytes,
            "k2_bytes": k2_bytes, "launches": 2, "differing_pairs": pairs,
            "pair_evaluations": evals}


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
    """K8 deriving the LOD: tu, tv and the id read and the LOD and C planes
    written per pixel (20 bytes at C = 1), the pyramid read once (bytes);
    ~(12 C + 12) flops for each level a pixel samples, 4 taps and 3 lerps
    a channel and the coordinates, and ~20 for its LOD (operations)."""
    px = lam.numel()
    levels = px + int(_mip_levels(lam, n_levels)[1].sum())
    return _bound(px * 4 * (4 + C) + pyr.numel() * 4,
                  levels * (12 * C + 12) + 20 * px)


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


def k5_bound_ms(entry, bins, uvz=False):
    """K5: entry read for every pixel, u, v, 8 extra and 8 cotangent
    planes for every covered pixel (76 bytes with its entry; with ``uvz``
    the u, v, z cotangents too, 88), one 128-byte row written per live and
    global entry (bytes); ~110 flops per covered pixel for the
    coefficients and their sums (operations)."""
    hit = int((entry >= 0).sum())
    rows = int(bins.bin_start[-1]) + int(bins.n_global[0])
    nbytes = entry.numel() * 4 + hit * 4 * (21 if uvz else 18) + rows * 128
    return _bound(nbytes, 110 * hit)


def k6_bound_ms(bins, n_tris):
    """K6: 27 floats and a triangle id read per live and global entry, the
    (B*T, 32) rows written (bytes); 27 adds per entry (operations)."""
    rows = int(bins.bin_start[-1]) + int(bins.n_global[0])
    return _bound(rows * (27 * 4 + 4) + n_tris * 128, 27 * rows)


def _search_probes(a, lo, hi, t):
    """K6's binary search of each ``t`` in the ascending ``a[lo, hi)``, all
    at once: (probes of ``a`` each search makes, found position or -1)."""
    import torch

    probes = torch.zeros_like(lo)
    pos = torch.full_like(lo, -1)
    active = lo < hi
    while bool(active.any()):
        mid = (lo + hi) // 2
        v = a[torch.where(active, mid, 0)].long()
        probes += active
        hit = active & (v == t)
        pos = torch.where(hit, mid, pos)
        lo = torch.where(active & (v < t), mid + 1, lo)
        hi = torch.where(active & (v > t), mid, hi)
        active = active & ~hit & (lo < hi)
    return probes, pos


def k6_design_bytes(tile_ids, bins):
    """The traffic of K6's gather design on ``bins`` (whose slots are
    ``tile_ids``, (B, T, K)), counted slot by slot as the kernel searches:
    the found rows, read whole (128 bytes each), the tile ids (4 bytes a
    slot), the global rows taken and the (B*T, 32) rows written, in
    device memory; beside them the searches' probes of ``sorted_tri`` and
    of ``global_idx`` (4 bytes each, from the L2) and the bin bounds (8
    bytes a live slot).

    :return: dict of bytes by part, their "total", its "ms" at the HBM
        rate, and the probe counts.
    """
    import torch

    n_tiles = bins.bin_start.numel() - 1
    tid = tile_ids.reshape(-1, tile_ids.shape[-1]).long()
    n_tris = tid.shape[0]
    tri = torch.arange(n_tris, device=tid.device)
    bs = bins.bin_start.long()
    live = tid < n_tiles
    probes, pos = _search_probes(bins.sorted_tri, bs[tid[live]],
                                 bs[tid[live] + 1],
                                 tri[:, None].expand_as(tid)[live])
    none = tri[~live.any(1)]
    g_probes, g_pos = _search_probes(
        bins.global_idx, torch.zeros_like(none),
        bins.n_global.long().expand_as(none), none)
    found, g_found = int((pos >= 0).sum()), int((g_pos >= 0).sum())
    parts = {"rows": 128 * found, "tile_ids": 4 * tid.numel(),
             "global_rows": 128 * g_found, "out": 128 * n_tris}
    total = sum(parts.values())
    return {**parts, "total": total, "ms": total / HBM_BYTES_PER_S * 1e3,
            "found": found, "live_slots": int(live.sum()),
            "probes": int(probes.sum()),
            "max_probes": int(probes.max()) if probes.numel() else 0,
            "global_found": g_found, "global_probes": int(g_probes.sum()),
            "bin_bounds": 8 * int(live.sum())}


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
    if sys.argv[1:2] == ["--sharded-rank"]:
        return sharded_rank_main(sys.argv[2:])
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
    from fpc_diffrend_tpu_torch.ops.cuda import KERNELS as counters
    from fpc_diffrend_tpu_torch.ops.cuda import (DEVICE_KERNELS,
                                                 device_events,
                                                 device_launches, device_want)
    from fpc_diffrend_tpu_torch.ops.cuda import antialias_cuda as ac
    from fpc_diffrend_tpu_torch.ops.cuda import bin_place_cuda as bp
    from fpc_diffrend_tpu_torch.ops.cuda import raster_grad_cuda as gc
    from fpc_diffrend_tpu_torch.ops.cuda import rasterize_cuda as rc
    from fpc_diffrend_tpu_torch.ops.cuda import texture_cuda as tc
    from fpc_diffrend_tpu_torch.workload import build_workload

    t_start = time.perf_counter()
    record = {"phase_s": {}}
    t_mark = [t_start]

    def phase_done(name):
        """Print and record the seconds since the last phase ended."""
        now = time.perf_counter()
        record["phase_s"][name] = now - t_mark[0]
        t_mark[0] = now
        print(f"phase {name}: {record['phase_s'][name]:.1f} s", flush=True)

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
    record["build_kernel_s"] = {n: r["seconds"] for n, r in report.items()}
    for name, r in report.items():
        lines = [ln.strip() for ln in r["log"].splitlines()
                 if "registers" in ln or "spill" in ln or "reused" in ln]
        print(f"build {name}: {r['seconds']:.1f} s; " + " | ".join(lines),
              flush=True)
    print(f"build total: {record['build_s']:.1f} s", flush=True)

    phase_done("1-2")

    # ---- 3. kernel checks at a mid size ----
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for grid in (40, 5):
        wl = build_workload(256, 384, grid=grid, batch=2, tex_size=1024,
                            device=dev)
        state = step_inputs(wl, backward=False)
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
        guvz = torch.randn((3, 2 * ph, pw), device=dev, generator=gen)
        check_backward(k1, bins, wl["params"]["tex"], g_aa, guvz, 256, 384,
                       ph, 2 * wl["faces"].shape[0], label)
        # a LOD plane over every level of the 7 and past both clamps
        lam_random = (torch.rand((2 * ph, pw), device=dev, generator=gen)
                      * (MAX_MIP_LEVEL + 3) - 1.5)
        _, _, (pyr, sizes, _) = check_mip(k1, wl["params"]["tex"].detach(),
                                          g_aa, lam_random, 256, 384, ph,
                                          label)
        lod_errs = mip_lod_errors(pyr, sizes, k1[2][3], k1[2][4], k1[0], 256,
                                  384, ph)
        check_lod_errors(lod_errs, label)
        record.setdefault("mip_lod_err", {})[label] = lod_errs
        check_place(state["pc"], wl["scene"].faces, 256, 384,
                    wl["config"].pair_cap, label)
    check_place_edges(dev)
    check_fold_edges(dev)
    record["k2_edges_err"] = check_k2_edges(dev, gen)
    record["k10_edges_err"] = check_k10_edges(dev, gen)
    record["k4_edges_err"] = check_k4_edges(dev, gen)
    record["mip_edges_err"] = check_mip_edges(dev, gen)
    record["mip_lod_cases_err"] = check_mip_lod(dev, gen)

    phase_done("3")

    # ---- 4. the forward at full width ----
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

    phase_done("4")

    # ---- 4b. each stack position against its sample alone ----
    record["stack_positions"] = stack_positions(wl)

    phase_done("4b")

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
    host = {k: f.launches for k, f in counters.items()}
    # one more dispatch, its kernels measured on the device
    with device_launches() as launches:
        runs.append(loop.train_steps(config, scene, state, wl["frames_u8"],
                                     gen, k, wl["n_frames"])[1])
    losses = {m: torch.cat([r[m] for r in runs]).tolist() for m in runs[0]}
    mpix = B * H * W / step_ms / 1e3
    print(f"train_steps: {n_dispatch} x {k} steps, {step_ms:.3f} ms/step "
          f"(host clock, synchronized), {mpix:.1f} Mpix/s; then {k} steps "
          f"launched on the device {launches}; loss first "
          f"{losses['loss'][0]} last {losses['loss'][-1]}", flush=True)
    for m, v in losses.items():
        if not all(math.isfinite(x) for x in v):
            fail(f"non-finite step {m}: {v}")
    for name, p in params.items():
        if not bool(torch.isfinite(p).all()):
            fail(f"non-finite parameter {name} after the steps")
    if any(host.values()):
        fail(f"the timed steps launched from the host {host}: not every "
             "step replayed the step's CUDA graph")
    want = device_want(dict.fromkeys(STEP_KERNELS, k))
    if launches != want:
        fail(f"kernel launches on the device {launches} != {want}")
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

    # each stage's device time in one eager step, by the program's spans;
    # the step's kernels' inputs for phases 6 and 10
    record["step_span_ms"] = step_span_ms(config, scene, state, wl["batch"])
    print("step spans (device ms, one eager step, batch of 8): " + ", ".join(
        f"{k} {v:.3f}" for k, v in record["step_span_ms"].items()),
        flush=True)
    sstate = step_inputs(wl)

    phase_done("5")

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
    mip_between = mip_kernels_between(wlm, cpu_gen)
    print(f"mip forward between K1 and K2: {mip_between}", flush=True)
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
    host = {k: f.launches for k, f in counters.items()}
    with device_launches() as mip_launches:
        runs.append(loop.train_steps(cm, scm, mstate, wlm["frames_u8"], gen,
                                     k, wlm["n_frames"])[1])
    mlosses = {m: torch.cat([r[m] for r in runs]).tolist() for m in runs[0]}
    print(f"mip train_steps: {n_dispatch} x {k} steps, {mip_step_ms:.3f} "
          f"ms/step (host clock, synchronized), "
          f"{B * H * W / mip_step_ms / 1e3:.1f} Mpix/s; then {k} steps "
          f"launched on the device {mip_launches}; loss first "
          f"{mlosses['loss'][0]} last {mlosses['loss'][-1]}", flush=True)
    for m, v in mlosses.items():
        if not all(math.isfinite(x) for x in v):
            fail(f"mip: non-finite step {m}: {v}")
    for name, p in pm.items():
        if not bool(torch.isfinite(p).all()):
            fail(f"mip: non-finite parameter {name} after the steps")
    if any(host.values()):
        fail(f"mip: the timed steps launched from the host {host}: not "
             "every step replayed the step's CUDA graph")
    want = device_want(dict(dict.fromkeys(STEP_KERNELS, k), texture_bwd=0,
                            mip_sample=k, mip_sample_bwd=k))
    if mip_launches != want:
        fail(f"mip: kernel launches on the device {mip_launches} != {want}")
    mip_spans = step_span_ms(cm, scm, mstate, wlm["batch"])
    print("mip step spans (device ms, one eager step, batch of 8): "
          + ", ".join(f"{k} {v:.3f}" for k, v in mip_spans.items()),
          flush=True)
    mstage = step_inputs(wlm)
    record.update(mip_between_k1_k2=mip_between,
                  mip_forward_ms_per_batch=mip_fwd_ms, mip_metrics=metrics,
                  mip_launches_evaluate=launches_fwd, mip_step_ms=mip_step_ms,
                  mip_step_losses=mlosses, mip_launches=mip_launches,
                  mip_step_span_ms=mip_spans)

    phase_done("5b")

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
        t0 = time.perf_counter()
        with device_launches() as fit_launches:
            fstate = fit_api.fit_take(fcfg)
        fit_s = time.perf_counter() - t0
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
        want = device_want(dict.fromkeys(STEP_KERNELS, n_fit))
        if fit_launches != want or fstate.step != n_fit:
            fail(f"fit_take ran {fstate.step} steps with launches on the "
                 f"device {fit_launches} != {want}")
        if fstate.graph is not None:
            fail("fit_take returned its state with the step's CUDA graph")
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
        with device_launches() as resumed:
            rstate = fit_api.fit_take(dataclasses.replace(
                fcfg, max_iter=n_fit + 5, mp4_interval=2))
        n_prog = 3                      # after the resumed run's steps 0, 2, 4
        want = dict.fromkeys(STEP_KERNELS, 5)
        for k in ("fused_raster", "antialias", "bin_place"):
            want[k] += n_prog
        want = device_want(want)
        if rstate.step != n_fit + 5 or resumed != want:
            fail(f"the resumed fit_take ended at step {rstate.step} with "
                 f"launches on the device {resumed} != {want}")
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

        # ---- 9. the host tools, on 5c's take and 5d's renders while they
        # are on disk ----
        record["tools"] = tools_phase((fcfg, paths, written, tmp), card)
    phase_done("5c, 5d, 9")

    # ---- 5e. the primitives composed at full width; the scan route ----
    record["primitives"] = primitive_views(wl, counters, gen)
    record["scan_route"] = scan_route(dev, gen)

    phase_done("5e")

    # ---- 5f. the fit examples at their own widths ----
    record["examples"] = examples_phase(counters, card)
    record.update(fit_take_s=fit_s, fit_take_ms_per_step=fit_ms,
                  fit_take_launches=fit_launches, fit_take_losses=losses,
                  fit_take_pair_cap=cap, fit_take_live_pairs=live0)

    phase_done("5f")

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
        berr, babs, (k3, k4, k5, _, k5_cot) = check_backward(
            k1_out, bins, tex, g_aa, None, H, W, ph, B * T, "bench batch")
        # K5's instance with u, v, z planes, on zero planes: the parent's
        # reads (88 bytes a covered pixel against 76)
        args5 = (bins, entry, payload[0], payload[1], extra)
        k5_cot_uvz = k5_cot[:3] + (torch.zeros((3, rows, pw), device=dev),)
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
            "pixel_grad": (lambda: gc.pixel_grad(*args5, *k5_cot),
                           lambda: gc.pixel_grad_plain(*args5, *k5_cot)),
            "pixel_grad_uvz": (
                lambda: gc.pixel_grad(*args5, *k5_cot_uvz),
                lambda: gc.pixel_grad_plain(*args5, *k5_cot_uvz)),
            "fold_entries": (
                lambda: gc.fold_entries(*k5, bins, B * T),
                lambda: gc.fold_entries_plain(*k5, bins, B * T)),
        }
        # K8 and K9 at the mip step's shapes, on K3's colour cotangent (the
        # inputs chip_turns.py times too)
        mg = mstage["k3"][0]
        _, mabs, (pyr, sizes, _) = check_mip(
            mstage["k1"], pm["tex"].detach(), mg, None, H, W, ph,
            "bench batch, mip")
        mk1 = mstage["k1"]
        lod_errs = mip_lod_errors(pyr, sizes, mk1[2][3], mk1[2][4], mk1[0],
                                  H, W, ph)
        check_lod_errors(lod_errs, "bench batch, mip")
        record.setdefault("mip_lod_err", {})["bench batch, mip"] = lod_errs
        # the kernel table's K8 is K8 deriving the LOD
        mabs["mip_sample"] = max(mabs["mip_sample"],
                                 lod_errs["colour_plain"])
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
        # K10 at the single view: its kernels' device time beside the
        # "sepaa" route's K1 and K2, and its design's traffic
        k10_fn = t["fused_raster_aa"][0]
        single["fused_raster_aa_device_kernels_ms"] = device_kernels_ms(
            k10_fn, 20)
        single["sepaa_device_kernels_ms"] = device_kernels_ms(
            view_place_pairs(tex, bins1, H, W, ph, None, 0, 0)["sepaa"][0],
            20)
        single["fused_raster_aa_design"] = k10_design_bytes(
            bins1, ph, pw, C, tex, k1s[0], k1s[2], H, W, ph)
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
        # K5's two instances: without u, v, z planes (the backward's) and
        # with them, on zero planes
        k5_instances_ms = {
            name: {"ms": times[name][0],
                   "device_ms": device_ms(t[name][0], 20),
                   "bound_ms": k5_bound_ms(entry, bins, uvz)[0]}
            for name, uvz in (("pixel_grad", False),
                              ("pixel_grad_uvz", True))}
        record["pixel_grad_instances"] = k5_instances_ms
        print(f"K5 at the bench batch by instance (CUDA events, device ms "
              f"by the profiler, bound): {k5_instances_ms}", flush=True)
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
            if not (e_uv <= K4_ATOL and e_tex <= K4_GTEX_RTOL):
                fail(f"K4 {mode} on the missed pixels' hot spot differs "
                     f"from its plain version: gtu/gtv {e_uv}, gtex {e_tex}")
            print(f"K4 {mode} on the missed pixels' hot spot: gtex rel "
                  f"{e_tex} (limit {K4_GTEX_RTOL})", flush=True)
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
        # K11's device time by kernel, and the host's issue of one call
        k11_dev = device_kernels_ms(t["bin_place"][0], 20)
        k11_host = host_us(t["bin_place"][0], 200)
        largest, mean_bin, _ = bin_sizes(tile_ids, n_tiles)
        # the count step's two paths at this batch, in turns: the
        # shared-memory histogram K11 takes here, and one device-memory
        # atomic a slot, its path past the card's shared memory
        counts = bp.count_pairs(tile_ids, n_tiles)
        if not torch.equal(counts, bp.count_pairs(tile_ids, n_tiles, True)):
            fail("K11's two count paths disagree at the bench batch")
        count_ev = {False: [], True: []}
        with device_profile() as prof:
            for in_dev in (False, True, True, False):
                count_ev[in_dev].append(cuda_ms(
                    lambda: bp.count_pairs(tile_ids, n_tiles, in_dev), 50))
            torch.cuda.synchronize()
        count_dev = {name: ms / 102 for name, ms, _ in device_events(prof)
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
        k11_design = k11_design_bytes(tile_ids, n_tiles, P)
        print(f"K11 {times['bin_place'][0]:.4f} ms (plain "
              f"{times['bin_place'][1]:.4f}, torch.sort + searchsorted "
              f"{place_lib:.4f}); {k11_host:.1f} us of host issue a call; "
              f"its device work {sum(k11_dev.values()):.4f} ms a call: "
              + ", ".join(f"{k[:40]} {v:.4f}" for k, v in k11_dev.items())
              + f"; {tile_ids.numel()} slots, K {tile_ids.shape[2]}, "
              f"{n_tiles} tiles, largest bin {largest}, mean {mean_bin:.2f}; "
              f"its design {k11_design}; record gather "
              f"{gather['autotuned']:.4f} ms "
              f"at P = {Ps['autotuned']} against {gather['uncapped']:.4f} ms "
              f"uncapped (P = {Ps['uncapped']}); {live11} live", flush=True)
        record.update(gather_ms=gather, place_P=Ps, place_live=live11,
                      bin_place_device_ms=k11_dev,
                      bin_place_host_issue_us=k11_host,
                      bin_place_bins={"largest": largest, "mean": mean_bin,
                                      "n_tiles": n_tiles},
                      bin_count_event_ms={"shared": count_ev[False],
                                          "device": count_ev[True]},
                      bin_count_device_ms=count_dev,
                      bin_place_design=k11_design)
        # the library yardstick of K6: one index_add_ of the live rows
        live = int(bins.bin_start[-1])
        idx = bins.sorted_tri[:live].long()
        src = k5[0][:live][:, gc.LIVE_SLOTS].contiguous()
        acc = torch.zeros((B * T, len(gc.LIVE_SLOTS)), device=dev)
        fold_lib = cuda_ms(lambda: acc.index_add_(0, idx, src), 20)
        # K6: its device time, its design's traffic beside index_add_'s
        # time, and exact at the single view (B = 1) on a random cotangent
        k6_design = k6_design_bytes(bins.tile_ids, bins)
        k6_dev = device_kernels_ms(t["fold_entries"][0], 20)
        gpl1 = torch.randn((gc.N_GPL, ph, pw), device=dev, generator=gen)
        check_fold(gc.pixel_grad(bins1, k1s[1], k1s[2][0], k1s[2][1],
                                 k1s[3], *k5_planes(gpl1)), bins1, T,
                   "single view")
        record.update(fold_entries_design=k6_design,
                      fold_entries_device_ms=k6_dev,
                      fold_entries_index_add_ms=fold_lib)
        print(f"K6 at the bench batch: {times['fold_entries'][0]:.4f} ms "
              f"(CUDA events), device {k6_dev}; its design moves "
              f"{k6_design['total'] / 1e6:.1f} MB ({k6_design['ms']:.4f} ms "
              f"at 3.35 TB/s): {k6_design}; index_add_ of the live rows "
              f"{fold_lib:.4f} ms; exact at the single view", flush=True)
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
    # the step's kernels as phases 5 and 5b measured them on the device
    launches = {k: launches[DEVICE_KERNELS[k][0]] for k in STEP_KERNELS}
    launches.update({k: mip_launches[DEVICE_KERNELS[k][0]]
                     for k in ("mip_sample", "mip_sample_bwd")})
    launches.update(
        texture_fwd=sv_launches["separate"]["texture_fwd"],
        fused_raster_aa=sv_launches["aa_fused"]["fused_raster_aa"])
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
    phase_done("6")

    # ---- 6b. K5's two instances at the b36 cells' batch ----
    record["k5_b36"] = {"bilinear": k5_instances(dev, False),
                        "mip": k5_instances(dev, True)}
    phase_done("6b")

    # ---- 7. the step's gradients from run to run ----
    spread, equal = grad_spread(wl)
    record.update(grad_spread=spread, grad_bit_equal=equal)
    print(f"step gradients, 3 runs from one state: spread over the largest "
          f"magnitude {spread} (limit {GRAD_SPREAD_RTOL}); bit-equal to the "
          f"first run {equal}", flush=True)
    phase_done("7")

    # ---- 8. the sharded fit step at full width ----
    record["sharded"] = sharded_phase(wl, card)
    phase_done("8")

    # ---- 10. the bench, its rows, the precision modes and study ----
    record["precision"] = precision_phase(tex, sstate, card)
    phase_done("10")
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
    if not equal["tex"]:
        fail(f"the step's texture gradient is not bit-equal from run to "
             f"run: spread {spread['tex']}")
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
