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
   1e-5; its texture-free mode, which the mip path runs, equal to the
   textured mode on ids, entries, payload and extra), K2 (within 1e-6),
   K3 (within 1e-6: a deterministic gather in the plain version's order),
   K4 (gtu/gtv within 1e-6), K8 and K9 on the 7-level pyramid with the
   real LOD and with a random LOD plane past both clamps (K8 and K9's
   gtu/gtv within 1e-6: one thread per pixel, no atomics), and K4's gtex,
   K9's gradient pyramid, K5's and K6's rows, whose atomics sum in another
   order, each element within 1e-5 of the sum of the magnitudes it adds
   up; and K11 (bin placement) equal to its plain version exactly
   (``bin_start``, ``sorted_tri``) uncapped, at the autotuned entry cap and
   at a cap of half the live entries, which drops entries;
4. the forward at full width: the benchmarked workload (1600x1200, 29,768
   triangles, 1024^2 texture, batch 8, 3 cameras, 4 frames, free mode,
   Laplacian 1.0, the entry cap autotuned with no K11 launch) through
   ``fit.loop.evaluate``: 1 warm-up batch, then 5 timed batches with the
   launch counters set to 0 just before; the losses must be finite and K1,
   K2 and K11 launched once per batch;
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
   resume from the checkpoint, end at step 25 and write them again;
6. each kernel at the main path's shapes (K8, K9: the mip path's; K11 the
   step's batch at the autotuned cap, checked also uncapped and at half
   the live entries) against its plain version, with its time, the plain
   version's time, the library call's time where one computes the same
   function, and its bound, printed as one ``{"kernels": [...]}`` line;
   beside it the record gather's time capped and uncapped, and K11's
   count step by its shared-memory histogram against device-memory
   atomics, in turns.

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
K8_ATOL = 1e-6                 # one thread per pixel, no atomics
K9_ATOL = 1e-6                 # gtu, gtv: one thread per pixel, no atomics
ATOMIC_RTOL = 1e-5             # gtex, gpyr, K5/K6 rows: atomics reorder sums
MAX_MIP_LEVEL = 6              # the mip path's chain: 1024^2 .. 16^2


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

    from fpc_diffrend_tpu_torch.ops import texture_mip as tm
    from fpc_diffrend_tpu_torch.ops.cuda import texture_mip_cuda as tmc

    idbuf, _, payload, _, _ = k1
    tu, tv = payload[3], payload[4]
    pyr, sizes = tm.mip_pyramid(tex, MAX_MIP_LEVEL)
    lam = tm.lod_from_texc(tu, tv, idbuf, *sizes[0], height, width,
                           sample_ph)
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


def _bound(nbytes, ops):
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations"


def _diff_pairs(idbuf, height, width, sample_ph):
    """(pairs whose ids differ, pixels in at least one such pair), within
    the pair masks of K2/K3."""
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
    return int(h.sum() + v.sum()), int(px.sum())


def k3_bound_ms(idbuf, C, height, width, sample_ph):
    """K3: id, C colour and C gout read and C + 6 planes written for every
    pixel; z, 6 corners and 3 neighbours read for the pixels in a pair
    whose ids differ (bytes). ~150 flops per such pair for its forward
    recompute and derivative (operations)."""
    px = idbuf.numel()
    pairs, diff_px = _diff_pairs(idbuf, height, width, sample_ph)
    nbytes = px * 4 * (1 + 2 * C + C + 6) + diff_px * 4 * 10
    return _bound(nbytes, 150 * pairs + 8 * px)


def k4_bound_ms(gcolour, tex):
    """K4: C cotangent planes read and gtu/gtv written for every pixel, tu
    and tv read where the cotangent is not 0, the texture read and gtex
    written (bytes); ~40 flops per such pixel and channel (operations)."""
    C = gcolour.shape[0]
    px = gcolour[0].numel()
    live = int((gcolour != 0).any(dim=0).sum())
    nbytes = px * 4 * (C + 2) + live * 8 + 2 * tex.numel() * 4
    return _bound(nbytes, 40 * live * C)


def _hi_live(lam, n_levels):
    """Pixels whose LOD blends a second level."""
    import torch

    lc = torch.clamp(lam, 0.0, float(n_levels - 1))
    return (torch.floor(lc) + 1 < n_levels) & (lc != torch.floor(lc))


def k8_bound_ms(lam, C, pyr, n_levels):
    """K8: tu, tv and lam read and C planes written per pixel, the pyramid
    read once (bytes); ~(12 C + 12) flops for each level a pixel samples,
    4 taps and 3 lerps a channel and the coordinates (operations)."""
    px = lam.numel()
    levels = px + int(_hi_live(lam, n_levels).sum())
    return _bound(px * 4 * (3 + C) + pyr.numel() * 4, levels * (12 * C + 12))


def k9_bound_ms(lam, gcolour, pyr, n_levels):
    """K9: C cotangent planes read and gtu/gtv written per pixel, tu, tv and
    lam read where the cotangent is not 0, the pyramid read and the
    gradient pyramid written (bytes); ~(24 C + 12) flops for each level
    such a pixel samples (operations)."""
    C = gcolour.shape[0]
    px = lam.numel()
    live = (gcolour != 0).any(dim=0)
    levels = int(live.sum()) + int((_hi_live(lam, n_levels) & live).sum())
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


KERNELS = {
    "fused_raster": ("csrc/fused_raster.cu", "rasterize_tpu.py:1055"),
    "antialias": ("csrc/antialias.cu", "antialias_tpu.py:184"),
    "antialias_bwd": ("csrc/antialias_bwd.cu", "antialias_tpu.py:228"),
    "texture_bwd": ("csrc/texture_bwd.cu", "texture_tpu.py:463"),
    "pixel_grad": ("csrc/raster_grad.cu", "raster_grad_tpu.py:97"),
    "fold_entries": ("csrc/raster_grad.cu", "raster_grad_tpu.py:338"),
    "mip_sample": ("csrc/texture_mip.cu", "texture_mip_tpu.py:163"),
    "mip_sample_bwd": ("csrc/texture_mip.cu", "texture_mip_tpu.py:246"),
    "bin_place": ("csrc/bin_place.cu", "rasterize_tpu.py:350"),
}


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
        # random cotangents, u/v/z ones included, exercise every slot
        g_aa = torch.randn(k1[4].shape, device=dev, generator=gen)
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

    # ---- 4. the forward at full width ----
    counters = {"fused_raster": rc.fused_raster,
                "antialias": ac.antialias_planes,
                "antialias_bwd": ac.antialias_planes_bwd,
                "texture_bwd": tc.texture_planes_bwd,
                "pixel_grad": gc.pixel_grad,
                "fold_entries": gc.fold_entries,
                "mip_sample": tmc.mip_sample,
                "mip_sample_bwd": tmc.mip_sample_bwd,
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
    want = {k: 0 if k.startswith("mip") else n_steps for k in counters}
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
    want = {k: 0 if k == "texture_bwd" else n_steps for k in counters}
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
        want = {k: 0 if k.startswith("mip") else n_fit for k in counters}
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

        # resume: the second call continues from the step-20 checkpoint
        import shutil

        shutil.rmtree(os.path.join(fcfg.out_dir, "result"))
        os.remove(os.path.join(fcfg.out_dir, "config.txt"))
        for f in counters.values():
            f.launches = 0
        rstate = fit_api.fit_take(dataclasses.replace(fcfg,
                                                      max_iter=n_fit + 5))
        torch.cuda.synchronize()
        resumed = {k: f.launches for k, f in counters.items()}
        want = {k: 0 if k.startswith("mip") else 5 for k in counters}
        if rstate.step != n_fit + 5 or resumed != want:
            fail(f"the resumed fit_take ended at step {rstate.step} with "
                 f"launches {resumed} != {want}")
        check_fit_outputs(fcfg, nv, nt, 4, "resumed fit_take")
        if not ckpt_mod.latest_checkpoint(fcfg.checkpoint_dir).endswith(
                f"step_{n_fit + 5:09d}.pt"):
            fail("the resumed fit_take left no step-25 checkpoint")
        print(f"fit_take resumed from step {n_fit} to {rstate.step}; "
              f"launches {resumed}", flush=True)
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
        gcolour = k3[0]
        t = {
            "fused_raster": (
                lambda: rc.fused_raster(bins, tex, rows, pw),
                lambda: rc.fused_raster_plain(bins, tex, rows, pw)),
            "antialias": (
                lambda: ac.antialias_planes(idbuf, payload, colour, H, W,
                                            ph),
                lambda: ac.antialias_planes_plain(idbuf, payload, colour, H,
                                                  W, ph)),
            "antialias_bwd": (
                lambda: ac.antialias_planes_bwd(idbuf, payload, colour,
                                                g_aa, H, W, ph),
                lambda: ac.antialias_planes_bwd_plain(
                    idbuf, payload, colour, g_aa, H, W, ph)),
            "texture_bwd": (
                lambda: tc.texture_planes_bwd(tex, payload[3], payload[4],
                                              gcolour),
                lambda: tc.texture_planes_bwd_plain(tex, payload[3],
                                                    payload[4], gcolour)),
            "pixel_grad": (
                lambda: gc.pixel_grad(bins, entry, payload[0], payload[1],
                                      extra, gpl),
                lambda: gc.pixel_grad_plain(bins, entry, payload[0],
                                            payload[1], extra, gpl)),
            "fold_entries": (
                lambda: gc.fold_entries(*k5, bins, B * T),
                lambda: gc.fold_entries_plain(*k5, bins, B * T)),
        }
        # K8 and K9 at the mip step's shapes
        _, mabs, (pyr, sizes, lam) = check_mip(
            mstage["k1"], pm["tex"].detach(), mstage["k3"][0], None, H, W,
            ph, "bench batch, mip")
        mpay = mstage["k1"][2]
        mg = mstage["k3"][0]
        t["mip_sample"] = (
            lambda: tmc.mip_sample(pyr, sizes, mpay[3], mpay[4], lam),
            lambda: tmc.mip_sample_plain(pyr, sizes, mpay[3], mpay[4], lam))
        t["mip_sample_bwd"] = (
            lambda: tmc.mip_sample_bwd(pyr, sizes, mpay[3], mpay[4], lam,
                                       mg),
            lambda: tmc.mip_sample_bwd_plain(pyr, sizes, mpay[3], mpay[4],
                                             lam, mg))
        # K11 on the step's batch: exact at three caps, timed at the
        # autotuned one
        tile_ids, n_tiles, Ps, live11 = check_place(
            sstate["pc"], scene.faces, H, W, config.pair_cap, "bench batch")
        P = Ps["autotuned"]
        t["bin_place"] = (lambda: bp.place_pairs(tile_ids, n_tiles, P),
                          lambda: bp.place_pairs_plain(tile_ids, n_tiles, P))
        times = {name: (cuda_ms(kf, 20), cuda_ms(pf, 2))
                 for name, (kf, pf) in t.items()}
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
        "antialias": k2_bound_ms(idbuf, C, H, W, ph),
        "antialias_bwd": k3_bound_ms(idbuf, C, H, W, ph),
        "texture_bwd": k4_bound_ms(gcolour, tex),
        "pixel_grad": k5_bound_ms(entry, bins),
        "fold_entries": k6_bound_ms(bins, B * T),
        "mip_sample": k8_bound_ms(lam, C, pyr, len(sizes)),
        "mip_sample_bwd": k9_bound_ms(lam, mg, pyr, len(sizes)),
        "bin_place": k11_bound_ms(tile_ids, n_tiles, P),
    }
    # K11 equals its plain version exactly (check_place fails otherwise)
    errs = {"fused_raster": k1_err, "antialias": k2_err, **babs, **mabs,
            "bin_place": 0.0}
    library = {"fold_entries": fold_lib, "bin_place": place_lib}
    launches = {**launches, "mip_sample": mip_launches["mip_sample"],
                "mip_sample_bwd": mip_launches["mip_sample_bwd"]}
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
    record.update(kernels=kernels, backward_check=berr,
                  live_bin_entries=live, n_global=int(bins.n_global[0]),
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
