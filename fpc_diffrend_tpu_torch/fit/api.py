"""``fit_take(config)``: fit a take on disk end to end (port of
``fpc_diffrend_tpu.fit.api``).

Load the calibration, base mesh, blendshapes and reference frames from the
configured paths, size the binning's entry cap from the scene
(``autotune_caps``), fit with the batched step, checkpoint, and write the
reference-format results.

Left out of the port, and why: the face-order flip and the banded-fold
checks (they serve only the TPU's banded gradient fold; the port's atomic
fold K6 needs neither), the binning-window rebind (an XLA-sort tuning of
the TPU) and ``FPC_CAP_MULT`` (the cap is 1.25 x the measured entries).
``mp4_interval`` writes progress frames as the JAX package does: an mp4
where imageio has an encoder, else PNGs (``utils.video``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import time

import numpy as np
import torch

from fpc_diffrend_tpu_torch.data import frames as frames_mod
from fpc_diffrend_tpu_torch.data import obj as objlib
from fpc_diffrend_tpu_torch.device import resolve_device
from fpc_diffrend_tpu_torch.fit import checkpoint as ckpt_mod
from fpc_diffrend_tpu_torch.fit import loop as loop_mod
from fpc_diffrend_tpu_torch.fit import results as results_mod
from fpc_diffrend_tpu_torch.fit import state as state_mod
from fpc_diffrend_tpu_torch.fit.config import FitConfig
from fpc_diffrend_tpu_torch.fit.scene import build_scene, load_calibration
from fpc_diffrend_tpu_torch.models import blendshape
from fpc_diffrend_tpu_torch.ops.cuda.rasterize_cuda import (MAX_GLOBAL,
                                                             raster_stats)
from fpc_diffrend_tpu_torch.ops.rasterize import check_impl
from fpc_diffrend_tpu_torch.utils.image import (display_image, load_image,
                                                make_img)
from fpc_diffrend_tpu_torch.utils.video import ProgressVideo, progress_callback

CAP_MULT = 1.25          # cap headroom: pose and expression move triangles
HEALTH_KEYS = ("n_valid_pairs", "n_global", "global_overflow", "wy_max",
               "wx_max")


def load_texture(texpath: str, texshape, seed: int) -> np.ndarray:
    """The initial texture: the file at ``texpath`` (flipped vertically,
    scaled to [0, 1]; reference fit.py:433-439) or uniform noise drawn from
    ``np.random.default_rng(seed)``."""
    if texpath:
        tex = load_image(texpath).astype(np.float32) / 255.0
        return np.flip(tex, 0).copy()
    return np.random.default_rng(seed).uniform(
        size=tuple(texshape)).astype(np.float32)


def setup_from_config(config: FitConfig, device=None):
    """Load a take's data onto ``device`` (default CUDA).

    :return: (scene, frames_u8 (C, F, H, W) uint8 tensor, n_frames, the
        camera directory names).
    """
    device = resolve_device(device)
    cams = sorted(os.listdir(config.imdir))
    n_frames, _ = frames_mod.assert_num_frames(cams, config.imdir)
    # directory names look like "<take>_<calibration key>" (fit.py:516)
    calib_keys = [c.split("_")[1] if "_" in c else c for c in cams]
    proj, mv = load_calibration(config.calibpath, calib_keys)
    basemesh = objlib.load_obj(config.basemeshpath)
    deltas = None
    if config.localblpath and config.mode in ("prior", "combined"):
        deltas, _, _ = blendshape.setup_dataset(
            config.localblpath, config.globalblpath, n_frames,
            basemesh.vertices.shape[0], basemesh.vertices)
    scene = build_scene(basemesh, proj, mv, deltas, device=device)
    frames_u8 = torch.as_tensor(frames_mod.load_take(config.imdir, cams),
                                device=device)
    return scene, frames_u8, n_frames, cams


def measure_raster_health(config: FitConfig, scene, params) -> dict:
    """The binning's counts at frame 0 of every configured camera, worst
    case over the cameras (one ``raster_stats`` call, one host read).

    :return: dict of ints: n_valid_pairs, n_global, global_overflow,
        wy_max, wx_max.
    """
    h, w = config.resolution
    cams = torch.tensor(config.cam_idxs, dtype=torch.int64,
                        device=scene.device)
    with torch.no_grad():
        pos_clip, _ = loop_mod.sample_clip_positions(
            config, scene, params, cams, torch.zeros_like(cams))
        stats = raster_stats(pos_clip, scene.faces, h, w)
        worst = torch.stack([stats[k].amax() for k in HEALTH_KEYS]).cpu()
    return {k: int(v) for k, v in zip(HEALTH_KEYS, worst)}


def batch_global_rows(config: FitConfig, health: dict) -> int:
    """The oversized triangles a batch can pool into the stacked binning's
    one global list of ``MAX_GLOBAL`` rows: ``batch_size`` x the worst
    view's (a batch may draw that view at every position)."""
    return config.batch_size * (health["n_global"]
                                + health["global_overflow"])


def health_warnings(config: FitConfig, health: dict) -> list[str]:
    """Warning lines for a measured health dict: global-list overflow, of
    a view or of the batch's pooled list, and bin entries past
    ``pair_cap`` (each drops gradient contributions)."""
    warnings = []
    pooled = batch_global_rows(config, health)
    if health["global_overflow"] > 0:
        warnings.append(
            f"WARNING: raster global-list overflow "
            f"({health['global_overflow']} triangles dropped)")
    elif pooled > MAX_GLOBAL:
        warnings.append(
            f"WARNING: raster global-list overflow for the batch (up to "
            f"{pooled} oversized triangles from {config.batch_size} "
            f"samples in {MAX_GLOBAL} rows)")
    if config.pair_cap and health["n_valid_pairs"] > config.pair_cap:
        warnings.append(
            f"WARNING: bin entries ({health['n_valid_pairs']}) "
            f"exceed pair_cap ({config.pair_cap}) — gradient "
            "contributions are being dropped")
    return warnings


def autotune_caps(config: FitConfig, scene, params) -> FitConfig:
    """Resolve ``pair_cap == 0`` (auto) from the scene: 1.25 x the worst
    camera's bin entries, rounded up to a multiple of 128. The scan route
    has no bins, and keeps its cap of 0.

    :raises RuntimeError: the oversized-triangle list overflows (the fit
        would drop triangles): a view's, or the batch's, whose samples pool
        their oversized triangles into one list of ``MAX_GLOBAL`` rows
        (:func:`batch_global_rows`).
    """
    if config.pair_cap or config.raster_impl == "scan":
        return config
    health = measure_raster_health(config, scene, params)
    if health["global_overflow"] > 0:
        raise RuntimeError(
            f"raster global-list overflow ({health['global_overflow']} "
            "oversized triangles dropped) — scene exceeds MAX_GLOBAL; "
            "reduce triangle size or raise the cap")
    pooled = batch_global_rows(config, health)
    if pooled > MAX_GLOBAL:
        raise RuntimeError(
            f"raster global-list overflow for the batch: {config.batch_size}"
            f" samples of up to {health['n_global']} oversized triangles "
            f"each pool up to {pooled} into {MAX_GLOBAL} rows — reduce "
            "batch_size or triangle size")
    cap = max(int(health["n_valid_pairs"] * CAP_MULT), 1)
    cap = (cap + 127) // 128 * 128
    print(f"[autotune] pair_cap={cap} (measured {health['n_valid_pairs']} "
          f"bin entries, {health['n_global']} global)", flush=True)
    return dataclasses.replace(config, pair_cap=cap)


def _display_callback(config, scene, frames_u8):
    """Refresh out_dir/preview.png every ``display_interval`` steps: the
    reference frame beside the render of camera 0, frame 0 (a stacked
    batch of one)."""
    one = torch.zeros((1,), dtype=torch.int64, device=scene.device)
    ref = frames_u8[0, 0].cpu().numpy().astype(np.float32)[..., None] / 255.0

    def cb(i, st, metrics):
        if i % config.display_interval:
            return
        with torch.no_grad():
            img, _ = loop_mod.render_batch(config, scene, st.params, one, one)
        grid = make_img(np.stack([ref[::-1], img[0].cpu().numpy()[::-1]]))
        display_image(grid, os.path.join(config.out_dir, "preview.png"))
    return cb


def fit_take(config: FitConfig, resume: bool = True, device=None):
    """Fit the configured take and save the results.

    Loads the data, sizes the entry cap, resumes from the latest checkpoint
    in ``config.checkpoint_dir`` (with ``resume``), runs the fit, logs to
    ``out_dir/metrics.jsonl`` (with a health re-measure every
    ``max(20 * log_interval, 1000)`` steps) and on any exit (the end, an
    interrupt, SIGTERM, an exception) writes a final checkpoint and the
    results, then re-raises an exception.

    :param device: default CUDA; ``"cpu"`` runs the plain versions.
    :return: the final TrainState, without the CUDA graph of its step
        (its memory freed).
    :raises ValueError: ``config.raster_impl`` names no rasterizer
        (:func:`ops.rasterize.check_impl`).
    """
    config.validate()
    check_impl(config.raster_impl)
    os.makedirs(config.out_dir, exist_ok=True)
    scene, frames_u8, n_frames, _ = setup_from_config(config, device)
    tex_init = load_texture(config.texpath, config.texshape, config.seed)
    params = state_mod.init_params(config, n_frames, scene.v_base.shape[0],
                                   scene.deltas.shape[1], tex_init,
                                   scene.n_cameras, device=scene.device)
    config = autotune_caps(config, scene, params)
    state = state_mod.init_state(config, params)
    if resume and config.checkpoint_dir:
        latest = ckpt_mod.latest_checkpoint(config.checkpoint_dir)
        if latest:
            print(f"Resuming from {latest}")
            state = ckpt_mod.restore_checkpoint(latest, state)

    t0 = time.time()
    health_interval = max(config.log_interval * 20, 1000)
    every = max(config.steps_per_dispatch, 1)
    metrics_file = open(os.path.join(config.out_dir, "metrics.jsonl"), "a")

    def log_cb(i, st, metrics):
        if config.log_interval and i % config.log_interval >= every:
            return
        loss = float(metrics["loss"])
        rate = (i + 1) / max(time.time() - t0, 1e-9)
        print(f"It[{i}] - Loss: {loss:.4f} - {rate:.2f} it/s", flush=True)
        record = {"step": int(st.step), "loss": loss, "it_per_s": rate,
                  "pair_cap": config.pair_cap}
        # the geometry moves during a fit: re-measure the caps' health
        # (the scan route has no bins; a cap set on it is still watched)
        if ((config.raster_impl != "scan" or config.pair_cap)
                and i % health_interval < every):
            health = measure_raster_health(config, scene, st.params)
            record.update(health)
            for warning in health_warnings(config, health):
                print(warning, flush=True)
        metrics_file.write(json.dumps(record) + "\n")
        metrics_file.flush()

    callbacks = [log_cb]
    if config.checkpoint_dir and config.checkpoint_interval:
        callbacks.append(ckpt_mod.checkpoint_callback(
            config.checkpoint_dir, config.checkpoint_interval))
    video = None
    if config.mp4_interval:
        video = ProgressVideo(config.out_dir)
        callbacks.append(progress_callback(video, config, scene,
                                           config.mp4_interval, frames_u8))
    if config.display_interval:
        callbacks.append(_display_callback(config, scene, frames_u8))

    def _sigterm(_sig, _frm):
        raise KeyboardInterrupt

    prev_handler = None
    try:
        prev_handler = signal.signal(signal.SIGTERM, _sigterm)
    except ValueError:
        pass                    # not the main thread: no handler
    try:
        # train_step updates the state in place: after an exception between
        # steps (a callback's) it holds the last completed step
        remaining = config.max_iter - state.step
        if remaining > 0:
            state = loop_mod.run_fit(config, scene, frames_u8, n_frames,
                                     callbacks=callbacks, state=state,
                                     n_steps=remaining)
        if scene.device.type == "cuda":
            torch.cuda.synchronize(scene.device)
    except KeyboardInterrupt:
        print("Interrupted — saving partial results...")
    finally:
        state.graph = None      # the step's CUDA graph and its memory pool
        if prev_handler is not None:
            signal.signal(signal.SIGTERM, prev_handler)
        metrics_file.close()
        if video is not None:
            video.close()
        if config.checkpoint_dir:
            try:
                ckpt_mod.save_checkpoint(config.checkpoint_dir, state)
            except Exception as e:      # keep result saving alive
                print(f"WARNING: final checkpoint failed: {e}")
        try:
            results_mod.save_results(config, scene, state.params, n_frames)
        except Exception as e:
            print(f"WARNING: result saving failed: {e}")
    print("Done")
    return state
