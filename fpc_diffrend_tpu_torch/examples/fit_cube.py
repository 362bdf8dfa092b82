"""End-to-end demo: fit pose + texture of a textured cube from renders.

A self-contained miniature of the facial-capture loop (no data
downloads): the ground truth is the cube rendered with known per-frame
poses; the fit starts from identity pose and a grey texture and recovers
both. Prints the loss curve and steps/s. Its 12 large triangles all go to
the binning's global list. Runs on the CUDA device, or with ``--cpu`` on
the plain PyTorch versions of the kernels.

Usage:  python -m fpc_diffrend_tpu_torch.examples.fit_cube [--cpu]
        [--steps N] [--res R] [--impl auto|scan] [--save-preview PATH]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from fpc_diffrend_tpu_torch.data import obj as objlib
from fpc_diffrend_tpu_torch.device import resolve_device
from fpc_diffrend_tpu_torch.fit import loop as fit_loop
from fpc_diffrend_tpu_torch.fit import state as state_mod
from fpc_diffrend_tpu_torch.fit.config import FitConfig
from fpc_diffrend_tpu_torch.fit.scene import build_scene
from fpc_diffrend_tpu_torch.models import camera

N_CAMS, N_FRAMES = 2, 2


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--res", type=int, default=128)
    ap.add_argument("--impl", default="auto")
    ap.add_argument("--save-preview", default="")
    return ap.parse_args(argv)


def cube_mesh() -> objlib.MeshData:
    """The 12-triangle cube of side 4 with a planar uv map."""
    verts = np.array([[x, y, z] for z in (-1, 1) for y in (-1, 1)
                      for x in (-1, 1)], np.float32) * 2.0
    faces = np.array([
        [0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5], [0, 4, 5], [0, 5, 1],
        [2, 3, 7], [2, 7, 6], [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]],
        np.int32)
    uv = (verts[:, :2] * 0.25 + 0.5).astype(np.float32)
    return objlib.MeshData(vertices=verts.reshape(-1), uv=uv, faces=faces,
                           fuv=faces)


def run(args) -> dict:
    """Render the ground truth, fit, print the curve.

    :return: {"ok": the last loss is below half of the first, "losses":
        every step's loss, "seconds": the fit's, "renders": the
        ground-truth renders, "gt_t", "fit_t", "config", "scene",
        "frames" (C, F, H, W) uint8 on the device, "state"}.
    """
    dev = resolve_device("cpu" if args.cpu else None)
    print("device:", dev, flush=True)
    proj = np.stack([camera.default_projection()] * N_CAMS)
    mv0 = (camera.default_modelview(zoffset=-28) @ camera.rotate_y(0.5)
           @ camera.rotate_x(0.35))
    mv1 = (camera.default_modelview(zoffset=-30) @ camera.rotate_y(-0.4)
           @ camera.rotate_x(0.3))
    scene = build_scene(cube_mesh(), proj, np.stack([mv0, mv1]),
                        device=dev)

    config = FitConfig(
        max_iter=args.steps, lr_base=5e-3, lr_t=2e-3, lr_q=1e-5,
        resolution=(args.res, args.res), texshape=(32, 32, 1), mode="free",
        cam_idxs=tuple(range(N_CAMS)), batch_size=4, raster_impl=args.impl,
        log_interval=max(1, args.steps // 10))

    # ground truth: blob texture + small per-frame pose offsets
    yy, xx = np.meshgrid(np.linspace(-1, 1, 32), np.linspace(-1, 1, 32),
                         indexing="ij")
    tex = (0.3 + 0.6 * np.exp(-(xx ** 2 + yy ** 2) / 0.3)
           ).astype(np.float32)[..., None]
    gt = state_mod.init_params(config, N_FRAMES, scene.v_base.shape[0],
                               scene.deltas.shape[1], tex, N_CAMS, device=dev)
    gt_t = np.array([[0.2, -0.15, 0.0], [-0.18, 0.12, 0.0]], np.float32)
    gt["per_frame_t"] = torch.tensor(gt_t, device=dev)

    print("rendering ground truth take...", flush=True)
    frames = np.empty((N_CAMS, N_FRAMES, args.res, args.res), np.uint8)
    with torch.no_grad():
        for c in range(N_CAMS):
            for f in range(N_FRAMES):
                img, _ = fit_loop.render_sample(config, scene, gt, c, f)
                frames[c, f] = np.clip(np.rint(
                    img[..., 0].cpu().numpy() * 255), 0, 255).astype(
                    np.uint8)
    frames_dev = torch.as_tensor(frames, device=dev)

    init = {k: v.clone() for k, v in gt.items()}
    init["per_frame_t"] = torch.zeros((N_FRAMES, 3), device=dev)
    init["tex"] = torch.full_like(gt["tex"], 0.5)
    state = state_mod.init_state(config, init)

    losses = []

    def log(i, s, m):
        losses.append(float(m["loss"]))
        if i % config.log_interval == 0 or i == args.steps - 1:
            print(f"step {i}: loss {losses[-1]:.2f}", flush=True)

    t0 = time.time()
    state = fit_loop.run_fit(config, scene, frames_dev, N_FRAMES,
                             callbacks=[log], state=state)
    got_t = state.params["per_frame_t"].detach().cpu().numpy()
    dt = time.time() - t0
    print(f"\n{args.steps} steps in {dt:.1f}s ({args.steps / dt:.1f} "
          f"steps/s)", flush=True)
    print("loss:", f"{losses[0]:.2f} -> {losses[-1]:.2f}")
    print("gt  t:", gt_t.astype(np.float64).round(3).tolist())
    print("fit t:", got_t.astype(np.float64).round(3).tolist())

    if args.save_preview:
        from fpc_diffrend_tpu_torch.utils.image import save_image
        with torch.no_grad():
            img, _ = fit_loop.render_sample(config, scene, state.params, 0, 0)
        save_image(args.save_preview, img.cpu().numpy()[::-1])
        print("preview saved to", args.save_preview)

    ok = losses[-1] < losses[0] * 0.5
    print("CONVERGED" if ok else "DID NOT CONVERGE")
    return {"ok": ok, "losses": losses, "seconds": dt,
            "renders": N_CAMS * N_FRAMES, "gt_t": gt_t.tolist(),
            "fit_t": got_t.tolist(), "config": config, "scene": scene,
            "frames": frames_dev, "state": state}


def main(argv=None) -> int:
    return 0 if run(parse_args(argv))["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
