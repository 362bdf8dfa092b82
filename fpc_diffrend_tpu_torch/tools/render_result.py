"""Offline result renderer: re-render a fit's saved frames for inspection.

The port's copy of ``fpc_diffrend_tpu.tools.render_result``, with parity
to the reference's three result scripts in one loop:
  * side-by-side — one camera beside its reference frames (render_result.py)
  * blend — a 50/50 blend over the reference (render_result_blended.py)
  * grid — every camera in one grid per frame (render_multicam.py)
  * plain — the render alone
Output is a sequence of PNGs (``write_imgs``) and, where imageio with an
mp4 encoder is installed, an mp4. Reference frames are read through the
port's native TIFF decoder.

Usage:
  python -m fpc_diffrend_tpu_torch.tools.render_result \
      --result-dir out/result --calib calibration.json \
      --basemesh basemesh.obj --cams cam0 cam1 cam2 --frames 4 \
      --mode grid --write-imgs [--refdir refs] [--y-offset 170] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from fpc_diffrend_tpu_torch.data import obj as objlib
from fpc_diffrend_tpu_torch.data.frames import load_tiff
from fpc_diffrend_tpu_torch.device import resolve_device
from fpc_diffrend_tpu_torch.fit.results import load_pose, load_result_mesh
from fpc_diffrend_tpu_torch.models import camera, pose as pose_mod
from fpc_diffrend_tpu_torch.ops.pipeline import render
from fpc_diffrend_tpu_torch.tools.simple_render import load_texture_png
from fpc_diffrend_tpu_torch.utils.image import make_img, save_image


def _writer(path: str, fps: int = 30):
    try:
        import imageio

        return imageio.get_writer(path, mode="I", fps=fps, codec="libx264",
                                  bitrate="16M")
    except Exception as e:  # the encoder depends on what is installed
        print(f"mp4 writer unavailable ({e}); writing PNGs only")
        return None


def render_result(result_dir: str, calibpath: str, basemesh_path: str,
                  cams, n_frames: int, refdir: str = "",
                  resolution=(1600, 1200), mode: str = "side-by-side",
                  y_offset: float = 0.0, reproduce_pose: bool = True,
                  texpath: str = "", out_prefix: str = "result_comparison",
                  write_imgs: bool = False, impl: str = "auto",
                  route: str = "sepaa", device=None):
    """Re-render saved frames through calibrated cameras.

    :param cams: list of calibration keys; one -> single-cam modes,
        several -> grid mode (render_multicam.py behavior).
    :param mode: 'side-by-side' | 'blend' | 'grid' | 'plain'
    :param refdir: directory of the reference frames
        ``{cam}_{i:03d}.tif`` (side-by-side and blend; "" compares
        against black).
    :param device: where to render; None means CUDA.
    """
    dev = resolve_device(device)
    with open(calibpath) as f:
        calibs = json.load(f)

    basemesh = objlib.load_obj(basemesh_path)
    topo = objlib.build_topology(basemesh.faces, basemesh.n_vertices)

    def on_dev(x, dtype):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    uv = on_dev(basemesh.uv, torch.float32)
    uv_idx = on_dev(basemesh.fuv, torch.int32)
    faces = on_dev(basemesh.faces, torch.int32)
    fn = on_dev(topo.face_neighbors, torch.int32)

    if not texpath:
        texpath = os.path.join(result_dir, "texture.png")
    tex = on_dev(load_texture_png(texpath), torch.float32)

    pose_t, pose_q = (load_pose(result_dir) if reproduce_pose
                      else (np.zeros((n_frames, 3), np.float32),
                            np.tile([0, 0, 0, 1.0], (n_frames, 1))))

    mvps = {}
    for cam in cams:
        calib = calibs[cam]
        proj = camera.intrinsic_to_projection(
            np.asarray(calib["intrinsic"], np.float32)).numpy()
        mv = camera.extrinsic_to_modelview(
            np.asarray(calib["rotation"], np.float32),
            np.asarray(calib["translation"], np.float32)).numpy()
        mvps[cam] = (proj, mv @ camera.translate(0.0, y_offset, 0.0))

    writer = _writer(os.path.join(result_dir, f"{out_prefix}_{mode}.mp4"))
    for i in range(n_frames):
        verts3 = on_dev(load_result_mesh(result_dir, i).reshape(-1, 3),
                        torch.float32)
        rigid = pose_mod.rigid_from_pose(
            torch.as_tensor(pose_t[i], dtype=torch.float32),
            torch.as_tensor(pose_q[i], dtype=torch.float32)).numpy()

        renders = []
        for cam in cams:
            proj, t_mv = mvps[cam]
            mvp = proj @ (rigid @ t_mv)
            with torch.no_grad():
                img = render(mvp, verts3, faces, uv, uv_idx, tex,
                             tuple(resolution), fn, impl=impl, route=route,
                             device=dev)
            img_np = img.cpu().numpy()[::-1]          # flip to image order
            renders.append(np.clip(img_np * 255.0, 0, 255))

        if mode == "grid":
            n = len(renders)
            ncols = int(np.ceil(np.sqrt(n)))
            while n % ncols:
                renders.append(np.zeros_like(renders[0]))
                n += 1
            frame = make_img(np.stack(renders), ncols=ncols)
        else:
            rendered = renders[0]
            if refdir:
                ref = load_tiff(os.path.join(
                    refdir, f"{cams[0]}_{i:03d}.tif")).astype(np.float32)
                ref = ref.reshape(ref.shape[0], ref.shape[1], 1)
            else:
                ref = np.zeros_like(rendered)
            if mode == "blend":
                frame = 0.5 * ref + 0.5 * rendered
            elif mode == "side-by-side":
                frame = make_img(np.stack([ref, rendered]))
            else:
                frame = rendered

        frame_u8 = np.clip(np.rint(frame), 0, 255).astype(np.uint8)
        if write_imgs:
            save_image(os.path.join(result_dir, f"frame{i}_{mode}.png"),
                       frame_u8)
        if writer is not None:
            writer.append_data(frame_u8)
        print(f"frame {i}/{n_frames}", flush=True)

    if writer is not None:
        writer.close()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--result-dir", required=True)
    ap.add_argument("--calib", required=True)
    ap.add_argument("--basemesh", required=True)
    ap.add_argument("--cams", nargs="+", default=["pod2primary"])
    ap.add_argument("--frames", type=int, required=True)
    ap.add_argument("--refdir", default="")
    ap.add_argument("--res", nargs=2, type=int, default=[1600, 1200])
    ap.add_argument("--mode", default="side-by-side",
                    choices=["side-by-side", "blend", "grid", "plain"])
    ap.add_argument("--y-offset", type=float, default=0.0)
    ap.add_argument("--no-pose", action="store_true")
    ap.add_argument("--tex", default="")
    ap.add_argument("--write-imgs", action="store_true")
    ap.add_argument("--route", default="sepaa",
                    choices=["sepaa", "aa_fused", "separate"])
    ap.add_argument("--cpu", action="store_true",
                    help="render with the plain PyTorch versions on the CPU")
    args = ap.parse_args()
    render_result(args.result_dir, args.calib, args.basemesh, args.cams,
                  args.frames, args.refdir, tuple(args.res), args.mode,
                  args.y_offset, not args.no_pose, args.tex,
                  write_imgs=args.write_imgs, route=args.route,
                  device="cpu" if args.cpu else None)


if __name__ == "__main__":
    main()
