"""Smoke-test renderer: one calibrated view of a mesh to a PNG.

The port's copy of ``fpc_diffrend_tpu.tools.simple_render`` (reference
simplerender.py:16-79): load calibration + mesh + texture, render through
one camera, flip vertically, quantize, save. Validates data/camera
conventions end to end.

Usage:
  python -m fpc_diffrend_tpu_torch.tools.simple_render \
      --calib calibration.json --cam pod2texture --mesh basemesh.obj \
      [--tex texture.png] [--res 1600 1200] [--out test.png] [--cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from fpc_diffrend_tpu_torch.data import obj as objlib
from fpc_diffrend_tpu_torch.device import resolve_device
from fpc_diffrend_tpu_torch.models import camera
from fpc_diffrend_tpu_torch.ops.pipeline import render
from fpc_diffrend_tpu_torch.utils.image import load_image, save_image


def load_texture_png(texpath: str) -> np.ndarray:
    """(TH, TW, C) float32 in [0, 1] of an image file, flipped to the
    renderer's row order (row 0 at the bottom)."""
    tex = load_image(texpath).astype(np.float32) / 255.0
    return np.flip(tex, 0).copy()


def simple_render(calibpath: str, cam: str, meshpath: str, texpath: str = "",
                  resolution=(1600, 1200), out: str = "test.png",
                  y_offset: float = 0.0, impl: str = "auto",
                  route: str = "sepaa", device=None) -> np.ndarray:
    """Render ``meshpath`` through camera ``cam`` of ``calibpath``.

    :param texpath: texture image; "" renders a constant 0.7 texture.
    :param out: PNG to write ("" writes none).
    :param device: where to render; None means CUDA.
    :return: (H, W, C) uint8 image in file row order.
    """
    dev = resolve_device(device)
    with open(calibpath) as f:
        calibs = json.load(f)
    calib = calibs[cam]
    intr = np.asarray(calib["intrinsic"], np.float32)
    rot = np.asarray(calib["rotation"], np.float32)
    trans = np.asarray(calib["translation"], np.float32)

    mesh = objlib.load_obj(meshpath)
    topo = objlib.build_topology(mesh.faces, mesh.n_vertices)

    if texpath:
        tex = load_texture_png(texpath)
    else:
        tex = np.full((256, 256, 1), 0.7, np.float32)

    proj = camera.intrinsic_to_projection(intr).numpy()
    mv = camera.extrinsic_to_modelview(rot, trans).numpy()
    mvp = proj @ mv @ camera.translate(0.0, y_offset, 0.0)

    with torch.no_grad():
        img = render(mvp, mesh.verts3, mesh.faces, mesh.uv, mesh.fuv, tex,
                     tuple(resolution), topo.face_neighbors, impl=impl,
                     background=0.0, route=route, device=dev)

    # flip vertically (OpenGL row order) and quantize (simplerender.py:69-76)
    arr = img.cpu().numpy()[::-1]
    arr = np.clip(np.rint(arr * 255), 0, 255).astype(np.uint8)
    if out:
        save_image(out, arr)
    return arr


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--calib", required=True)
    ap.add_argument("--cam", default="pod2texture")
    ap.add_argument("--mesh", required=True)
    ap.add_argument("--tex", default="")
    ap.add_argument("--res", nargs=2, type=int, default=[1600, 1200])
    ap.add_argument("--out", default="test.png")
    ap.add_argument("--y-offset", type=float, default=0.0)
    ap.add_argument("--route", default="sepaa",
                    choices=["sepaa", "aa_fused", "separate"])
    ap.add_argument("--cpu", action="store_true",
                    help="render with the plain PyTorch versions on the CPU")
    args = ap.parse_args()
    simple_render(args.calib, args.cam, args.mesh, args.tex,
                  tuple(args.res), args.out, args.y_offset, route=args.route,
                  device="cpu" if args.cpu else None)
    print(f"saved {args.out}")


if __name__ == "__main__":
    main()
