"""Lens undistortion preprocessing (offline, like the reference): the
port's copy of ``fpc_diffrend_tpu.tools.undistort``.

The reference handles lens distortion entirely offline with cv2.undistort
over every frame (undistort.py; fit.py:540 comment). Two implementations:

  * ``undistort_image_cv2`` — exact OpenCV path when cv2 is available.
  * ``undistort_image_torch`` — a Brown-Conrady bilinear remap in torch on
    the device (JAX's ``undistort_image_jax``; CUDA unless the caller asks
    for the CPU), for environments without OpenCV. Uses the standard
    5-coefficient model (k1, k2, p1, p2, k3).

``undistort_take`` takes the remap where cv2 is missing, as the JAX tool
does: that is the tool's own choice of method, not a device fallback.

Usage:
  python -m fpc_diffrend_tpu_torch.tools.undistort --take take_dir \
      --out out_dir --calib calibration.json [--torch] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from fpc_diffrend_tpu_torch.device import resolve_device

Tensor = torch.Tensor


def undistort_image_cv2(image: np.ndarray, intrinsic: np.ndarray,
                        distortion: np.ndarray) -> np.ndarray:
    import cv2

    return cv2.undistort(image, intrinsic, distortion)


def undistort_map(intrinsic, distortion, height: int, width: int,
                  device=None) -> Tensor:
    """(H, W, 2) sampling map: undistorted pixel -> distorted source pixel
    (row, col), float32 on ``device`` (None: CUDA)."""
    dev = resolve_device(device)
    intrinsic = np.asarray(intrinsic, np.float32)
    fx, fy = float(intrinsic[0, 0]), float(intrinsic[1, 1])
    cx, cy = float(intrinsic[0, 2]), float(intrinsic[1, 2])
    k1, k2, p1, p2, k3 = [float(d) for d in
                          np.asarray(distortion).reshape(-1)[:5]]

    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev) + 0.5,
        torch.arange(width, dtype=torch.float32, device=dev) + 0.5,
        indexing="ij")
    x = (xs - cx) / fx
    y = (ys - cy) / fy
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3
    x_d = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    y_d = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    u = x_d * fx + cx
    v = y_d * fy + cy
    return torch.stack([v, u], dim=-1)


def undistort_image_torch(image, intrinsic, distortion,
                          device=None) -> Tensor:
    """Bilinear remap through the distortion model, on ``device`` (None:
    CUDA): JAX's ``undistort_image_jax``.

    :param image: (H, W) or (H, W, C), any real dtype.
    :return: float32 image of the same shape on the device.
    """
    dev = resolve_device(device)
    image = torch.as_tensor(np.asarray(image) if not isinstance(
        image, Tensor) else image).to(device=dev, dtype=torch.float32)
    squeeze = image.ndim == 2
    if squeeze:
        image = image[..., None]
    h, w = image.shape[:2]
    m = undistort_map(intrinsic, distortion, h, w, dev)
    sy = m[..., 0] - 0.5
    sx = m[..., 1] - 0.5
    y0 = torch.clamp(torch.floor(sy).to(torch.int64), 0, h - 1)
    x0 = torch.clamp(torch.floor(sx).to(torch.int64), 0, w - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    fy = (sy - y0.to(torch.float32))[..., None]
    fx = (sx - x0.to(torch.float32))[..., None]
    out = (image[y0, x0] * (1 - fx) * (1 - fy) + image[y0, x1] * fx * (1 - fy)
           + image[y1, x0] * (1 - fx) * fy + image[y1, x1] * fx * fy)
    return out[..., 0] if squeeze else out


def undistort_take(takedir: str, outdir: str, calibpath: str,
                   use_cv2: bool = True, device=None) -> None:
    """Undistort every frame of every camera directory (undistort.py parity).

    Camera directory names end with the calibration key after the last
    '_' (undistort.py:37-38). Without cv2 (or ``use_cv2=False``) the
    frames go through :func:`undistort_image_torch` on ``device``.
    """
    from PIL import Image

    with open(calibpath) as f:
        calib = json.load(f)
    os.makedirs(outdir, exist_ok=True)
    for cam in sorted(os.listdir(takedir)):
        campath = os.path.join(takedir, cam)
        if not os.path.isdir(campath):
            continue
        key = cam.split("_")[-1]
        intr = np.asarray(calib[key]["intrinsic"], np.float32)
        dist = np.asarray(calib[key]["distortion"], np.float32)
        outcam = os.path.join(outdir, cam)
        os.makedirs(outcam, exist_ok=True)
        for frame in sorted(os.listdir(campath)):
            img = np.array(Image.open(os.path.join(campath, frame)))
            und = None
            if use_cv2:
                try:
                    und = undistort_image_cv2(img, intr, dist)
                except ImportError:
                    pass
            if und is None:
                und = undistort_image_torch(img, intr, dist, device)
                und = und.cpu().numpy().astype(img.dtype)
            Image.fromarray(und).save(os.path.join(outcam, frame))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--take", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--calib", required=True)
    ap.add_argument("--torch", action="store_true",
                    help="use the torch remap (JAX's --jax)")
    ap.add_argument("--cpu", action="store_true",
                    help="run the torch remap on the CPU")
    args = ap.parse_args()
    undistort_take(args.take, args.out, args.calib, use_cv2=not args.torch,
                   device="cpu" if args.cpu else None)


if __name__ == "__main__":
    main()
