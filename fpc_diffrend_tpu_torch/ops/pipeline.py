"""The render pipeline (port of ``fpc_diffrend_tpu.ops.pipeline``): the
single view ``render`` / ``render_from_clip``, which the result renderers
call, and the stacked batch ``render_batch_stacked``, which the fit step
calls.

The background is composited after antialias, as in the reference
renderer: antialias blends a foreground pixel against the colour a missed
pixel sampled (uv (0, 0)), and the composite then paints 45/255 over every
missed pixel.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from fpc_diffrend_tpu_torch.device import resolve_device
from fpc_diffrend_tpu_torch.models.camera import transform_clip
from fpc_diffrend_tpu_torch.ops.rasterize import (
    rasterize_textured_sepaa_stacked)

Tensor = torch.Tensor

BACKGROUND = 45.0 / 255.0


def composite_stacked(idbuf: Tensor, aa: Tensor, batch: int,
                      resolution: Tuple[int, int],
                      background: float = BACKGROUND) -> Tensor:
    """Background composite, unstack and crop.

    :param idbuf: (B*ph, pw) int32 ids; aa: (C, B*ph, pw) colour.
    :return: (B, H, W, C) images.
    """
    h, w = resolution
    img = torch.where(idbuf >= 0, aa, background)
    ph = idbuf.shape[0] // batch
    img = img.reshape(aa.shape[0], batch, ph, idbuf.shape[1])[:, :, :h, :w]
    return img.movedim(0, -1)


def render_batch_stacked(pos_clip_b: Tensor, pos_idx: Tensor, uv: Tensor,
                         uv_idx: Tensor, tex: Tensor,
                         resolution: Tuple[int, int], face_neighbors: Tensor,
                         background: float = BACKGROUND,
                         enable_mip: bool = False,
                         max_mip_level: int = 0,
                         pair_cap: int = 0) -> Tensor:
    """Render a batch of clip positions through the stacked pipeline.

    :param pos_clip_b: (B, V, 4) clip positions per sample.
    :param enable_mip: trilinear mipmap sampling (``linear-mipmap-linear``
        with up to ``max_mip_level`` levels) in place of bilinear.
    :param pair_cap: per-sample bin-entry cap (0: uncapped).
    :return: (B, H, W, C) images in [0, 1], row 0 = bottom (GL convention).
    """
    idbuf, aa = rasterize_textured_sepaa_stacked(
        pos_clip_b, pos_idx, uv, uv_idx, tex, face_neighbors, resolution,
        enable_mip, max_mip_level, pair_cap)
    return composite_stacked(idbuf, aa, pos_clip_b.shape[0], resolution,
                             background)


def render(mvp, pos, pos_idx, uv, uv_idx, tex, resolution: Tuple[int, int],
           face_neighbors, enable_mip: bool = False, max_mip_level: int = 0,
           impl: str = "auto", background: float = BACKGROUND,
           aa_max_pairs: int | None = None, pair_cap: int | None = None,
           route: str = "sepaa", device=None) -> Tensor:
    """Render one view; differentiable with respect to pos, tex (and mvp).

    The JAX package's ``render`` with its names and defaults, on the
    device: inputs (tensors or arrays) are moved to ``device``.

    :param mvp: (4, 4) modelview-projection matrix.
    :param pos: (V, 3) object-space vertex positions.
    :param pos_idx: (T, 3) int triangles; uv (U, 2), uv_idx (T, 3).
    :param tex: (TH, TW, C) texture.
    :param resolution: (height, width).
    :param face_neighbors: (T, 3) int adjacency for antialiasing.
    :param impl: "auto" or "pallas" (the JAX name of the binned kernel
        path) render through the kernels; "scan", JAX's O(T·H·W)
        reference rasterizer, is not ported and raises.
    :param aa_max_pairs: JAX's pair cap of its scan-path antialias; the
        kernels' antialias is exact, so it is not read.
    :param pair_cap: bin-entry cap (None: uncapped).
    :param route: the kernels of the bilinear path: "sepaa" (K1 -> K2,
        JAX's default), "aa_fused" (K10) or "separate" (K1 -> K7 -> K2);
        the three give the same image and gradients. JAX picks them by
        environment variables; the port reads none.
    :param device: where to render; None means CUDA (no CPU fallback).
    :return: (H, W, C) image in [0, 1], row 0 = bottom (GL convention).
    """
    dev = resolve_device(device)

    def tensor(x):
        # arrays are copied (a JAX array's numpy view is read-only);
        # tensors keep their autograd graph
        return x if isinstance(x, torch.Tensor) else torch.tensor(np.array(x))

    def f32(x):
        return tensor(x).to(device=dev, dtype=torch.float32)

    def i32(x):
        return tensor(x).to(device=dev, dtype=torch.int32)

    pos_clip = transform_clip(f32(mvp), f32(pos))
    return render_from_clip(pos_clip, i32(pos_idx), f32(uv), i32(uv_idx),
                            f32(tex), resolution, i32(face_neighbors),
                            enable_mip=enable_mip,
                            max_mip_level=max_mip_level, impl=impl,
                            background=background,
                            aa_max_pairs=aa_max_pairs, pair_cap=pair_cap,
                            route=route)


def render_from_clip(pos_clip: Tensor, pos_idx: Tensor, uv: Tensor,
                     uv_idx: Tensor, tex: Tensor, resolution: Tuple[int, int],
                     face_neighbors: Tensor, enable_mip: bool = False,
                     max_mip_level: int = 0, impl: str = "auto",
                     background: float = BACKGROUND,
                     aa_max_pairs: int | None = None,
                     pair_cap: int | None = None,
                     route: str = "sepaa") -> Tensor:
    """:func:`render` from clip positions (V, 4), on the device they lie
    on: one view binned as a batch of one, through the stacked pipeline.
    A 2-D texture is taken as one channel."""
    if impl == "scan":
        raise NotImplementedError(
            "impl='scan' (the O(T*H*W) reference rasterizer) is not ported; "
            "use impl='auto'")
    if impl not in ("auto", "pallas"):
        raise ValueError(f"unknown impl {impl!r}")
    tex3 = tex[..., None] if tex.ndim == 2 else tex
    idbuf, aa = rasterize_textured_sepaa_stacked(
        pos_clip[None], pos_idx, uv, uv_idx, tex3, face_neighbors,
        tuple(resolution), enable_mip, max_mip_level, pair_cap or 0, route)
    return composite_stacked(idbuf, aa, 1, tuple(resolution), background)[0]
