"""The stacked-batch render pipeline (port of ``fpc_diffrend_tpu.ops.pipeline``'s
``render_batch_stacked``).

The background is composited after antialias, as in the reference
renderer: antialias blends a foreground pixel against the colour a missed
pixel sampled (uv (0, 0)), and the composite then paints 45/255 over every
missed pixel.
"""

from __future__ import annotations

from typing import Tuple

import torch

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
