"""Stacked-batch rasterize + texture + antialias, forward.

Port of the forward of ``fpc_diffrend_tpu.ops.rasterize``'s
``rasterize_pallas_textured_sepaa_stacked`` and
``rasterize_texture_sepaa_stacked``: aux records and binning on the
device, then K1 (fused raster + texture) and K2 (antialias), each one pass
over the B samples stacked vertically into one image. The backward is
slice 2: asking for a gradient through the kernels raises.
"""

from __future__ import annotations

import torch

from fpc_diffrend_tpu_torch.ops.cuda.antialias_cuda import antialias_planes
from fpc_diffrend_tpu_torch.ops.cuda.rasterize_cuda import (
    aux_records, bin_scene_stacked, fused_raster, pad_resolution)

Tensor = torch.Tensor


def bin_stacked(pos_clip_b: Tensor, faces: Tensor, uv: Tensor,
                uv_idx: Tensor, face_neighbors: Tensor, resolution):
    """Aux records and stacked binning for a batch of clip positions.

    :return: Bins over the (B * ph, pw) stacked image.
    """
    height, width = resolution
    aux_b = aux_records(uv, uv_idx, pos_clip_b, faces, face_neighbors,
                        height, width)
    return bin_scene_stacked(pos_clip_b, faces, height, width, aux_b)[2]


def rasterize_textured_sepaa_stacked(pos_clip_b: Tensor, faces: Tensor,
                                     uv: Tensor, uv_idx: Tensor, tex: Tensor,
                                     face_neighbors: Tensor, resolution):
    """Render B samples through one pass of each kernel.

    :param pos_clip_b: (B, V, 4) clip positions per sample.
    :param tex: (TH, TW, C) texture.
    :return: (idbuf (B*ph, pw) int32, aa (C, B*ph, pw) antialiased colour
        before the background composite).
    """
    height, width = resolution
    ph, pw = pad_resolution(height, width)
    bins = bin_stacked(pos_clip_b, faces, uv, uv_idx, face_neighbors,
                       resolution)
    idbuf, _entry, payload, _extra, colour = fused_raster(
        bins, tex, pos_clip_b.shape[0] * ph, pw)
    return idbuf, antialias_planes(idbuf, payload, colour, height, width, ph)
