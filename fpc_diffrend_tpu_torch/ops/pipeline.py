"""The render pipeline (port of ``fpc_diffrend_tpu.ops.pipeline``): the
single view ``render`` / ``render_from_clip``, which the result renderers
call, and the stacked batch ``render_batch_stacked``, which the fit step
calls.

``impl`` picks the rasterizer: "auto" and "pallas" (the JAX name of the
binned kernel path) render through the kernels at B = 1; "scan" composes
the nvdiffrast-style primitives as the JAX package's scan route does
(``ops.rasterize.rasterize_with_uv`` with the O(T·H·W) visibility scan,
``ops.texture.texture``, ``ops.antialias.antialias`` with its pair cap;
with mip, ``rasterize`` -> ``interpolate(diff_attrs="all")`` -> the
trilinear ``texture``).

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
from fpc_diffrend_tpu_torch.ops.antialias import antialias
from fpc_diffrend_tpu_torch.ops.interpolate import interpolate
from fpc_diffrend_tpu_torch.ops.rasterize import (
    check_impl, rasterize, rasterize_textured_sepaa_stacked,
    rasterize_with_uv)
from fpc_diffrend_tpu_torch.ops.texture import texture
from fpc_diffrend_tpu_torch.utils.profiling import span

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
    with span("raster.composite"):
        img = torch.where(idbuf >= 0, aa, background)
        ph = idbuf.shape[0] // batch
        img = img.reshape(aa.shape[0], batch, ph,
                          idbuf.shape[1])[:, :, :h, :w]
        return img.movedim(0, -1)


def render_batch_stacked(pos_clip_b: Tensor, pos_idx: Tensor, uv: Tensor,
                         uv_idx: Tensor, tex: Tensor,
                         resolution: Tuple[int, int], face_neighbors: Tensor,
                         background: float = BACKGROUND,
                         pair_cap: int | None = None,
                         enable_mip: bool = False,
                         max_mip_level: int = 0) -> Tensor:
    """Render a batch of clip positions through the stacked pipeline.

    :param pos_clip_b: (B, V, 4) clip positions per sample.
    :param pair_cap: per-sample bin-entry cap (None or 0: uncapped).
    :param enable_mip: trilinear mipmap sampling (``linear-mipmap-linear``
        with up to ``max_mip_level`` levels) in place of bilinear.
    :return: (B, H, W, C) images in [0, 1], row 0 = bottom (GL convention).
    """
    idbuf, aa = rasterize_textured_sepaa_stacked(
        pos_clip_b, pos_idx, uv, uv_idx, tex, face_neighbors, resolution,
        pair_cap=pair_cap, enable_mip=enable_mip,
        max_mip_level=max_mip_level)
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
        path) render through the kernels; "scan" composes the primitives
        over the O(T·H·W) reference rasterizer. JAX's "auto" takes the
        scan route off the TPU; the port's is always the kernels.
    :param aa_max_pairs: the scan route's antialias pair cap a direction
        (None: every pair, exact); the kernels' antialias is exact and
        does not read it.
    :param pair_cap: bin-entry cap of the kernel route (None: uncapped).
    :param route: the kernels of the bilinear path: "sepaa" (K1 -> K2,
        JAX's default), "aa_fused" (K10) or "separate" (K1 -> K7 -> K2);
        the three give the same image and gradients. JAX picks them by
        environment variables; the port reads none. The scan route does
        not read it.
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
    on: on the kernel route one view binned as a batch of one, through the
    stacked pipeline. A 2-D texture is taken as one channel."""
    tex3 = tex[..., None] if tex.ndim == 2 else tex
    if check_impl(impl) == "scan":
        return _render_scan(pos_clip, pos_idx, uv, uv_idx, tex3,
                            tuple(resolution), face_neighbors, enable_mip,
                            max_mip_level, background, aa_max_pairs)
    idbuf, aa = rasterize_textured_sepaa_stacked(
        pos_clip[None], pos_idx, uv, uv_idx, tex3, face_neighbors,
        tuple(resolution), pair_cap=pair_cap, enable_mip=enable_mip,
        max_mip_level=max_mip_level, route=route)
    return composite_stacked(idbuf, aa, 1, tuple(resolution), background)[0]


def scan_colour(pos_clip, pos_idx, uv, uv_idx, tex, resolution,
                enable_mip, max_mip_level):
    """The scan route's rasterize and sampler, before the antialias:
    bilinear, ``rasterize_with_uv`` then ``texture``; with ``enable_mip``,
    ``rasterize`` -> ``interpolate(diff_attrs="all")`` -> the trilinear
    ``texture``, whose uv derivatives stay in the gradient, as in JAX.

    :return: (rast (H, W, 4), colour (H, W, C)).
    """
    if not enable_mip:
        rast, texc = rasterize_with_uv(pos_clip, pos_idx, uv, uv_idx,
                                       resolution, impl="scan")
        return rast, texture(tex, texc, filter_mode="linear")
    rast, rast_db = rasterize(pos_clip, pos_idx, resolution, impl="scan",
                              with_db=True)
    texc, texd = interpolate(uv, rast, uv_idx, rast_db=rast_db,
                             diff_attrs="all")
    return rast, texture(tex, texc, uv_da=texd,
                         filter_mode="linear-mipmap-linear",
                         max_mip_level=max_mip_level)


def _render_scan(pos_clip, pos_idx, uv, uv_idx, tex, resolution,
                 face_neighbors, enable_mip, max_mip_level, background,
                 aa_max_pairs):
    """The scan route of :func:`render_from_clip` (JAX's
    ``ops/pipeline.py:121-126,201-221``): the primitives composed over the
    visibility scan (:func:`scan_colour`), then the background
    composite."""
    rast, colour = scan_colour(pos_clip, pos_idx, uv, uv_idx, tex,
                               resolution, enable_mip, max_mip_level)
    colour = antialias(colour, rast, pos_clip, pos_idx, face_neighbors,
                       max_pairs=aa_max_pairs)
    return torch.where(rast[..., 3:] > 0, colour, background)


def _bary_db_to_uv_da(db: Tensor, uv: Tensor, uv_idx: Tensor,
                      rast: Tensor) -> Tensor:
    """(du/dx, du/dy, dv/dx, dv/dy) barycentric derivatives -> the uv
    derivatives (ds/dx, ds/dy, dt/dx, dt/dy) of the winner's texture
    coordinates, texc = u c0 + v c1 + (1 - u - v) c2, with the corners held
    out of the gradient (JAX's mip LOD of the kernel route; the port's
    kernel route takes the finite-difference LOD instead).

    :return: (H, W, 4).
    """
    ids = torch.clamp(rast[..., 3].to(torch.int64) - 1, min=0)
    c = uv[uv_idx.long()].detach()[ids]              # (H, W, 3, 2)
    d0 = c[..., 0, :] - c[..., 2, :]
    d1 = c[..., 1, :] - c[..., 2, :]
    du_dx, du_dy, dv_dx, dv_dy = db.unbind(-1)
    return torch.stack([d0[..., 0] * du_dx + d1[..., 0] * dv_dx,
                        d0[..., 0] * du_dy + d1[..., 0] * dv_dy,
                        d0[..., 1] * du_dx + d1[..., 1] * dv_dx,
                        d0[..., 1] * du_dy + d1[..., 1] * dv_dy], dim=-1)
