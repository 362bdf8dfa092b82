"""Stacked-batch rasterize + texture + antialias, forward and backward.

Port of ``fpc_diffrend_tpu.ops.rasterize``'s
``rasterize_pallas_textured_sepaa_stacked`` and its custom VJP
``rasterize_texture_sepaa_stacked``: aux records and binning on the
device, then K1 (fused raster + texture) and K2 (antialias), each one pass
over the B samples stacked vertically into one image. The backward is
K3 (antialias) -> K4 (texture) -> K5 (pixel -> bin entry) -> K6 (bin
entry -> triangle), under one ``torch.autograd.Function``; the y-shift and
the triangle setup chain back to clip positions through ordinary autograd,
as the JAX package leaves them to autodiff.

The single view (``ops.pipeline.render``) is the same pass at B = 1, and
picks one of three routes that compute the same image and gradients
(``route``; the JAX package picks them by environment variables,
``ops/pipeline.py:149-193`` there):

* ``"sepaa"``: K1 with its texture tail, then K2 (the JAX default, and
  the stacked batch's only route);
* ``"aa_fused"``: K10, K1 with the antialias in the same pass
  (``FPC_AA_FUSE=1``, JAX's ``rasterize_texture_aa_fused``);
* ``"separate"``: K1 without its texture tail, the standalone sampler K7,
  then K2 (``FPC_FUSE_TEX=0``).

All three share the backward K3 -> K4 -> K5 -> K6.

The mip path (``enable_mip``) is the same Function with another sampler:
K1 without its texture tail, the finite-difference LOD, K8 (trilinear mip
sample), K2; backward K3 -> K9 -> K5 -> K6. The JAX package renders it per
sample under ``vmap`` (``render_from_clip``'s mip branch); stacked, each
sample gives the same result, as the JAX package says of its own stacked
path ("functionally identical to vmapping").
"""

from __future__ import annotations

import torch

from fpc_diffrend_tpu_torch.ops.cuda.antialias_cuda import (
    antialias_planes, antialias_planes_bwd)
from fpc_diffrend_tpu_torch.ops.cuda.raster_grad_cuda import (
    fold_entries, pixel_grad)
from fpc_diffrend_tpu_torch.ops.cuda.rasterize_cuda import (
    aux_records, bin_scene_stacked, fused_raster, fused_raster_aa,
    pad_resolution)
from fpc_diffrend_tpu_torch.ops.cuda.texture_cuda import (
    texture_planes, texture_planes_bwd)
from fpc_diffrend_tpu_torch.ops.cuda.texture_mip_cuda import (
    mip_sample, mip_sample_bwd)
from fpc_diffrend_tpu_torch.ops.texture_mip import lod_from_texc, mip_pyramid

Tensor = torch.Tensor


def _raster(ctx, data_s, bins, tex, sample_ph, height, width, aa=False):
    """K1 over the stacked image (``tex`` None: no texture tail); with
    ``aa``, K10 (K1's outputs and the antialiased colour)."""
    B, T = data_s.shape[:2]
    _, pw = pad_resolution(height, width)
    ctx.bins = bins
    ctx.dims = (B, T, sample_ph, height, width)
    if aa:
        return fused_raster_aa(bins, tex, B * sample_ph, pw, height, width,
                               sample_ph)
    return fused_raster(bins, tex, B * sample_ph, pw)


def _antialias(ctx, idbuf, payload, colour):
    """K2 over the sampled colour."""
    _, _, sample_ph, height, width = ctx.dims
    ctx.mark_non_differentiable(idbuf)
    return antialias_planes(idbuf, payload, colour, height, width, sample_ph)


def _antialias_bwd(ctx, idbuf, payload, colour, g_aa):
    """K3: (gcolour, gverts) from the cotangent of K2's output."""
    _, _, sample_ph, height, width = ctx.dims
    return antialias_planes_bwd(idbuf, payload, colour, g_aa.contiguous(),
                                height, width, sample_ph)


def _records_bwd(ctx, entry, payload, extra, gtu, gtv, gverts):
    """K5 -> K6: the cotangents of the sampled uv and the screen corners
    into the (B, T, 16) data and aux records."""
    B, T = ctx.dims[:2]
    # the 11 cotangent planes of payload 0-10 [gu gv gz gtu gtv
    # g(x0..y2)]: u, v and z get none (the payload never leaves this
    # op, and the antialias differentiates only corners and colour)
    gpl = torch.cat([torch.zeros((3,) + gtu.shape, device=gtu.device),
                     gtu[None], gtv[None], gverts])
    grad_entries, grad_global = pixel_grad(ctx.bins, entry, payload[0],
                                           payload[1], extra, gpl)
    grad = fold_entries(grad_entries, grad_global, ctx.bins, B * T)
    return grad[:, :16].reshape(B, T, 16), grad[:, 16:].reshape(B, T, 16)


class RasterizeTexturedSepaaStacked(torch.autograd.Function):
    """K1 -> K2 forward, K3 -> K4 -> K5 -> K6 backward.

    ``apply(data_s, aux_s, tex, bins, sample_ph, height, width)``:

    :param data_s, aux_s: (B, T, 16) shifted stacked records
        (``bin_scene_stacked``), differentiable.
    :param tex: (TH, TW, C) texture, differentiable.
    :param bins: the Bins built from the same records (no gradient).
    :param sample_ph: row pitch of the stacked samples.
    :param height, width: one sample's real size.
    :return: (idbuf (B*ph, pw) int32, aa (C, B*ph, pw) antialiased colour
        before the background composite).
    """

    @staticmethod
    def forward(ctx, data_s, aux_s, tex, bins, sample_ph, height, width):
        idbuf, entry, payload, extra, colour = _raster(
            ctx, data_s, bins, tex, sample_ph, height, width)
        ctx.save_for_backward(idbuf, entry, payload, extra, colour, tex)
        return idbuf, _antialias(ctx, idbuf, payload, colour)

    @staticmethod
    def backward(ctx, _g_id, g_aa):
        idbuf, entry, payload, extra, colour, tex = ctx.saved_tensors
        gcolour, gverts = _antialias_bwd(ctx, idbuf, payload, colour, g_aa)
        gtex, gtu, gtv = texture_planes_bwd(tex, payload[3], payload[4],
                                            gcolour)
        return (*_records_bwd(ctx, entry, payload, extra, gtu, gtv, gverts),
                gtex, None, None, None, None)


class RasterizeTexturedAaFused(RasterizeTexturedSepaaStacked):
    """K10 forward (K1 and K2 in one pass), the same backward K3 -> K4 ->
    K5 -> K6 (JAX's ``_rasterize_texture_aa_fused_bwd``, which runs the
    antialias backward over the planes K10 also writes). Arguments and
    results as :class:`RasterizeTexturedSepaaStacked`."""

    @staticmethod
    def forward(ctx, data_s, aux_s, tex, bins, sample_ph, height, width):
        idbuf, entry, payload, extra, colour, aa = _raster(
            ctx, data_s, bins, tex, sample_ph, height, width, aa=True)
        ctx.save_for_backward(idbuf, entry, payload, extra, colour, tex)
        ctx.mark_non_differentiable(idbuf)
        return idbuf, aa


class RasterizeSeparateTexture(RasterizeTexturedSepaaStacked):
    """K1 without its texture tail -> K7 (the standalone bilinear wrap
    sampler) -> K2 forward, the same backward K3 -> K4 -> K5 -> K6 (JAX's
    ``texture_planes_pallas`` route). Arguments and results as
    :class:`RasterizeTexturedSepaaStacked`."""

    @staticmethod
    def forward(ctx, data_s, aux_s, tex, bins, sample_ph, height, width):
        idbuf, entry, payload, extra, _ = _raster(
            ctx, data_s, bins, None, sample_ph, height, width)
        colour = texture_planes(tex, payload[3], payload[4], "wrap")
        ctx.save_for_backward(idbuf, entry, payload, extra, colour, tex)
        return idbuf, _antialias(ctx, idbuf, payload, colour)


ROUTES = {"sepaa": RasterizeTexturedSepaaStacked,
          "aa_fused": RasterizeTexturedAaFused,
          "separate": RasterizeSeparateTexture}


class RasterizeMipSepaaStacked(torch.autograd.Function):
    """K1 (no texture) -> LOD -> K8 -> K2 forward, K3 -> K9 -> K5 -> K6
    backward.

    ``apply(data_s, aux_s, pyramid, sizes, bins, sample_ph, height,
    width)``: as :class:`RasterizeTexturedSepaaStacked`, with the flat mip
    pyramid (n_texels, C) and its levels' sizes (``ops.texture_mip.
    mip_pyramid``) in place of the texture. The LOD plane is computed from
    K1's uv and ids and held out of the gradient.
    """

    @staticmethod
    def forward(ctx, data_s, aux_s, pyramid, sizes, bins, sample_ph, height,
                width):
        idbuf, entry, payload, extra, _ = _raster(
            ctx, data_s, bins, None, sample_ph, height, width)
        th, tw = sizes[0]
        lam = lod_from_texc(payload[3], payload[4], idbuf, th, tw, height,
                            width, sample_ph)
        colour = mip_sample(pyramid, sizes, payload[3], payload[4], lam)
        ctx.save_for_backward(idbuf, entry, payload, extra, colour, pyramid,
                              lam)
        ctx.sizes = sizes
        return idbuf, _antialias(ctx, idbuf, payload, colour)

    @staticmethod
    def backward(ctx, _g_id, g_aa):
        idbuf, entry, payload, extra, colour, pyramid, lam = ctx.saved_tensors
        gcolour, gverts = _antialias_bwd(ctx, idbuf, payload, colour, g_aa)
        gpyr, gtu, gtv = mip_sample_bwd(pyramid, ctx.sizes, payload[3],
                                        payload[4], lam, gcolour)
        return (*_records_bwd(ctx, entry, payload, extra, gtu, gtv, gverts),
                gpyr, None, None, None, None, None)


def bin_stacked(pos_clip_b: Tensor, faces: Tensor, uv: Tensor,
                uv_idx: Tensor, face_neighbors: Tensor, resolution,
                entry_cap: int = 0):
    """Aux records and stacked binning for a batch of clip positions.

    :param entry_cap: per-sample bin-entry cap (0: uncapped).
    :return: (data_s, aux_s (B, T, 16) shifted records, differentiable,
        Bins over the (B * ph, pw) stacked image).
    """
    height, width = resolution
    aux_b = aux_records(uv, uv_idx, pos_clip_b, faces, face_neighbors,
                        height, width)
    return bin_scene_stacked(pos_clip_b, faces, height, width, aux_b,
                             entry_cap)


def rasterize_textured_sepaa_stacked(pos_clip_b: Tensor, faces: Tensor,
                                     uv: Tensor, uv_idx: Tensor, tex: Tensor,
                                     face_neighbors: Tensor, resolution,
                                     enable_mip: bool = False,
                                     max_mip_level: int = 0,
                                     pair_cap: int = 0,
                                     route: str = "sepaa"):
    """Render B samples through one pass of each kernel.

    :param pos_clip_b: (B, V, 4) clip positions per sample.
    :param tex: (TH, TW, C) texture.
    :param enable_mip: sample trilinearly across the mip chain of up to
        ``max_mip_level`` levels below the texture (K8, K9) instead of
        bilinearly (K1's tail, K4).
    :param pair_cap: per-sample bin-entry cap (``FitConfig.pair_cap``;
        0: uncapped).
    :param route: the bilinear path's kernels, a key of :data:`ROUTES`
        ("sepaa": K1 -> K2; "aa_fused": K10; "separate": K1 -> K7 -> K2);
        the mip path has one route.
    :return: (idbuf (B*ph, pw) int32, aa (C, B*ph, pw) antialiased colour
        before the background composite), differentiable with respect to
        ``pos_clip_b`` and ``tex``.
    """
    if route not in ROUTES:
        raise ValueError(f"unknown route {route!r}; one of {list(ROUTES)}")
    height, width = resolution
    ph, _ = pad_resolution(height, width)
    data_s, aux_s, bins = bin_stacked(pos_clip_b, faces, uv, uv_idx,
                                      face_neighbors, resolution, pair_cap)
    if enable_mip:
        pyramid, sizes = mip_pyramid(tex, max_mip_level)
        return RasterizeMipSepaaStacked.apply(data_s, aux_s, pyramid, sizes,
                                              bins, ph, height, width)
    return ROUTES[route].apply(data_s, aux_s, tex, bins, ph, height, width)
