"""Trilinear-mipmap texture sampling (port of the public API of
``fpc_diffrend_tpu.ops.pallas.texture_mip_tpu``).

The mip path of the fit step: the box-filtered pyramid built in autograd
and flattened into one buffer (``mip_pyramid``), then K8 with K9 as its
backward (``mip_texture``, on a caller's LOD plane). The render Functions
have K8 derive the LOD plane from finite differences of the interpolated
uv image (``ops.cuda.texture_mip_cuda.mip_sample_lod``; its plain
version ``lod_from_texc``, re-exported here), held out of the gradient.
The pyramid's own backward, the adjoint of the 2x2 means, stays in
autograd, as the JAX package keeps ``build_mip_pyramid`` in its graph.
"""

from __future__ import annotations

import torch

from fpc_diffrend_tpu_torch.ops.cuda.texture_mip_cuda import (  # noqa: F401
    lod_from_texc, mip_sample, mip_sample_bwd)
from fpc_diffrend_tpu_torch.ops.texture import build_mip_pyramid

Tensor = torch.Tensor


def level_sizes(th: int, tw: int, max_level: int):
    """[(th_l, tw_l)] of the levels :func:`build_mip_pyramid` builds."""
    sizes = [(th, tw)]
    while len(sizes) <= max_level and min(sizes[-1]) >= 2:
        sizes.append((sizes[-1][0] // 2, sizes[-1][1] // 2))
    return sizes


def mip_pyramid(tex: Tensor, max_level: int):
    """The mip chain of tex (TH, TW, C) as K8 and K9 read it.

    :return: (pyramid (n_texels, C), differentiable with respect to tex;
        sizes, the levels' (th_l, tw_l) as a tuple).
    """
    levels = build_mip_pyramid(tex, max_level)
    pyramid = torch.cat([lv.reshape(-1, lv.shape[-1]) for lv in levels])
    return pyramid, tuple(level_sizes(tex.shape[0], tex.shape[1], max_level))


class MipSample(torch.autograd.Function):
    """K8 forward, K9 backward: ``apply(pyramid, tu, tv, lam, sizes)``.

    ``lam`` is held constant (its cotangent is None), as the JAX package's
    mip kernel returns a zero LOD cotangent.
    """

    @staticmethod
    def forward(ctx, pyramid, tu, tv, lam, sizes):
        ctx.save_for_backward(pyramid, tu, tv, lam)
        ctx.sizes = sizes
        return mip_sample(pyramid, sizes, tu, tv, lam)

    @staticmethod
    def backward(ctx, g):
        pyramid, tu, tv, lam = ctx.saved_tensors
        gpyr, gtu, gtv = mip_sample_bwd(pyramid, ctx.sizes, tu, tv, lam,
                                        g.contiguous())
        return gpyr, gtu, gtv, None, None


def mip_texture(tex: Tensor, tu: Tensor, tv: Tensor, lam: Tensor,
                max_mip_level: int) -> Tensor:
    """Trilinear mip sample of tex (TH, TW, C), wrap boundary.

    :param tu, tv: (rows, pw) uv planes.
    :param lam: (rows, pw) LOD in levels (no gradient; clamped to the
        chain).
    :return: (C, rows, pw) samples, differentiable with respect to tex,
        tu and tv.
    """
    pyramid, sizes = mip_pyramid(tex, max_mip_level)
    return MipSample.apply(pyramid, tu, tv, lam.detach(), sizes)
