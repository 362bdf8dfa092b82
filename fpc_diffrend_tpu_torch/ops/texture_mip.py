"""Trilinear-mipmap texture sampling (port of the public API of
``fpc_diffrend_tpu.ops.pallas.texture_mip_tpu``).

The mip path of the fit step: the LOD plane from finite differences of
the interpolated uv image (``lod_from_texc``, torch ops, held out of the
gradient), the box-filtered pyramid built in autograd and flattened into
one buffer (``mip_pyramid``), then K8 with K9 as its backward
(``mip_texture``). The pyramid's own backward, the adjoint of the 2x2
means, stays in autograd, as the JAX package keeps ``build_mip_pyramid``
in its graph.
"""

from __future__ import annotations

import torch

from fpc_diffrend_tpu_torch.ops.cuda.texture_mip_cuda import (
    mip_sample, mip_sample_bwd)
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


def lod_from_texc(tu: Tensor, tv: Tensor, idbuf: Tensor, th: int, tw: int,
                  height: int, width: int, sample_ph: int) -> Tensor:
    """Finite-difference LOD plane of the stacked uv image.

    Screen-space uv derivatives by one-pixel differences between pixels of
    the same triangle: the forward difference where the next pixel holds
    the same id, else the backward one, else 0. A neighbour outside the
    sample's real height x width counts as absent (column >= width, or a
    vertical pair whose upper row has ``row % sample_ph >= height - 1``),
    the pair masks of K2 and K3: the JAX package takes the differences on
    one sample's cropped image, and the stacked ids are local triangle
    ids, which two samples can share across their boundary.

    :param tu, tv: (rows, pw) interpolated uv (K1 payload planes 3, 4).
    :param idbuf: (rows, pw) int32 triangle ids, -1 where nothing is hit.
    :param th, tw: size of the texture's finest level.
    :return: (rows, pw) LOD in levels, unclamped.
    """
    rows, pw = idbuf.shape
    dev = idbuf.device
    hpair = torch.arange(pw - 1, device=dev) < width - 1
    vpair = (torch.arange(rows - 1, device=dev) % sample_ph
             < height - 1)[:, None]
    same_h = (idbuf[:, 1:] == idbuf[:, :-1]) & hpair
    same_v = (idbuf[1:] == idbuf[:-1]) & vpair
    pad = torch.nn.functional.pad

    def fd_x(f):
        d = f[:, 1:] - f[:, :-1]
        return torch.where(pad(same_h, (0, 1)), pad(d, (0, 1)),
                           torch.where(pad(same_h, (1, 0)), pad(d, (1, 0)),
                                       0.0))

    def fd_y(f):
        d = f[1:] - f[:-1]
        return torch.where(pad(same_v, (0, 0, 0, 1)), pad(d, (0, 0, 0, 1)),
                           torch.where(pad(same_v, (0, 0, 1, 0)),
                                       pad(d, (0, 0, 1, 0)), 0.0))

    s = tu * tw
    t = tv * th
    dsdx, dtdx, dsdy, dtdy = fd_x(s), fd_x(t), fd_y(s), fd_y(t)
    rho2 = torch.maximum(dsdx * dsdx + dtdx * dtdx,
                         dsdy * dsdy + dtdy * dtdy)
    return 0.5 * torch.log2(torch.clamp(rho2, min=1e-20))


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
