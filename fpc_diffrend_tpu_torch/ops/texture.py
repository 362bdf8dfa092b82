"""Texture sampling, bilinear and trilinear-mipmap (port of
``fpc_diffrend_tpu.ops.texture``).

``bilinear`` is the plain version of the fused raster kernel's texture
tail and of the standalone sampler K7: a direct four-texel gather with wrap
(or clamp) indices and no footprint limit. ``texture`` with
``filter_mode="linear"`` runs K7 forward and K4 backward
(``ops.cuda.texture_cuda.TextureBilinear``; their plain versions on the
CPU). ``build_mip_pyramid`` is the box-filtered mip chain the
mip path samples, differentiable through autograd, and ``texture`` with
``filter_mode="linear-mipmap-linear"`` is the XLA trilinear sampler, kept
as the reference of the mip kernels' plain versions. uv follows
OpenGL/nvdiffrast: texel (i, j) spans [i / size, (i + 1) / size) and the
sample position is uv * size - 0.5.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def wrap_idx(idx: Tensor, size: int, mode: str) -> Tensor:
    if mode == "wrap":
        return torch.remainder(idx, size)
    if mode == "clamp":
        return torch.clamp(idx, 0, size - 1)
    raise ValueError(f"unknown boundary mode {mode!r}")


def bilinear(tex: Tensor, u: Tensor, v: Tensor,
             boundary_mode: str = "wrap") -> Tensor:
    """Bilinear sample of tex (TH, TW, C) at coordinate planes u, v (...).

    :return: (..., C) samples.
    """
    th, tw = tex.shape[0], tex.shape[1]
    s = u * tw - 0.5
    t = v * th - 0.5
    s0 = torch.floor(s)
    t0 = torch.floor(t)
    fs = (s - s0)[..., None]
    ft = (t - t0)[..., None]
    s0 = s0.to(torch.int64)
    t0 = t0.to(torch.int64)
    s1 = wrap_idx(s0 + 1, tw, boundary_mode)
    t1 = wrap_idx(t0 + 1, th, boundary_mode)
    s0 = wrap_idx(s0, tw, boundary_mode)
    t0 = wrap_idx(t0, th, boundary_mode)
    c00 = tex[t0, s0]
    c01 = tex[t0, s1]
    c10 = tex[t1, s0]
    c11 = tex[t1, s1]
    top = c00 * (1 - fs) + c01 * fs
    bot = c10 * (1 - fs) + c11 * fs
    return top * (1 - ft) + bot * ft


def build_mip_pyramid(tex: Tensor, max_level: int) -> list[Tensor]:
    """Box-filtered mip chain [level0, level1, ...] of tex (TH, TW, C):
    2x2 means, stopping at ``max_level`` or a 1-texel side."""
    levels = [tex]
    cur = tex
    while len(levels) <= max_level and min(cur.shape[0], cur.shape[1]) >= 2:
        th, tw, c = cur.shape
        cur = cur.reshape(th // 2, 2, tw // 2, 2, c).mean(dim=(1, 3))
        levels.append(cur)
    return levels


def texture(tex: Tensor, uv: Tensor, uv_da: Tensor | None = None,
            filter_mode: str = "linear", boundary_mode: str = "wrap",
            max_mip_level: int = 0) -> Tensor:
    """Sample tex (TH, TW, C) at uv (..., 2) -> (..., C); the JAX
    ``texture``'s parameters, in its order.

    :param uv_da: (..., 4) screen-space uv derivatives (du/dx, du/dy,
        dv/dx, dv/dy); required for mipmap filtering.
    :param filter_mode: "linear" (bilinear) or "linear-mipmap-linear"
        (trilinear across the mip chain, LOD from ``uv_da``).
    :param boundary_mode: "wrap" or "clamp".
    :param max_mip_level: the deepest mip level built and sampled.
    """
    if filter_mode == "linear":
        # imported here: texture_cuda takes its plain version from this module
        from fpc_diffrend_tpu_torch.ops.cuda.texture_cuda import (
            TextureBilinear)

        planes = TextureBilinear.apply(tex.contiguous(),
                                       uv[..., 0].contiguous(),
                                       uv[..., 1].contiguous(), boundary_mode)
        return planes.movedim(0, -1)
    if filter_mode != "linear-mipmap-linear":
        raise NotImplementedError(f"filter_mode {filter_mode!r}")
    if uv_da is None:
        raise ValueError("mipmap filtering requires uv_da")
    th, tw = tex.shape[0], tex.shape[1]
    levels = build_mip_pyramid(tex, max_mip_level)
    n_levels = len(levels)
    dsdx = uv_da[..., 0] * tw
    dsdy = uv_da[..., 1] * tw
    dtdx = uv_da[..., 2] * th
    dtdy = uv_da[..., 3] * th
    rho2 = torch.maximum(dsdx * dsdx + dtdx * dtdx, dsdy * dsdy + dtdy * dtdy)
    lod = 0.5 * torch.log2(torch.clamp(rho2, min=1e-20))
    lod = torch.clamp(lod, 0.0, float(n_levels - 1))
    lo = torch.floor(lod)
    frac = (lod - lo)[..., None]
    lo = lo[..., None]
    samples = [bilinear(lv, uv[..., 0], uv[..., 1], boundary_mode)
               for lv in levels]
    samples_lo = torch.zeros_like(samples[0])
    samples_hi = torch.zeros_like(samples[0])
    for li in range(n_levels):
        samples_lo = torch.where(lo == li, samples[li], samples_lo)
        samples_hi = torch.where(lo == li,
                                 samples[min(li + 1, n_levels - 1)],
                                 samples_hi)
    return samples_lo * (1 - frac) + samples_hi * frac
