"""Bilinear texture sampling (port of ``fpc_diffrend_tpu.ops.texture``).

The plain version of the fused raster kernel's texture tail: a direct
four-texel gather with wrap (or clamp) indices and no footprint limit.
uv follows OpenGL/nvdiffrast: texel (i, j) spans [i / size, (i + 1) / size)
and the sample position is uv * size - 0.5.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _wrap_idx(idx: Tensor, size: int, mode: str) -> Tensor:
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
    s1 = _wrap_idx(s0 + 1, tw, boundary_mode)
    t1 = _wrap_idx(t0 + 1, th, boundary_mode)
    s0 = _wrap_idx(s0, tw, boundary_mode)
    t0 = _wrap_idx(t0, th, boundary_mode)
    c00 = tex[t0, s0]
    c01 = tex[t0, s1]
    c10 = tex[t1, s0]
    c11 = tex[t1, s1]
    top = c00 * (1 - fs) + c01 * fs
    bot = c10 * (1 - fs) + c11 * fs
    return top * (1 - ft) + bot * ft


def texture(tex: Tensor, uv: Tensor, boundary_mode: str = "wrap") -> Tensor:
    """Bilinear sample at uv (..., 2) -> (..., C)."""
    return bilinear(tex, uv[..., 0], uv[..., 1], boundary_mode)
