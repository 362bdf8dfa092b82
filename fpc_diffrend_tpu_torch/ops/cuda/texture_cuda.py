"""The bilinear texture sampler (K7) and its backward (K4), wrap or clamp.

Port of ``fpc_diffrend_tpu.ops.pallas.texture_tpu._fwd_kernel``
(launched by ``_texture_fwd_impl`` and ``_texture_planes_fwd_impl``) as
the CUDA kernel ``csrc/texture_fwd.cu``, and of its ``_bwd_kernel``
(launched by ``texture_planes_bwd_impl``) as ``csrc/texture_bwd.cu``. They
compute the XLA sampler (``fpc_diffrend_tpu.ops.texture``) and its
autodiff over planes of uv of any shape: the texture cotangent summed over
every pixel, and the cotangents of the sampled uv. Clamp mode clamps the
texel indices, as the XLA sampler does; the TPU kernel instead clips the
coordinate to ``size - 1.001`` (``texture_tpu.py:855-856``) and gates the
uv gradient past it, which moves a sample past the high edge by at most
0.001 of the edge texel step. Its zeroed uv gradient where its texel patch
clamps is a layout artefact and is not copied either.

``texture_planes`` and ``texture_planes_bwd`` run their kernels for CUDA
tensors and their plain PyTorch versions (``*_plain``) for CPU tensors.
:class:`TextureBilinear` joins them into an autograd Function (K7
forward, K4 backward), the port's ``texture_pallas``.
"""

from __future__ import annotations

import ctypes

import torch

from fpc_diffrend_tpu_torch.kernels import build
from fpc_diffrend_tpu_torch.ops.texture import bilinear, wrap_idx

Tensor = torch.Tensor

BOUNDARY_MODES = ("wrap", "clamp")


def _clamp_flag(boundary_mode: str) -> int:
    if boundary_mode not in BOUNDARY_MODES:
        raise ValueError(f"unknown boundary mode {boundary_mode!r}")
    return int(boundary_mode == "clamp")


def _check(tex: Tensor, tu: Tensor, tv: Tensor, planes: dict):
    """Raise unless the tensors fit the kernels; :return: the device."""
    dev = tu.device
    check = build.check_tensor
    check(tex, "tex", torch.float32, tex.shape, dev)
    if tex.ndim != 3:
        raise ValueError(f"tex must be (TH, TW, C), got {tuple(tex.shape)}")
    check(tu, "tu", torch.float32, tu.shape, dev)
    check(tv, "tv", torch.float32, tu.shape, dev)
    for name, t in planes.items():
        check(t, name, torch.float32, (tex.shape[2],) + tuple(tu.shape), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def texture_planes_plain(tex: Tensor, tu: Tensor, tv: Tensor,
                         boundary_mode: str = "wrap") -> Tensor:
    """Plain PyTorch version of K7 (same arguments as
    :func:`texture_planes`): ``ops.texture.bilinear``, channels first."""
    return bilinear(tex, tu, tv, boundary_mode).movedim(-1, 0).contiguous()


def texture_planes(tex: Tensor, tu: Tensor, tv: Tensor,
                   boundary_mode: str = "wrap") -> Tensor:
    """K7: bilinear sample of ``tex`` at every (tu, tv).

    :param tex: (TH, TW, C) float32 texture.
    :param tu, tv: uv planes of one shape (...), float32.
    :param boundary_mode: "wrap" (nvdiffrast's default) or "clamp".
    :return: (C, ...) samples.
    """
    clamp = _clamp_flag(boundary_mode)
    dev = _check(tex, tu, tv, {})
    if dev.type == "cpu":
        return texture_planes_plain(tex, tu, tv, boundary_mode)
    th, tw, C = tex.shape
    out = torch.empty((C,) + tuple(tu.shape), device=dev)
    fn = build.load("texture_fwd").texture_fwd_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2)
    texture_planes.launches += 1
    ptr = build.ptr
    status = fn(ptr(tex), ptr(tu), ptr(tv), tu.numel(), th, tw, C, clamp,
                ptr(out), build.stream(dev))
    build.check(status, "texture_fwd")
    return out


texture_planes.launches = 0


def texture_planes_bwd_plain(tex: Tensor, tu: Tensor, tv: Tensor,
                             gcolour: Tensor, boundary_mode: str = "wrap"):
    """Plain PyTorch version of K4 (same arguments as
    :func:`texture_planes_bwd`): the backward of ``ops.texture.bilinear``
    with its weight derivatives written out, in the kernel's order."""
    th, tw, C = tex.shape
    s = tu * tw - 0.5
    t = tv * th - 0.5
    s0f = torch.floor(s)
    t0f = torch.floor(t)
    fs = s - s0f
    ft = t - t0f
    s0 = s0f.to(torch.int64)
    t0 = t0f.to(torch.int64)
    r0 = wrap_idx(t0, th, boundary_mode) * tw
    r1 = wrap_idx(t0 + 1, th, boundary_mode) * tw
    q0 = wrap_idx(s0, tw, boundary_mode)
    q1 = wrap_idx(s0 + 1, tw, boundary_mode)
    idx = [r0 + q0, r0 + q1, r1 + q0, r1 + q1]      # 00 01 10 11
    flat = tex.reshape(-1, C)
    c00, c01, c10, c11 = (flat[i].movedim(-1, 0) for i in idx)
    top = c00 * (1 - fs) + c01 * fs
    bot = c10 * (1 - fs) + c11 * fs
    gtop = gcolour * (1 - ft)
    gbot = gcolour * ft
    gs_c = (gtop * c01 - gtop * c00) + (gbot * c11 - gbot * c10)
    gt_c = gcolour * bot - gcolour * top
    gs = torch.zeros_like(tu)
    gt = torch.zeros_like(tv)
    for c in range(C):
        gs = gs + gs_c[c]
        gt = gt + gt_c[c]
    gtex = torch.zeros((th * tw, C), device=tex.device)
    for i, w in zip(idx, (gtop * (1 - fs), gtop * fs, gbot * (1 - fs),
                          gbot * fs)):
        gtex.index_add_(0, i.reshape(-1), w.reshape(C, -1).T)
    return gtex.reshape(th, tw, C), gs * tw, gt * th


def texture_planes_bwd(tex: Tensor, tu: Tensor, tv: Tensor,
                       gcolour: Tensor, boundary_mode: str = "wrap"):
    """K4: the backward of K7 and of K1's bilinear wrap texture tail.

    :param tex: (TH, TW, C) float32 texture that was sampled.
    :param tu, tv: the sampled uv planes (...) (K1: payload planes 3, 4).
    :param gcolour: (C, ...) cotangent of the sampled colour.
    :param boundary_mode: the forward's, "wrap" or "clamp".
    :return: (gtex (TH, TW, C) summed over every pixel, gtu (...),
        gtv (...)).
    """
    clamp = _clamp_flag(boundary_mode)
    dev = _check(tex, tu, tv, {"gcolour": gcolour})
    if dev.type == "cpu":
        return texture_planes_bwd_plain(tex, tu, tv, gcolour, boundary_mode)
    th, tw, C = tex.shape
    gtex = torch.empty((th, tw, C), device=dev)
    gtu = torch.empty(tu.shape, device=dev)
    gtv = torch.empty(tu.shape, device=dev)
    fn = build.load("texture_bwd").texture_bwd_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int64]
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 4)
    texture_planes_bwd.launches += 1
    ptr = build.ptr
    status = fn(ptr(tex), ptr(tu), ptr(tv), ptr(gcolour), tu.numel(), th, tw,
                C, clamp, ptr(gtex), ptr(gtu), ptr(gtv), build.stream(dev))
    build.check(status, "texture_bwd")
    return gtex, gtu, gtv


texture_planes_bwd.launches = 0


class TextureBilinear(torch.autograd.Function):
    """K7 forward, K4 backward: ``apply(tex, tu, tv, boundary_mode)`` ->
    (C, ...) samples, differentiable with respect to ``tex``, ``tu`` and
    ``tv``."""

    @staticmethod
    def forward(ctx, tex, tu, tv, boundary_mode):
        ctx.boundary_mode = boundary_mode
        ctx.save_for_backward(tex, tu, tv)
        return texture_planes(tex, tu, tv, boundary_mode)

    @staticmethod
    def backward(ctx, g):
        tex, tu, tv = ctx.saved_tensors
        gtex, gtu, gtv = texture_planes_bwd(tex, tu, tv, g.contiguous(),
                                            ctx.boundary_mode)
        return gtex, gtu, gtv, None
