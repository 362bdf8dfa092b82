"""The texture backward kernel (K4): bilinear wrap sampling's VJP.

Port of ``fpc_diffrend_tpu.ops.pallas.texture_tpu._bwd_kernel`` (launched
by ``texture_planes_bwd_impl``) as the CUDA kernel ``csrc/texture_bwd.cu``.
It computes the autodiff of the XLA sampler
(``fpc_diffrend_tpu.ops.texture``, wrap mode) over the stacked image: the
texture cotangent summed over every pixel of the batch, and the
cotangents of the sampled uv planes. The TPU kernel's zeroed coordinate
gradient where its texel patch clamps is a layout artefact and is not
copied.

``texture_planes_bwd`` runs the kernel for CUDA tensors and its plain
PyTorch version ``texture_planes_bwd_plain`` for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from fpc_diffrend_tpu_torch.kernels import build

Tensor = torch.Tensor


def texture_planes_bwd_plain(tex: Tensor, tu: Tensor, tv: Tensor,
                             gcolour: Tensor):
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
    r0, r1 = torch.remainder(t0, th) * tw, torch.remainder(t0 + 1, th) * tw
    q0, q1 = torch.remainder(s0, tw), torch.remainder(s0 + 1, tw)
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
                       gcolour: Tensor):
    """K4: the backward of K1's bilinear wrap texture sample.

    :param tex: (TH, TW, C) float32 texture that was sampled.
    :param tu, tv: (rows, pw) sampled uv planes (K1 payload planes 3, 4).
    :param gcolour: (C, rows, pw) cotangent of the sampled colour.
    :return: (gtex (TH, TW, C) summed over every pixel, gtu (rows, pw),
        gtv (rows, pw)).
    """
    dev = tu.device
    rows, pw = tu.shape
    th, tw, C = tex.shape
    check = build.check_tensor
    check(tex, "tex", torch.float32, (th, tw, C), dev)
    check(tu, "tu", torch.float32, (rows, pw), dev)
    check(tv, "tv", torch.float32, (rows, pw), dev)
    check(gcolour, "gcolour", torch.float32, (C, rows, pw), dev)
    if dev.type == "cpu":
        return texture_planes_bwd_plain(tex, tu, tv, gcolour)
    if dev.type != "cuda":
        raise ValueError(f"texture_planes_bwd: unsupported device {dev}")

    gtex = torch.empty((th, tw, C), device=dev)
    gtu = torch.empty((rows, pw), device=dev)
    gtv = torch.empty((rows, pw), device=dev)
    lib = build.load("texture_bwd")
    fn = lib.texture_bwd_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 4)
    texture_planes_bwd.launches += 1
    ptr = build.ptr
    status = fn(ptr(tex), ptr(tu), ptr(tv), ptr(gcolour), rows, pw, th, tw,
                C, ptr(gtex), ptr(gtu), ptr(gtv), build.stream(dev))
    build.check(status, "texture_bwd")
    return gtex, gtu, gtv


texture_planes_bwd.launches = 0
