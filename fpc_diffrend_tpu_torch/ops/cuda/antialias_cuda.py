"""The antialias kernel (K2) over the fused raster kernel's planes.

Port of ``fpc_diffrend_tpu.ops.pallas.antialias_tpu._fwd_kernel``
(launched by ``_aa_fwd_from_packed``) as the CUDA kernel
``csrc/antialias.cu``. The TPU kernel takes a packed plane stack; this
one reads the id buffer, payload and colour planes directly, in the
packing order of ``ops.antialias`` ([id, z, x0..y2, n0 n1 n2, colour]).

Pairs: horizontal (x, x+1) for x < W - 1, and vertical (r, r+1) within a
stacked sample, r % sample_ph < H - 1, so no pair crosses a sample
boundary or reaches into the padding. Each pixel's output is
c + da(right pair) + db(left pair) + da(pair below) + db(pair above), in
that order.

``antialias_planes`` runs the kernel for CUDA tensors and its plain
PyTorch version ``antialias_planes_plain`` for CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from fpc_diffrend_tpu_torch.kernels import build
from fpc_diffrend_tpu_torch.ops.antialias import pair_delta
from fpc_diffrend_tpu_torch.ops.cuda.rasterize_cuda import N_PAYLOAD

Tensor = torch.Tensor


def pack_planes(idbuf: Tensor, payload: Tensor, colour: Tensor) -> Tensor:
    """(11 + C, rows, pw) [id, z, x0 y0 x1 y1 x2 y2, n0 n1 n2, colour]."""
    return torch.cat([idbuf.to(torch.float32)[None], payload[2:3],
                      payload[5:14], colour])


def antialias_planes_plain(idbuf: Tensor, payload: Tensor, colour: Tensor,
                           height: int, width: int,
                           sample_ph: int) -> Tensor:
    """Plain PyTorch version of K2 (same arguments as
    :func:`antialias_planes`)."""
    rows, pw = idbuf.shape
    dev = idbuf.device
    packed = pack_planes(idbuf, payload, colour)
    x = torch.arange(pw, dtype=torch.float32, device=dev) + 0.5
    r = torch.arange(rows, device=dev)
    y = (r.to(torch.float32) + 0.5)[:, None]
    out = colour.clone()

    m = (x[:-1] - 0.5) < width - 1
    da, db = pair_delta(packed[:, :, :-1], packed[:, :, 1:],
                        x[:-1], y, x[:-1] + 1.0, y)
    out[:, :, :-1] += torch.where(m, da, 0.0)
    out[:, :, 1:] += torch.where(m, db, 0.0)

    m = (torch.remainder(r[:-1], sample_ph) < height - 1)[:, None]
    da, db = pair_delta(packed[:, :-1], packed[:, 1:],
                        x, y[:-1], x, y[:-1] + 1.0)
    out[:, :-1] += torch.where(m, da, 0.0)
    out[:, 1:] += torch.where(m, db, 0.0)
    return out


def antialias_planes(idbuf: Tensor, payload: Tensor, colour: Tensor,
                     height: int, width: int, sample_ph: int) -> Tensor:
    """K2: silhouette antialias of the stacked image.

    :param idbuf: (rows, pw) int32 winning triangle ids, -1 = none.
    :param payload: (14, rows, pw) K1 payload (z, corners, neighbours used).
    :param colour: (C, rows, pw) colour planes.
    :param height, width: one sample's real size.
    :param sample_ph: row pitch of the stacked samples.
    :return: (C, rows, pw) antialiased colour, before the background
        composite.
    """
    dev = idbuf.device
    rows, pw = idbuf.shape
    C = colour.shape[0]
    check = build.check_tensor
    check(idbuf, "idbuf", torch.int32, (rows, pw), dev)
    check(payload, "payload", torch.float32, (N_PAYLOAD, rows, pw), dev)
    check(colour, "colour", torch.float32, (C, rows, pw), dev)
    if rows % sample_ph or height > sample_ph or width > pw:
        raise ValueError(f"{rows}x{pw} planes do not hold samples of "
                         f"{height}x{width} at pitch {sample_ph}")
    if dev.type == "cpu":
        return antialias_planes_plain(idbuf, payload, colour, height, width,
                                      sample_ph)
    if dev.type != "cuda":
        raise ValueError(f"antialias_planes: unsupported device {dev}")
    build.refuse_grad(payload, colour)

    out = torch.empty((C, rows, pw), device=dev)
    lib = build.load("antialias")
    fn = lib.antialias_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p] * 2)
    antialias_planes.launches += 1
    ptr = build.ptr
    status = fn(ptr(idbuf), ptr(payload), ptr(colour), rows, pw, C, height,
                width, sample_ph, ptr(out), build.stream(dev))
    build.check(status, "antialias")
    return out


antialias_planes.launches = 0
