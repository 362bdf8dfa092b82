"""The antialias kernel (K2) and its backward (K3) over the fused raster
kernel's planes.

Port of ``fpc_diffrend_tpu.ops.pallas.antialias_tpu._fwd_kernel``
(launched by ``_aa_fwd_from_packed``) as the CUDA kernel
``csrc/antialias.cu``, and of its ``_bwd_kernel`` (launched by
``aa_planes_bwd_core``) as ``csrc/antialias_bwd.cu``. The TPU kernels
take a packed plane stack; these read the id buffer, payload and colour
planes directly, in the packing order of ``ops.antialias`` ([id, z,
x0..y2, n0 n1 n2, colour]).

Pairs: horizontal (x, x+1) for x < W - 1, and vertical (r, r+1) within a
stacked sample, r % sample_ph < H - 1, so no pair crosses a sample
boundary or reaches into the padding. The payload's screen corners are in
each sample's own frame (``rasterize_cuda.Bins``), so a pair is evaluated
at its pixels' rows within their sample, r % sample_ph. Each pixel's
output is c + da(right pair) + db(left pair) + da(pair below) + db(pair
above), in that order.

``antialias_planes`` and ``antialias_planes_bwd`` run their kernels for
CUDA tensors and their plain PyTorch versions (``*_plain``) for CPU
tensors.
"""

from __future__ import annotations

import torch

from fpc_diffrend_tpu_torch.kernels import build
from fpc_diffrend_tpu_torch.ops.antialias import pair_delta, pair_grad
from fpc_diffrend_tpu_torch.ops.cuda.rasterize_cuda import (
    N_PAYLOAD, PAY_CORNERS, PAY_NEIGHBOURS, PAY_Z)

Tensor = torch.Tensor
_PTR, _INT = build.PTR, build.INT
_AA_ARGS = [_PTR] * 3 + [_INT] * 6 + [_PTR] * 2
_AA_BWD_ARGS = [_PTR] * 4 + [_INT] * 6 + [_PTR] * 3


def pack_planes(idbuf: Tensor, payload: Tensor, colour: Tensor) -> Tensor:
    """(11 + C, rows, pw) [id, z, x0 y0 x1 y1 x2 y2, n0 n1 n2, colour]."""
    return torch.cat([idbuf.to(torch.float32)[None], payload[PAY_Z][None],
                      payload[PAY_CORNERS], payload[PAY_NEIGHBOURS], colour])


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
    y = (torch.remainder(r, sample_ph).to(torch.float32) + 0.5)[:, None]
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


def _check_planes(idbuf, payload, planes, height, width, sample_ph):
    """Raise unless the planes fit the kernels (K2 and K3)."""
    dev = idbuf.device
    rows, pw = idbuf.shape
    check = build.check_tensor
    check(idbuf, "idbuf", torch.int32, (rows, pw), dev)
    check(payload, "payload", torch.float32, (N_PAYLOAD, rows, pw), dev)
    for name, t in planes.items():
        check(t, name, torch.float32, (planes["colour"].shape[0], rows, pw),
              dev)
    if rows % sample_ph or height > sample_ph or width > pw:
        raise ValueError(f"{rows}x{pw} planes do not hold samples of "
                         f"{height}x{width} at pitch {sample_ph}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")


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
    _check_planes(idbuf, payload, {"colour": colour}, height, width,
                  sample_ph)
    if dev.type == "cpu":
        return antialias_planes_plain(idbuf, payload, colour, height, width,
                                      sample_ph)

    out = torch.empty((C, rows, pw), device=dev)
    fn = build.entry("antialias", "antialias_launch", _AA_ARGS)
    antialias_planes.launches += 1
    ptr = build.ptr
    status = fn(ptr(idbuf), ptr(payload), ptr(colour), rows, pw, C, height,
                width, sample_ph, ptr(out), build.stream(dev))
    build.check(status, "antialias")
    return out


antialias_planes.launches = 0


def antialias_planes_bwd_plain(idbuf: Tensor, payload: Tensor,
                               colour: Tensor, gout: Tensor, height: int,
                               width: int, sample_ph: int):
    """Plain PyTorch version of K3 (same arguments as
    :func:`antialias_planes_bwd`): :func:`pair_grad` on every pair, with
    the pair masks of :func:`antialias_planes_plain`, summed per pixel in
    the kernel's order."""
    rows, pw = idbuf.shape
    dev = idbuf.device
    C = colour.shape[0]
    packed = pack_planes(idbuf, payload, colour)
    x = torch.arange(pw, dtype=torch.float32, device=dev) + 0.5
    r = torch.arange(rows, device=dev)
    y = (torch.remainder(r, sample_ph).to(torch.float32) + 0.5)[:, None]

    # share planes (C + 6): as the a-side of the pair to the right / below,
    # as the b-side of the pair to the left / above
    right, left, down, up = (torch.zeros((C + 6, rows, pw), device=dev)
                             for _ in range(4))
    m = (x[:-1] - 0.5) < width - 1
    sa, sb = pair_grad(packed[:, :, :-1], packed[:, :, 1:], x[:-1], y,
                       x[:-1] + 1.0, y, gout[:, :, :-1], gout[:, :, 1:])
    right[:, :, :-1] = torch.where(m, sa, 0.0)
    left[:, :, 1:] = torch.where(m, sb, 0.0)

    m = (torch.remainder(r[:-1], sample_ph) < height - 1)[:, None]
    sa, sb = pair_grad(packed[:, :-1], packed[:, 1:], x, y[:-1], x,
                       y[:-1] + 1.0, gout[:, :-1], gout[:, 1:])
    down[:, :-1] = torch.where(m, sa, 0.0)
    up[:, 1:] = torch.where(m, sb, 0.0)

    gcolour = (gout + (right[:C] + left[:C])) + (down[:C] + up[:C])
    gverts = (right[C:] + left[C:]) + (down[C:] + up[C:])
    return gcolour, gverts


def antialias_planes_bwd(idbuf: Tensor, payload: Tensor, colour: Tensor,
                         gout: Tensor, height: int, width: int,
                         sample_ph: int):
    """K3: the backward of :func:`antialias_planes`.

    :param idbuf, payload, colour, height, width, sample_ph: as given to
        :func:`antialias_planes`.
    :param gout: (C, rows, pw) cotangent of its output.
    :return: (gcolour (C, rows, pw) cotangent of ``colour``, gverts (6,
        rows, pw) cotangent of the payload's screen-corner planes 5-10).
    """
    dev = idbuf.device
    rows, pw = idbuf.shape
    C = colour.shape[0]
    _check_planes(idbuf, payload, {"colour": colour, "gout": gout}, height,
                  width, sample_ph)
    if dev.type == "cpu":
        return antialias_planes_bwd_plain(idbuf, payload, colour, gout,
                                          height, width, sample_ph)

    gcolour = torch.empty((C, rows, pw), device=dev)
    gverts = torch.empty((6, rows, pw), device=dev)
    fn = build.entry("antialias_bwd", "antialias_bwd_launch", _AA_BWD_ARGS)
    antialias_planes_bwd.launches += 1
    ptr = build.ptr
    status = fn(ptr(idbuf), ptr(payload), ptr(colour), ptr(gout), rows, pw,
                C, height, width, sample_ph, ptr(gcolour), ptr(gverts),
                build.stream(dev))
    build.check(status, "antialias_bwd")
    return gcolour, gverts


antialias_planes_bwd.launches = 0
