"""The trilinear mip sampler (K8) and its backward (K9).

Port of ``fpc_diffrend_tpu.ops.pallas.texture_mip_tpu._mip_fwd_kernel``
(launched by ``_mip_fwd_impl``) and ``_mip_bwd_kernel`` (launched by
``_mip_vjp_bwd``) as the CUDA kernels of ``csrc/texture_mip.cu``. Both
read one flat pyramid: an (n_texels, C) float32 buffer holding the levels
(th_l, tw_l, C) row-major one after the other, level l from texel row
``sum(th_k * tw_k for k < l)`` (``ops.texture_mip.mip_pyramid`` builds
it). The LOD plane is an input, held constant by the backward; the mip
render Functions have K8 derive it (``mip_sample_lod``) from the uv and
id planes, as ``lod_from_texc`` does in torch ops, and save it for K9.

K9 computes the autodiff of the XLA trilinear sampler
(``fpc_diffrend_tpu.ops.texture.texture``, wrap mode, LOD given): the
gradient pyramid summed over every pixel of the batch, and the cotangents
of the sampled uv planes. The TPU kernel's zeroed uv gradient where its
VMEM patch clamps is a layout artefact and is not copied.

``mip_sample``, ``mip_sample_lod`` and ``mip_sample_bwd`` run their
kernels for CUDA tensors and their plain PyTorch versions (``*_plain``;
``lod_from_texc`` then ``mip_sample_plain`` for ``mip_sample_lod``) for
CPU tensors; K8's launches in either mode count on
``mip_sample.launches``. K8 takes
four neighbouring pixels a thread, with 16-byte loads of tu, tv and lam
and 16-byte stores where the planes are 16-byte aligned (else one pixel a
thread); K9 one pixel a thread, whose neighbouring lanes sum the texel
shares they have in common before the reductions into the gradient
pyramid. The launchers pick the instantiation from the shapes: the
channel count, a chain of power-of-two levels (mask wrap) or not, and the
planes' alignment. K8 equals its plain version bit for bit; K9's gtu and
gtv keep its order too, and its gradient pyramid sums with atomics in
another order from run to run.
"""

from __future__ import annotations

import ctypes

import torch

from fpc_diffrend_tpu_torch.kernels import build
from fpc_diffrend_tpu_torch.utils import profiling

Tensor = torch.Tensor

MAX_LEVELS = 16           # levels the kernels take as arguments
MAX_C = 4                 # channels the kernels take
_PTR, _INT = build.PTR, build.INT
_MIP_FWD_ARGS = [_PTR] * 4 + [_INT] * 3 + [_PTR] * 3 + [_INT] + [_PTR] * 2
_MIP_FWD_LOD_ARGS = ([_PTR] * 4 + [_INT] * 6 + [_PTR] * 3 + [_INT]
                     + [_PTR] * 3)
_MIP_BWD_ARGS = ([_PTR] * 5 + [_INT] * 3 + [_PTR] * 3 + [_INT] * 2
                 + [_PTR] * 4)


def level_offsets(sizes) -> list[int]:
    """First texel row of each level of the flat pyramid."""
    offs, n = [], 0
    for th, tw in sizes:
        offs.append(n)
        n += th * tw
    return offs


def _taps(sizes, level: Tensor, tu: Tensor, tv: Tensor):
    """Per pixel at its ``level`` (int64 plane): the texel rows of the four
    bilinear wrap taps (00 01 10 11), fs, ft and the level's th, tw."""
    dev = tu.device
    th = torch.tensor([h for h, _ in sizes], device=dev)[level]
    tw = torch.tensor([w for _, w in sizes], device=dev)[level]
    off = torch.tensor(level_offsets(sizes), device=dev)[level]
    s = tu * tw.to(torch.float32) - 0.5
    t = tv * th.to(torch.float32) - 0.5
    s0f = torch.floor(s)
    t0f = torch.floor(t)
    s0 = s0f.to(torch.int64)
    t0 = t0f.to(torch.int64)
    r0 = off + torch.remainder(t0, th) * tw
    r1 = off + torch.remainder(t0 + 1, th) * tw
    q0, q1 = torch.remainder(s0, tw), torch.remainder(s0 + 1, tw)
    return (r0 + q0, r0 + q1, r1 + q0, r1 + q1), s - s0f, t - t0f, th, tw


def _pick(lam: Tensor, n_levels: int):
    """(lo, frac, hi, hi_live): lam clamped to [0, L - 1], its floor and
    fraction, and the next level where it takes part."""
    lc = torch.clamp(lam, 0.0, float(n_levels - 1))
    lof = torch.floor(lc)
    lo = lof.to(torch.int64)
    frac = lc - lof
    hi_live = (lo + 1 < n_levels) & (frac > 0)
    return lo, frac, torch.clamp(lo + 1, max=n_levels - 1), hi_live


def mip_sample_plain(pyramid: Tensor, sizes, tu: Tensor, tv: Tensor,
                     lam: Tensor) -> Tensor:
    """Plain PyTorch version of K8 (same arguments as :func:`mip_sample`)."""
    lo, frac, hi, hi_live = _pick(lam, len(sizes))
    ia, fsa, fta, _, _ = _taps(sizes, lo, tu, tv)
    ib, fsb, ftb, _, _ = _taps(sizes, hi, tu, tv)

    def bilinear(col, idx, fs, ft):
        c00, c01, c10, c11 = (col[i] for i in idx)
        top = c00 * (1 - fs) + c01 * fs
        bot = c10 * (1 - fs) + c11 * fs
        return top * (1 - ft) + bot * ft

    out = []
    for c in range(pyramid.shape[1]):
        col = pyramid[:, c]
        r = bilinear(col, ia, fsa, fta) * (1 - frac)
        out.append(torch.where(hi_live,
                               r + bilinear(col, ib, fsb, ftb) * frac, r))
    return torch.stack(out)


def mip_sample_bwd_plain(pyramid: Tensor, sizes, tu: Tensor, tv: Tensor,
                         lam: Tensor, gcolour: Tensor):
    """Plain PyTorch version of K9 (same arguments as
    :func:`mip_sample_bwd`): the VJP of :func:`mip_sample_plain` with its
    weight derivatives written out, in the kernel's order."""
    n, C = pyramid.shape
    lo, frac, hi, hi_live = _pick(lam, len(sizes))
    gpyr = torch.zeros(n * C, device=pyramid.device)
    gu = torch.zeros_like(tu)
    gv = torch.zeros_like(tv)
    for level, w, live in ((lo, 1 - frac, None), (hi, frac, hi_live)):
        idx, fs, ft, th, tw = _taps(sizes, level, tu, tv)
        gs = torch.zeros_like(tu)
        gt = torch.zeros_like(tv)
        for c in range(C):
            c00, c01, c10, c11 = (pyramid[:, c][i] for i in idx)
            top = c00 * (1 - fs) + c01 * fs
            bot = c10 * (1 - fs) + c11 * fs
            gl = gcolour[c] * w
            if live is not None:
                gl = torch.where(live, gl, 0.0)
            gtop = gl * (1 - ft)
            gbot = gl * ft
            gs = gs + ((gtop * c01 - gtop * c00) + (gbot * c11 - gbot * c10))
            gt = gt + (gl * bot - gl * top)
            for i, share in zip(idx, (gtop * (1 - fs), gtop * fs,
                                      gbot * (1 - fs), gbot * fs)):
                gpyr.index_add_(0, (i * C + c).reshape(-1),
                                share.reshape(-1))
        gu_l = gu + gs * tw.to(torch.float32)
        gv_l = gv + gt * th.to(torch.float32)
        gu = gu_l if live is None else torch.where(live, gu_l, gu)
        gv = gv_l if live is None else torch.where(live, gv_l, gv)
    return gpyr.reshape(n, C), gu, gv


def lod_from_texc(tu: Tensor, tv: Tensor, idbuf: Tensor, th: int, tw: int,
                  height: int, width: int, sample_ph: int) -> Tensor:
    """Finite-difference LOD plane of the stacked uv image (the plain
    version of the LOD :func:`mip_sample_lod` derives in K8).

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


def _check(pyramid: Tensor, sizes, tu: Tensor, tv: Tensor, lam):
    """Check the shared inputs (``lam`` None: no LOD plane); :return:
    (rows, pw, C)."""
    dev = tu.device
    rows, pw = tu.shape
    if not sizes:
        raise ValueError("the pyramid has no levels")
    n = sum(th * tw for th, tw in sizes)
    if pyramid.dim() != 2:
        raise ValueError(f"pyramid has shape {tuple(pyramid.shape)}, "
                         "expected (n_texels, C)")
    C = pyramid.shape[1]
    check = build.check_tensor
    check(pyramid, "pyramid", torch.float32, (n, C), dev)
    check(tu, "tu", torch.float32, (rows, pw), dev)
    check(tv, "tv", torch.float32, (rows, pw), dev)
    if lam is not None:
        check(lam, "lam", torch.float32, (rows, pw), dev)
    return rows, pw, C


def _level_args(sizes):
    arr = ctypes.c_int * len(sizes)
    return (len(sizes), arr(*(th for th, _ in sizes)),
            arr(*(tw for _, tw in sizes)), arr(*level_offsets(sizes)))


def _kernel_ok(name: str, dev, sizes, n: int, C: int) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if not 1 <= C <= MAX_C or len(sizes) > MAX_LEVELS or n * C >= 2 ** 31:
        raise ValueError(f"{name}: the kernel takes 1-{MAX_C} channels, "
                         f"<= {MAX_LEVELS} levels and < 2^31 values; got "
                         f"C={C}, {len(sizes)} levels, {n} texels")


def mip_sample(pyramid: Tensor, sizes, tu: Tensor, tv: Tensor,
               lam: Tensor) -> Tensor:
    """K8: trilinear mip sample of the stacked image.

    :param pyramid: (n_texels, C) float32 flat pyramid.
    :param sizes: the levels' (th_l, tw_l), finest first.
    :param tu, tv: (rows, pw) sampled uv planes (K1 payload planes 3, 4).
    :param lam: (rows, pw) LOD plane, clamped to the levels by the kernel.
    :return: (C, rows, pw) samples.
    """
    rows, pw, C = _check(pyramid, sizes, tu, tv, lam)
    dev = tu.device
    if dev.type == "cpu":
        return mip_sample_plain(pyramid, sizes, tu, tv, lam)
    _kernel_ok("mip_sample", dev, sizes, pyramid.shape[0], C)
    out = torch.empty((C, rows, pw), device=dev)
    fn = build.entry("texture_mip", "mip_fwd_launch", _MIP_FWD_ARGS)
    mip_sample.launches += 1
    ptr = build.ptr
    status = fn(ptr(pyramid), ptr(tu), ptr(tv), ptr(lam), rows, pw,
                *_level_args(sizes), C, ptr(out), build.stream(dev))
    build.check(status, "mip_sample")
    return out


def mip_sample_lod(pyramid: Tensor, sizes, tu: Tensor, tv: Tensor,
                   idbuf: Tensor, height: int, width: int, sample_ph: int):
    """K8 deriving its LOD from the uv and id planes: :func:`mip_sample` of
    :func:`lod_from_texc`'s plane, in one launch. Counts the pixels whose
    LOD it derived on ``mip.lod_fused`` (host).

    :param idbuf: (rows, pw) int32 triangle ids (K1's), -1 where missed.
    :param height, width, sample_ph: each stacked sample's image, and the
        rows between two samples' first rows.
    :return: (colour (C, rows, pw), lam (rows, pw) unclamped, for K9).
    """
    rows, pw, C = _check(pyramid, sizes, tu, tv, None)
    dev = tu.device
    build.check_tensor(idbuf, "idbuf", torch.int32, (rows, pw), dev)
    if min(height, width, sample_ph) < 1:
        raise ValueError(f"mip_sample_lod: height {height}, width {width} "
                         f"and sample_ph {sample_ph} must be positive")
    profiling.count("mip.lod_fused", rows * pw)
    if dev.type == "cpu":
        lam = lod_from_texc(tu, tv, idbuf, *sizes[0], height, width,
                            sample_ph)
        return mip_sample_plain(pyramid, sizes, tu, tv, lam), lam
    _kernel_ok("mip_sample_lod", dev, sizes, pyramid.shape[0], C)
    out = torch.empty((C, rows, pw), device=dev)
    lam = torch.empty((rows, pw), device=dev)
    fn = build.entry("texture_mip", "mip_fwd_lod_launch", _MIP_FWD_LOD_ARGS)
    mip_sample.launches += 1
    ptr = build.ptr
    status = fn(ptr(pyramid), ptr(tu), ptr(tv), ptr(idbuf), rows, pw,
                sample_ph, height, width, *_level_args(sizes), C, ptr(out),
                ptr(lam), build.stream(dev))
    build.check(status, "mip_sample_lod")
    return out, lam


def mip_sample_bwd(pyramid: Tensor, sizes, tu: Tensor, tv: Tensor,
                   lam: Tensor, gcolour: Tensor):
    """K9: the backward of :func:`mip_sample` with ``lam`` held constant.

    :param gcolour: (C, rows, pw) cotangent of the samples.
    :return: (gpyramid (n_texels, C) summed over every pixel, gtu
        (rows, pw), gtv (rows, pw)).
    """
    rows, pw, C = _check(pyramid, sizes, tu, tv, lam)
    dev = tu.device
    build.check_tensor(gcolour, "gcolour", torch.float32, (C, rows, pw), dev)
    if dev.type == "cpu":
        return mip_sample_bwd_plain(pyramid, sizes, tu, tv, lam, gcolour)
    n = pyramid.shape[0]
    _kernel_ok("mip_sample_bwd", dev, sizes, n, C)
    gpyr = torch.empty((n, C), device=dev)
    gtu = torch.empty((rows, pw), device=dev)
    gtv = torch.empty((rows, pw), device=dev)
    fn = build.entry("texture_mip", "mip_bwd_launch", _MIP_BWD_ARGS)
    mip_sample_bwd.launches += 1
    ptr = build.ptr
    status = fn(ptr(pyramid), ptr(tu), ptr(tv), ptr(lam), ptr(gcolour), rows,
                pw, *_level_args(sizes), C, n, ptr(gpyr), ptr(gtu), ptr(gtv),
                build.stream(dev))
    build.check(status, "mip_sample_bwd")
    return gpyr, gtu, gtv


mip_sample.launches = 0
mip_sample_bwd.launches = 0
