"""The rasterizer's gradient kernels: pixel -> bin entry (K5), bin entry ->
triangle (K6).

Port of ``fpc_diffrend_tpu.ops.pallas.raster_grad_tpu``: ``_grad_kernel``
(launched by ``pixel_grad_pallas``) as ``pixel_grad`` and the fold after
it (the JAX step's ``segment_sum``, or the opt-in ``_fold_kernel`` of
``banded_fold``) as ``fold_entries``, both in ``csrc/raster_grad.cu``.

K1 resolves each pixel's winning bin entry and writes the residual planes
the chain rule needs, so the backward streams no triangle records: K5
computes 32 coefficients per pixel (one per record slot) from the payload
cotangents, each plane read where the kernel before it wrote it (the
sampler's gtu and gtv, K3's corners; u, v and z only where they have a
cotangent), and reduces them onto the winner's entry row; K6 sums the
entry rows (about 2.4 per triangle) and the global-list rows into
per-triangle rows in the record layout (geometry slots 0-15, aux slots
16-31; the id, neighbour and pad slots stay 0). K6 gathers: each triangle
finds its window slots' entries in their bins (``Bins.tile_ids``) and adds
their rows in a fixed order, so it equals its plain version bit for bit.

``fast=True`` is the gradient precision "fast" (``ops.precision``; JAX's
``FPC_GRAD_PREC=fast``): K5 rounds each coefficient to bf16 before its
sums. K6 has no fast mode: JAX's default fold is an f32 ``segment_sum``.

Each function runs its kernel for CUDA tensors and its plain PyTorch
version (``*_plain``) for CPU tensors.
"""

from __future__ import annotations

import torch

from fpc_diffrend_tpu_torch.kernels import build
from fpc_diffrend_tpu_torch.ops.cuda.rasterize_cuda import (
    MAX_GLOBAL, N_EXTRA, PAY_CORNERS, PAY_UVZ, REC, TILE_H, TILE_W,
    WINDOW_X, WINDOW_Y, Bins)
from fpc_diffrend_tpu_torch.utils import profiling

Tensor = torch.Tensor

# the payload planes that have a cotangent, [u v z tu tv x0 y0 x1 y1 x2
# y2] (``rasterize_cuda.PAY_*``); the neighbour ids have none
N_GPL = PAY_CORNERS.stop
N_CORNERS = PAY_CORNERS.stop - PAY_CORNERS.start
N_UVZ = PAY_UVZ.stop - PAY_UVZ.start
# record slots that carry gradient: all but the id (12) and pad (28-31)
LIVE_SLOTS = [k for k in range(REC) if k != 12 and k < 28]
WINDOW = WINDOW_Y * WINDOW_X   # window slots a triangle (K)
_AREA_EPS = 1e-12
_PTR, _INT = build.PTR, build.INT
_PIXEL_GRAD_ARGS = [_PTR] * 9 + [_INT] * 5 + [_PTR] * 2 + [_INT] * 2 + [_PTR]
_FOLD_ARGS = [_PTR] * 7 + [_INT] * 2 + [_PTR] * 2


def coefficient_planes(u: Tensor, v: Tensor, extra: Tensor, gtu: Tensor,
                       gtv: Tensor, gcorners: Tensor, guvz: Tensor | None,
                       x: Tensor, y: Tensor, fast: bool = False) -> Tensor:
    """The 32 per-pixel gradient coefficients (raster_grad_tpu.py
    :286-310, in the kernel's order): (32, rows, pw); with ``fast`` each
    rounded to bf16 (nearest even) and back. ``guvz`` None: 0 in place of
    the u, v and z cotangents, as the kernel's instance without them."""
    D, iw0, iw1, iw2, du02, du12, dv02, dv12 = extra
    zero = torch.zeros_like(u)
    gu0, gv0, gz = (0.0, 0.0, zero) if guvz is None else guvz
    d0 = u * D
    d1 = v * D
    d2 = (D - d0) - d1
    gu = (gu0 + gtu * du02) + gtv * dv02
    gv = (gv0 + gtu * du12) + gtv * dv12
    rD = 1.0 / torch.where(torch.abs(D) > _AREA_EPS, D, 1.0)
    S = ((gu * d0 + gv * d1) * rD) * rD
    gd0 = gu * rD - S
    gd1 = gv * rD - S
    gd2 = -S
    gl0 = gd0 * iw0
    gl1 = gd1 * iw1
    gl2 = gd2 * iw2
    wp = (1.0 - u) - v
    planes = [gl0 * x, gl0 * y, gl0, gl1 * x, gl1 * y, gl1,
              gl2 * x, gl2 * y, gl2, gz * x, gz * y, gz, zero,
              -gd0 * d0 * iw0, -gd1 * d1 * iw1, -gd2 * d2 * iw2,
              gtu * u, gtv * u, gtu * v, gtv * v, gtu * wp, gtv * wp,
              *gcorners, zero, zero, zero, zero]
    out = torch.stack([p.expand_as(u) for p in planes])
    return out.to(torch.bfloat16).float() if fast else out


def pixel_grad_plain(bins: Bins, entry: Tensor, u: Tensor, v: Tensor,
                     extra: Tensor, gtu: Tensor, gtv: Tensor,
                     gcorners: Tensor, guvz: Tensor | None = None,
                     fast: bool = False):
    """Plain PyTorch version of K5 (same arguments as :func:`pixel_grad`);
    its rows past the live prefix are 0."""
    rows, pw = entry.shape
    dev = entry.device
    x = torch.arange(pw, dtype=torch.float32, device=dev) + 0.5
    y = (torch.remainder(torch.arange(rows, device=dev), bins.sample_ph)
         .to(torch.float32) + 0.5)[:, None]
    coeff = coefficient_planes(u, v, extra, gtu, gtv, gcorners, guvz, x, y,
                               fast).reshape(REC, -1).T
    e = entry.reshape(-1).long()
    gbase = bins.gbase
    grad_entries = torch.zeros((gbase, REC), device=dev)
    grad_global = torch.zeros((MAX_GLOBAL, REC), device=dev)
    binned = (e >= 0) & (e < gbase)
    grad_entries.index_add_(0, e[binned], coeff[binned])
    glob = e >= gbase
    grad_global.index_add_(0, e[glob] - gbase, coeff[glob])
    return grad_entries, grad_global


def pixel_grad(bins: Bins, entry: Tensor, u: Tensor, v: Tensor,
               extra: Tensor, gtu: Tensor, gtv: Tensor, gcorners: Tensor,
               guvz: Tensor | None = None, fast: bool = False):
    """K5: per-pixel gradient coefficients summed onto each winner entry.

    Each cotangent plane is read where its producer wrote it: nothing is
    copied. ``guvz`` None (the textured pass, whose u, v and z never leave
    it) launches the kernel's instance that reads no u, v, z plane and
    takes them as 0, and counts the call's pixels on ``k5.uvz_skipped``
    (host); given, the instance that reads them.

    :param bins: the bins K1 rasterized; a pixel's coefficients take its
        row within its sample (``bins.sample_ph``), as K1 evaluated it.
    :param entry: (rows, pw) int32 K1 winner entry, -1 = none; global-list
        winners are ``bins.gbase + row``.
    :param u, v: (rows, pw) K1 payload planes 0-1.
    :param extra: (8, rows, pw) K1 residual planes.
    :param gtu, gtv: (rows, pw) cotangents of the sampled uv (payload
        planes 3-4).
    :param gcorners: (6, rows, pw) cotangents of the screen corners
        (payload planes 5-10).
    :param guvz: (3, rows, pw) cotangents of u, v, z (payload planes
        0-2), or None where they are 0.
    :param fast: round each coefficient to bf16 first (the gradient
        precision "fast").
    :return: (grad_entries (gbase, 32): one row per bin entry, rows past
        ``bin_start[-1]`` unspecified; grad_global (MAX_GLOBAL, 32)).
    """
    dev = entry.device
    rows, pw = entry.shape
    if rows % TILE_H or pw % TILE_W:
        raise ValueError(f"stacked image {rows}x{pw} is not whole tiles")
    n_tiles = rows // TILE_H * (pw // TILE_W)
    check = build.check_tensor
    check(entry, "entry", torch.int32, (rows, pw), dev)
    check(u, "u", torch.float32, (rows, pw), dev)
    check(v, "v", torch.float32, (rows, pw), dev)
    check(extra, "extra", torch.float32, (N_EXTRA, rows, pw), dev)
    check(gtu, "gtu", torch.float32, (rows, pw), dev)
    check(gtv, "gtv", torch.float32, (rows, pw), dev)
    check(gcorners, "gcorners", torch.float32, (N_CORNERS, rows, pw), dev)
    if guvz is not None:
        check(guvz, "guvz", torch.float32, (N_UVZ, rows, pw), dev)
    check(bins.bin_start, "bin_start", torch.int32, (n_tiles + 1,), dev)
    if rows % bins.sample_ph or bins.sample_ph % TILE_H:
        raise ValueError(f"{rows} stacked rows are not whole samples of "
                         f"{bins.sample_ph} rows in whole tiles")
    if guvz is None:
        profiling.count("k5.uvz_skipped", rows * pw)
    if dev.type == "cpu":
        return pixel_grad_plain(bins, entry, u, v, extra, gtu, gtv, gcorners,
                                guvz, fast)
    if dev.type != "cuda":
        raise ValueError(f"pixel_grad: unsupported device {dev}")

    grad_entries = torch.empty((bins.gbase, REC), device=dev)
    grad_global = torch.empty((MAX_GLOBAL, REC), device=dev)
    fn = build.entry("raster_grad", "pixel_grad_launch", _PIXEL_GRAD_ARGS)
    pixel_grad.launches += 1
    ptr = build.ptr
    status = fn(ptr(entry), ptr(u), ptr(v), ptr(extra), ptr(gtu), ptr(gtv),
                ptr(gcorners), None if guvz is None else ptr(guvz),
                ptr(bins.bin_start), n_tiles, pw // TILE_W, rows,
                bins.sample_ph, bins.gbase,
                ptr(grad_entries), ptr(grad_global), MAX_GLOBAL, int(fast),
                build.stream(dev))
    build.check(status, "pixel_grad")
    return grad_entries, grad_global


pixel_grad.launches = 0


def fold_positions(bins: Bins) -> Tensor:
    """The entry of each window slot in its bin, as K6's search finds it.

    :return: (B*T, K) int64 positions into the live prefix; -1 where the
        slot is dead or the entry cap dropped it. One ``searchsorted`` of
        the slots' (tile, triangle) keys in the live entries' keys: a bin
        holds its triangles ascending, so the keys ascend.
    """
    n_tiles = bins.bin_start.shape[0] - 1
    tid = bins.tile_ids.reshape(-1, bins.tile_ids.shape[-1]).long()
    n, dev = tid.shape[0], tid.device
    n_live = int(bins.bin_start[-1])
    if n_live == 0:
        return torch.full(tid.shape, -1, dtype=torch.int64, device=dev)
    tile = torch.searchsorted(bins.bin_start.long(),
                              torch.arange(n_live, device=dev),
                              right=True) - 1
    keys = tile * n + bins.sorted_tri[:n_live].long()
    want = tid * n + torch.arange(n, device=dev)[:, None]
    pos = torch.searchsorted(keys, want.reshape(-1)).reshape(tid.shape)
    hit = (tid < n_tiles) & (keys[pos.clamp(max=n_live - 1)] == want)
    return torch.where(hit, pos, -1)


def fold_entries_plain(grad_entries: Tensor, grad_global: Tensor,
                       bins: Bins, n_tris: int) -> Tensor:
    """Plain PyTorch version of K6 (same arguments as
    :func:`fold_entries`), in the kernel's order: each triangle's found
    rows (:func:`fold_positions`) added in ascending window slot from 0,
    then the global row of a triangle none of whose slots names a tile.
    Reads no row past the live prefix or past ``n_global``."""
    dev = grad_entries.device
    pos = fold_positions(bins)
    n_live = int(bins.bin_start[-1])
    rows = torch.cat([grad_entries[:n_live],
                      torch.zeros((1, REC), device=dev)])   # dead: 0
    gathered = rows[torch.where(pos >= 0, pos, n_live)]
    out = torch.zeros((n_tris, REC), device=dev)
    for k in range(pos.shape[1]):
        out = out + gathered[:, k]
    n_global = int(bins.n_global[0])
    gidx = bins.global_idx[:n_global].long()
    none = (bins.tile_ids.reshape(n_tris, -1)
            >= bins.bin_start.shape[0] - 1).all(1)
    take = (gidx < n_tris) & none[gidx.clamp(max=max(n_tris - 1, 0))]
    gidx = gidx[take]
    out[gidx] = out[gidx] + grad_global[:n_global][take]
    out[:, [k for k in range(REC) if k not in LIVE_SLOTS]] = 0.0
    return out


def fold_entries(grad_entries: Tensor, grad_global: Tensor, bins: Bins,
                 n_tris: int) -> Tensor:
    """K6: bin-entry and global-list gradient rows summed per triangle.

    :param grad_entries, grad_global: from :func:`pixel_grad` on ``bins``.
    :param n_tris: stacked triangle count B * T.
    :return: (n_tris, 32) per-triangle gradient rows.
    """
    dev = grad_entries.device
    check = build.check_tensor
    check(grad_entries, "grad_entries", torch.float32, (bins.gbase, REC),
          dev)
    check(grad_global, "grad_global", torch.float32, (MAX_GLOBAL, REC), dev)
    n_raw = bins.sorted_tri.shape[0]
    if n_raw > bins.gbase:
        raise ValueError(f"{n_raw} bin entries exceed {bins.gbase} rows")
    n_tiles = bins.bin_start.shape[0] - 1
    check(bins.bin_start, "bin_start", torch.int32, (n_tiles + 1,), dev)
    check(bins.sorted_tri, "sorted_tri", torch.int32, (n_raw,), dev)
    check(bins.global_idx, "global_idx", torch.int32, (MAX_GLOBAL,), dev)
    check(bins.n_global, "n_global", torch.int32, (1,), dev)
    if bins.tile_ids.numel() != n_tris * WINDOW:
        raise ValueError(f"tile_ids {tuple(bins.tile_ids.shape)} do not "
                         f"hold {WINDOW} slots of {n_tris} triangles")
    check(bins.tile_ids, "tile_ids", torch.int32,
          bins.tile_ids.shape[:-1] + (WINDOW,), dev)
    if dev.type == "cpu":
        return fold_entries_plain(grad_entries, grad_global, bins, n_tris)
    if dev.type != "cuda":
        raise ValueError(f"fold_entries: unsupported device {dev}")
    if grad_entries.data_ptr() % 16 or grad_global.data_ptr() % 16:
        raise ValueError("fold_entries: rows must be 16-byte aligned")

    out = torch.empty((n_tris, REC), device=dev)
    fn = build.entry("raster_grad", "fold_entries_launch", _FOLD_ARGS)
    fold_entries.launches += 1
    ptr = build.ptr
    status = fn(ptr(grad_entries), ptr(grad_global), ptr(bins.tile_ids),
                ptr(bins.bin_start), ptr(bins.sorted_tri),
                ptr(bins.global_idx), ptr(bins.n_global), n_tiles, n_tris,
                ptr(out), build.stream(dev))
    build.check(status, "fold_entries")
    return out


fold_entries.launches = 0
