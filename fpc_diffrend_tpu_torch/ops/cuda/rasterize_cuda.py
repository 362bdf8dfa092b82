"""Stacked-batch triangle setup, binning and the fused raster kernel (K1).

Port of the XLA-side setup and binning of
``fpc_diffrend_tpu.ops.pallas.rasterize_tpu`` (``triangle_setup``,
``aux_records``, ``shift_records_stacked``, ``bin_scene_stacked``,
``pad_resolution``, ``Bins``) as PyTorch code on the device, and of its
fused raster+interpolate+texture kernel ``_fused_kernel`` (launched by
``fused_rasterize_from_bins``) as the CUDA kernel ``csrc/fused_raster.cu``.

Binning keeps the TPU tiles of 8x128 pixels and the order of the sort key
``tile * T + tri``; the pairs are placed by K11 (``bin_place_cuda``, the
counting-rank placement of ``_place_pallas``, in int32, hence the guard in
:func:`bin_scene_stacked`) and cut at the entry cap, so the bins come out
bit-equal to the JAX package's. The B samples of a batch are stacked
vertically into one (B * ph, pw) image; each sample's records are shifted
into its band. :func:`raster_stats` gives the binning's counts that size
the cap.

One deliberate difference: a triangle too large for the binning window
(the global list) is tested only inside its own clipped tile box, which
``Bins.global_bbox`` carries. The TPU kernel tests each 128-record block of
the global list on every tile row the block spans, so a triangle of one
sample that reaches past its image could cover pixels of the next sample.

K10, the same pass with the antialias (K2) in its tail, is the CUDA kernel
``csrc/fused_raster.cu`` ``fused_raster_aa_launch``: the port of the TPU
kernel's ``aa=True`` mode (``_aa_tile``, ``_aa_empty_tile``,
``_fold_aa_sides``).

``fused_raster`` and ``fused_raster_aa`` run their kernels for CUDA tensors
and their plain PyTorch versions (``*_plain``) for CPU tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from fpc_diffrend_tpu_torch.kernels import build
from fpc_diffrend_tpu_torch.ops.cuda.bin_place_cuda import place_pairs
from fpc_diffrend_tpu_torch.ops.texture import bilinear

Tensor = torch.Tensor

TILE_H = 8                # tile height in pixels
TILE_W = 128              # tile width in pixels
WINDOW_Y = 4              # binning window in tiles
WINDOW_X = 2
CHUNK = 128               # record-row padding granule
MAX_GLOBAL = 1024         # cap of the oversized-triangle list
REC = 32                  # floats per triangle record
N_PAYLOAD = 14            # u v z tu tv x0 y0 x1 y1 x2 y2 n0 n1 n2
N_EXTRA = 8               # D iw0 iw1 iw2 du02 du12 dv02 dv12
BIG = 3.0e38              # depth of a pixel no triangle covers
_AREA_EPS = 1e-12
_W_EPS = 1e-9


def pad_resolution(height: int, width: int):
    """(ph, pw): the image padded to whole 8x128 tiles."""
    ph = (height + TILE_H - 1) // TILE_H * TILE_H
    pw = (width + TILE_W - 1) // TILE_W * TILE_W
    return ph, pw


def _screen_xy(pos_clip: Tensor, height: int, width: int):
    w = pos_clip[..., 3]
    safe_w = torch.where(torch.abs(w) > _W_EPS, w, _W_EPS)
    ndc = pos_clip[..., :3] / safe_w[..., None]
    sx = (ndc[..., 0] + 1.0) * (0.5 * width)
    sy = (ndc[..., 1] + 1.0) * (0.5 * height)
    return sx, sy, ndc[..., 2], w


def triangle_setup(pos_clip: Tensor, faces: Tensor, height: int, width: int):
    """Per-triangle screen records, batched over leading dims.

    :param pos_clip: (..., V, 4) clip positions.
    :param faces: (T, 3) integer vertex indices.
    :return: (data (..., T, 16) f32 = [a0 b0 c0 a1 b1 c1 a2 b2 c2 zx zy zc
        tri_id w0 w1 w2] with lambda_i = a_i x + b_i y + c_i the normalized
        edge planes and z = zx x + zy y + zc the depth plane,
        tile_bbox (..., T, 4) int64 = (tx0, ty0, tx1, ty1), valid (..., T)).
    """
    sx, sy, sz, w = _screen_xy(pos_clip, height, width)
    fx, fy, fz, fw = (sx[..., faces], sy[..., faces], sz[..., faces],
                      w[..., faces])                        # (..., T, 3)
    x0, x1, x2 = fx.unbind(-1)
    y0, y1, y2 = fy.unbind(-1)

    area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    big_area = torch.abs(area) > _AREA_EPS
    valid = torch.all(fw > _W_EPS, dim=-1) & big_area
    inv_area = torch.where(valid, 1.0 / torch.where(big_area, area, 1.0),
                           0.0)

    def edge_coeffs(ax, ay, bx, by):
        a = -(by - ay) * inv_area
        b = (bx - ax) * inv_area
        c = (by - ay) * ax * inv_area - (bx - ax) * ay * inv_area
        return a, b, c

    a0, b0, c0 = edge_coeffs(x1, y1, x2, y2)
    a1, b1, c1 = edge_coeffs(x2, y2, x0, y0)
    a2, b2, c2 = edge_coeffs(x0, y0, x1, y1)
    z0, z1, z2 = fz.unbind(-1)
    zx = a0 * z0 + a1 * z1 + a2 * z2
    zy = b0 * z0 + b1 * z1 + b2 * z2
    zc = c0 * z0 + c1 * z1 + c2 * z2
    # invalid triangles: an edge plane of -1e30 covers no pixel
    c0 = torch.where(valid, c0, -1e30)
    c1 = torch.where(valid, c1, -1e30)
    c2 = torch.where(valid, c2, -1e30)
    tri_id = torch.arange(faces.shape[0], dtype=torch.float32,
                          device=pos_clip.device).expand_as(a0)
    w0, w1, w2 = fw.unbind(-1)
    data = torch.stack([a0, b0, c0, a1, b1, c1, a2, b2, c2, zx, zy, zc,
                        tri_id, w0, w1, w2], dim=-1)

    xmin = torch.minimum(torch.minimum(x0, x1), x2)
    xmax = torch.maximum(torch.maximum(x0, x1), x2)
    ymin = torch.minimum(torch.minimum(y0, y1), y2)
    ymax = torch.maximum(torch.maximum(y0, y1), y2)
    gx = (width + TILE_W - 1) // TILE_W
    gy = (height + TILE_H - 1) // TILE_H

    def tile(v, size, n):
        # clamp before the integer cast: the JAX cast saturates
        return torch.clamp(torch.floor(v / size), 0, n - 1).to(torch.int64)

    tile_bbox = torch.stack([tile(xmin, TILE_W, gx), tile(ymin, TILE_H, gy),
                             tile(xmax, TILE_W, gx), tile(ymax, TILE_H, gy)],
                            dim=-1)
    on_screen = (xmax >= 0) & (xmin < width) & (ymax >= 0) & (ymin < height)
    return data, tile_bbox, valid & on_screen


def aux_records(uv: Tensor, uv_idx: Tensor, pos_clip: Tensor, faces: Tensor,
                face_neighbors: Tensor | None, height: int,
                width: int) -> Tensor:
    """(..., T, 16) auxiliary rows [u0 v0 u1 v1 u2 v2 x0 y0 x1 y1 x2 y2
    n0 n1 n2 0]: uv corners, screen corners, neighbour face ids."""
    lead = pos_clip.shape[:-2]
    T = faces.shape[0]
    corners = uv[uv_idx].reshape(T, 6).expand(*lead, T, 6)
    sx, sy, _, _ = _screen_xy(pos_clip, height, width)
    sv = torch.stack([sx, sy], dim=-1)                       # (..., V, 2)
    verts = sv[..., faces, :].reshape(*lead, T, 6)
    if face_neighbors is None:
        neigh = torch.full((T, 3), -1.0, device=pos_clip.device)
    else:
        neigh = face_neighbors.to(torch.float32)
    neigh = neigh.expand(*lead, T, 3)
    pad = torch.zeros(*lead, T, 1, device=pos_clip.device)
    return torch.cat([corners, verts, neigh, pad], dim=-1)


def shift_records_stacked(data_b: Tensor, aux_b: Tensor, sample_ph: int):
    """Per-sample y-shift of (B, T, 16) records into the stacked frame.

    Sample b's pixels live at stacked rows [b*sample_ph, (b+1)*sample_ph):
    a plane a x + b y + c evaluated at y + dy needs c' = c - dy * b, and
    the screen-corner y values move by +dy.
    """
    B = data_b.shape[0]
    dy = (torch.arange(B, dtype=torch.float32, device=data_b.device)
          * sample_ph)[:, None]
    data_s = data_b.clone()
    for c, b in ((2, 1), (5, 4), (8, 7), (11, 10)):
        data_s[..., c] = data_b[..., c] - dy * data_b[..., b]
    aux_s = aux_b.clone()
    for k in (7, 9, 11):
        aux_s[..., k] = aux_b[..., k] + dy
    return data_s, aux_s


@dataclasses.dataclass
class Bins:
    """Tile-binned triangle records over the stacked image.

    sorted_rec:  (P + pad, 32) records, grouped by tile, triangle id
                 ascending in each bin; rows past the live prefix are dead.
    bin_start:   (n_tiles + 1,) int32 bin offsets into sorted_rec.
    global_rec:  (MAX_GLOBAL, 32) records of the oversized triangles;
                 their entry index is ``sorted_rec.shape[0] + row``.
    n_global:    (1,) int32 live rows of global_rec.
    sorted_tri:  (P,) int32 stacked triangle id b*T + t per entry (B*T dead).
    global_idx:  (MAX_GLOBAL,) int32 stacked triangle id per global row.
    global_bbox: (MAX_GLOBAL, 4) int32 stacked tile box (tx0, ty0, tx1, ty1)
                 of each global row; empty for unused rows.
    """

    sorted_rec: Tensor
    bin_start: Tensor
    global_rec: Tensor
    n_global: Tensor
    sorted_tri: Tensor
    global_idx: Tensor
    global_bbox: Tensor

    @property
    def gbase(self) -> int:
        return self.sorted_rec.shape[0]


def raster_stats(pos_clip: Tensor, faces: Tensor, height: int,
                 width: int) -> dict:
    """Binning health counters (port of ``rasterize_tpu.raster_stats``),
    batched over leading dims: one call takes every camera's clip
    positions.

    :param pos_clip: (..., V, 4) clip positions.
    :return: dict of (...) int64 tensors: n_valid_pairs (bin entries),
        n_global (oversized triangles in the global list), global_overflow
        (oversized triangles dropped past MAX_GLOBAL), pair_cap_suggestion
        (= n_valid_pairs), wy_max / wx_max (largest valid tile box).
    """
    _, tile_bbox, valid = triangle_setup(pos_clip, faces, height, width)
    tx0, ty0, tx1, ty1 = tile_bbox.unbind(-1)
    wx = tx1 - tx0 + 1
    wy = ty1 - ty0 + 1
    fits = (wx <= WINDOW_X) & (wy <= WINDOW_Y)
    n_pairs = torch.where(valid & fits, wx * wy, 0).sum(-1)
    n_big = (valid & ~fits).sum(-1)
    return {
        "n_valid_pairs": n_pairs,
        "n_global": torch.clamp(n_big, max=MAX_GLOBAL),
        "global_overflow": torch.clamp(n_big - MAX_GLOBAL, min=0),
        "pair_cap_suggestion": n_pairs,
        "wy_max": torch.where(valid, wy, 0).amax(-1),
        "wx_max": torch.where(valid, wx, 0).amax(-1),
    }


def entry_count(B: int, T: int, entry_cap: int = 0) -> int:
    """P, the entries the stacked bins keep: B x the per-sample cap rounded
    up to 128, at most all B*T*K pair slots (a cap <= 0: all)."""
    P_s = T * WINDOW_Y * WINDOW_X
    if 0 < entry_cap < P_s:
        P_s = min((int(entry_cap) + CHUNK - 1) // CHUNK * CHUNK, P_s)
    return B * P_s


def _stacked_tiles(bbox_b: Tensor, valid_b: Tensor, gy_s: int, gx: int):
    """The stacked pair slots of B samples' tile boxes.

    :return: (tile_ids (B, T, K) int32, the stacked tile of each window
        slot, n_tiles where the slot is dead; fits (B, T), the triangles
        inside the window; stacked boxes (tx0, ty0, tx1, ty1)).
    """
    dev = bbox_b.device
    B = bbox_b.shape[0]
    n_tiles = B * gy_s * gx
    row0 = (torch.arange(B, device=dev) * gy_s)[:, None]
    tx0, ty0, tx1, ty1 = bbox_b.unbind(-1)
    ty0 = ty0 + row0
    ty1 = ty1 + row0
    wx = tx1 - tx0 + 1
    wy = ty1 - ty0 + 1
    fits = (wx <= WINDOW_X) & (wy <= WINDOW_Y)
    k = torch.arange(WINDOW_Y * WINDOW_X, device=dev)
    dx = k % WINDOW_X
    dyk = k // WINDOW_X
    pair_valid = ((valid_b & fits)[..., None] & (dx < wx[..., None])
                  & (dyk < wy[..., None]))
    tile_ids = torch.where(pair_valid, (ty0[..., None] + dyk) * gx
                           + tx0[..., None] + dx, n_tiles)
    return tile_ids.to(torch.int32), fits, (tx0, ty0, tx1, ty1)


def pair_tile_ids(pos_clip_b: Tensor, faces: Tensor, height: int,
                  width: int):
    """K11's input for a batch of clip positions, as
    :func:`bin_scene_stacked` builds it.

    :return: (tile_ids (B, T, K) int32, n_tiles of the stacked image).
    """
    ph, pw = pad_resolution(height, width)
    _, bbox_b, valid_b = triangle_setup(pos_clip_b, faces, height, width)
    tile_ids, _, _ = _stacked_tiles(bbox_b, valid_b, ph // TILE_H,
                                    pw // TILE_W)
    return tile_ids, pos_clip_b.shape[0] * (ph // TILE_H) * (pw // TILE_W)


def bin_scene_stacked(pos_clip_b: Tensor, faces: Tensor, height: int,
                      width: int, aux_b: Tensor,
                      entry_cap: int = 0):
    """Stacked-batch triangle setup and binning (K11 places the pairs).

    The bins are built from detached records: they are constants of the
    backward (stop-gradient, as in the JAX package), and gradients reach
    ``data_s``/``aux_s`` only through ``ops.rasterize``'s autograd Function.

    :param pos_clip_b: (B, V, 4) clip positions per sample.
    :param aux_b: (B, T, 16) per-sample aux records (``aux_records``).
    :param entry_cap: per-sample bin-entry cap (``FitConfig.pair_cap``),
        rounded up to 128; the samples pool it into one prefix of B x cap
        entries, and entries past it are dropped as the sort's kept prefix
        drops them. A cap <= 0 keeps all B*T*K pair slots.
    :return: (data_s (B, T, 16), aux_s (B, T, 16) shifted records, Bins
        over the (B * ph, pw) stacked image).
    :raises ValueError: the pair slots and the global list overflow int32
        entry indices.
    """
    dev = pos_clip_b.device
    B = pos_clip_b.shape[0]
    T = faces.shape[0]
    ph, pw = pad_resolution(height, width)
    gy_s = ph // TILE_H
    n_tiles = B * gy_s * (pw // TILE_W)
    K = WINDOW_Y * WINDOW_X
    if B * T * K + MAX_GLOBAL + 2 * CHUNK >= 1 << 31:
        raise ValueError(
            f"stacked binning overflow: {B} x {T} triangles x {K} slots "
            "exceed int32 entry indices; render fewer samples per batch")
    P = entry_count(B, T, entry_cap)

    data_b, bbox_b, valid_b = triangle_setup(pos_clip_b, faces, height, width)
    data_s, aux_s = shift_records_stacked(data_b, aux_b, ph)
    tile_ids, fits, (tx0, ty0, tx1, ty1) = _stacked_tiles(
        bbox_b, valid_b, gy_s, pw // TILE_W)
    # a stacked tile holds one sample's triangles, so ordering a bin by the
    # stacked id b*T + t orders it by t, as the key tile * T + t does
    bin_start, sorted_tri = place_pairs(tile_ids, n_tiles, P)

    rec = torch.cat([data_s.detach(), aux_s.detach()],
                    dim=-1).reshape(B * T, REC)
    pad_rows = CHUNK + (-P) % CHUNK
    sorted_rec = torch.cat([
        rec[torch.clamp(sorted_tri, max=B * T - 1).long()],
        torch.zeros((pad_rows, REC), dtype=torch.float32, device=dev)])

    # compacted list of the oversized triangles of every sample
    big = valid_b & ~fits
    gid = torch.arange(B * T, device=dev).reshape(B, T)
    big_key = torch.where(big, gid, B * T).reshape(-1)
    big_idx, _ = torch.sort(torch.cat([
        big_key, torch.full((MAX_GLOBAL,), B * T, device=dev)]))
    big_idx = big_idx[:MAX_GLOBAL]
    n_global = torch.clamp(big.sum(), max=MAX_GLOBAL).to(torch.int32)
    safe_big = torch.clamp(big_idx, max=B * T - 1)
    grow = (big_idx < B * T)[:, None]
    global_rec = torch.where(grow, rec[safe_big], 0.0)
    box = torch.stack([tx0, ty0, tx1, ty1], dim=-1).reshape(B * T, 4)
    empty = (torch.arange(4, device=dev) < 2).long()     # box (1, 1, 0, 0)
    global_bbox = torch.where(grow, box[safe_big], empty).to(torch.int32)

    bins = Bins(sorted_rec=sorted_rec.contiguous(), bin_start=bin_start,
                global_rec=global_rec.contiguous(),
                n_global=n_global.reshape(1), sorted_tri=sorted_tri,
                global_idx=big_idx.to(torch.int32),
                global_bbox=global_bbox.contiguous())
    return data_s, aux_s, bins


# ----------------------------------------------------------------------------
# K1: the fused raster + interpolate + texture pass
# ----------------------------------------------------------------------------

def _planes(x: Tensor, rows: int, pw: int) -> Tensor:
    """(..., n_tiles, 8, 128) tile-major -> (..., rows, pw) row-major."""
    gy, gx = rows // TILE_H, pw // TILE_W
    lead = x.shape[:-3]
    x = x.reshape(*lead, gy, gx, TILE_H, TILE_W).transpose(-3, -2)
    return x.reshape(*lead, rows, pw)


def _plane_fn(a, b, c, x, y):
    # the kernel's exact order: a*x + (b*y + c), every step rounded
    return a * x + (b * y + c)


def resolve_payload(F: Tensor, x: Tensor, y: Tensor, hit: Tensor,
                    z: Tensor):
    """Payload and extra planes from the winner's record per pixel.

    :param F: (..., 32) winner records (zeros where nothing is hit).
    :return: (payload list of 14, extra list of 8) tensors (...).
    """
    f = F.unbind(-1)
    l0 = _plane_fn(f[0], f[1], f[2], x, y)
    l1 = _plane_fn(f[3], f[4], f[5], x, y)
    l2 = _plane_fn(f[6], f[7], f[8], x, y)
    iw = [1.0 / torch.where(torch.abs(f[13 + k]) > _W_EPS, f[13 + k], 1.0)
          for k in range(3)]
    d0, d1, d2 = l0 * iw[0], l1 * iw[1], l2 * iw[2]
    D = d0 + d1 + d2
    rD = 1.0 / torch.where(torch.abs(D) > _AREA_EPS, D, 1.0)
    up = d0 * rD
    vp = d1 * rD
    du02 = f[16] - f[20]
    du12 = f[18] - f[20]
    dv02 = f[17] - f[21]
    dv12 = f[19] - f[21]
    tu = up * du02 + vp * du12 + f[20]
    tv = up * dv02 + vp * dv12 + f[21]
    payload = ([up, vp, torch.where(hit, z, 0.0), tu, tv]
               + list(f[22:28]) + list(f[28:31]))
    extra = [D, iw[0], iw[1], iw[2], du02, du12, dv02, dv12]
    return payload, extra


def fused_raster_plain(bins: Bins, tex: Tensor | None, rows: int, pw: int):
    """Plain PyTorch version of K1 (same inputs and outputs as
    :func:`fused_raster`).

    Each pixel tests its tile's bin entries in entry order, then the
    global rows whose tile box holds the tile; a covered test (all three
    edge planes >= 0, z in [-1, 1]) with z strictly below the best so far
    wins, so the lowest entry wins a tie. The loop runs over entry slots,
    on the tiles sorted by bin size, so each step touches only the tiles
    that still have entries.
    """
    dev = bins.sorted_rec.device
    gy, gx = rows // TILE_H, pw // TILE_W
    n_tiles = gy * gx
    t = torch.arange(n_tiles, device=dev)
    start = bins.bin_start[:-1].long()
    cnt = bins.bin_start[1:].long() - start
    order = torch.argsort(cnt, descending=True, stable=True)
    cnt_sorted = cnt[order].cpu().numpy()
    ti, tj = (order // gx)[:, None, None], (order % gx)[:, None, None]
    x = ((tj * TILE_W + torch.arange(TILE_W, device=dev)).float()
         + 0.5)                                         # (n, 1, 128)
    y = ((ti * TILE_H + torch.arange(TILE_H, device=dev)[:, None]).float()
         + 0.5)                                         # (n, 8, 1)
    bz = torch.full((n_tiles, TILE_H, TILE_W), BIG, device=dev)
    be = torch.full((n_tiles, TILE_H, TILE_W), -1, dtype=torch.int64,
                    device=dev)

    def test(n, r, entry, live=None):
        """Merge records r (n, 32) into the first n sorted tiles."""
        c = [r[:, i, None, None] for i in range(12)]
        xs, ys = x[:n], y[:n]
        l0 = _plane_fn(c[0], c[1], c[2], xs, ys)
        l1 = _plane_fn(c[3], c[4], c[5], xs, ys)
        l2 = _plane_fn(c[6], c[7], c[8], xs, ys)
        z = _plane_fn(c[9], c[10], c[11], xs, ys)
        cov = ((l0 >= 0.0) & (l1 >= 0.0) & (l2 >= 0.0) & (z >= -1.0)
               & (z <= 1.0))
        if live is not None:
            cov = cov & live[:, None, None]
        better = cov & (z < bz[:n])
        bz[:n] = torch.where(better, z, bz[:n])
        be[:n] = torch.where(better, entry, be[:n])

    start_sorted = start[order]
    for k in range(int(cnt_sorted[0]) if n_tiles else 0):
        n = int(np.count_nonzero(cnt_sorted > k))
        e = start_sorted[:n] + k
        test(n, bins.sorted_rec[e], e[:, None, None])
    box = bins.global_bbox.long()
    for g in range(int(bins.n_global[0])):
        inside = ((tj[:, 0, 0] >= box[g, 0]) & (tj[:, 0, 0] <= box[g, 2])
                  & (ti[:, 0, 0] >= box[g, 1]) & (ti[:, 0, 0] <= box[g, 3]))
        test(n_tiles, bins.global_rec[g].expand(n_tiles, REC),
             bins.gbase + g, live=inside)

    # back to tile order, then resolve the winner's record per pixel
    inv = torch.empty_like(order)
    inv[order] = t
    bz, be = bz[inv], be[inv]
    x, y = x[inv], y[inv]
    hit = bz < BIG
    table = torch.cat([bins.sorted_rec, bins.global_rec,
                       torch.zeros((1, REC), device=dev)])
    F = table[torch.where(hit, be, table.shape[0] - 1)]
    payload, extra = resolve_payload(F, x, y, hit, bz)
    if tex is None:
        colour = torch.empty((0, rows, pw), device=dev)
    else:
        colour = _planes(bilinear(tex, payload[3], payload[4],
                                  "wrap").movedim(-1, 0), rows,
                         pw).contiguous()
    idbuf = torch.where(hit, F[..., 12].to(torch.int32), -1)
    entry = torch.where(hit, be, -1).to(torch.int32)
    return (_planes(idbuf, rows, pw), _planes(entry, rows, pw),
            _planes(torch.stack(payload), rows, pw),
            _planes(torch.stack(extra), rows, pw), colour)


def _check_raster(bins: Bins, tex: Tensor | None, rows: int, pw: int):
    """Raise unless the bins and texture fit K1/K10; :return: (device,
    th, tw, C, n_tiles)."""
    dev = bins.sorted_rec.device
    if rows % TILE_H or pw % TILE_W:
        raise ValueError(f"stacked image {rows}x{pw} is not whole tiles")
    n_tiles = rows // TILE_H * (pw // TILE_W)
    check = build.check_tensor
    if tex is None:
        th, tw, C = 1, 1, 0
    else:
        th, tw, C = tex.shape
        check(tex, "tex", torch.float32, (th, tw, C), dev)
    check(bins.bin_start, "bin_start", torch.int32, (n_tiles + 1,), dev)
    check(bins.sorted_rec, "sorted_rec", torch.float32, (bins.gbase, REC),
          dev)
    check(bins.global_rec, "global_rec", torch.float32, (MAX_GLOBAL, REC),
          dev)
    check(bins.global_bbox, "global_bbox", torch.int32, (MAX_GLOBAL, 4), dev)
    check(bins.n_global, "n_global", torch.int32, (1,), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev, th, tw, C, n_tiles


def _raster_outputs(dev, rows: int, pw: int, C: int):
    """Empty (idbuf, entry, payload, extra, colour) for the kernels."""
    return (torch.empty((rows, pw), dtype=torch.int32, device=dev),
            torch.empty((rows, pw), dtype=torch.int32, device=dev),
            torch.empty((N_PAYLOAD, rows, pw), device=dev),
            torch.empty((N_EXTRA, rows, pw), device=dev),
            torch.empty((C, rows, pw), device=dev))


def _bins_args(bins: Bins):
    ptr = build.ptr
    return (ptr(bins.sorted_rec), ptr(bins.global_rec), ptr(bins.global_bbox),
            ptr(bins.n_global), ptr(bins.bin_start))


def fused_raster(bins: Bins, tex: Tensor | None, rows: int, pw: int):
    """K1: rasterize, interpolate and texture the stacked image in one pass.

    :param bins: from :func:`bin_scene_stacked`.
    :param tex: (TH, TW, C) float32 texture, sampled bilinearly with wrap;
        None skips the texture tail (C = 0: the mip path and the separate
        sampler K7 sample the payload's uv themselves).
    :param rows, pw: stacked image size, whole 8x128 tiles.
    :return: (idbuf (rows, pw) int32 winning triangle id, -1 = none;
        entry (rows, pw) int32 winning bin entry, -1 = none;
        payload (14, rows, pw) [u v z tu tv x0 y0 x1 y1 x2 y2 n0 n1 n2];
        extra (8, rows, pw) [D iw0 iw1 iw2 du02 du12 dv02 dv12];
        colour (C, rows, pw)). A pixel no triangle covers samples uv (0, 0).
    """
    dev, th, tw, C, n_tiles = _check_raster(bins, tex, rows, pw)
    if dev.type == "cpu":
        return fused_raster_plain(bins, tex, rows, pw)
    out = _raster_outputs(dev, rows, pw, C)
    fn = build.load("fused_raster").fused_raster_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p] * 6)
    fused_raster.launches += 1
    ptr = build.ptr
    status = fn(*_bins_args(bins), None if tex is None else ptr(tex),
                th, tw, C, n_tiles, pw // TILE_W, bins.gbase, rows,
                *(ptr(t) for t in out), build.stream(dev))
    build.check(status, "fused_raster")
    return out


fused_raster.launches = 0


def fused_raster_aa_plain(bins: Bins, tex: Tensor, rows: int, pw: int,
                          height: int, width: int, sample_ph: int):
    """Plain PyTorch version of K10 (same arguments and outputs as
    :func:`fused_raster_aa`): K2's plain version over K1's."""
    # imported here: antialias_cuda imports this module
    from fpc_diffrend_tpu_torch.ops.cuda.antialias_cuda import (
        antialias_planes_plain)

    k1 = fused_raster_plain(bins, tex, rows, pw)
    return (*k1, antialias_planes_plain(k1[0], k1[2], k1[4], height, width,
                                        sample_ph))


def fused_raster_aa(bins: Bins, tex: Tensor, rows: int, pw: int,
                    height: int, width: int, sample_ph: int):
    """K10: K1 with the silhouette antialias (K2) in the same pass.

    :param bins, tex, rows, pw: as for :func:`fused_raster`; C <= 4.
    :param height, width: one sample's real size (the antialias's pair
        masks).
    :param sample_ph: row pitch of the stacked samples.
    :return: K1's five outputs, then aa (C, rows, pw), the antialiased
        colour before the background composite (K2's output on K1's).
    """
    if tex is None:
        raise ValueError("fused_raster_aa needs a texture")
    dev, th, tw, C, n_tiles = _check_raster(bins, tex, rows, pw)
    if not 1 <= C <= 4:
        raise ValueError(f"fused_raster_aa takes 1 to 4 channels, not {C}")
    if rows % sample_ph or height > sample_ph or width > pw:
        raise ValueError(f"{rows}x{pw} planes do not hold samples of "
                         f"{height}x{width} at pitch {sample_ph}")
    if dev.type == "cpu":
        return fused_raster_aa_plain(bins, tex, rows, pw, height, width,
                                     sample_ph)
    out = _raster_outputs(dev, rows, pw, C)
    aa = torch.empty((C, rows, pw), device=dev)
    fn = build.load("fused_raster").fused_raster_aa_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
                   + [ctypes.c_void_p] * 7)
    fused_raster_aa.launches += 1
    ptr = build.ptr
    status = fn(*_bins_args(bins), ptr(tex), th, tw, C, n_tiles, pw // TILE_W,
                bins.gbase, rows, height, width, sample_ph,
                *(ptr(t) for t in out), ptr(aa), build.stream(dev))
    build.check(status, "fused_raster_aa")
    return (*out, aa)


fused_raster_aa.launches = 0
