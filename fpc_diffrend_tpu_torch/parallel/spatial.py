"""Spatial (tile-axis) parallel rendering: image row-bands across ranks
(port of ``fpc_diffrend_tpu.parallel.spatial``).

Each rank renders a horizontal band of the image by windowing the
projection matrix (a per-band y scale and offset in clip space), so its
pixel centres fall on the matching rows of the full-frame render. The
antialias needs one row of (colour, rast) from each vertical neighbour
band: the rows go round the tile axis's process group
(``parallel.mesh.exchange``), and the seam's pair blend is the
antialias's own pair math (``ops.antialias._pair_blend``).

On the kernel route a rank's samples render stacked at the band's size,
through one K11, one K1 and one K2 for all of them (backward K3, K4, K5,
K6), as the single-device step renders its batch: the band path is the
single-device pass, ``ops.rasterize.rasterize_textured_sepaa_stacked``.
With ``edge_rows`` that pass also returns each sample's first and last
rows of the pre-antialias colour and of the payload's u, v, z, which the
seam blends; their cotangents join the colour cotangent before K4 (K9) and
reach K5. ``impl="scan"`` composes the primitives sample by sample, as the
JAX package's non-fused branch does.
"""

from __future__ import annotations

import numpy as np
import torch

from fpc_diffrend_tpu_torch.device import resolve_device
from fpc_diffrend_tpu_torch.models.camera import transform_clip
from fpc_diffrend_tpu_torch.ops.antialias import _pair_blend, antialias
from fpc_diffrend_tpu_torch.ops.cuda.rasterize_cuda import (_screen_xy,
                                                            pad_resolution)
from fpc_diffrend_tpu_torch.ops.pipeline import (BACKGROUND,
                                                 composite_stacked,
                                                 scan_colour)
from fpc_diffrend_tpu_torch.ops.rasterize import (
    check_impl, rasterize_textured_sepaa_stacked)
from fpc_diffrend_tpu_torch.parallel.mesh import exchange

Tensor = torch.Tensor


def band_window_matrix(band, n_bands: int, device=None) -> Tensor:
    """4x4 matrix mapping clip space so band ``band`` fills the viewport.

    Band b covers ndc y in [-1 + 2b/n, -1 + 2(b+1)/n] (bottom-up, GL row
    order). y' = n*y - (n*center)*w.

    :param device: where the matrix lives (None: the CPU).
    """
    n = float(n_bands)
    center = (2.0 * float(band) + 1.0) / n - 1.0
    m = torch.eye(4, dtype=torch.float32, device=device)
    m[1, 1] = n
    m[1, 3] = -n * center
    return m


def render_band(mvp, pos, pos_idx, uv, uv_idx, tex, band_resolution,
                face_neighbors, band, n_bands: int, enable_mip=False,
                max_mip_level=0, impl="auto", group=None, aa_max_pairs=None,
                pair_cap=None, device=None) -> Tensor:
    """Render one band of one view; with ``group`` (the tile axis's
    process group, JAX's ``axis_name``) blend the antialias seam with the
    neighbour bands of that group's ranks, which must render their bands
    of the same view in the same call.

    :param mvp: (4, 4) full-frame modelview-projection; pos (V, 3).
    :param band_resolution: (H_band, W) of this band.
    :param band: this band's index, 0 the bottom band.
    :param impl: "auto" or "pallas" the kernels, "scan" the primitives
        over the reference rasterizer (``ops.pipeline.render``'s).
    :param device: where to render; None means CUDA (no CPU fallback).
    :return: (H_band, W, C) image (this band of the full framebuffer).
    """
    dev = resolve_device(device)

    def tensor(x, dtype):
        x = x if isinstance(x, Tensor) else torch.tensor(np.array(x))
        return x.to(device=dev, dtype=dtype)

    f32, i32 = torch.float32, torch.int32
    mvp = band_window_matrix(band, n_bands, dev) @ tensor(mvp, f32)
    band_clip = transform_clip(mvp, tensor(pos, f32))
    tex = tensor(tex, f32)
    return render_band_stacked(
        band_clip[None], tensor(pos_idx, i32), tensor(uv, f32),
        tensor(uv_idx, i32), tex[..., None] if tex.ndim == 2 else tex,
        band_resolution, tensor(face_neighbors, i32), band, n_bands,
        enable_mip, max_mip_level, impl, group, aa_max_pairs, pair_cap)[0]


def render_band_stacked(band_clip: Tensor, pos_idx: Tensor, uv: Tensor,
                        uv_idx: Tensor, tex: Tensor, band_resolution,
                        face_neighbors: Tensor, band, n_bands: int,
                        enable_mip=False, max_mip_level=0, impl="auto",
                        group=None, aa_max_pairs=None,
                        pair_cap=None) -> Tensor:
    """:func:`render_band` for B samples' band clip positions (B, V, 4)
    (the band window already applied), on their device: the kernel route
    renders them stacked, through one pass of each kernel.

    :return: (B, H_band, W, C) images.
    """
    hb, w = band_resolution
    seam = group is not None and n_bands > 1
    if check_impl(impl) == "scan":
        return _render_band_scan(band_clip, pos_idx, uv, uv_idx, tex,
                                 (hb, w), face_neighbors, band, n_bands,
                                 enable_mip, max_mip_level, group if seam
                                 else None, aa_max_pairs)
    B = band_clip.shape[0]
    out = rasterize_textured_sepaa_stacked(
        band_clip, pos_idx, uv, uv_idx, tex, face_neighbors, (hb, w),
        pair_cap=pair_cap, enable_mip=enable_mip,
        max_mip_level=max_mip_level, edge_rows=seam)
    if not seam:
        return composite_stacked(*out, B, (hb, w))
    idbuf, aa, colour_rows, uvz_rows = out
    ph, pw = pad_resolution(hb, w)
    first = torch.arange(B, device=idbuf.device) * ph
    rows = torch.stack([first, first + hb - 1], 1).reshape(-1)
    ids = idbuf[rows].reshape(B, 2, pw)[..., :w]
    idf = torch.where(ids >= 0, (ids + 1).to(torch.float32), 0.0)
    rast_rows = torch.cat([uvz_rows[..., :w].permute(1, 2, 3, 0),
                           idf[..., None]], -1)
    delta = _seam_antialias_delta(
        colour_rows[..., :w].permute(1, 2, 3, 0), rast_rows, band_clip,
        pos_idx, face_neighbors, (hb, w), group, n_bands, band)
    C = aa.shape[0]
    delta = torch.nn.functional.pad(delta, (0, 0, 0, pw - w))
    aa = aa.index_add(1, rows, delta.permute(3, 0, 1, 2).reshape(
        C, 2 * B, pw))
    return composite_stacked(idbuf, aa, B, (hb, w))


def _render_band_scan(band_clip, pos_idx, uv, uv_idx, tex, band_resolution,
                      face_neighbors, band, n_bands, enable_mip,
                      max_mip_level, group, aa_max_pairs):
    """The scan route of :func:`render_band_stacked`, sample by sample
    (JAX's non-fused branch): the primitives over the visibility scan, the
    seam from the pre-antialias colour, the antialias, the background."""
    hb, w = band_resolution
    colours, rasts = [], []
    for clip in band_clip:
        rast, colour = scan_colour(clip, pos_idx, uv, uv_idx, tex, (hb, w),
                                   enable_mip, max_mip_level)
        colours.append(colour)
        rasts.append(rast)
    if group is not None:
        edge = torch.tensor([0, hb - 1], device=band_clip.device)
        delta = _seam_antialias_delta(
            torch.stack([c[edge] for c in colours]),
            torch.stack([r[edge] for r in rasts]), band_clip, pos_idx,
            face_neighbors, (hb, w), group, n_bands, band)
    out = []
    for b, (clip, colour, rast) in enumerate(zip(band_clip, colours, rasts)):
        img = antialias(colour, rast, clip, pos_idx, face_neighbors,
                        max_pairs=aa_max_pairs)
        if group is not None:
            img = img.index_add(0, edge, delta[b])
        out.append(torch.where(rast[..., 3:] > 0, img, BACKGROUND))
    return torch.stack(out)


def _seam_antialias_delta(colour, rast, band_clip, faces, face_neighbors,
                          band_resolution, group, n_bands, band):
    """Colour deltas from the vertical pixel pairs that straddle band
    boundaries, for B samples at once.

    My top row (the last, GL bottom-up) pairs with the next band's bottom
    row; my bottom row pairs with the previous band's top row. Screen y of
    the neighbour rows is in *this band's* pixel coordinates (one row
    above or below the band), which the band clip transform supports since
    the pair math needs only relative geometry.

    :param colour: (B, 2, W, C) pre-antialias colour of each sample's
        first and last row.
    :param rast: (B, 2, W, 4) their rast rows (u, v, z, id + 1).
    :param band_clip: (B, V, 4) band clip positions.
    :param group: the tile axis's process group.
    :return: (B, 2, W, C) deltas of the first and the last row.
    """
    h, w = band_resolution
    B, T = band_clip.shape[0], faces.shape[0]
    dev = band_clip.device
    sx, sy, _, _ = _screen_xy(band_clip, h, w)
    tri_screen = torch.stack([sx, sy], -1)[:, faces.long()].reshape(
        B * T, 3, 2)
    # the B samples' triangles as one list: sample b's ids move by b * T
    off = torch.arange(B, device=dev) * T
    fn = face_neighbors.long()
    neighbours = torch.where(fn >= 0, fn + off[:, None, None],
                             -1).reshape(B * T, 3)
    idf = torch.where(rast[..., 3] > 0,
                      rast[..., 3] + off.to(torch.float32)[:, None, None],
                      0.0)
    rast = torch.cat([rast[..., :3], idf[..., None]], -1)
    C = colour.shape[-1]
    slots = exchange(torch.cat([colour, rast], -1), group)
    # the band above's first row, the band below's last row
    above = slots[(band + 1) % n_bands, :, 0]
    below = slots[(band - 1) % n_bands, :, 1]

    xs = torch.arange(w, dtype=torch.float32, device=dev) + 0.5

    def centers(y):
        return torch.stack([xs, torch.full_like(xs, y)], -1).expand(B, w, 2)

    # pair (my last row, the neighbour row at y = h + 0.5)
    da, _ = _pair_blend(colour[:, 1], above[..., :C], rast[:, 1],
                        above[..., C:], centers(h - 0.5), centers(h + 0.5),
                        tri_screen, neighbours)
    # pair (the neighbour row at y = -0.5, my row 0)
    _, db = _pair_blend(below[..., :C], colour[:, 0], below[..., C:],
                        rast[:, 0], centers(-0.5), centers(0.5), tri_screen,
                        neighbours)
    # the wrap-around pairs of band 0 and band n-1 are spurious; they are
    # zeroed, not dropped, so every rank runs the exchange's backward
    da = da * float(band != n_bands - 1)
    db = db * float(band != 0)
    return torch.stack([db, da], 1)
