"""Stacked-batch rasterize + texture + antialias, forward and backward.

Port of ``fpc_diffrend_tpu.ops.rasterize``'s
``rasterize_pallas_textured_sepaa_stacked`` and its custom VJP
``rasterize_texture_sepaa_stacked``: aux records and binning on the
device, then K1 (fused raster + texture) and K2 (antialias), each one pass
over the B samples stacked vertically into one image. The backward is
K3 (antialias) -> K4 (texture) -> K5 (pixel -> bin entry) -> K6 (bin
entry -> triangle), under one ``torch.autograd.Function``,
:class:`RasterizeTextured`; the triangle setup chains back to clip
positions through ordinary autograd, as the JAX package leaves it to
autodiff. Each sample's records stay in its own frame: the kernels
evaluate them at the pixel's row within its sample, where the JAX package
shifts them into the stacked frame (``ops.cuda.rasterize_cuda``), so each
stack position renders and differentiates as the sample rendered alone.

:func:`rasterize_textured_sepaa_stacked` is the one entry point of the
pass: it bins, builds the mip pyramid where there is one, and applies
the Function with a sampler of :data:`SAMPLERS`, the kernels that run
between K1 and K2 and, in the backward, between K3 and K5. The single
view (``ops.pipeline.render``) is the same pass at B = 1, and picks one
of three routes that compute the same image and gradients (``route``;
the JAX package picks them by environment variables,
``ops/pipeline.py:149-193`` there):

* ``"sepaa"``: K1 with its texture tail, then K2 (the JAX default, and
  the stacked batch's only route);
* ``"aa_fused"``: K10, K1 with the antialias from one entry point
  (``FPC_AA_FUSE=1``, JAX's ``rasterize_texture_aa_fused``);
* ``"separate"``: K1 without its texture tail, the standalone sampler K7,
  then K2 (``FPC_FUSE_TEX=0``).

All three share the backward K3 -> K4 -> K5 -> K6.

The mip path (``enable_mip``) is the sampler ``"mip"``: K1 without its
texture tail, K8 (trilinear mip sample, deriving the finite-difference
LOD from K1's uv and ids), K2; backward K3 -> K9 -> K5 -> K6. The JAX
package renders it per sample under ``vmap`` (``render_from_clip``'s mip
branch); stacked, each sample gives the same result, as the JAX package
says of its own stacked path ("functionally identical to vmapping").

With ``edge_rows`` the pass also returns each sample's first and last
image rows of the pre-antialias colour and of u, v, z, whose cotangents
join the backward before the sampler's and K5: the sharded band render's
seam (``parallel.spatial``).

The layers are spans of ``utils.profiling``: ``raster.bin`` (records and
binning), ``raster.fwd`` (the Function's forward, with the mip pyramid's
build on the mip route, ``raster.pyramid``, and K8 with its LOD,
``raster.mip_fwd``, inside it) and ``raster.bwd`` (its backward, on
autograd's device thread on CUDA; K9 in ``raster.mip_bwd``). The
pyramid's own backward, the adjoint of its 2x2 means, is autograd's,
outside ``raster.bwd``; the LOD has none.

The Function reads the gradient precision (``ops.precision``) in its
forward and keeps it, so that its backward launches K4 and K5 in the
forward's modes (K9 has none).

The nvdiffrast-style primitive (JAX's public ``rasterize`` and
``rasterize_with_uv``) has two routes. The kernel route is the same pass
at B = 1 with K1 in its texture-free mode, under
:class:`RasterizeKernel` (JAX's ``rasterize_fused``): its backward is K5,
fed the cotangents of u, v and z as well, then K6. The scan route is the
O(T·H·W) :func:`visibility_scan` and the autograd of
:func:`pixel_attributes`, plain torch on either device as JAX's is XLA.
"""

from __future__ import annotations

import torch

from fpc_diffrend_tpu_torch.ops.antialias import edge_fn
from fpc_diffrend_tpu_torch.ops.cuda.antialias_cuda import (
    antialias_planes, antialias_planes_bwd)
from fpc_diffrend_tpu_torch.ops.cuda.raster_grad_cuda import (
    fold_entries, pixel_grad)
from fpc_diffrend_tpu_torch.ops.cuda.rasterize_cuda import (
    _AREA_EPS, _W_EPS, PAY_CORNERS, PAY_TU, PAY_TV, PAY_U, PAY_UVZ, PAY_V,
    _screen_xy, aux_records, bin_scene_stacked, fused_raster,
    fused_raster_aa, pad_resolution)
from fpc_diffrend_tpu_torch.ops.cuda.texture_cuda import (
    texture_planes, texture_planes_bwd)
from fpc_diffrend_tpu_torch.ops.cuda.texture_mip_cuda import (
    mip_sample_bwd, mip_sample_lod)
from fpc_diffrend_tpu_torch.ops.interpolate import gather_rows, interpolate
from fpc_diffrend_tpu_torch.ops.precision import get_precision
from fpc_diffrend_tpu_torch.ops.texture_mip import mip_pyramid
from fpc_diffrend_tpu_torch.utils.profiling import span

Tensor = torch.Tensor


def _raster(ctx, data_b, bins, tex, sample_ph, height, width, aa=False):
    """K1 over the stacked image (``tex`` None: no texture tail); with
    ``aa``, K10 (K1's outputs and the antialiased colour). Keeps the
    gradient precision for the backward in ``ctx.prec``."""
    B, T = data_b.shape[:2]
    _, pw = pad_resolution(height, width)
    ctx.bins = bins
    ctx.dims = (B, T, sample_ph, height, width)
    ctx.prec = get_precision()
    if aa:
        return fused_raster_aa(bins, tex, B * sample_ph, pw, height, width,
                               sample_ph)
    return fused_raster(bins, tex, B * sample_ph, pw)


def _records_bwd(ctx, entry, payload, extra, gtu, gtv, gcorners, guvz=None):
    """K5 -> K6: the cotangents of the payload's u, v, z (``guvz`` (3,
    rows, pw); None: zero, and K5 reads none), of the sampled uv and of the
    screen corners into the (B, T, 16) data and aux records; K5 reads each
    plane where K3 and the sampler's backward wrote it, at the forward's
    gradient precision."""
    B, T = ctx.dims[:2]
    # the textured pass's u, v and z never leave the op but for the band
    # render's edge rows (the antialias differentiates only corners and
    # colour)
    grad_entries, grad_global = pixel_grad(
        ctx.bins, entry, payload[PAY_U], payload[PAY_V], extra, gtu, gtv,
        gcorners, guvz, ctx.prec.grad == "fast")
    grad = fold_entries(grad_entries, grad_global, ctx.bins, B * T)
    return grad[:, :16].reshape(B, T, 16), grad[:, 16:].reshape(B, T, 16)


# ---- the samplers between K1 and K2 (forward) and K3 and K5 (backward) ----

def _k7(ctx, idbuf, payload, tex, sizes):
    """K7, the standalone bilinear wrap sampler, on K1's uv planes."""
    return texture_planes(tex, payload[PAY_TU], payload[PAY_TV], "wrap"), ()


def _k8(ctx, idbuf, payload, pyramid, sizes):
    """K8 deriving the LOD from K1's uv and ids (span ``raster.mip_fwd``):
    colour (C, rows, pw), and the LOD plane (rows, pw) kept for K9."""
    _, _, sample_ph, height, width = ctx.dims
    with span("raster.mip_fwd"):
        colour, lam = mip_sample_lod(pyramid, sizes, payload[PAY_TU],
                                     payload[PAY_TV], idbuf, height, width,
                                     sample_ph)
    return colour, (lam,)


def _k4(ctx, payload, tex, kept, gcolour):
    """K4 on K1's uv planes, at the forward's texture precision: (gtex,
    gtu, gtv)."""
    return texture_planes_bwd(tex, payload[PAY_TU], payload[PAY_TV], gcolour,
                              "wrap", ctx.prec.tex)


def _k9(ctx, payload, pyramid, kept, gcolour):
    """K9 (span ``raster.mip_bwd``; the LOD is held out of the gradient):
    (gpyr, gtu, gtv)."""
    with span("raster.mip_bwd"):
        return mip_sample_bwd(pyramid, ctx.sizes, payload[PAY_TU],
                              payload[PAY_TV], kept[0], gcolour)


# name -> (K1's mode: "tail" with its texture tail, "aa" K10 (K1 and K2
# from one entry point), "plain" without the tail; the sampler after a
# plain K1 (ctx, idbuf, payload, tex, sizes) -> (colour, tensors kept for
# its backward); the backward (ctx, payload, tex, kept, gcolour) -> (gtex,
# gtu, gtv)). The first three are the single view's routes, "mip" the
# trilinear mip path, whose tex is the flat pyramid.
SAMPLERS = {"sepaa": ("tail", None, _k4),
            "aa_fused": ("aa", None, _k4),
            "separate": ("plain", _k7, _k4),
            "mip": ("plain", _k8, _k9)}
ROUTES = ("sepaa", "aa_fused", "separate")


def _edge_rows(ctx, payload, colour):
    """(colour (C, B, 2, pw), uvz (3, B, 2, pw)): each stacked sample's
    first and last image rows (``b * ph`` and ``b * ph + height - 1``,
    GL bottom-up) of the pre-antialias colour and the payload's u, v, z,
    for the antialias seam between image row-bands
    (``parallel.spatial``)."""
    B, _, sample_ph, height, _ = ctx.dims
    first = torch.arange(B, device=colour.device) * sample_ph
    ctx.edge_rows = torch.stack([first, first + height - 1], 1).reshape(-1)
    pw = colour.shape[-1]
    return (colour[:, ctx.edge_rows].reshape(-1, B, 2, pw),
            payload[PAY_UVZ, ctx.edge_rows].reshape(3, B, 2, pw))


def _add_edge_grads(ctx, gcolour, g_colour_rows, g_uvz_rows):
    """The edge rows' cotangents added into K3's colour cotangent (before
    the sampler's backward) and into u, v, z planes for K5."""
    rows = ctx.edge_rows
    pw = gcolour.shape[-1]
    gcolour = gcolour.index_add(1, rows, g_colour_rows.reshape(
        gcolour.shape[0], -1, pw))
    guvz = torch.zeros((3,) + gcolour.shape[1:], device=gcolour.device)
    guvz.index_add_(1, rows, g_uvz_rows.reshape(3, -1, pw))
    return gcolour, guvz


class RasterizeTextured(torch.autograd.Function):
    """The textured pass: K1 -> sampler -> K2 forward, K3 -> the sampler's
    backward -> K5 -> K6 backward.

    ``apply(data_b, aux_b, tex, bins, sample_ph, height, width, sampler,
    sizes, edge_rows)``:

    :param data_b, aux_b: (B, T, 16) records, each in its sample's own
        frame (``bin_scene_stacked``), differentiable.
    :param tex: (TH, TW, C) texture; for the sampler "mip" the flat mip
        pyramid (n_texels, C) (``ops.texture_mip.mip_pyramid``);
        differentiable.
    :param bins: the Bins built from the same records (no gradient).
    :param sample_ph: row pitch of the stacked samples.
    :param height, width: one sample's real size.
    :param sampler: a key of :data:`SAMPLERS`.
    :param sizes: the pyramid's level sizes (sampler "mip"; else None).
    :param edge_rows: also return each sample's edge rows
        (:func:`_edge_rows`), whose cotangents join the backward.
    :return: (idbuf (B*ph, pw) int32, aa (C, B*ph, pw) antialiased colour
        before the background composite); with ``edge_rows`` also (colour
        rows (C, B, 2, pw), uvz rows (3, B, 2, pw)).
    """

    @staticmethod
    def forward(ctx, data_b, aux_b, tex, bins, sample_ph, height, width,
                sampler="sepaa", sizes=None, edge_rows=False):
        k1, sample, _ = SAMPLERS[sampler]
        ctx.sampler, ctx.sizes = sampler, sizes
        out = _raster(ctx, data_b, bins, None if k1 == "plain" else tex,
                      sample_ph, height, width, aa=k1 == "aa")
        idbuf, entry, payload, extra, colour = out[:5]
        kept = ()
        if sample is not None:
            colour, kept = sample(ctx, idbuf, payload, tex, sizes)
        ctx.save_for_backward(idbuf, entry, payload, extra, colour, tex,
                              *kept)
        ctx.mark_non_differentiable(idbuf)
        aa = out[5] if k1 == "aa" else antialias_planes(
            idbuf, payload, colour, height, width, sample_ph)
        if not edge_rows:
            return idbuf, aa
        return (idbuf, aa, *_edge_rows(ctx, payload, colour))

    @staticmethod
    def backward(ctx, _g_id, g_aa, *g_rows):
        with span("raster.bwd"):
            idbuf, entry, payload, extra, colour, tex, *kept = (
                ctx.saved_tensors)
            _, _, sample_ph, height, width = ctx.dims
            gcolour, gcorners = antialias_planes_bwd(
                idbuf, payload, colour, g_aa.contiguous(), height, width,
                sample_ph)
            guvz = None
            if g_rows:
                gcolour, guvz = _add_edge_grads(ctx, gcolour, *g_rows)
            gtex, gtu, gtv = SAMPLERS[ctx.sampler][2](ctx, payload, tex,
                                                      kept, gcolour)
            return (*_records_bwd(ctx, entry, payload, extra, gtu, gtv,
                                  gcorners, guvz),
                    gtex) + (None,) * 7


def bin_stacked(pos_clip_b: Tensor, faces: Tensor, uv: Tensor,
                uv_idx: Tensor, face_neighbors: Tensor, resolution,
                entry_cap: int = 0):
    """Aux records and stacked binning for a batch of clip positions.

    :param entry_cap: per-sample bin-entry cap (0: uncapped).
    :return: (data_b, aux_b (B, T, 16) records, differentiable,
        Bins over the (B * ph, pw) stacked image).
    """
    height, width = resolution
    with span("raster.bin"):
        aux_b = aux_records(uv, uv_idx, pos_clip_b, faces, face_neighbors,
                            height, width)
        return bin_scene_stacked(pos_clip_b, faces, height, width, aux_b,
                                 entry_cap)


def rasterize_textured_sepaa_stacked(pos_clip_b: Tensor, faces: Tensor,
                                     uv: Tensor, uv_idx: Tensor, tex: Tensor,
                                     face_neighbors: Tensor, resolution,
                                     pair_cap: int | None = None,
                                     enable_mip: bool = False,
                                     max_mip_level: int = 0,
                                     route: str = "sepaa",
                                     edge_rows: bool = False):
    """Render B samples through one pass of each kernel.

    :param pos_clip_b: (B, V, 4) clip positions per sample.
    :param tex: (TH, TW, C) texture.
    :param pair_cap: per-sample bin-entry cap (``FitConfig.pair_cap``;
        None or 0: uncapped).
    :param enable_mip: sample trilinearly across the mip chain of up to
        ``max_mip_level`` levels below the texture (K8, K9) instead of
        bilinearly (K1's tail, K4).
    :param route: the bilinear path's kernels, one of :data:`ROUTES`
        ("sepaa": K1 -> K2; "aa_fused": K10; "separate": K1 -> K7 -> K2);
        the mip path has one route.
    :param edge_rows: also return each sample's edge rows of the
        pre-antialias colour and of u, v, z (the band render's seam,
        ``parallel.spatial``).
    :return: (idbuf (B*ph, pw) int32, aa (C, B*ph, pw) antialiased colour
        before the background composite), differentiable with respect to
        ``pos_clip_b`` and ``tex``; with ``edge_rows`` also the rows, as
        :class:`RasterizeTextured` returns them.
    """
    if route not in ROUTES:
        raise ValueError(f"unknown route {route!r}; one of {list(ROUTES)}")
    height, width = resolution
    ph, _ = pad_resolution(height, width)
    data_b, aux_b, bins = bin_stacked(pos_clip_b, faces, uv, uv_idx,
                                      face_neighbors, resolution,
                                      pair_cap or 0)
    with span("raster.fwd"):
        sampler, sizes = route, None
        if enable_mip:
            sampler = "mip"
            with span("raster.pyramid"):
                tex, sizes = mip_pyramid(tex, max_mip_level)
        return RasterizeTextured.apply(data_b, aux_b, tex, bins, ph, height,
                                       width, sampler, sizes, edge_rows)


# ----------------------------------------------------------------------------
# The nvdiffrast-style primitive: rasterize, rasterize_with_uv
# ----------------------------------------------------------------------------

def screen_vertices(pos_clip: Tensor, width: int, height: int) -> Tensor:
    """Clip-space (V, 4) -> screen-space (V, 3) = (sx, sy, z_ndc),
    differentiable; w is guarded by a tiny epsilon (triangles with a
    vertex at w <= eps are masked out where they are tested)."""
    sx, sy, z, _ = _screen_xy(pos_clip, height, width)
    return torch.stack([sx, sy, z], dim=1)


def _tri_screen(pos_clip: Tensor, faces: Tensor, width: int, height: int):
    """Per-triangle (p (T, 3, 2) screen xy, zndc (T, 3), w (T, 3),
    valid (T,)): every vertex in front of w = eps."""
    sv = screen_vertices(pos_clip, width, height)[faces]     # (T, 3, 3)
    w = pos_clip[:, 3][faces]
    return sv[..., :2], sv[..., 2], w, torch.all(w > _W_EPS, dim=1)


def visibility_scan(pos_clip: Tensor, faces: Tensor, height: int,
                    width: int, chunk: int = 8) -> Tensor:
    """Winning triangle id per pixel by a full-image z-buffered test of
    every triangle: the O(T·H·W) reference rasterizer (the JAX package's
    XLA scan), plain torch on either device.

    ``chunk`` triangles are tested at once; the nearest covering one of a
    chunk replaces the buffer only where strictly nearer, and a tie goes to
    the lower index, as the JAX scan's strict ``z < zbuf`` in triangle
    order gives.

    :return: (H, W) int32; -1 = background, else triangle index.
    """
    dev = pos_clip.device
    p, zndc, _, valid = _tri_screen(pos_clip, faces, width, height)
    px = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
    py = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5)[:, None]
    zbuf = torch.full((height, width), float("inf"), device=dev)
    idbuf = torch.full((height, width), -1, dtype=torch.int32, device=dev)
    for t0 in range(0, faces.shape[0], chunk):
        c = p[t0:t0 + chunk, :, :, None, None]             # (n, 3, 2, 1, 1)
        (ax, ay), (bx, by), (cx, cy) = (c[:, k].unbind(1) for k in range(3))
        area = edge_fn(ax, ay, bx, by, cx, cy)
        big = torch.abs(area) > _AREA_EPS
        inv_area = torch.where(big, 1.0 / torch.where(big, area, 1.0), 0.0)
        l0 = edge_fn(bx, by, cx, cy, px, py) * inv_area
        l1 = edge_fn(cx, cy, ax, ay, px, py) * inv_area
        l2 = edge_fn(ax, ay, bx, by, px, py) * inv_area
        ok = valid[t0:t0 + chunk, None, None] & big
        covered = (l0 >= 0) & (l1 >= 0) & (l2 >= 0) & ok
        z0, z1, z2 = zndc[t0:t0 + chunk, :, None, None].unbind(1)
        z = l0 * z0 + l1 * z1 + l2 * z2
        zmin, k = torch.where(covered, z, float("inf")).min(dim=0)
        closer = zmin < zbuf
        zbuf = torch.where(closer, zmin, zbuf)
        idbuf = torch.where(closer, (k + t0).to(torch.int32), idbuf)
    return idbuf


def _pixel_grid(height: int, width: int, dev):
    """(px, py) (H, W) pixel centres."""
    px = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
    py = torch.arange(height, dtype=torch.float32, device=dev) + 0.5
    return px.expand(height, width), py[:, None].expand(height, width)


def _bary_derivatives(dl, iw, u, v, inv_denom):
    """(H, W, 4) (du/dx, du/dy, dv/dx, dv/dy) of the perspective-correct
    barycentrics from the affine ones' (dl0/dx, dl0/dy, ..., dl2/dy)."""
    dd = [dl[2 * i + j] * iw[i] for i in range(3) for j in range(2)]
    ddenom_dx = dd[0] + dd[2] + dd[4]
    ddenom_dy = dd[1] + dd[3] + dd[5]
    return torch.stack([(dd[0] - u * ddenom_dx) * inv_denom,
                        (dd[1] - u * ddenom_dy) * inv_denom,
                        (dd[2] - v * ddenom_dx) * inv_denom,
                        (dd[3] - v * ddenom_dy) * inv_denom], dim=-1)


def _safe_inverse(x, eps):
    big = torch.abs(x) > eps
    return torch.where(big, 1.0 / torch.where(big, x, 1.0), 0.0)


def pixel_attributes(pos_clip: Tensor, faces: Tensor, idbuf: Tensor,
                     height: int, width: int, with_db: bool = False):
    """Perspective-correct (u, v, z) per pixel from the winning triangle
    ids, differentiable with respect to ``pos_clip`` (the ids held fixed,
    as nvdiffrast's rasterize backward holds them).

    :param idbuf: (H, W) int winning triangle index, -1 = background.
    :param with_db: also return (du/dx, du/dy, dv/dx, dv/dy).
    :return: (u, v, z, mask[, db]), each (H, W), db (H, W, 4).
    """
    ids = torch.clamp(idbuf, min=0)
    mask = idbuf >= 0
    p, zndc, w, _ = _tri_screen(pos_clip, faces, width, height)
    tp, tz, tw = (gather_rows(x, ids) for x in (p, zndc, w))
    px, py = _pixel_grid(height, width, pos_clip.device)
    ax, ay = tp[..., 0, 0], tp[..., 0, 1]
    bx, by = tp[..., 1, 0], tp[..., 1, 1]
    cx, cy = tp[..., 2, 0], tp[..., 2, 1]
    inv_area = _safe_inverse(edge_fn(ax, ay, bx, by, cx, cy), _AREA_EPS)
    l0 = edge_fn(bx, by, cx, cy, px, py) * inv_area
    l1 = edge_fn(cx, cy, ax, ay, px, py) * inv_area
    l2 = edge_fn(ax, ay, bx, by, px, py) * inv_area
    iw = (1.0 / tw).unbind(-1)
    d0, d1, d2 = l0 * iw[0], l1 * iw[1], l2 * iw[2]
    inv_denom = _safe_inverse(d0 + d1 + d2, _AREA_EPS)
    u = d0 * inv_denom
    v = d1 * inv_denom
    z = l0 * tz[..., 0] + l1 * tz[..., 1] + l2 * tz[..., 2]
    u_m = torch.where(mask, u, 0.0)
    v_m = torch.where(mask, v, 0.0)
    z = torch.where(mask, z, 0.0)
    if not with_db:
        return u_m, v_m, z, mask
    # the affine barycentrics' screen derivatives
    dl = [-(cy - by) * inv_area, (cx - bx) * inv_area,
          -(ay - cy) * inv_area, (ax - cx) * inv_area,
          -(by - ay) * inv_area, (bx - ax) * inv_area]
    db = _bary_derivatives(dl, iw, u_m, v_m, inv_denom)
    return u_m, v_m, z, mask, torch.where(mask[..., None], db, 0.0)


def _pixel_db_from_data(data: Tensor, idbuf: Tensor, height: int,
                        width: int) -> Tensor:
    """(H, W, 4) perspective-correct barycentric pixel derivatives from the
    (T, 16) triangle records (``triangle_setup``: slots 0-8 the edge planes,
    13-15 w): dlambda_i/dx = a_i, dlambda_i/dy = b_i. Differentiable
    through the record gather."""
    mask = idbuf >= 0
    f = gather_rows(data, torch.clamp(idbuf, min=0)).unbind(-1)
    px, py = _pixel_grid(height, width, data.device)
    l0 = f[0] * px + f[1] * py + f[2]
    l1 = f[3] * px + f[4] * py + f[5]
    l2 = f[6] * px + f[7] * py + f[8]
    iw = [1.0 / torch.where(torch.abs(w) > _W_EPS, w, 1.0)
          for w in f[13:16]]
    d0, d1, d2 = l0 * iw[0], l1 * iw[1], l2 * iw[2]
    inv_denom = _safe_inverse(d0 + d1 + d2, _AREA_EPS)
    u = d0 * inv_denom
    v = d1 * inv_denom
    db = _bary_derivatives([f[0], f[1], f[3], f[4], f[6], f[7]], iw, u, v,
                           inv_denom)
    return torch.where(mask[..., None], db, 0.0)


class RasterizeKernel(torch.autograd.Function):
    """K1 without its texture tail forward, K5 -> K6 backward: the port of
    JAX's ``rasterize_fused`` custom VJP as ``_rasterize_pallas_full``
    uses it.

    ``apply(data_b, aux_b, bins, sample_ph, height, width)``: records and
    bins as :class:`RasterizeTextured` takes them.

    :return: (idbuf (rows, pw) int32, payload (14, rows, pw) [u v z tu tv
        x0 y0 x1 y1 x2 y2 n0 n1 n2]), padded; the cotangents of payload
        planes 0-10 reach the records (the neighbour ids have none).
    """

    @staticmethod
    def forward(ctx, data_b, aux_b, bins, sample_ph, height, width):
        idbuf, entry, payload, extra, _ = _raster(
            ctx, data_b, bins, None, sample_ph, height, width)
        ctx.save_for_backward(entry, payload, extra)
        ctx.mark_non_differentiable(idbuf)
        return idbuf, payload

    @staticmethod
    def backward(ctx, _g_id, g_payload):
        with span("raster.bwd"):
            entry, payload, extra = ctx.saved_tensors
            g = g_payload.contiguous()
            return (*_records_bwd(ctx, entry, payload, extra, g[PAY_TU],
                                  g[PAY_TV], g[PAY_CORNERS], g[PAY_UVZ]),
                    None, None, None, None)


def check_impl(impl: str) -> str:
    """The rasterizer ``impl`` names (``render``'s argument and
    ``FitConfig.raster_impl``): "pallas" for "auto" and "pallas" (the
    kernels), "scan" for "scan" (the O(T·H·W) reference rasterizer).

    :raises ValueError: for any other value.
    """
    if impl in ("auto", "pallas"):
        return "pallas"
    if impl == "scan":
        return "scan"
    raise ValueError(f"unknown rasterize impl {impl!r}")


def _rasterize_kernel(pos_clip: Tensor, faces: Tensor, uv, uv_idx,
                      resolution):
    """The kernel route at B = 1: aux records, K11's binning, K1 without
    its texture tail, cropped to (H, W).

    :return: (rast (H, W, 4), texc (H, W, 2), data (T, 16) records,
        idbuf (H, W) int32).
    """
    height, width = resolution
    if uv is None:
        uv = torch.zeros((1, 2), device=pos_clip.device)
        uv_idx = torch.zeros_like(faces)
    ph, _ = pad_resolution(height, width)
    data_b, aux_b, bins = bin_stacked(pos_clip[None], faces, uv, uv_idx,
                                      None, resolution)
    with span("raster.fwd"):
        idbuf_p, payload_p = RasterizeKernel.apply(data_b, aux_b, bins, ph,
                                                   height, width)
    idbuf = idbuf_p[:height, :width]
    payload = payload_p[:, :height, :width]
    idf = torch.where(idbuf >= 0, (idbuf + 1).to(torch.float32), 0.0)
    rast = torch.stack([*payload[PAY_UVZ], idf], dim=-1)
    texc = torch.stack([payload[PAY_TU], payload[PAY_TV]], dim=-1)
    return rast, texc, data_b[0], idbuf


def rasterize(pos_clip: Tensor, faces: Tensor, resolution,
              impl: str = "auto", with_db: bool = True):
    """Rasterize clip-space triangles; nvdiffrast-compatible output, on
    the device of ``pos_clip``.

    :param pos_clip: (V, 4) float32 clip-space positions.
    :param faces: (T, 3) int triangle vertex indices.
    :param resolution: (height, width).
    :param impl: "pallas" (JAX's name of the kernel route): K11 bins, K1
        rasterizes, K5 -> K6 differentiate; "scan": the O(T·H·W)
        :func:`visibility_scan` and the autograd of
        :func:`pixel_attributes`; "auto": the kernel route on every device
        (JAX's "auto" takes the scan route off the TPU). JAX's
        ``interpret`` switch has no counterpart.
    :param with_db: also return the (H, W, 4) barycentric derivatives.
    :return: rast (H, W, 4) = (u, v, z_ndc, tri_id + 1), id 0 the
        background; with ``with_db`` also rast_db (H, W, 4) = (du/dx,
        du/dy, dv/dx, dv/dy) in pixels. Row 0 is the bottom row.
    """
    height, width = resolution
    if check_impl(impl) == "pallas":
        rast, _, data, idbuf = _rasterize_kernel(pos_clip, faces, None, None,
                                                 resolution)
        if with_db:
            return rast, _pixel_db_from_data(data, idbuf, height, width)
        return rast
    idbuf = visibility_scan(pos_clip.detach(), faces, height, width)
    u, v, z, mask, *db = pixel_attributes(pos_clip, faces, idbuf, height,
                                          width, with_db=with_db)
    idf = torch.where(mask, (idbuf + 1).to(torch.float32), 0.0)
    rast = torch.stack([u, v, z, idf], dim=-1)
    return (rast, db[0]) if with_db else rast


def rasterize_with_uv(pos_clip: Tensor, faces: Tensor, uv: Tensor,
                      uv_idx: Tensor, resolution, impl: str = "auto"):
    """Rasterize and interpolate the uv coordinates: on the kernel route K1
    resolves the winner's perspective-correct uv in its pass; on the scan
    route :func:`rasterize` then ``ops.interpolate.interpolate``.

    :param impl: as :func:`rasterize`.
    :return: (rast (H, W, 4), texc (H, W, 2)).
    """
    if check_impl(impl) == "pallas":
        return _rasterize_kernel(pos_clip, faces, uv, uv_idx, resolution)[:2]
    rast = rasterize(pos_clip, faces, resolution, impl=impl, with_db=False)
    return rast, interpolate(uv, rast, uv_idx)[0]
