"""Plain PyTorch reference of one view's render, forward only; autograd
gives its backward.

It imports nothing of the program. Its arithmetic follows the render the
program is held to, written out again one view at a time:

* clip -> screen: ndc = xyz / w, sx = (ndc_x + 1) W / 2, sy = (ndc_y + 1)
  H / 2, row 0 at the bottom (GL);
* coverage: the three edge planes lambda_i = a_i x + (b_i y + c_i),
  normalised by the signed area (no culling), all >= 0 at the pixel centre,
  and the depth plane z in [-1, 1]; the nearest z wins and a tie goes to
  the lower triangle index. Candidate pixels are each triangle's bounding
  box, padded by one pixel, so no tile binning is involved;
* perspective-correct barycentrics u, v from lambda_i / w_i, and the uv
  corners' interpolation tu = u (u0 - u2) + v (u1 - u2) + u2; a pixel no
  triangle covers samples uv (0, 0);
* bilinear texture sampling with wrap (texel (i, j) spans [i / size,
  (i + 1) / size), sample position uv * size - 0.5), or trilinear across
  the box-filtered mip chain with the LOD from one-pixel differences of
  the uv image between pixels of one triangle, held out of the gradient;
* nvdiffrast's analytic silhouette antialias over every horizontal and
  vertical pixel pair whose triangles differ: the occluder's edge that
  crosses the segment between the centres, unless the other pixel's
  triangle shares it, blends the two colours by the crossing point;
* the 45/255 background painted over every pixel no triangle covers.
"""

from __future__ import annotations

import torch

AREA_EPS = 1e-12
W_EPS = 1e-9
BACKGROUND = 45.0 / 255.0
CANDIDATES = 1 << 24       # candidate (triangle, pixel) pairs at a time
NO_HIT = torch.iinfo(torch.int64).max


def screen(clip: torch.Tensor, height: int, width: int):
    """(V, 4) clip positions -> (sx, sy, z_ndc, w), each (V,)."""
    w = clip[:, 3]
    safe_w = torch.where(torch.abs(w) > W_EPS, w, W_EPS)
    ndc = clip[:, :3] / safe_w[:, None]
    sx = (ndc[:, 0] + 1.0) * (0.5 * width)
    sy = (ndc[:, 1] + 1.0) * (0.5 * height)
    return sx, sy, ndc[:, 2], w


def triangle_planes(clip: torch.Tensor, faces: torch.Tensor, height: int,
                    width: int) -> dict:
    """Per-triangle planes and corners, differentiable w.r.t. ``clip``.

    :return: dict of (T,) tensors: a0 b0 c0 a1 b1 c1 a2 b2 c2 (edge
        planes), zx zy zc (depth plane), w0 w1 w2, x0 y0 x1 y1 x2 y2
        (screen corners), valid (bool).
    """
    sx, sy, sz, w = screen(clip, height, width)
    f = faces.long()
    x0, x1, x2 = sx[f].unbind(-1)
    y0, y1, y2 = sy[f].unbind(-1)
    z0, z1, z2 = sz[f].unbind(-1)
    fw = w[f]
    area = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)
    big = torch.abs(area) > AREA_EPS
    valid = torch.all(fw > W_EPS, dim=-1) & big
    inv = torch.where(valid, 1.0 / torch.where(big, area, 1.0), 0.0)

    def coeffs(ax, ay, bx, by):
        return (-(by - ay) * inv, (bx - ax) * inv,
                (by - ay) * ax * inv - (bx - ax) * ay * inv)

    a0, b0, c0 = coeffs(x1, y1, x2, y2)
    a1, b1, c1 = coeffs(x2, y2, x0, y0)
    a2, b2, c2 = coeffs(x0, y0, x1, y1)
    w0, w1, w2 = fw.unbind(-1)
    return dict(a0=a0, b0=b0, c0=c0, a1=a1, b1=b1, c1=c1, a2=a2, b2=b2,
                c2=c2, zx=a0 * z0 + a1 * z1 + a2 * z2,
                zy=b0 * z0 + b1 * z1 + b2 * z2,
                zc=c0 * z0 + c1 * z1 + c2 * z2, w0=w0, w1=w1, w2=w2,
                x0=x0, y0=y0, x1=x1, y1=y1, x2=x2, y2=y2, valid=valid)


def _plane(a, b, c, x, y):
    return a * x + (b * y + c)


def _sortable(z: torch.Tensor) -> torch.Tensor:
    """float32 -> int64 keys in the same order."""
    bits = z.contiguous().view(torch.int32)
    return (bits ^ ((bits >> 31) & 0x7FFFFFFF)).to(torch.int64)


def winners(planes: dict, height: int, width: int) -> torch.Tensor:
    """(H, W) int64 winning triangle per pixel, -1 where none covers it."""
    p = {k: v.detach() for k, v in planes.items()}
    dev = p["a0"].device
    xs = torch.stack([p["x0"], p["x1"], p["x2"]])
    ys = torch.stack([p["y0"], p["y1"], p["y2"]])
    ix0 = torch.clamp(torch.floor(xs.amin(0)) - 1, 0, width - 1).long()
    ix1 = torch.clamp(torch.ceil(xs.amax(0)) + 1, -1, width - 1).long()
    iy0 = torch.clamp(torch.floor(ys.amin(0)) - 1, 0, height - 1).long()
    iy1 = torch.clamp(torch.ceil(ys.amax(0)) + 1, -1, height - 1).long()
    nx = torch.clamp(ix1 - ix0 + 1, min=0)
    ny = torch.clamp(iy1 - iy0 + 1, min=0)
    onscreen = (xs.amax(0) >= 0) & (xs.amin(0) < width) & \
        (ys.amax(0) >= 0) & (ys.amin(0) < height)
    counts = torch.where(p["valid"] & onscreen, nx * ny, 0)
    best = torch.full((height * width,), NO_HIT, dtype=torch.int64,
                      device=dev)
    ends = torch.cumsum(counts, 0).cpu()
    T = counts.shape[0]
    t0 = 0
    while t0 < T:
        base = int(ends[t0 - 1]) if t0 else 0
        t1 = int(torch.searchsorted(ends, base + CANDIDATES, right=True))
        t1 = min(max(t1, t0 + 1), T)
        cnt = counts[t0:t1]
        tri = torch.repeat_interleave(torch.arange(t0, t1, device=dev), cnt)
        if tri.numel():
            start = torch.cumsum(cnt, 0) - cnt
            local = torch.arange(tri.numel(), device=dev) - start[tri - t0]
            px_i = ix0[tri] + local % nx[tri]
            py_i = iy0[tri] + local // nx[tri]
            px = px_i.to(torch.float32) + 0.5
            py = py_i.to(torch.float32) + 0.5
            g = {k: p[k][tri] for k in ("a0", "b0", "c0", "a1", "b1", "c1",
                                        "a2", "b2", "c2", "zx", "zy", "zc")}
            z = _plane(g["zx"], g["zy"], g["zc"], px, py)
            cov = ((_plane(g["a0"], g["b0"], g["c0"], px, py) >= 0.0)
                   & (_plane(g["a1"], g["b1"], g["c1"], px, py) >= 0.0)
                   & (_plane(g["a2"], g["b2"], g["c2"], px, py) >= 0.0)
                   & (z >= -1.0) & (z <= 1.0))
            key = _sortable(z[cov]) * (1 << 32) + tri[cov]
            best.scatter_reduce_(0, (py_i * width + px_i)[cov], key, "amin")
        t0 = t1
    hit = best != NO_HIT
    return torch.where(hit, best & 0xFFFFFFFF, -1).reshape(height, width)


def gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` by ``index_select``, whose backward adds rows with
    atomics (advanced indexing's sorts its indices and sums each run of
    equal ones serially, which every background pixel reading one row
    turns into seconds a view)."""
    rows = torch.index_select(table.reshape(table.shape[0], -1), 0,
                              idx.reshape(-1))
    return rows.reshape(*idx.shape, *table.shape[1:])


PLANE_KEYS = ("a0", "b0", "c0", "a1", "b1", "c1", "a2", "b2", "c2", "zx",
              "zy", "zc", "w0", "w1", "w2", "x0", "y0", "x1", "y1", "x2",
              "y2")


def pixel_planes(planes: dict, ids: torch.Tensor, uv: torch.Tensor,
                 uv_idx: torch.Tensor, height: int, width: int) -> dict:
    """Per-pixel winner quantities, differentiable w.r.t. the planes.

    :return: dict of (H, W) tensors: tu, tv, z, and corners (6, H, W);
        zero where no triangle covers the pixel.
    """
    dev = ids.device
    T = planes["a0"].shape[0]
    hit = ids >= 0
    # a zero row for the pixels no triangle covers
    row = torch.where(hit, ids, T)
    table = torch.cat([torch.stack([planes[k] for k in PLANE_KEYS], 1),
                       torch.zeros((1, len(PLANE_KEYS)), device=dev)])
    f = dict(zip(PLANE_KEYS, gather(table, row).unbind(-1)))
    x = (torch.arange(width, dtype=torch.float32, device=dev) + 0.5)
    y = (torch.arange(height, dtype=torch.float32, device=dev)
         + 0.5)[:, None]
    ls = [_plane(f[f"a{i}"], f[f"b{i}"], f[f"c{i}"], x, y) for i in range(3)]
    iw = [1.0 / torch.where(torch.abs(f[f"w{i}"]) > W_EPS, f[f"w{i}"], 1.0)
          for i in range(3)]
    d0, d1, d2 = ls[0] * iw[0], ls[1] * iw[1], ls[2] * iw[2]
    D = d0 + d1 + d2
    rD = 1.0 / torch.where(torch.abs(D) > AREA_EPS, D, 1.0)
    u, v = d0 * rD, d1 * rD
    corners_uv = torch.cat([uv[uv_idx.long()].reshape(-1, 6),
                            torch.zeros((1, 6), device=dev)])
    c = gather(corners_uv, row)
    du02, du12 = c[..., 0] - c[..., 4], c[..., 2] - c[..., 4]
    dv02, dv12 = c[..., 1] - c[..., 5], c[..., 3] - c[..., 5]
    tu = u * du02 + v * du12 + c[..., 4]
    tv = u * dv02 + v * dv12 + c[..., 5]
    z = _plane(f["zx"], f["zy"], f["zc"], x, y)
    corners = torch.stack([f[k] for k in ("x0", "y0", "x1", "y1", "x2",
                                          "y2")])
    zero = torch.zeros((), device=dev)
    return dict(tu=torch.where(hit, tu, zero), tv=torch.where(hit, tv, zero),
                z=torch.where(hit, z, zero),
                corners=torch.where(hit, corners, zero))


def _taps(tu, tv, th: int, tw: int, offset):
    """The four bilinear wrap taps' flat rows (00 01 10 11) into a level of
    th x tw texels starting at ``offset``, and the weights fs, ft."""
    s = tu * tw - 0.5
    t = tv * th - 0.5
    s0f, t0f = torch.floor(s), torch.floor(t)
    s0, t0 = s0f.long(), t0f.long()
    r0 = offset + torch.remainder(t0, th) * tw
    r1 = offset + torch.remainder(t0 + 1, th) * tw
    q0, q1 = torch.remainder(s0, tw), torch.remainder(s0 + 1, tw)
    return (r0 + q0, r0 + q1, r1 + q0, r1 + q1), s - s0f, t - t0f


def _blend(flat, idx, fs, ft):
    """(C, ...) bilinear blend of the taps of a flat (n, C) texel table."""
    c00, c01, c10, c11 = (gather(flat, i).movedim(-1, 0) for i in idx)
    top = c00 * (1 - fs) + c01 * fs
    bot = c10 * (1 - fs) + c11 * fs
    return top * (1 - ft) + bot * ft


def bilinear(tex: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Bilinear wrap sample of tex (TH, TW, C) at (...) planes -> (C, ...)."""
    th, tw, ch = tex.shape
    idx, fs, ft = _taps(u, v, th, tw, 0)
    return _blend(tex.reshape(th * tw, ch), idx, fs, ft)


def mip_levels(tex: torch.Tensor, max_level: int) -> list:
    """The box-filtered chain [tex, 2x2 means, ...], down to ``max_level``
    or a one-texel side."""
    levels = [tex]
    while len(levels) <= max_level and min(levels[-1].shape[:2]) >= 2:
        th, tw, c = levels[-1].shape
        levels.append(levels[-1].reshape(th // 2, 2, tw // 2, 2, c)
                      .mean(dim=(1, 3)))
    return levels


def lod(tu, tv, ids, th: int, tw: int) -> torch.Tensor:
    """LOD in levels from one-pixel differences of (tu th, tv tw) between
    pixels of one triangle: the forward difference, else the backward one,
    else 0; unclamped."""
    pad = torch.nn.functional.pad
    same_h = ids[:, 1:] == ids[:, :-1]
    same_v = ids[1:] == ids[:-1]

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

    s, t = tu * tw, tv * th
    dsdx, dtdx, dsdy, dtdy = fd_x(s), fd_x(t), fd_y(s), fd_y(t)
    rho2 = torch.maximum(dsdx * dsdx + dtdx * dtdx,
                         dsdy * dsdy + dtdy * dtdy)
    return 0.5 * torch.log2(torch.clamp(rho2, min=1e-20))


def trilinear(levels: list, tu, tv, lam) -> torch.Tensor:
    """Trilinear wrap sample between levels floor(lam) and floor(lam) + 1
    (lam clamped to the chain) -> (C, ...)."""
    n = len(levels)
    dev = tu.device
    ch = levels[0].shape[2]
    flat = torch.cat([lv.reshape(-1, ch) for lv in levels])
    sizes = torch.tensor([lv.shape[:2] for lv in levels], device=dev)
    offsets = torch.cumsum(sizes[:, 0] * sizes[:, 1], 0) - sizes[:, 0] * \
        sizes[:, 1]
    lc = torch.clamp(lam, 0.0, float(n - 1))
    lo_f = torch.floor(lc)
    frac = lc - lo_f
    lo = lo_f.long()
    hi_live = (lo + 1 < n) & (frac > 0)
    hi = torch.clamp(lo + 1, max=n - 1)

    def sample(level):
        th, tw = sizes[level, 0], sizes[level, 1]
        idx, fs, ft = _taps(tu, tv, th, tw, offsets[level])
        return _blend(flat, idx, fs, ft)

    out = sample(lo) * (1 - frac)
    return torch.where(hi_live, out + sample(hi) * frac, out)


def _edge(ax, ay, bx, by, px, py):
    return (bx - ax) * (py - ay) - (by - ay) * (px - ax)


def pair_delta(a: dict, b: dict, pax, pay, pbx, pby):
    """nvdiffrast's blend of aligned pixel pairs a, b: dicts of planes
    id, z, corners (6, ...), neigh (3, ...), colour (C, ...).

    :return: (delta_a, delta_b), each (C, ...).
    """
    differs = a["id"] != b["id"]
    inf = torch.tensor(float("inf"), device=a["z"].device)
    z_a = torch.where(a["id"] >= 0, a["z"], inf)
    z_b = torch.where(b["id"] >= 0, b["z"], inf)
    a_occ = z_a <= z_b
    occ_id = torch.where(a_occ, a["id"], b["id"])
    other_id = torch.where(a_occ, b["id"], a["id"])
    valid = differs & (occ_id >= 0)
    tv = torch.where(a_occ, a["corners"], b["corners"])
    neigh = torch.where(a_occ, a["neigh"], b["neigh"])
    best_xi = torch.zeros_like(z_a)
    best_score = torch.full_like(z_a, float("inf"))
    found = torch.zeros_like(differs)
    for j in range(3):
        k = (j + 1) % 3
        vax, vay, vbx, vby = tv[2 * j], tv[2 * j + 1], tv[2 * k], tv[2 * k + 1]
        f_a = _edge(vax, vay, vbx, vby, pax, pay)
        f_b = _edge(vax, vay, vbx, vby, pbx, pby)
        ok = ((f_a * f_b) < 0.0) & ~((neigh[j] >= 0) & (neigh[j] == other_id))
        denom = f_a - f_b
        xi = f_a / torch.where(torch.abs(denom) > 1e-20, denom, 1e-20)
        score = torch.abs(xi - 0.5)
        better = ok & (score < best_score)
        best_xi = torch.where(better, xi, best_xi)
        best_score = torch.where(better, score, best_score)
        found = found | ok
    delta = torch.where(valid & found, torch.clamp(best_xi - 0.5, -0.5, 0.5),
                        0.0)
    diff = a["colour"] - b["colour"]
    return (torch.where(delta < 0, -delta * (-diff), 0.0),
            torch.where(delta > 0, delta * diff, 0.0))


def antialias(colour, ids, z, corners, neigh):
    """Every horizontal, then every vertical, pair's deltas from the
    unblended colour (C, H, W), added up."""
    height, width = ids.shape
    dev = ids.device
    planes = dict(id=ids, z=z, corners=corners, neigh=neigh, colour=colour)
    x = torch.arange(width, dtype=torch.float32, device=dev) + 0.5
    y = (torch.arange(height, dtype=torch.float32, device=dev) + 0.5)[:, None]

    def cut(rows, cols):
        return {k: v[..., rows, cols] for k, v in planes.items()}

    full, head, tail = slice(None), slice(None, -1), slice(1, None)
    da, db = pair_delta(cut(full, head), cut(full, tail), x[:-1], y,
                        x[:-1] + 1.0, y)
    zero_col = torch.zeros_like(colour[..., :1])
    zero_row = torch.zeros_like(colour[..., :1, :])
    out = (colour + torch.cat([da, zero_col], -1)
           + torch.cat([zero_col, db], -1))
    da, db = pair_delta(cut(head, full), cut(tail, full), x, y[:-1], x,
                        y[:-1] + 1.0)
    return out + torch.cat([da, zero_row], -2) + torch.cat([zero_row, db], -2)


def render_view(clip, faces, uv, uv_idx, face_neighbors, tex, height: int,
                width: int, mip_level: int | None = None, stats=None):
    """One view's image (H, W, C), row 0 at the bottom, differentiable
    w.r.t. ``clip`` and ``tex``.

    :param mip_level: None: bilinear sampling; an int: trilinear over that
        many levels below the texture.
    :param stats: a dict to add the view's counts to (``covered``: pixels
        a triangle covers, ``edge_pairs``: pixel pairs whose triangles
        differ, ``views``).
    """
    planes = triangle_planes(clip, faces, height, width)
    ids = winners(planes, height, width)
    px = pixel_planes(planes, ids, uv, uv_idx, height, width)
    if mip_level is None:
        colour = bilinear(tex, px["tu"], px["tv"])
    else:
        levels = mip_levels(tex, mip_level)
        lam = lod(px["tu"].detach(), px["tv"].detach(), ids, tex.shape[0],
                  tex.shape[1])
        colour = trilinear(levels, px["tu"], px["tv"], lam)
    fn = face_neighbors.to(torch.float32)[torch.clamp(ids, min=0)]
    neigh = torch.where((ids >= 0)[..., None], fn, 0.0).movedim(-1, 0)
    aa = antialias(colour, ids.to(torch.float32), px["z"], px["corners"],
                   neigh)
    img = torch.where(ids >= 0, aa, BACKGROUND).movedim(0, -1)
    if stats is not None:
        hit = ids >= 0
        stats["covered"] = stats.get("covered", 0) + int(hit.sum())
        stats["edge_pairs"] = stats.get("edge_pairs", 0) + int(
            (ids[:, 1:] != ids[:, :-1]).sum() + (ids[1:] != ids[:-1]).sum())
        stats["views"] = stats.get("views", 0) + 1
    return img
