"""Analytic silhouette-edge antialiasing, plain PyTorch (nvdiffrast ``antialias``).

Port of ``fpc_diffrend_tpu.ops.antialias``'s ``_pair_blend_planes`` and
``antialias_fused``. For every horizontally or vertically adjacent pixel
pair whose triangle ids differ, the closer ("occluder") triangle's edge that
crosses the segment between the two pixel centres is found; if it is not
shared with the other pixel's triangle (a silhouette), the crossing point
xi in [0, 1] blends the two colours:

  delta = xi - 0.5;  delta > 0: b += delta * (c_a - c_b);
                     delta < 0: a += -delta * (c_b - c_a)

The occluder's geometry comes from per-pixel planes (the fused raster
kernel's payload), packed plane-major in the order
[id, z, x0 y0 x1 y1 x2 y2, n0 n1 n2, colour...] — the packing of
``fpc_diffrend_tpu.ops.pallas.antialias_tpu``. ``pair_delta`` keeps that
kernel's ``_pair_delta`` operand for operand, and the CUDA kernel
(``csrc/antialias.cu``) does the same. ``pair_grad`` is its backward,
written out by hand, which ``csrc/antialias_bwd.cu`` keeps operand for
operand.

The public ``antialias`` (JAX's, on a rast buffer and clip positions)
gathers each pixel's winner planes from ``rast`` and runs K2 forward and
K3 backward on them (:class:`AntialiasGathered`); with ``max_pairs`` it
is ``_antialias_compact``, JAX's ``_pair_blend`` on the differing pairs
its top-k keeps.
"""

from __future__ import annotations

import torch

from fpc_diffrend_tpu_torch.ops.interpolate import gather_rows

Tensor = torch.Tensor

ID, Z, V0, N0, C0 = 0, 1, 2, 8, 11     # packed plane indices


def edge_fn(ax, ay, bx, by, px, py):
    """Signed parallelogram area of (b - a) x (p - a)."""
    return (bx - ax) * (py - ay) - (by - ay) * (px - ax)


def pair_delta(a: Tensor, b: Tensor, pax, pay, pbx, pby):
    """Blend deltas for aligned packed pixel-pair planes.

    :param a, b: (11 + C, ...) packed planes of the two sides.
    :param pax, pay, pbx, pby: pixel centres, broadcastable to (...).
    :return: (delta_a (C, ...), delta_b (C, ...)).
    """
    id_a, id_b = a[ID], b[ID]
    differs = id_a != id_b
    inf = torch.tensor(float("inf"), dtype=a.dtype, device=a.device)
    z_a = torch.where(id_a >= 0.0, a[Z], inf)
    z_b = torch.where(id_b >= 0.0, b[Z], inf)
    a_occ = z_a <= z_b
    occ_id = torch.where(a_occ, id_a, id_b)
    other_id = torch.where(a_occ, id_b, id_a)
    valid = differs & (occ_id >= 0.0)

    tv = torch.where(a_occ, a[V0:V0 + 6], b[V0:V0 + 6])
    neigh = torch.where(a_occ, a[N0:N0 + 3], b[N0:N0 + 3])

    best_xi = torch.zeros_like(id_a)
    best_score = torch.full_like(id_a, float("inf"))
    found = torch.zeros_like(differs)
    for j in range(3):
        k = (j + 1) % 3
        vax, vay = tv[2 * j], tv[2 * j + 1]
        vbx, vby = tv[2 * k], tv[2 * k + 1]
        f_a = edge_fn(vax, vay, vbx, vby, pax, pay)
        f_b = edge_fn(vax, vay, vbx, vby, pbx, pby)
        crossing = (f_a * f_b) < 0.0
        shared = (neigh[j] >= 0.0) & (neigh[j] == other_id)
        ok = crossing & ~shared
        denom = f_a - f_b
        xi = f_a / torch.where(torch.abs(denom) > 1e-20, denom, 1e-20)
        score = torch.abs(xi - 0.5)
        better = ok & (score < best_score)
        best_xi = torch.where(better, xi, best_xi)
        best_score = torch.where(better, score, best_score)
        found = found | ok

    valid = valid & found
    delta = torch.clamp(best_xi - 0.5, -0.5, 0.5)
    delta = torch.where(valid, delta, 0.0)
    diff = a[C0:] - b[C0:]
    delta_b = torch.where(delta > 0, delta * diff, 0.0)
    delta_a = torch.where(delta < 0, -delta * (-diff), 0.0)
    return delta_a, delta_b


def pair_grad(a: Tensor, b: Tensor, pax, pay, pbx, pby, g_a: Tensor,
              g_b: Tensor):
    """Backward of :func:`pair_delta`, written out by hand.

    ``csrc/antialias_bwd.cu`` keeps it operand for operand. The clamp of
    delta passes the gradient inside (-0.5, 0.5) and half of it at a bound,
    as JAX's ``clip`` does.

    :param a, b: (11 + C, ...) packed planes of the two sides.
    :param g_a, g_b: (C, ...) cotangents of delta_a and delta_b.
    :return: (share_a, share_b), each (C + 6, ...): that side's colour
        cotangent, then the cotangents of its 6 screen corners (non-zero
        only on the occluding side).
    """
    id_a, id_b = a[ID], b[ID]
    differs = id_a != id_b
    inf = torch.tensor(float("inf"), dtype=a.dtype, device=a.device)
    z_a = torch.where(id_a >= 0.0, a[Z], inf)
    z_b = torch.where(id_b >= 0.0, b[Z], inf)
    a_occ = z_a <= z_b
    occ_id = torch.where(a_occ, id_a, id_b)
    other_id = torch.where(a_occ, id_b, id_a)
    valid = differs & (occ_id >= 0.0)

    tv = torch.where(a_occ, a[V0:V0 + 6], b[V0:V0 + 6])
    neigh = torch.where(a_occ, a[N0:N0 + 3], b[N0:N0 + 3])

    best_xi = torch.zeros_like(id_a)
    best_score = torch.full_like(id_a, float("inf"))
    found = torch.zeros_like(differs)
    bfa = torch.zeros_like(id_a)
    bfb = torch.zeros_like(id_a)
    bq = torch.ones_like(id_a)
    bj = torch.full_like(id_a, -1.0)
    for j in range(3):
        k = (j + 1) % 3
        vax, vay = tv[2 * j], tv[2 * j + 1]
        vbx, vby = tv[2 * k], tv[2 * k + 1]
        f_a = edge_fn(vax, vay, vbx, vby, pax, pay)
        f_b = edge_fn(vax, vay, vbx, vby, pbx, pby)
        crossing = (f_a * f_b) < 0.0
        shared = (neigh[j] >= 0.0) & (neigh[j] == other_id)
        ok = crossing & ~shared
        denom = f_a - f_b
        q = torch.where(torch.abs(denom) > 1e-20, denom, 1e-20)
        xi = f_a / q
        score = torch.abs(xi - 0.5)
        better = ok & (score < best_score)
        best_xi = torch.where(better, xi, best_xi)
        best_score = torch.where(better, score, best_score)
        bfa = torch.where(better, f_a, bfa)
        bfb = torch.where(better, f_b, bfb)
        bq = torch.where(better, q, bq)
        bj = torch.where(better, float(j), bj)
        found = found | ok

    valid = valid & found
    d0 = best_xi - 0.5
    delta = torch.where(valid, torch.clamp(d0, -0.5, 0.5), 0.0)
    gs = torch.where(delta > 0, g_b, torch.where(delta < 0, g_a, 0.0))
    diff = a[C0:] - b[C0:]
    gdelta = torch.zeros_like(id_a)
    for c in range(diff.shape[0]):
        gdelta = gdelta + gs[c] * diff[c]
    gd = delta * gs

    fac = torch.where((d0 > -0.5) & (d0 < 0.5), 1.0,
                      torch.where((d0 == -0.5) | (d0 == 0.5), 0.5, 0.0))
    gxi = gdelta * fac
    gden = torch.where(torch.abs(bfa - bfb) > 1e-20,
                       (-gxi * bfa) / (bq * bq), 0.0)
    gfa = gxi / bq + gden
    gfb = -gden
    gv = [torch.zeros_like(id_a) for _ in range(6)]
    for j in range(3):
        k = (j + 1) % 3
        sel = bj == float(j)
        vax, vay = tv[2 * j], tv[2 * j + 1]
        vbx, vby = tv[2 * k], tv[2 * k + 1]
        ax, cy = vbx - vax, vby - vay
        bya, exa = pay - vay, pax - vax
        byb, exb = pby - vay, pbx - vax
        gv[2 * j] = torch.where(
            sel, (-(gfa * bya) + gfa * cy) + (-(gfb * byb) + gfb * cy),
            gv[2 * j])
        gv[2 * j + 1] = torch.where(
            sel, (-(gfa * ax) + gfa * exa) + (-(gfb * ax) + gfb * exb),
            gv[2 * j + 1])
        gv[2 * k] = torch.where(sel, gfa * bya + gfb * byb, gv[2 * k])
        gv[2 * k + 1] = torch.where(sel, -(gfa * exa) + -(gfb * exb),
                                    gv[2 * k + 1])
    gv = torch.stack(gv)
    share_a = torch.cat([gd, torch.where(a_occ, gv, 0.0)])
    share_b = torch.cat([-gd, torch.where(a_occ, 0.0, gv)])
    return share_a, share_b


def antialias_fused(color: Tensor, rast: Tensor, verts_img: Tensor,
                    neigh_img: Tensor) -> Tensor:
    """Antialias one image from per-pixel winner planes (every pair).

    :param color: (H, W, C) shaded image.
    :param rast: (H, W, 4) rasterizer output (u, v, z, id + 1).
    :param verts_img: (H, W, 6) winning triangle's screen corners.
    :param neigh_img: (H, W, 3) winning triangle's neighbour-face ids.
    :return: (H, W, C) antialiased image.
    """
    height, width = color.shape[0], color.shape[1]
    packed = torch.cat([(rast[..., 3:4] - 1.0), rast[..., 2:3], verts_img,
                        neigh_img, color], dim=-1).movedim(-1, 0)
    x = torch.arange(width, dtype=torch.float32, device=color.device) + 0.5
    y = (torch.arange(height, dtype=torch.float32, device=color.device)
         + 0.5)[:, None]
    out = color.movedim(-1, 0).clone()

    da, db = pair_delta(packed[:, :, :-1], packed[:, :, 1:],
                        x[:-1], y, x[:-1] + 1.0, y)
    out[:, :, :-1] += da
    out[:, :, 1:] += db

    da, db = pair_delta(packed[:, :-1], packed[:, 1:],
                        x, y[:-1], x, y[:-1] + 1.0)
    out[:, :-1] += da
    out[:, 1:] += db
    return out.movedim(0, -1)


# ----------------------------------------------------------------------------
# The nvdiffrast-style primitive: antialias from a rast buffer
# ----------------------------------------------------------------------------

def _pair_blend(color_a, color_b, rast_a, rast_b, centers_a, centers_b,
                tri_screen, face_neighbors):
    """Blend deltas of aligned pixel pairs, the occluder's geometry
    gathered per pair (JAX's ``_pair_blend``, operand for operand).

    :param color_a, color_b: (..., C) the two pixels' colours.
    :param rast_a, rast_b: (..., 4) their rasterizer outputs.
    :param centers_a, centers_b: (..., 2) their pixel centres.
    :param tri_screen: (T, 3, 2) screen-space triangle corners.
    :param face_neighbors: (T, 3) neighbour face of each edge, -1 open.
    :return: (delta_a, delta_b), each (..., C).
    """
    id_a = rast_a[..., 3].to(torch.int64) - 1
    id_b = rast_b[..., 3].to(torch.int64) - 1
    differs = id_a != id_b
    inf = torch.tensor(float("inf"), dtype=rast_a.dtype,
                       device=rast_a.device)
    z_a = torch.where(id_a >= 0, rast_a[..., 2], inf)
    z_b = torch.where(id_b >= 0, rast_b[..., 2], inf)
    a_occ = z_a <= z_b
    occ_id = torch.where(a_occ, id_a, id_b)
    other_id = torch.where(a_occ, id_b, id_a)
    valid = differs & (occ_id >= 0)
    occ_safe = torch.clamp(occ_id, min=0)
    tv = tri_screen[occ_safe]                        # (..., 3, 2)
    neigh = face_neighbors[occ_safe]                 # (..., 3)
    pax, pay = centers_a[..., 0], centers_a[..., 1]
    pbx, pby = centers_b[..., 0], centers_b[..., 1]

    best_xi = torch.zeros_like(z_a)
    best_score = torch.full_like(z_a, float("inf"))
    found = torch.zeros_like(differs)
    for j in range(3):
        va = tv[..., j, :]
        vb = tv[..., (j + 1) % 3, :]
        f_a = edge_fn(va[..., 0], va[..., 1], vb[..., 0], vb[..., 1], pax,
                      pay)
        f_b = edge_fn(va[..., 0], va[..., 1], vb[..., 0], vb[..., 1], pbx,
                      pby)
        crossing = (f_a * f_b) < 0.0
        # a shared edge (the surface goes on) only if its neighbour is the
        # other pixel's triangle; every other edge is a silhouette
        shared = (neigh[..., j] >= 0) & (neigh[..., j] == other_id)
        ok = crossing & ~shared
        denom = f_a - f_b
        xi = f_a / torch.where(torch.abs(denom) > 1e-20, denom, 1e-20)
        score = torch.abs(xi - 0.5)
        better = ok & (score < best_score)
        best_xi = torch.where(better, xi, best_xi)
        best_score = torch.where(better, score, best_score)
        found = found | ok

    valid = valid & found
    delta = torch.clamp(best_xi - 0.5, -0.5, 0.5)
    delta = torch.where(valid, delta, 0.0)[..., None]
    diff = color_a - color_b
    delta_b = torch.where(delta > 0, delta * diff, 0.0)
    delta_a = torch.where(delta < 0, -delta * (-diff), 0.0)
    return delta_a, delta_b


def _antialias_compact(color, rast, tri_screen, face_neighbors,
                       max_pairs: int):
    """The antialias over at most ``max_pairs`` pairs a direction: the
    pairs whose ids differ, in row-major order, by the JAX package's top-k
    of priorities (so the pairs past the cap are the ones it drops). The
    pair masks are discrete, so compaction changes no gradient of the pairs
    kept."""
    height, width = color.shape[0], color.shape[1]
    dev = color.device
    ids = rast[..., 3].to(torch.int32)
    out = color
    for direction in ("h", "v"):
        if direction == "h":
            differs = ids[:, :-1] != ids[:, 1:]
            pw = width - 1
            n = height * pw
        else:
            differs = ids[:-1, :] != ids[1:, :]
            pw = width
            n = (height - 1) * width
        k = min(max_pairs, n)
        if k <= 0:
            continue
        # true pairs in (0, 1] by ascending index, false ones below -1
        idxf = torch.arange(n, dtype=torch.float32, device=dev) * (1.0 / n)
        pri = torch.where(differs.reshape(-1), 1.0 - idxf, -1.0 - idxf)
        v, flat_idx = torch.topk(pri, k)
        valid = (v > 0.0)[:, None]
        safe = torch.clamp(flat_idx, max=n - 1)
        ay = safe // pw
        ax = safe % pw
        by, bx = (ay, ax + 1) if direction == "h" else (ay + 1, ax)
        centers_a = torch.stack([ax.to(torch.float32) + 0.5,
                                 ay.to(torch.float32) + 0.5], dim=-1)
        centers_b = torch.stack([bx.to(torch.float32) + 0.5,
                                 by.to(torch.float32) + 0.5], dim=-1)
        da, db = _pair_blend(color[ay, ax], color[by, bx], rast[ay, ax],
                             rast[by, bx], centers_a, centers_b, tri_screen,
                             face_neighbors)
        out = out.index_put((ay, ax), torch.where(valid, da, 0.0),
                            accumulate=True)
        out = out.index_put((by, bx), torch.where(valid, db, 0.0),
                            accumulate=True)
    return out


class AntialiasGathered(torch.autograd.Function):
    """K2 forward, K3 backward on the winner planes gathered from a rast
    buffer (``csrc/antialias.cu``, ``csrc/antialias_bwd.cu``; their plain
    versions on the CPU).

    ``apply(colour, corners, idbuf, zn, height, width)``: tile-padded
    (rows, pw) planes, pad pixels background.

    :param colour: (C, rows, pw) colour, differentiable.
    :param corners: (6, rows, pw) each pixel's winner's screen corners
        (x0 y0 x1 y1 x2 y2), differentiable.
    :param idbuf: (rows, pw) int32 winner ids, -1 = background.
    :param zn: (4, rows, pw) [z, n0, n1, n2]: depth and neighbour ids.
    :param height, width: the image's real size (the pair masks).
    :return: (C, rows, pw) antialiased colour.
    """

    @staticmethod
    def forward(ctx, colour, corners, idbuf, zn, height, width):
        from fpc_diffrend_tpu_torch.ops.cuda.antialias_cuda import (
            antialias_planes)
        from fpc_diffrend_tpu_torch.ops.cuda.rasterize_cuda import (
            N_PAYLOAD, PAY_CORNERS, PAY_NEIGHBOURS, PAY_Z)

        payload = corners.new_zeros((N_PAYLOAD,) + idbuf.shape)
        payload[PAY_Z] = zn[0]
        payload[PAY_CORNERS] = corners
        payload[PAY_NEIGHBOURS] = zn[1:]
        ctx.save_for_backward(idbuf, payload, colour)
        ctx.dims = (height, width)
        return antialias_planes(idbuf, payload, colour, height, width,
                                idbuf.shape[0])

    @staticmethod
    def backward(ctx, g):
        from fpc_diffrend_tpu_torch.ops.cuda.antialias_cuda import (
            antialias_planes_bwd)

        idbuf, payload, colour = ctx.saved_tensors
        gcolour, gverts = antialias_planes_bwd(
            idbuf, payload, colour, g.contiguous(), *ctx.dims,
            idbuf.shape[0])
        return gcolour, gverts, None, None, None, None


def _antialias_gathered(color, rast, tri_screen, face_neighbors):
    """Every pair through K2/K3: the winner's [id, z, corners, neighbours]
    gathered by the rast buffer's ids and padded to whole 8x128 tiles,
    pad pixels background so that no pair crosses the image's edge."""
    from fpc_diffrend_tpu_torch.ops.cuda.rasterize_cuda import (
        pad_resolution)

    height, width = color.shape[0], color.shape[1]
    ph, pw = pad_resolution(height, width)
    pad = (0, pw - width, 0, ph - height)
    ids = rast[..., 3].to(torch.int32) - 1
    safe = torch.clamp(ids, min=0)
    corners = gather_rows(tri_screen, safe).reshape(height, width, 6)
    zn = torch.cat([rast[None, ..., 2].detach(), gather_rows(
        face_neighbors.to(torch.float32), safe).movedim(-1, 0)])

    def padded(x):
        return torch.nn.functional.pad(x, pad).contiguous()

    aa = AntialiasGathered.apply(
        padded(color.movedim(-1, 0)), padded(corners.movedim(-1, 0)),
        torch.nn.functional.pad(ids, pad, value=-1).contiguous(),
        padded(zn), height, width)
    return aa[:, :height, :width].movedim(0, -1)


def antialias(color: Tensor, rast: Tensor, pos_clip: Tensor, faces: Tensor,
              face_neighbors: Tensor, max_pairs: int | None = None) -> Tensor:
    """Antialias the silhouette edges of a rendered image, on the device
    of its tensors.

    :param color: (H, W, C) shaded image.
    :param rast: (H, W, 4) rasterizer output of the same view.
    :param pos_clip: (V, 4) clip-space positions (gradient target).
    :param faces: (T, 3) int triangles.
    :param face_neighbors: (T, 3) int neighbour face of each edge, -1 open
        (``data.obj.build_topology``).
    :param max_pairs: None: every pixel pair, through K2 forward and K3
        backward (:class:`AntialiasGathered`); an int: only the pairs
        whose ids differ, at most this many a direction in row-major order
        (the rest dropped), in plain torch (:func:`_antialias_compact`).
    :return: (H, W, C) antialiased image.
    """
    # imported here: ops.rasterize imports this module
    from fpc_diffrend_tpu_torch.ops.rasterize import screen_vertices

    height, width = color.shape[0], color.shape[1]
    tri_screen = screen_vertices(pos_clip, width, height)[faces][..., :2]
    if max_pairs is not None:
        return _antialias_compact(color, rast, tri_screen, face_neighbors,
                                  max_pairs)
    return _antialias_gathered(color, rast, tri_screen, face_neighbors)
