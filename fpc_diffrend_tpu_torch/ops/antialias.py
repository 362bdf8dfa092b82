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
(``csrc/antialias.cu``) does the same.
"""

from __future__ import annotations

import torch

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
