"""Barycentric attribute interpolation (nvdiffrast ``interpolate``).

Port of ``fpc_diffrend_tpu.ops.interpolate``: plain torch gathers on the
device of the inputs (the JAX package's is XLA too); autograd gives the
scatter-add backward that nvdiffrast writes by hand.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def gather_rows(x: Tensor, idx: Tensor) -> Tensor:
    """``x[idx]`` for an integer index of any shape into x's first axis,
    by ``index_select``: its backward adds the rows with ``index_add_``
    (atomics on the card), where advanced indexing's backward sorts the
    indices first, which took most of a 1600x1200 composition's backward
    on an H100 (``chip_smoke.py`` phase 5e).

    :return: (*idx.shape, *x.shape[1:]).
    """
    rows = torch.index_select(x.reshape(x.shape[0], -1), 0,
                              idx.reshape(-1).long())
    return rows.reshape(*idx.shape, *x.shape[1:])


def interpolate(attr: Tensor, rast: Tensor, faces: Tensor,
                rast_db: Tensor | None = None, diff_attrs=None):
    """Interpolate per-vertex attributes at rasterized pixels.

    :param attr: (V, A) per-vertex attributes (e.g. uv, (U, 2)).
    :param rast: (H, W, 4) rasterizer output (u, v, z, tri_id + 1).
    :param faces: (T, 3) int attribute indices per triangle (for uv the
        ``uv_idx`` buffer).
    :param rast_db: (H, W, 4) barycentric pixel derivatives; required with
        ``diff_attrs``.
    :param diff_attrs: None or "all": also the screen-space attribute
        derivatives (H, W, 2A) ordered (dA0/dx, dA0/dy, dA1/dx, ...),
        nvdiffrast's ``diff_attrs='all'`` layout.
    :return: (out (H, W, A), out_da (H, W, 2A) or None).
    :raises ValueError: ``diff_attrs`` without ``rast_db``.
    :raises NotImplementedError: ``diff_attrs`` other than "all".
    """
    u = rast[..., 0:1]
    v = rast[..., 1:2]
    mask = rast[..., 3:4] > 0
    ids = torch.clamp(rast[..., 3].to(torch.int64) - 1, min=0)
    pa = gather_rows(attr[faces.long()], ids)         # (H, W, 3, A)
    a0, a1, a2 = pa.unbind(-2)
    out = torch.where(mask, u * a0 + v * a1 + (1.0 - u - v) * a2, 0.0)
    if diff_attrs is None:
        return out, None
    if rast_db is None:
        raise ValueError("diff_attrs requires rast_db")
    if diff_attrs != "all":
        raise NotImplementedError("only diff_attrs='all' is supported")
    du_dx, du_dy, dv_dx, dv_dy = rast_db[..., None, :].unbind(-1)
    # a = u (a0 - a2) + v (a1 - a2) + a2
    d02 = a0 - a2
    d12 = a1 - a2
    da_dx = du_dx * d02 + dv_dx * d12                 # (H, W, A)
    da_dy = du_dy * d02 + dv_dy * d12
    out_da = torch.stack([da_dx, da_dy], dim=-1).flatten(-2)
    return out, torch.where(mask, out_da, 0.0)
