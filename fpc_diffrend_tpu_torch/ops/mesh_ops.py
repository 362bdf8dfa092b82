"""Mesh regularizer losses, forward (port of ``fpc_diffrend_tpu.ops.mesh_ops``).

All adjacency is precomputed once (``data.obj.build_topology``), so each
loss is a fixed-shape gather and reduction. Inputs are batched over any
leading dims: ``verts3`` is (..., V, 3) and each loss returns (...).
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def edge_lengths(verts3: Tensor, edges: Tensor) -> Tensor:
    """(..., E) edge lengths; epsilon inside the sqrt as in the reference."""
    d = verts3[..., edges[:, 0], :] - verts3[..., edges[:, 1], :]
    return torch.sqrt(torch.sum(d * d, dim=-1) + 1e-12)


def mesh_edge_loss(verts3: Tensor, edges: Tensor,
                   target_length: float = 0.0) -> Tensor:
    """Mean over edges of (||e|| - target)^2."""
    return torch.mean((edge_lengths(verts3, edges) - target_length) ** 2,
                      dim=-1)


def neighbor_sum(verts3: Tensor, nbr_idx: Tensor, nbr_mask: Tensor) -> Tensor:
    """Sum of each vertex's neighbours over the padded (V, D) table."""
    g = verts3[..., nbr_idx, :]                              # (..., V, D, 3)
    return torch.sum(torch.where(nbr_mask[..., None] != 0, g, 0.0), dim=-2)


def uniform_laplacian_padded(verts3: Tensor, nbr_idx: Tensor,
                             nbr_mask: Tensor, degree: Tensor) -> Tensor:
    """(mean of neighbours) - vertex, (..., V, 3)."""
    deg = torch.clamp(degree, min=1.0)[:, None]
    return neighbor_sum(verts3, nbr_idx, nbr_mask) / deg - verts3


def mesh_laplacian_smoothing_padded(verts3: Tensor, nbr_idx: Tensor,
                                    nbr_mask: Tensor,
                                    degree: Tensor) -> Tensor:
    """Mean over vertices of the L2 norm of the uniform Laplacian."""
    lap = uniform_laplacian_padded(verts3, nbr_idx, nbr_mask, degree)
    return torch.mean(torch.sqrt(torch.sum(lap * lap, dim=-1) + 1e-12),
                      dim=-1)


def face_normals(verts3: Tensor, faces: Tensor,
                 normalized: bool = True) -> Tensor:
    """(..., T, 3) face normals via the winding cross product."""
    v0 = verts3[..., faces[:, 0], :]
    v1 = verts3[..., faces[:, 1], :]
    v2 = verts3[..., faces[:, 2], :]
    n = torch.linalg.cross(v1 - v0, v2 - v0, dim=-1)
    if normalized:
        n = n / torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True) + 1e-12)
    return n


def mesh_normal_consistency(verts3: Tensor, faces: Tensor,
                            edge_face_pairs: Tensor) -> Tensor:
    """Mean over adjacent-face pairs of 1 - cos(n_a, n_b)."""
    n = face_normals(verts3, faces, normalized=False)
    na = n[..., edge_face_pairs[:, 0], :]
    nb = n[..., edge_face_pairs[:, 1], :]
    norm_a = torch.sqrt(torch.sum(na * na, dim=-1) + 1e-12)
    norm_b = torch.sqrt(torch.sum(nb * nb, dim=-1) + 1e-12)
    cos = torch.sum(na * nb, dim=-1) / (norm_a * norm_b)
    return torch.mean(1.0 - cos, dim=-1)
