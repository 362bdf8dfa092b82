"""Quaternion and rigid-pose math (port of ``fpc_diffrend_tpu.models.pose``).

Quaternions are XYZW, batched over leading dims.
"""

from __future__ import annotations

import torch

from fpc_diffrend_tpu_torch.models.camera import rigid_transform

Tensor = torch.Tensor


def quat_identity(shape=()) -> Tensor:
    """Identity quaternion(s) [0, 0, 0, 1], broadcast to ``shape + (4,)``
    (a float32 CPU tensor; ``.to`` moves it)."""
    q = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float32)
    return q.expand(tuple(shape) + (4,))


def quat_normalize(q) -> Tensor:
    """Quaternion(s) scaled to unit norm along the last axis."""
    q = torch.as_tensor(q, dtype=torch.float32)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_to_rotmat(q: Tensor) -> Tensor:
    """Unit quaternion(s) (..., 4) XYZW -> (..., 3, 3) rotation matrices.

    The input is not normalized here: the fit renormalizes after each step.
    """
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    row0 = torch.stack([1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz),
                        2.0 * (xz + wy)], dim=-1)
    row1 = torch.stack([2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz),
                        2.0 * (yz - wx)], dim=-1)
    row2 = torch.stack([2.0 * (xz - wy), 2.0 * (yz + wx),
                        1.0 - 2.0 * (xx + yy)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def quat_multiply(q1, q2) -> Tensor:
    """Hamilton product of XYZW quaternions, batched over leading dims."""
    q1 = torch.as_tensor(q1, dtype=torch.float32)
    q2 = torch.as_tensor(q2, dtype=torch.float32)
    x1, y1, z1, w1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    x2, y2, z2, w2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack([w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
                        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2], dim=-1)


def rigid_from_pose(tvec: Tensor, quat: Tensor) -> Tensor:
    """(..., 4, 4) rigid transforms from translations (..., 3) and unit
    quaternions (..., 4)."""
    return rigid_transform(tvec, quat_to_rotmat(quat))
