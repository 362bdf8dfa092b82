"""Quaternion and rigid-pose math (port of ``fpc_diffrend_tpu.models.pose``).

Quaternions are XYZW, batched over leading dims.
"""

from __future__ import annotations

import torch

from fpc_diffrend_tpu_torch.models.camera import rigid_transform

Tensor = torch.Tensor


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


def rigid_from_pose(tvec: Tensor, quat: Tensor) -> Tensor:
    """(..., 4, 4) rigid transforms from translations (..., 3) and unit
    quaternions (..., 4)."""
    return rigid_transform(tvec, quat_to_rotmat(quat))
