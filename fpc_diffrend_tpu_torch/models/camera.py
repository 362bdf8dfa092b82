"""Camera math: calibrated intrinsics/extrinsics -> OpenGL-convention matrices.

Port of ``fpc_diffrend_tpu.models.camera``: the same OpenCV -> OpenGL
conventions, including the row sign flips of the modelview, so a
calibration maps into the same clip space in both packages. Matrix
builders return float32 tensors; the fixed rotations and translations stay
numpy, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor


def _f32(x, device=None) -> Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def intrinsic_to_projection(intr, zn: float = 0.01, zf: float = 200.0,
                            device=None) -> Tensor:
    """OpenGL projection matrix from a 3x3 pinhole intrinsic matrix.

    The focal/principal-point ratios set the frustum half-angles; depth
    terms are the standard GL ones, computed in float32.

    :param intr: 3x3 intrinsic matrix in pixels.
    :return: (4, 4) float32 projection matrix.
    """
    intr = _f32(intr, device)
    zn = torch.tensor(zn, dtype=torch.float32, device=intr.device)
    zf = torch.tensor(zf, dtype=torch.float32, device=intr.device)
    out = torch.zeros((4, 4), dtype=torch.float32, device=intr.device)
    out[0, 0] = intr[0, 0] / intr[0, 2]
    out[1, 1] = intr[1, 1] / intr[1, 2]
    out[2, 2] = -(zf + zn) / (zf - zn)
    out[2, 3] = -(2.0 * zf * zn) / (zf - zn)
    out[3, 2] = -1.0
    return out


def extrinsic_to_modelview(rmat, tvec, device=None) -> Tensor:
    """OpenGL modelview matrix from OpenCV extrinsics: rows 1 and 2 of
    [R|t] are negated (OpenCV looks down +z with +y down).

    :param rmat: 3x3 world -> camera rotation.
    :param tvec: translation, shape (3,), (3, 1) or (1, 3).
    :return: (4, 4) float32 modelview matrix.
    """
    rmat = _f32(rmat, device).reshape(3, 3)
    tvec = _f32(tvec, rmat.device).reshape(3, 1)
    rt = torch.cat([rmat, tvec], dim=1)
    flip = torch.tensor([[1.0], [-1.0], [-1.0]], dtype=torch.float32,
                        device=rmat.device)
    br = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=torch.float32,
                      device=rmat.device)
    return torch.cat([rt * flip, br], dim=0)


def transform_clip(mvp: Tensor, pos: Tensor) -> Tensor:
    """Vertex positions to homogeneous clip space, batched over leading dims.

    :param mvp: (..., 4, 4) modelview-projection matrices.
    :param pos: (..., V, 3) vertex positions.
    :return: (..., V, 4) clip-space positions.
    """
    posw = torch.cat([pos, torch.ones_like(pos[..., :1])], dim=-1)
    return posw @ mvp.transpose(-1, -2)


def default_projection(xn: float = 1.0, xf: float = 50.0,
                       x: float = 0.1) -> np.ndarray:
    """Simple symmetric frustum."""
    return np.array(
        [
            [xn / x, 0, 0, 0],
            [0, xn / -x, 0, 0],
            [0, 0, -(xf + xn) / (xf - xn), -(2 * xf * xn) / (xf - xn)],
            [0, 0, -1, 0],
        ],
        dtype=np.float32,
    )


def default_modelview(zoffset: float = -30.0) -> np.ndarray:
    """Identity view with a z offset."""
    m = np.eye(4, dtype=np.float32)
    m[2, 3] = zoffset
    return m


def rotate_x(a: float) -> np.ndarray:
    s, c = np.sin(a), np.cos(a)
    return np.array(
        [[1, 0, 0, 0], [0, c, s, 0], [0, -s, c, 0], [0, 0, 0, 1]],
        dtype=np.float32)


def rotate_y(a: float) -> np.ndarray:
    s, c = np.sin(a), np.cos(a)
    return np.array(
        [[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1]],
        dtype=np.float32)


def translate(x: float, y: float, z: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[0, 3] = x
    m[1, 3] = y
    m[2, 3] = z
    return m


def rigid_transform(tvec: Tensor, rotmat: Tensor) -> Tensor:
    """[R|t; 0 1] from translation (..., 3) and rotation (..., 3, 3)."""
    rt = torch.cat([rotmat, tvec[..., :, None]], dim=-1)       # (..., 3, 4)
    br = torch.zeros(rt.shape[:-2] + (1, 4), dtype=rt.dtype,
                     device=rt.device)
    br[..., 0, 3] = 1.0
    return torch.cat([rt, br], dim=-2)
