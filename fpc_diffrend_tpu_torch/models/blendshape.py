"""Blendshape rig models: prior / free / combined vertex blending.

Port of ``fpc_diffrend_tpu.models.blendshape``. Frames are selected by
integer index (a column gather where the original rig multiplies by a
one-hot frame vector), batched over a ``frame_idx`` vector.

Parameter shapes:
  deltas            (3V, B)   blendshape delta matrix
  maps              (F, F)    frame -> frame mapping (learned)
  maps_intermediate (B, F)    frame -> blendshape activations (learned)
  m1, m2            (F, F)    free-mode mappings (learned)
  m3                (3V, F)   free-mode delta basis (learned)
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor


def _rows_first(x: Tensor) -> Tensor:
    return x.movedim(-1, 0) if x.ndim == 2 else x


def prior_activations(maps: Tensor, maps_intermediate: Tensor,
                      frame_idx: Tensor) -> Tensor:
    """maps_intermediate @ maps[:, f]: (B,) or (N, B) activations."""
    return _rows_first(maps_intermediate @ maps[:, frame_idx])


def blend_prior(v_base, deltas, maps, maps_intermediate, frame_idx):
    """v = v_base + deltas @ act(frame); (3V,) or (N, 3V)."""
    act = prior_activations(maps, maps_intermediate, frame_idx)
    return v_base + torch.einsum("vb,...b->...v", deltas, act)


def free_deltas(m1, m2, m3, frame_idx) -> Tensor:
    """Learned-basis deltas m3 @ m2 @ m1[:, f]; (3V,) or (N, 3V)."""
    return _rows_first(m3 @ (m2 @ m1[:, frame_idx]))


def blend_free(v_base, m1, m2, m3, frame_idx) -> Tensor:
    return v_base + free_deltas(m1, m2, m3, frame_idx)


def blend_combined(v_base, m1, m2, m3, maps, maps_intermediate, deltas,
                   frame_idx, learned_coefficient=1.0) -> Tensor:
    """Prior plus scaled learned correctives."""
    act = prior_activations(maps, maps_intermediate, frame_idx)
    bl_res = torch.einsum("vb,...b->...v", deltas, act)
    prod = free_deltas(m1, m2, m3, frame_idx)
    return v_base + bl_res + learned_coefficient * prod


def blend(mode: str, params: dict, v_base: Tensor, frame_idx: Tensor,
          learned_coefficient: float = 1.0) -> Tensor:
    """Dispatch on the mode string; ``params`` also carries ``deltas``."""
    if mode == "prior":
        return blend_prior(v_base, params["deltas"], params["maps"],
                           params["maps_intermediate"], frame_idx)
    if mode == "free":
        return blend_free(v_base, params["m1"], params["m2"], params["m3"],
                          frame_idx)
    if mode == "combined":
        return blend_combined(v_base, params["m1"], params["m2"],
                              params["m3"], params["maps"],
                              params["maps_intermediate"], params["deltas"],
                              frame_idx, learned_coefficient)
    raise ValueError(f"invalid mode {mode!r}; expected prior|free|combined")


def setup_dataset_free(n_frames: int, n_vertices_x3: int):
    """Free-mode initial parameters: m1, m2 identity (F, F); m3 zeros (3V, F)."""
    m1 = np.eye(n_frames, dtype=np.float32)
    m2 = np.eye(n_frames, dtype=np.float32)
    m3 = np.zeros((n_vertices_x3, n_frames), dtype=np.float32)
    return m1, m2, m3
