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

import os

import numpy as np
import torch

from fpc_diffrend_tpu_torch.data.obj import load_obj_vertices
from fpc_diffrend_tpu_torch.runtime import native

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


def load_blendshape_deltas(localblpath: str, v_basemesh: np.ndarray,
                           progress_every: int = 50) -> np.ndarray:
    """A directory of blendshape OBJs as a (3V, nB) delta matrix.

    Each OBJ gives one column of per-vertex deltas against the base mesh,
    in ``sorted(os.listdir)`` order. The vertex blocks are parsed by the
    native runtime where it is available, else by :func:`load_obj_vertices`,
    which prints ``Blendshape i/n`` every ``progress_every`` files (0:
    never).
    """
    v_basemesh = np.asarray(v_basemesh, dtype=np.float32).reshape(-1)
    paths = [os.path.join(localblpath, name)
             for name in sorted(os.listdir(localblpath))]
    if native.available():
        out = native.parse_obj_vertices(paths, v_basemesh.shape[0])
    else:
        out = np.empty((len(paths), v_basemesh.shape[0]), dtype=np.float32)
        for i, path in enumerate(paths):
            if progress_every and i % progress_every == 0:
                print(f"Blendshape {i}/{len(paths)}")
            out[i] = load_obj_vertices(path)
    return (out - v_basemesh[None, :]).T.copy()


def setup_dataset(localblpath: str, globalblpath: str, n_frames: int,
                  n_vertices_x3: int, v_basemesh: np.ndarray):
    """Prior-mode initial data (reference setup_dataset, fit.py:183-230).

    :return: (deltas (3V, nB), maps (F, F) zeros, maps_intermediate (nB, F)
        identity).
    :raises NotImplementedError: a global blendshape dataset, which the
        reference does not implement either.
    """
    if globalblpath:
        raise NotImplementedError(
            "global blendshape datasets are not implemented (parity with "
            "reference fit.py:196-197)")
    deltas = load_blendshape_deltas(localblpath, v_basemesh)
    if deltas.shape[0] != n_vertices_x3:
        raise ValueError(f"blendshapes have {deltas.shape[0]} coordinates, "
                         f"the base mesh {n_vertices_x3}")
    maps = np.zeros((n_frames, n_frames), dtype=np.float32)
    maps_intermediate = np.eye(deltas.shape[1], n_frames, dtype=np.float32)
    return deltas, maps, maps_intermediate
