"""Static scene data for the fit (port of ``fpc_diffrend_tpu.fit.scene``).

Everything is computed once on the host with numpy and held as tensors on
one device. Index arrays keep the JAX package's int32 dtype, so a scene
carried across with ``fit.state.scene_from_numpy`` round-trips exactly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fpc_diffrend_tpu_torch.data import obj as objlib
from fpc_diffrend_tpu_torch.device import resolve_device

Tensor = torch.Tensor


@dataclasses.dataclass
class Scene:
    """All non-learned tensors the fit step reads."""

    v_base: Tensor           # (3V,) flat base vertex positions
    faces: Tensor            # (T, 3) int32
    uv: Tensor               # (U, 2)
    uv_idx: Tensor           # (T, 3) int32
    proj: Tensor             # (C, 4, 4) per-camera projections
    mv: Tensor               # (C, 4, 4) modelview (incl. y-offset)
    deltas: Tensor           # (3V, B) blendshape deltas
    edges: Tensor
    neighbor_src: Tensor
    neighbor_dst: Tensor
    degree: Tensor
    edge_face_pairs: Tensor
    face_neighbors: Tensor   # (T, 3) int32, -1 = open edge
    nbr_idx: Tensor          # (V, D) int32 padded neighbour table
    nbr_mask: Tensor         # (V, D) float32
    vtx_inc_idx: Tensor | None = None
    vtx_inc_mask: Tensor | None = None
    uv_inc_idx: Tensor | None = None
    uv_inc_mask: Tensor | None = None

    @property
    def n_vertices(self) -> int:
        return self.v_base.shape[0] // 3

    @property
    def n_cameras(self) -> int:
        return self.proj.shape[0]

    @property
    def device(self) -> torch.device:
        return self.v_base.device


def scene_from_arrays(arrays: dict, device) -> Scene:
    """A Scene from a dict of numpy arrays keyed by field name."""
    fields = {f.name for f in dataclasses.fields(Scene)}
    return Scene(**{k: torch.tensor(np.asarray(v), device=device)
                    for k, v in arrays.items()
                    if k in fields and v is not None})


def band_reorder(faces: np.ndarray, fuv: np.ndarray):
    """Spatially coherent face order: stable sort by smallest vertex index.

    The sort is stable, so the face order is identical to the JAX
    package's and triangle ids mean the same thing in both.

    :return: (faces, fuv) reordered consistently.
    """
    perm = np.argsort(np.asarray(faces).min(axis=1), kind="stable")
    return np.asarray(faces)[perm], np.asarray(fuv)[perm]


def build_scene(basemesh: objlib.MeshData, proj: np.ndarray, mv: np.ndarray,
                deltas: np.ndarray | None = None,
                reorder_faces: bool = True, device=None) -> Scene:
    """Assemble the Scene from parsed inputs on ``device`` (default CUDA).

    :param reorder_faces: band-reorder faces (see band_reorder).
    """
    device = resolve_device(device)
    faces, fuv = basemesh.faces, basemesh.fuv
    if reorder_faces:
        faces, fuv = band_reorder(faces, fuv)
    n_v = basemesh.n_vertices
    topo = objlib.build_topology(faces, n_v)
    vtx_inc = objlib.corner_incidence(faces, n_v)
    uv_inc = objlib.corner_incidence(fuv, basemesh.uv.shape[0])
    if deltas is None:
        deltas = np.zeros((basemesh.vertices.shape[0], 1), np.float32)
    return scene_from_arrays(dict(
        v_base=basemesh.vertices, faces=faces, uv=basemesh.uv, uv_idx=fuv,
        proj=np.asarray(proj, np.float32), mv=np.asarray(mv, np.float32),
        deltas=deltas, edges=topo.edges, neighbor_src=topo.neighbor_src,
        neighbor_dst=topo.neighbor_dst, degree=topo.degree,
        edge_face_pairs=topo.edge_face_pairs,
        face_neighbors=topo.face_neighbors, nbr_idx=topo.nbr_idx,
        nbr_mask=topo.nbr_mask, vtx_inc_idx=vtx_inc[0],
        vtx_inc_mask=vtx_inc[1], uv_inc_idx=uv_inc[0],
        uv_inc_mask=uv_inc[1]), device)
