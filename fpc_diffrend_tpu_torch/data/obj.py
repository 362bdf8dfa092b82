"""Wavefront OBJ I/O, mesh container and topology (numpy, host side).

The port's own copy of ``fpc_diffrend_tpu.data.obj``'s ``MeshData``,
``load_obj``, ``load_obj_vertices``, ``save_obj``, ``build_topology`` and
``corner_incidence``: same arrays, same order, so a scene built by either
package has identical topology. The face neighbours feed the antialias
kernel; ``nbr_idx``/``nbr_mask`` feed the Laplacian.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class MeshData:
    """Parsed mesh.

    vertices: (3V,) float32 flat xyz.
    uv:       (U, 2) float32 texture coordinates.
    faces:    (T, 3) int32 vertex indices (0-based).
    fuv:      (T, 3) int32 uv indices (0-based).
    """

    vertices: np.ndarray
    uv: np.ndarray
    faces: np.ndarray
    fuv: np.ndarray

    @property
    def verts3(self) -> np.ndarray:
        return self.vertices.reshape(-1, 3)

    @property
    def n_vertices(self) -> int:
        return self.vertices.shape[0] // 3


def _parse_float_block(lines: list[str], prefix: str,
                       ncols: int) -> np.ndarray:
    sel = [ln[len(prefix):] for ln in lines if ln.startswith(prefix)]
    if not sel:
        return np.zeros((0, ncols), dtype=np.float32)
    return np.array(" ".join(sel).split(), dtype=np.float32).reshape(-1,
                                                                   ncols)


def load_obj(path: str) -> MeshData:
    """Parse an OBJ file (v / vt / f records; triangles only).

    Faces are ``v/vt`` or ``v/vt/vn`` corners (a corner without vt uses its
    vertex index); indices become 0-based.

    :raises ValueError: a face that is not a triangle.
    """
    with open(path, "r") as f:
        lines = f.readlines()
    verts = _parse_float_block(lines, "v ", 3)
    uv = _parse_float_block(lines, "vt ", 2)
    face_lines = [ln for ln in lines if ln.startswith("f ")]
    faces = np.zeros((len(face_lines), 3), dtype=np.int32)
    fuv = np.zeros((len(face_lines), 3), dtype=np.int32)
    for i, ln in enumerate(face_lines):
        tri = ln.split()[1:]
        if len(tri) != 3:
            raise ValueError(f"non-triangle face in {path}: {tri}")
        for j, corner in enumerate(tri):
            parts = corner.split("/")
            faces[i, j] = int(parts[0]) - 1
            fuv[i, j] = (int(parts[1]) - 1 if len(parts) > 1 and parts[1]
                         else faces[i, j])
    return MeshData(vertices=verts.reshape(-1).astype(np.float32),
                    uv=uv.astype(np.float32), faces=faces, fuv=fuv)


def load_obj_vertices(path: str) -> np.ndarray:
    """Only the flat (3V,) vertex array (for blendshape stacks); the
    vertex block is read up to the first vt or f record after it."""
    vals = []
    with open(path, "r") as f:
        for line in f:
            if line.startswith("v "):
                vals.append(line[2:])
            elif vals and (line.startswith("vt ") or line.startswith("f ")):
                break
    return np.array(" ".join(vals).split(), dtype=np.float32)


def save_obj(path: str, verts3: np.ndarray, uv: np.ndarray,
             faces: np.ndarray, fuv: np.ndarray | None = None) -> None:
    """Write an OBJ with v/vt/f records (f as v/vt, 1-based)."""
    fuv = faces if fuv is None else fuv
    with open(path, "w") as f:
        for v in np.asarray(verts3).reshape(-1, 3):
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for t in np.asarray(uv).reshape(-1, 2):
            f.write(f"vt {t[0]} {t[1]}\n")
        for tri, triuv in zip(np.asarray(faces) + 1, np.asarray(fuv) + 1):
            f.write(f"f {tri[0]}/{triuv[0]} {tri[1]}/{triuv[1]} "
                    f"{tri[2]}/{triuv[2]}\n")


@dataclasses.dataclass
class MeshTopology:
    """Static adjacency arrays for the mesh regularizers and antialias.

    edges:           (E, 2) int32 unique undirected edges (v0 < v1).
    edge_face_pairs: (P, 2) int32 face pairs sharing a manifold edge.
    neighbor_src / neighbor_dst: (2E,) int32 directed edge lists.
    degree:          (V,) float32 vertex degrees.
    face_neighbors:  (T, 3) int32; [f, j] is the face across edge
                     (faces[f, j], faces[f, (j+1)%3]), or -1.
    nbr_idx:         (V, max_degree) int32 neighbours (pad = own index).
    nbr_mask:        (V, max_degree) float32 validity of ``nbr_idx``.
    """

    edges: np.ndarray
    edge_face_pairs: np.ndarray
    neighbor_src: np.ndarray
    neighbor_dst: np.ndarray
    degree: np.ndarray
    face_neighbors: np.ndarray
    n_vertices: int
    nbr_idx: np.ndarray = None
    nbr_mask: np.ndarray = None


def corner_incidence(idx: np.ndarray, n: int):
    """Inverse of the (T, 3) corner-index gather, as a padded table.

    :param idx: (T, 3) int corner indices (faces or fuv rows).
    :param n: number of target rows (vertices / uv entries).
    :return: (inc_idx (n, D) int32 into the flattened (T*3) slots, pad =
        slot 0; inc_mask (n, D) bool).
    """
    flat = np.asarray(idx, dtype=np.int64).reshape(-1)
    counts = np.bincount(flat, minlength=n)
    D = max(int(counts.max()) if counts.size else 1, 1)
    inc_idx = np.zeros((n, D), np.int64)
    inc_mask = np.zeros((n, D), bool)
    order = np.argsort(flat, kind="stable")
    flat_s = flat[order]
    first = np.searchsorted(flat_s, np.arange(n))
    slot = np.arange(flat_s.shape[0]) - first[flat_s]
    inc_idx[flat_s, slot] = order
    inc_mask[flat_s, slot] = True
    return inc_idx.astype(np.int32), inc_mask


def build_topology(faces: np.ndarray, n_vertices: int) -> MeshTopology:
    """Unique edges, adjacent-face pairs and vertex neighbourhoods."""
    faces = np.asarray(faces, dtype=np.int64)
    raw_edges = np.concatenate(
        [faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]], axis=0)
    face_ids = np.tile(np.arange(faces.shape[0], dtype=np.int64), 3)
    keyed = np.sort(raw_edges, axis=1)
    keys = keyed[:, 0] * np.int64(n_vertices) + keyed[:, 1]

    order = np.argsort(keys, kind="stable")
    skeys = keys[order]
    sface = face_ids[order]
    uniq_keys, first_idx, counts = np.unique(skeys, return_index=True,
                                             return_counts=True)
    edges = np.stack([uniq_keys // n_vertices, uniq_keys % n_vertices],
                     axis=1)

    # face pairs for edges shared by exactly two faces (manifold interior)
    two = counts == 2
    i0 = first_idx[two]
    edge_face_pairs = np.stack([sface[i0], sface[i0 + 1]], axis=1)

    # per-face, per-edge neighbour face (edge j = (v_j, v_{j+1})); the
    # raw_edges rows are [all edge-slot 0; all slot 1; all slot 2]
    n_faces = faces.shape[0]
    slot_ids = np.concatenate([np.full(n_faces, 0), np.full(n_faces, 1),
                               np.full(n_faces, 2)])
    sslot = slot_ids[order]
    face_neighbors = np.full((n_faces, 3), -1, dtype=np.int64)
    fa, sa = sface[i0], sslot[i0]
    fb, sb = sface[i0 + 1], sslot[i0 + 1]
    face_neighbors[fa, sa] = fb
    face_neighbors[fb, sb] = fa

    neighbor_src = np.concatenate([edges[:, 0], edges[:, 1]])
    neighbor_dst = np.concatenate([edges[:, 1], edges[:, 0]])
    degree = np.zeros(n_vertices, dtype=np.float32)
    np.add.at(degree, neighbor_src, 1.0)

    # padded per-vertex neighbour table (pad = own index, mask 0)
    max_deg = max(int(degree.max()), 1) if degree.size else 1
    nbr_idx = np.tile(np.arange(n_vertices, dtype=np.int64)[:, None],
                      (1, max_deg))
    nbr_mask = np.zeros((n_vertices, max_deg), np.float32)
    so = np.argsort(neighbor_src, kind="stable")
    src_s = neighbor_src[so]
    dst_s = neighbor_dst[so]
    first = np.searchsorted(src_s, np.arange(n_vertices))
    slot = np.arange(src_s.shape[0]) - first[src_s]
    nbr_idx[src_s, slot] = dst_s
    nbr_mask[src_s, slot] = 1.0

    return MeshTopology(
        edges=edges.astype(np.int32),
        edge_face_pairs=edge_face_pairs.astype(np.int32),
        neighbor_src=neighbor_src.astype(np.int32),
        neighbor_dst=neighbor_dst.astype(np.int32),
        degree=degree,
        face_neighbors=face_neighbors.astype(np.int32),
        n_vertices=n_vertices,
        nbr_idx=nbr_idx.astype(np.int32),
        nbr_mask=nbr_mask,
    )
