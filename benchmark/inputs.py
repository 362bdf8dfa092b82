"""The inputs of a cell, made from its configuration and ``--seed``.

Both the program and the reference get these and nothing else: the head
mesh, its blendshape deltas, the rig's calibration (as projection and
modelview matrices), the initial texture, the take's reference frames and,
for the view cell, a fitted state. The mesh and the calibration are
fixed; the deltas, the texture, the frames and the fitted state come from
the seed. The frames and the texture are made on the device by a
``torch.Generator`` there, in a few large calls.

The arithmetic of the head, the deltas and the calibration is the rig
examples' (a closed ellipsoid head with a nose bump and a cylindrical uv
unwrap; smooth localised bumps; nine cameras on an arc, OpenCV
convention turned into GL matrices with the rig's 170 y offset baked into
the modelview), frozen here so that the benchmark's inputs do not move
with the program.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference import render

HEAD_Y = 170.0


@dataclasses.dataclass
class Inputs:
    vertices: np.ndarray      # (3V,) float32
    uv: np.ndarray            # (V, 2) float32
    faces: np.ndarray         # (T, 3) int32
    uv_idx: np.ndarray        # (T, 3) int32
    deltas: np.ndarray        # (3V, nB) float32
    proj: np.ndarray          # (C, 4, 4) float32
    mv: np.ndarray            # (C, 4, 4) float32
    tex: torch.Tensor         # (TH, TW, C) float32, on the device
    frames: torch.Tensor | None = None   # (C, F, H, W) uint8, on the device
    state: dict | None = None            # parameter name -> tensor


def head_mesh(n_ring: int, n_seg: int, radius: float):
    """(verts (V, 3), uvs (V, 2), faces (T, 3)) of the closed head."""
    theta = np.pi * np.arange(n_seg + 1) / n_seg
    phi = 2 * np.pi * np.arange(n_ring) / n_ring
    th, ph = np.meshgrid(theta, phi, indexing="ij")
    x = radius * np.sin(th) * np.cos(ph)
    y = radius * 1.25 * np.cos(th)
    z = radius * 0.9 * np.sin(th) * np.sin(ph)
    z = z - 2.5 * np.exp(-((ph - 4.7) ** 2 * 4 + (th - np.pi / 2) ** 2 * 8))
    verts = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
    uvs = np.stack([np.broadcast_to(np.arange(n_ring) / (n_ring - 1 + 1e-6),
                                    th.shape),
                    np.broadcast_to(np.arange(n_seg + 1)[:, None] / n_seg,
                                    th.shape)], -1).reshape(-1, 2)
    uvs = np.clip(uvs.astype(np.float32), 0.01, 0.99)
    i, j = np.meshgrid(np.arange(n_seg), np.arange(n_ring), indexing="ij")
    a = i * n_ring + j
    b = i * n_ring + (j + 1) % n_ring
    c = (i + 1) * n_ring + j
    d = (i + 1) * n_ring + (j + 1) % n_ring
    faces = np.stack([np.stack([a, b, d], -1), np.stack([a, d, c], -1)],
                     2).reshape(-1, 3).astype(np.int32)
    return verts, uvs, faces


def blendshape_deltas(verts: np.ndarray, rng: np.random.Generator,
                      n: int) -> np.ndarray:
    """(3V, n) smooth localised offsets: per blendshape a centre vertex,
    then its 3-vector scale."""
    out = np.empty((n,) + verts.shape, np.float32)
    for k in range(n):
        centre = verts[rng.integers(0, len(verts))]
        fall = np.exp(-np.sum((verts - centre) ** 2, 1) / 8.0)[:, None]
        out[k] = fall * rng.normal(scale=0.8, size=(1, 3))
    return out.reshape(n, -1).T.copy()


def calibration(cal: dict, n_cams: int):
    """(proj, mv), each (C, 4, 4) float32: cameras of focal length
    ``focal_px`` on a ``sensor`` (width, height), on a horizontal arc of
    ``arc`` radians at ``distance`` from the head centre (0, 170, 0), each
    looking at it; near and far planes 0.01 and 200."""
    w, h = cal["sensor"]
    f = cal["focal_px"]
    zn, zf = 0.01, 200.0
    proj = np.zeros((4, 4), np.float32)
    proj[0, 0] = np.float32(f) / np.float32(w / 2.0)
    proj[1, 1] = np.float32(f) / np.float32(h / 2.0)
    proj[2, 2] = -(np.float32(zf) + np.float32(zn)) / (np.float32(zf)
                                                       - np.float32(zn))
    proj[2, 3] = -(np.float32(2.0) * np.float32(zf) * np.float32(zn)) / (
        np.float32(zf) - np.float32(zn))
    proj[3, 2] = -1.0
    centre = np.array([0.0, HEAD_Y, 0.0])
    shift = np.eye(4, dtype=np.float32)
    shift[1, 3] = HEAD_Y
    angles = (np.linspace(-cal["arc"] / 2, cal["arc"] / 2, n_cams)
              if n_cams > 1 else [0.0])
    mvs = []
    for a in angles:
        z_c = np.array([-np.sin(a), 0.0, np.cos(a)])
        y_c = np.array([0.0, -1.0, 0.0])
        rot = np.stack([np.cross(y_c, z_c), y_c, z_c]).astype(np.float32)
        t = (np.array([0.0, 0.0, cal["distance"]])
             - rot.astype(np.float64) @ centre).astype(np.float32)
        rt = np.concatenate([rot, t[:, None]], 1)
        rt = rt * np.array([[1.0], [-1.0], [-1.0]], np.float32)
        mv = np.concatenate([rt, [[0.0, 0.0, 0.0, 1.0]]]).astype(np.float32)
        mvs.append(mv @ shift)
    return (np.broadcast_to(proj, (n_cams, 4, 4)).copy(),
            np.stack(mvs).astype(np.float32))


def _generator(seed: int, stream: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((seed * 4 + stream) % (1 << 63))
    return g


def silhouettes(inputs: Inputs, height: int, width: int, device):
    """(C, H, W) bool: the pixels the rest-pose head covers in each camera
    (the reference rasterizer's coverage)."""
    verts = torch.as_tensor(inputs.vertices, device=device).reshape(-1, 3)
    faces = torch.as_tensor(inputs.faces, device=device)
    homo = torch.cat([verts, torch.ones_like(verts[:, :1])], -1)
    masks = []
    for c in range(inputs.proj.shape[0]):
        mvp = torch.as_tensor(inputs.proj[c] @ inputs.mv[c], device=device)
        planes = render.triangle_planes(homo @ mvp.T, faces, height, width)
        masks.append(render.winners(planes, height, width) >= 0)
    return torch.stack(masks)


def make_inputs(config: dict, kind: str, seed: int, device) -> Inputs:
    """The cell's inputs: ``kind`` "fit" makes the take's frames, "view"
    the fitted state."""
    mesh = config["mesh"]
    verts, uvs, faces = head_mesh(mesh["n_ring"], mesh["n_seg"],
                                  mesh["radius"])
    rng = np.random.default_rng(seed)
    deltas = blendshape_deltas(verts, rng, config["n_blendshapes"])
    proj, mv = calibration(config["calibration"], config["n_cameras"])
    tex = torch.rand(tuple(config["texshape"]), device=device,
                     generator=_generator(seed, 0, device))
    inputs = Inputs(vertices=verts.reshape(-1), uv=uvs, faces=faces,
                    uv_idx=faces.copy(), deltas=deltas, proj=proj, mv=mv,
                    tex=tex)
    h, w = config["resolution"]
    if kind == "fit":
        inputs.frames = take_frames(inputs, config["n_frames"], h, w, seed,
                                    device)
    else:
        inputs.state = fitted_state(config, seed, device)
    return inputs


def take_frames(inputs: Inputs, n_frames: int, height: int, width: int,
                seed: int, device) -> torch.Tensor:
    """(C, F, H, W) uint8 reference frames: uniform noise over the
    rest-pose head's silhouette in each camera, the 45 grey elsewhere, a
    fresh draw for every frame."""
    mask = silhouettes(inputs, height, width, device)
    n_cams = mask.shape[0]
    frames = torch.randint(0, 256, (n_cams, n_frames, height, width),
                           dtype=torch.uint8, device=device,
                           generator=_generator(seed, 1, device))
    frames.masked_fill_(~mask[:, None], 45)
    return frames


def fitted_state(config: dict, seed: int, device) -> dict:
    """A fitted take's parameters: prior activations, per-frame head poses
    and per-camera corrections drawn from the seed (the texture is the
    inputs' own)."""
    g = _generator(seed, 2, device)
    n_f, n_c, n_b = (config["n_frames"], config["n_cameras"],
                     config["n_blendshapes"])

    def normal(shape, scale):
        return torch.randn(shape, device=device, generator=g) * scale

    def quats(n, scale):
        q = torch.cat([normal((n, 3), scale), torch.ones((n, 1),
                                                         device=device)], 1)
        return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)

    return {"maps": normal((n_f, n_f), 0.3),
            "maps_intermediate": torch.eye(n_b, n_f, device=device)
            + normal((n_b, n_f), 0.05),
            "per_frame_t": normal((n_f, 3), 0.4),
            "per_frame_q": quats(n_f, 0.01),
            "t_opt": normal((n_c, 3), 0.05),
            "q_opt": quats(n_c, 0.002)}
