"""The benchmarked fit workload, built for the port.

The same scene, cameras, config, texture and frames as ``bench.py``'s
``build_workload`` (same numpy seed, same draws in the same order): a
123x123 grid dome of 29,768 triangles seen by 3 narrow-FOV cameras at
1600x1200, a 1024^2 one-channel texture, batch 8, 4 frames, free mode,
Laplacian weight 1.0. The binning's entry cap is autotuned from the scene
(``fit.api.autotune_caps``), as ``bench.py`` does on its accelerator; the
face-order flip it also runs there serves only the TPU's banded fold and is
left out. Sizes are arguments, so tests build it tiny. ``mip=True`` is
``bench.py`` with ``FPC_BENCH_MIP=1``: trilinear mipmap sampling with
``max_mip_level=6``, the same draws. ``weight_temporal`` and ``impl`` are
its ``FPC_BENCH_TEMPORAL`` and ``FPC_BENCH_IMPL`` (the temporal smoothness
weight and ``FitConfig.raster_impl``).
"""

from __future__ import annotations

import numpy as np
import torch

from fpc_diffrend_tpu_torch.data import obj as objlib
from fpc_diffrend_tpu_torch.device import resolve_device
from fpc_diffrend_tpu_torch.fit import api as fit_api
from fpc_diffrend_tpu_torch.fit import loop as fit_loop
from fpc_diffrend_tpu_torch.fit import state as state_mod
from fpc_diffrend_tpu_torch.fit.config import FitConfig
from fpc_diffrend_tpu_torch.fit.scene import build_scene
from fpc_diffrend_tpu_torch.models import camera


def build_workload(height: int = 1600, width: int = 1200, grid: int = 123,
                   batch: int = 8, tex_size: int = 1024, n_cams: int = 3,
                   n_frames: int = 4, mip: bool = False,
                   weight_temporal: float = 0.0, impl: str = "auto",
                   device=None) -> dict:
    """:return: dict with config, scene, params, state (the initial
    TrainState over those params), frames_u8 (C, F, H, W) uint8 on the
    device, batch (the fixed first batch bench.py draws), faces (numpy) and
    the sizes H, W, B, n_frames."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)

    # connected deformed-grid dome seen by narrow-FOV rig-style cameras
    lin = np.linspace(-10, 10, grid, dtype=np.float32)
    gy, gx = np.meshgrid(lin, lin, indexing="ij")
    r2 = gx ** 2 + gy ** 2
    gz = (-6 * np.exp(-r2 / 60)
          + 0.1 * rng.normal(size=gx.shape)).astype(np.float32)
    verts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    idx = np.arange(grid * grid).reshape(grid, grid)
    quads = np.stack([idx[:-1, :-1], idx[:-1, 1:], idx[1:, :-1],
                      idx[1:, 1:]], axis=-1).reshape(-1, 4)
    faces = np.concatenate([quads[:, [0, 1, 3]], quads[:, [0, 3, 2]]],
                           axis=0).astype(np.int32)
    uv = ((verts[:, :2] / 10) * 0.5 + 0.5).astype(np.float32)
    mesh = objlib.MeshData(vertices=verts.reshape(-1), uv=uv, faces=faces,
                           fuv=faces)

    # keep the face ~80% of the frame at any resolution: f scales with H
    intr = np.array([[7000.0, 0, 600.0], [0, 7000.0, 800.0], [0, 0, 1]],
                    np.float32)
    intr[0, 0] = intr[1, 1] = 7000.0 * height / 1600.0
    intr[0, 2] = width * 0.5
    intr[1, 2] = height * 0.5
    projs, mvs = [], []
    for c in range(n_cams):
        R = camera.rotate_y(0.3 * (c - 1))[:3, :3]
        t = np.array([[0.0], [0.0], [100.0]], np.float32)
        projs.append(camera.intrinsic_to_projection(intr).numpy())
        mvs.append(camera.extrinsic_to_modelview(R, t).numpy())
    scene = build_scene(mesh, np.stack(projs), np.stack(mvs), device=device)

    config = FitConfig(max_iter=1000, resolution=(height, width),
                       texshape=(tex_size, tex_size, 1), mode="free",
                       cam_idxs=tuple(range(n_cams)), batch_size=batch,
                       raster_impl=impl, weight_laplacian=1.0,
                       weight_temporal=weight_temporal, enable_mip=mip,
                       max_mip_level=6 if mip else 0, log_interval=0)
    tex = rng.uniform(size=(tex_size, tex_size, 1)).astype(np.float32)
    params = state_mod.init_params(config, n_frames, scene.v_base.shape[0],
                                   scene.deltas.shape[1], tex,
                                   scene.n_cameras, device=device)
    config = fit_api.autotune_caps(config, scene, params)
    frames_u8 = torch.as_tensor(rng.integers(
        0, 140, size=(n_cams, n_frames, height, width)).astype(np.uint8),
        device=device)
    cam = torch.as_tensor(rng.integers(0, n_cams, batch), device=device)
    fr = torch.as_tensor(rng.integers(0, n_frames, batch), device=device)
    first = fit_loop.Batch(cam, fr, fit_loop.decode_refs(frames_u8, cam, fr))
    return dict(config=config, scene=scene, params=params,
                state=state_mod.init_state(config, params),
                frames_u8=frames_u8, batch=first, faces=faces, H=height,
                W=width, B=batch, n_frames=n_frames)
