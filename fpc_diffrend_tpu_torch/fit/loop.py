"""The batched fit step's forward (port of ``fpc_diffrend_tpu.fit.loop``).

blend -> pose -> clip -> stacked-batch render (K1, K2) -> composite ->
photometric + mesh regularizer + staging/temporal losses. The mvp matches
the JAX package's:
  proj @ rigid(per-frame pose) @ rigid(per-camera correction) @ modelview

``evaluate`` is the slice-1 entry point: the loss forward for a few sampled
batches. The backward, the optimizer and ``train_step`` are slice 2.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from fpc_diffrend_tpu_torch.fit import losses as losses_mod
from fpc_diffrend_tpu_torch.fit.config import FitConfig
from fpc_diffrend_tpu_torch.fit.scene import Scene
from fpc_diffrend_tpu_torch.models import blendshape, pose
from fpc_diffrend_tpu_torch.models.camera import transform_clip
from fpc_diffrend_tpu_torch.ops import mesh_ops
from fpc_diffrend_tpu_torch.ops.pipeline import render_batch_stacked

Tensor = torch.Tensor


class Batch(NamedTuple):
    cam_idx: Tensor     # (B,) int
    frame_idx: Tensor   # (B,) int
    ref: Tensor         # (B, H, W, 1) float32 (already clipped + flipped)


def build_mvp(scene: Scene, params: dict, cam_idx: Tensor,
              frame_idx: Tensor) -> Tensor:
    """(B, 4, 4) modelview-projection per (camera, frame) sample."""
    rigid_cam = pose.rigid_from_pose(params["t_opt"][cam_idx],
                                     params["q_opt"][cam_idx])
    rigid_pose = pose.rigid_from_pose(params["per_frame_t"][frame_idx],
                                      params["per_frame_q"][frame_idx])
    return scene.proj[cam_idx] @ (rigid_pose @ (rigid_cam
                                                @ scene.mv[cam_idx]))


def sample_clip_positions(config: FitConfig, scene: Scene, params: dict,
                          cam_idx: Tensor, frame_idx: Tensor):
    """Blend + pose prologue.

    :return: (pos_clip (B, V, 4), verts3 (B, V, 3)).
    """
    vtx = blendshape.blend(config.mode, {**params, "deltas": scene.deltas},
                           scene.v_base, frame_idx,
                           config.combined_corrective_coefficient)
    verts3 = vtx.reshape(frame_idx.shape[0], -1, 3)
    mvp = build_mvp(scene, params, cam_idx, frame_idx)
    return transform_clip(mvp, verts3), verts3


def render_batch(config: FitConfig, scene: Scene, params: dict,
                 cam_idx: Tensor, frame_idx: Tensor):
    """Render a (B,) batch through the stacked-batch kernel pipeline.

    :return: (imgs (B, H, W, C), verts3 (B, V, 3)).
    """
    if config.enable_mip:
        raise NotImplementedError("the mip texture path is not ported yet")
    pos_clip_b, verts3 = sample_clip_positions(config, scene, params,
                                               cam_idx, frame_idx)
    imgs = render_batch_stacked(pos_clip_b, scene.faces, scene.uv,
                                scene.uv_idx, params["tex"],
                                tuple(config.resolution),
                                scene.face_neighbors)
    return imgs, verts3


def loss_from_render(config: FitConfig, scene: Scene, params: dict,
                     batch: Batch, imgs: Tensor, verts3: Tensor, step=0):
    """The loss terms from rendered images and blended vertices.

    :return: (total, metrics dict of scalar tensors).
    """
    pix = losses_mod.photometric_loss(batch.ref, imgs).mean()
    zero = torch.zeros((), dtype=torch.float32, device=imgs.device)
    mel_m = lap_m = mnc_m = zero
    if config.weight_meshedge:
        mel = mesh_ops.mesh_edge_loss(verts3, scene.edges,
                                      config.meshedge_target)
        mel_m = config.weight_meshedge * mel.mean()
    if config.weight_laplacian:
        lap = mesh_ops.mesh_laplacian_smoothing_padded(
            verts3, scene.nbr_idx, scene.nbr_mask, scene.degree)
        lap_m = config.weight_laplacian * (lap ** 2).mean()
    if config.weight_normalconsistency:
        mnc = mesh_ops.mesh_normal_consistency(verts3, scene.faces,
                                               scene.edge_face_pairs)
        mnc_m = config.weight_normalconsistency * mnc.mean()
    extra = (losses_mod.staging_regularizers(config, params,
                                             batch.frame_idx, step)
             + losses_mod.temporal_smoothness(config, params,
                                              batch.frame_idx))
    total = pix + (mel_m + lap_m + mnc_m) + extra
    return total, {"loss": total, "pix": pix, "mel": mel_m, "lap": lap_m,
                   "mnc": mnc_m}


def loss_fn(params: dict, config: FitConfig, scene: Scene, batch: Batch,
            step=0):
    """Forward of the fit loss for one batch: (total, metrics)."""
    imgs, verts3 = render_batch(config, scene, params, batch.cam_idx,
                                batch.frame_idx)
    return loss_from_render(config, scene, params, batch, imgs, verts3, step)


def decode_refs(frames_u8: Tensor, cam_idx: Tensor,
                frame_idx: Tensor) -> Tensor:
    """uint8 (C, F, H, W) frames -> (B, H, W, 1) float32 references."""
    return frames_u8[cam_idx, frame_idx].to(torch.float32)[..., None]


def sample_batches(config: FitConfig, n_frames: int,
                   generator: torch.Generator):
    """Endless sampler of (cam, frame) index batches from ``generator``
    (a CPU generator; the indices are moved to the device by the caller)."""
    cams = torch.tensor(config.cam_idxs, dtype=torch.int64)
    B = config.batch_size
    while True:
        pick = torch.randint(0, cams.shape[0], (B,), generator=generator)
        frame = torch.randint(0, n_frames, (B,), generator=generator)
        yield cams[pick], frame


def evaluate(config: FitConfig, scene: Scene, params: dict,
             frames_u8: Tensor, n_batches: int,
             generator: torch.Generator) -> dict:
    """Slice-1 entry point: the loss forward for ``n_batches`` sampled
    batches, without gradients.

    :param frames_u8: (C, F, H, W) uint8 reference frames on the scene's
        device.
    :return: metric name -> (n_batches,) tensor on the scene's device.
    """
    config.validate()
    dev = scene.device
    sampler = sample_batches(config, frames_u8.shape[1], generator)
    rows = []
    with torch.no_grad():
        for _ in range(n_batches):
            cam, frame = (t.to(dev) for t in next(sampler))
            batch = Batch(cam, frame, decode_refs(frames_u8, cam, frame))
            rows.append(loss_fn(params, config, scene, batch)[1])
    return {k: torch.stack([m[k] for m in rows]) for k in rows[0]}
