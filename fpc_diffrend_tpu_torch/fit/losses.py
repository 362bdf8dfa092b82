"""Fit-loop loss terms (port of ``fpc_diffrend_tpu.fit.losses``).

loss = mean((ref - colour*255)^2)
     + weight_meshedge * mesh_edge_loss + weight_laplacian * lap^2
     + weight_normalconsistency * normal_consistency
     [+ staging and temporal terms]
"""

from __future__ import annotations

import torch

from fpc_diffrend_tpu_torch.fit.config import FitConfig
from fpc_diffrend_tpu_torch.fit.scene import Scene
from fpc_diffrend_tpu_torch.models import blendshape
from fpc_diffrend_tpu_torch.ops import mesh_ops

Tensor = torch.Tensor


def photometric_loss(ref: Tensor, colour: Tensor) -> Tensor:
    """L2 in 8-bit units over the trailing (H, W, C) dims: (...) losses."""
    return torch.mean((ref - colour * 255.0) ** 2, dim=(-3, -2, -1))


def mesh_regularizers(config: FitConfig, scene: Scene, verts3: Tensor):
    """(edge, Laplacian, normal-consistency) terms of one mesh (or of a
    batch of them over leading dims), the Laplacian over the scene's
    directed edge lists."""
    mel = mesh_ops.mesh_edge_loss(verts3, scene.edges, config.meshedge_target)
    lap = mesh_ops.mesh_laplacian_smoothing(
        verts3, scene.neighbor_src, scene.neighbor_dst, scene.degree)
    mnc = mesh_ops.mesh_normal_consistency(verts3, scene.faces,
                                           scene.edge_face_pairs)
    return mel, lap, mnc


def temporal_smoothness(config: FitConfig, params: dict,
                        frame_idx: Tensor) -> Tensor:
    """L2 on pose deltas between each sampled frame and its predecessor."""
    zero = torch.zeros((), dtype=torch.float32, device=frame_idx.device)
    if config.weight_temporal == 0.0:
        return zero
    prev = torch.clamp(frame_idx - 1, min=0)
    dt = params["per_frame_t"][frame_idx] - params["per_frame_t"][prev]
    dq = params["per_frame_q"][frame_idx] - params["per_frame_q"][prev]
    gate = (frame_idx > 0).to(torch.float32)
    per = (torch.sum(dt * dt, dim=-1) + torch.sum(dq * dq, dim=-1)) * gate
    return config.weight_temporal * torch.mean(per)


def staging_regularizers(config: FitConfig, params: dict, frame_idx: Tensor,
                         step: int) -> Tensor:
    """Optional L2 terms on correctives / prior activations."""
    extra = torch.zeros((), dtype=torch.float32, device=frame_idx.device)
    if config.regularize_correctives and config.mode == "combined":
        deform = blendshape.free_deltas(params["m1"], params["m2"],
                                        params["m3"], frame_idx)
        gate = float(step > config.max_iter // 2)
        extra = extra + gate * torch.mean(deform ** 2)
    if config.regularize_prior and config.mode == "prior":
        act = blendshape.prior_activations(params["maps"],
                                           params["maps_intermediate"],
                                           frame_idx)
        extra = extra + torch.mean(act ** 2)
    return extra
