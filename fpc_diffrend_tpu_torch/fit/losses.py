"""Fit-loop loss terms (port of ``fpc_diffrend_tpu.fit.losses``).

loss = mean((ref - colour*255)^2)
     + weight_meshedge * mesh_edge_loss + weight_laplacian * lap^2
     + weight_normalconsistency * normal_consistency
     [+ staging and temporal terms]
"""

from __future__ import annotations

import torch

from fpc_diffrend_tpu_torch.fit.config import FitConfig
from fpc_diffrend_tpu_torch.models import blendshape

Tensor = torch.Tensor


def photometric_loss(ref: Tensor, colour: Tensor) -> Tensor:
    """L2 in 8-bit units over the trailing (H, W, C) dims: (...) losses."""
    return torch.mean((ref - colour * 255.0) ** 2, dim=(-3, -2, -1))


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
