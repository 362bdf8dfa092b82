"""Learned parameters and the multi-group Adam optimizer (port of
``fpc_diffrend_tpu.fit.state``).

Parameters are a plain dict of float32 tensors with the JAX package's names
and shapes. The optimizer is ``torch.optim.Adam`` with the five groups of
the JAX package's optax ``multi_transform`` and optax's defaults
(betas (0.9, 0.999), eps 1e-8, eps_root 0); every group's learning rate is
scaled by the shared ramp ``lr_ramp ** (count / max_iter)``, where
``count`` is the number of updates before this one (optax
``scale_by_schedule``). The optimizer updates the parameter tensors in
place.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fpc_diffrend_tpu_torch.device import resolve_device
from fpc_diffrend_tpu_torch.fit.config import FitConfig
from fpc_diffrend_tpu_torch.fit.scene import Scene, scene_from_arrays
from fpc_diffrend_tpu_torch.models import blendshape

PARAM_NAMES = ("m1", "m2", "m3", "maps", "maps_intermediate", "t_opt",
               "q_opt", "per_frame_t", "per_frame_q", "tex")


def init_params(config: FitConfig, n_frames: int, n_vertices_x3: int,
                n_blendshapes: int, tex_init: np.ndarray,
                n_cameras: int = 9, device=None) -> dict:
    """Initial parameters; every mode carries every parameter."""
    m1, m2, m3 = blendshape.setup_dataset_free(n_frames, n_vertices_x3)
    q0 = np.zeros((n_cameras, 4), np.float32)
    q0[:, 3] = 1.0
    qf = np.zeros((n_frames, 4), np.float32)
    qf[:, 3] = 1.0
    return params_from_numpy({
        "m1": m1,
        "m2": m2,
        "m3": m3,
        "maps": np.zeros((n_frames, n_frames), np.float32),
        "maps_intermediate": np.eye(n_blendshapes, n_frames,
                                    dtype=np.float32),
        "t_opt": np.zeros((n_cameras, 3), np.float32),
        "q_opt": q0,
        "per_frame_t": np.zeros((n_frames, 3), np.float32),
        "per_frame_q": qf,
        "tex": np.asarray(tex_init, np.float32),
    }, device)


def params_from_numpy(params: dict, device=None) -> dict:
    """The JAX package's parameter dict, as numpy arrays, as the port's:
    float32 tensors on ``device`` under the same names."""
    device = resolve_device(device)
    missing = set(PARAM_NAMES) - set(params)
    if missing:
        raise KeyError(f"parameters missing: {sorted(missing)}")
    # copies: the port owns its parameters (the optimizer updates them)
    return {k: torch.tensor(np.asarray(params[k], np.float32),
                            device=device) for k in PARAM_NAMES}


def scene_from_numpy(scene: dict, device=None) -> Scene:
    """A JAX ``Scene``'s fields, as a dict of numpy arrays, as the port's
    Scene on ``device`` (dtypes kept; absent optional fields stay None)."""
    return scene_from_arrays(scene, resolve_device(device))


# optimizer group -> (parameters, learning rate as a function of config)
GROUPS = {
    "corrective": (("m1", "m2", "m3"), lambda c: c.lr_base * (
        0.1 if c.mode == "combined" else 1.0)),
    "rig": (("maps", "maps_intermediate"), lambda c: c.lr_base),
    "trans": (("t_opt", "per_frame_t"), lambda c: c.lr_t),
    "quat": (("q_opt", "per_frame_q"), lambda c: c.lr_q),
    "tex": (("tex",), lambda c: c.lr_base * c.lr_tex_coef),
}


@dataclasses.dataclass
class TrainState:
    """The fit's state: ``step`` counts the updates taken; ``params`` are
    leaf tensors that ``optimizer`` updates in place."""

    step: int
    params: dict
    optimizer: torch.optim.Adam


def make_optimizer(config: FitConfig, params: dict) -> torch.optim.Adam:
    """Adam over five parameter groups at their base learning rates; call
    :func:`apply_lr_ramp` before each step."""
    groups = [{"params": [params[k] for k in names], "lr": lr(config),
               "base_lr": lr(config)} for names, lr in GROUPS.values()]
    return torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8)


def apply_lr_ramp(config: FitConfig, optimizer: torch.optim.Adam,
                  count: int) -> None:
    """Set each group's rate to base * lr_ramp ** (count / max_iter)."""
    ramp = config.lr_ramp ** (count / config.max_iter)
    for group in optimizer.param_groups:
        group["lr"] = group["base_lr"] * ramp


def init_state(config: FitConfig, params: dict) -> TrainState:
    """Step 0 over ``params`` (``fit.loop.train_step`` makes them require
    gradients)."""
    return TrainState(step=0, params=params,
                      optimizer=make_optimizer(config, params))


def corrective_gate(config: FitConfig, step: int) -> float:
    """1.0 when the learned correctives (m1/m2/m3) may update: combined
    mode freezes them for the first half of training, free mode always
    trains them, prior mode never uses them."""
    if config.mode == "combined":
        return float(step > config.max_iter // 2)
    return 1.0 if config.mode == "free" else 0.0


def apply_corrective_gate(config: FitConfig, step: int,
                          params: dict) -> None:
    """Scale the correctives' gradients by the gate, in place."""
    gate = corrective_gate(config, step)
    for k in ("m1", "m2", "m3"):
        params[k].grad.mul_(gate)


def optimizer_step(config: FitConfig, state: TrainState) -> None:
    """The update after a backward: corrective gate, Adam at the ramped
    rates, quaternion renorm, ``state.step += 1`` (all in place)."""
    apply_corrective_gate(config, state.step, state.params)
    apply_lr_ramp(config, state.optimizer, state.step)
    state.optimizer.step()
    normalize_quaternions(state.params)
    state.step += 1


def normalize_quaternions(params: dict) -> None:
    """Per-row unit renormalization of the pose quaternions, in place (the
    JAX package returns new arrays); a zero row stays zero."""
    with torch.no_grad():
        for k in ("q_opt", "per_frame_q"):
            q = params[k]
            norm = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
            q.div_(torch.clamp(norm, min=1e-12))
