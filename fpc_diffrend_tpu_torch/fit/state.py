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

On CUDA the optimizer is capturable: its step counts and its groups'
rates are device tensors, and the ramp reads the count on the device, so
an update reads nothing on the host and a CUDA graph of the step
(``fit.loop.train_steps``) ramps the rates at every replay.
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
    leaf tensors that ``optimizer`` updates in place. ``graph`` holds the
    CUDA graph of the step that ``fit.loop.train_steps`` replays for this
    state (None: not captured yet)."""

    step: int
    params: dict
    optimizer: torch.optim.Adam
    graph: object = dataclasses.field(default=None, repr=False,
                                      compare=False)


def make_optimizer(config: FitConfig, params: dict) -> torch.optim.Adam:
    """Adam over five parameter groups at their base learning rates; call
    :func:`apply_lr_ramp` before each step. On CUDA it is capturable, with
    each group's rate a float32 device tensor."""
    dev = params[PARAM_NAMES[0]].device
    capturable = dev.type == "cuda"

    def rate(lr):
        return (torch.tensor(lr, dtype=torch.float32, device=dev)
                if capturable else lr)

    groups = [{"params": [params[k] for k in names], "lr": rate(lr(config)),
               "base_lr": lr(config)} for names, lr in GROUPS.values()]
    return torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8,
                            capturable=capturable)


def is_capturable(optimizer: torch.optim.Optimizer) -> bool:
    """Whether every group keeps its step counts and its rate on the device
    (:func:`make_optimizer` on CUDA), so that a CUDA graph can replay the
    update."""
    return all(g.get("capturable") and isinstance(g["lr"], torch.Tensor)
               for g in optimizer.param_groups)


def update_count(state: TrainState):
    """The number of updates before this one: a capturable optimizer's own
    step count (a device tensor, read where it lies) once it has taken a
    step, else ``state.step``. The two agree for a state from
    :func:`init_state` or a checkpoint, which saves both."""
    opt = state.optimizer
    if is_capturable(opt):
        first = opt.state.get(opt.param_groups[0]["params"][0])
        if first:
            return first["step"]
    return state.step


def apply_lr_ramp(config: FitConfig, optimizer: torch.optim.Adam,
                  count) -> None:
    """Set each group's rate to base * lr_ramp ** (count / max_iter).

    :param count: an int, or a tensor whose ramp is taken in float64 on its
        device; a rate held as a tensor is written in place.
    """
    if isinstance(count, torch.Tensor):
        ramp = torch.pow(config.lr_ramp,
                         count.to(torch.float64) / config.max_iter)
    else:
        ramp = config.lr_ramp ** (count / config.max_iter)
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(group["base_lr"] * ramp)
        else:
            group["lr"] = group["base_lr"] * ramp


def load_optimizer_state(optimizer: torch.optim.Adam, saved: dict) -> None:
    """``optimizer.load_state_dict(saved)``, keeping the optimizer's own
    device policy: a state saved on another device loads capturable (or
    not) as this optimizer is, its rates tensors (or floats) as this
    optimizer's are."""
    groups = []
    for group, got in zip(optimizer.param_groups, saved["param_groups"]):
        rate = float(got["lr"])
        if isinstance(group["lr"], torch.Tensor):
            rate = torch.full_like(group["lr"], rate)
        groups.append(dict(got, capturable=group["capturable"], lr=rate))
    optimizer.load_state_dict(dict(saved, param_groups=groups))


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
    rates (from :func:`update_count`), quaternion renorm, ``state.step +=
    1`` (all in place)."""
    apply_corrective_gate(config, state.step, state.params)
    apply_lr_ramp(config, state.optimizer, update_count(state))
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
