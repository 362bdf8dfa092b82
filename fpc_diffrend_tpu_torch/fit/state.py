"""Learned parameters (port of ``fpc_diffrend_tpu.fit.state``'s init).

Parameters are a plain dict of float32 tensors with the JAX package's names
and shapes. The optimizer comes with the backward in slice 2.
"""

from __future__ import annotations

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
