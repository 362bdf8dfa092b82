"""Checkpoint and resume of the fit (port of ``fpc_diffrend_tpu.fit.
checkpoint``, with ``torch.save`` in place of orbax).

A checkpoint is the whole TrainState: the step, the parameters and the
Adam state (moments, step counts, group rates), one file
``step_{step:09d}.pt`` per saved step in the checkpoint directory.
Restoring copies the saved values into a TrainState built from the same
config, so the optimizer keeps its hold on the parameter tensors.
"""

from __future__ import annotations

import os

import torch

from fpc_diffrend_tpu_torch.fit import state as state_mod

_PREFIX = "step_"


def save_checkpoint(ckpt_dir: str, state: state_mod.TrainState) -> str:
    """Write a checkpoint of the state's current step; :return: its path.

    The file is written under a temporary name and renamed, so a crash
    mid-write never leaves a truncated latest checkpoint.
    """
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(os.path.abspath(ckpt_dir),
                        f"{_PREFIX}{int(state.step):09d}.pt")
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({"step": int(state.step),
                "params": {k: v.detach().cpu()
                           for k, v in state.params.items()},
                "opt_state": state.optimizer.state_dict()}, tmp)
    os.replace(tmp, path)
    return path


def latest_checkpoint(ckpt_dir: str) -> str | None:
    """The path of the highest step's checkpoint in ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith(_PREFIX) and d.endswith(".pt"))
    return os.path.join(ckpt_dir, steps[-1]) if steps else None


def restore_checkpoint(path: str, reference: state_mod.TrainState
                       ) -> state_mod.TrainState:
    """The saved TrainState, in ``reference``'s tensors.

    :param reference: a TrainState of the same config and shapes; its
        parameters are overwritten in place, its optimizer loads the saved
        state and its CUDA graph of the step, which read the optimizer's
        old tensors, is dropped.
    """
    reference.graph = None
    saved = torch.load(path, map_location="cpu", weights_only=True)
    with torch.no_grad():
        for k, v in reference.params.items():
            v.copy_(saved["params"][k])
    state_mod.load_optimizer_state(reference.optimizer, saved["opt_state"])
    return state_mod.TrainState(step=int(saved["step"]),
                                params=reference.params,
                                optimizer=reference.optimizer)


def checkpoint_callback(ckpt_dir: str, interval: int):
    """A ``run_fit`` callback that writes a checkpoint every ``interval``
    steps."""
    def cb(i, state, metrics):
        if interval and i and i % interval == 0:
            save_checkpoint(ckpt_dir, state)
    return cb
