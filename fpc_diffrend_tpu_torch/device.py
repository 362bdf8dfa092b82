"""Device selection: CUDA by default, the CPU only when asked for."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on.

    :param device: ``None`` means ``"cuda"``; ``"cpu"`` must be asked for
        explicitly (the CPU tests do).
    :raises RuntimeError: a CUDA device was asked for and there is none —
        nothing falls back to the CPU on its own.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev
