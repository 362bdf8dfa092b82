"""The card's name and power limit as ``nvidia-smi`` reports them (the
query of ``fpc_diffrend_tpu_torch.bench.card``)."""

from __future__ import annotations

import subprocess


def card(device) -> tuple:
    """(name, power limit) of the card; on the CPU ("cpu", None)."""
    if device.type != "cuda":
        return "cpu", None
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    name, limit = r.stdout.strip().splitlines()[0].rsplit(",", 1)
    return name.strip(), limit.strip()
