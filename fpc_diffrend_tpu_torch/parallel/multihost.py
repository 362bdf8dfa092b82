"""Multi-host glue (port of ``fpc_diffrend_tpu.parallel.multihost``):
frames across hosts.

The 'frame' mesh axis is laid out so that consecutive frame shards live
on the same host first: per-frame parameters stay with their shard, and
only the shared parameters' gradient all-reduce (texture, rig matrices,
per-camera corrections) crosses hosts, once a step.

This module wires ``torch.distributed`` and a mesh over every rank; the
sharded train step (``parallel/train.py``) does not depend on the layout.
One rank owns one device.
"""

from __future__ import annotations

import torch.distributed as dist

from fpc_diffrend_tpu_torch.device import resolve_device
from fpc_diffrend_tpu_torch.parallel.mesh import (axis_index, axis_sizes,
                                                  make_mesh)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str = "nccl") -> None:
    """Initialize the default process group; a no-op once initialized.

    :param coordinator_address: "host:port" of rank 0's store
        (``tcp://``); None reads torchrun's variables (``env://``: the
        address, the world size and the rank from ``MASTER_ADDR``,
        ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``, read by torch).
    :param num_processes, process_id: the world size and this rank (None
        with ``env://``).
    :param backend: "nccl" for CUDA ranks of their own cards, "gloo" for
        CPU ranks or ranks that share a card.
    """
    if dist.is_initialized():
        return
    if coordinator_address is None:
        init_method = "env://"
    else:
        init_method = "tcp://" + coordinator_address.removeprefix("tcp://")
    kwargs = {}
    if num_processes is not None:
        kwargs["world_size"] = num_processes
    if process_id is not None:
        kwargs["rank"] = process_id
    dist.init_process_group(backend, init_method=init_method, **kwargs)


def make_pod_mesh(view_parallel: int = 1, tile_parallel: int = 1,
                  device_type=None):
    """Mesh over every rank of the world, ("frame", "view", "tile").

    The 'frame' axis absorbs every rank not used by 'view'/'tile', and is
    outermost, so consecutive frame shards live on the same host first
    (ranks are numbered host by host).

    :param device_type: "cuda" (None) or "cpu".
    """
    device_type = resolve_device(device_type).type
    n = dist.get_world_size()
    inner = view_parallel * tile_parallel
    if n % inner:
        raise ValueError(f"{n} ranks do not split into view x tile = "
                         f"{view_parallel} x {tile_parallel}")
    return make_mesh(("frame", "view", "tile"),
                     (n // inner, view_parallel, tile_parallel), device_type)


def local_frame_range(mesh, n_frames: int) -> tuple[int, int]:
    """[start, end) of the frame indices this rank's frame shard owns."""
    frame_size = axis_sizes(mesh)["frame"]
    per = (n_frames + frame_size - 1) // frame_size
    start = axis_index(mesh, "frame") * per
    return min(start, n_frames), min(start + per, n_frames)
