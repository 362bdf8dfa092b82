"""Process-group meshes, batch sharding and the collectives of the
sharded fit (port of ``fpc_diffrend_tpu.parallel.mesh``).

One process (rank) owns one device. A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the default process
group, with named axes:

  "frame" — data parallelism over video-frame samples (per-frame pose
            parameters live with their shard);
  "view"  — parallelism over the cameras of a sample batch;
  "tile"  — spatial parallelism over image row-bands of one render (a
            one-row halo for the antialias seam).

``mesh.get_group(name)`` is the process group along one axis. Where the
JAX package places a whole array with a sharding, a rank here holds only
its own slice: :func:`shard_batch` cuts it out, :func:`replicate`
broadcasts from the mesh's first rank.

The collectives are autograd Functions: :func:`all_reduce_sum` is
``jax.lax.psum`` (its backward all-reduces the cotangent) and
:func:`ppermute` is ``jax.lax.ppermute``. The neighbour exchange is built
from the all-reduce too: each rank writes its tensor into its own slot of
a zero buffer of one slot per rank of the group, and after the sum reads
any rank's slot (:func:`exchange`). That works on every backend for
tensors on any device (gloo reduces CUDA tensors, but its send/recv take
CPU tensors only; NCCL refuses two ranks on one card), and the rows it
moves are small. Every all-reduce adds its element count to
``all_reduce_.elements``.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

from fpc_diffrend_tpu_torch.device import resolve_device

Tensor = torch.Tensor


def make_mesh(axis_names=("frame", "view"), shape=None, device_type=None):
    """A DeviceMesh of the default process group's ranks.

    :param axis_names: the mesh's axis names.
    :param shape: per-axis sizes; default packs every rank on the first
        axis. The product must equal the world size.
    :param device_type: "cuda" (None) or "cpu": the device each rank owns
        (JAX's ``devices``).
    :raises RuntimeError: CUDA is asked for and there is none, or no
        process group is initialized (``multihost.initialize``).
    """
    from torch.distributed.device_mesh import init_device_mesh

    device_type = resolve_device(device_type).type
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized; call "
                           "parallel.multihost.initialize first")
    n = dist.get_world_size()
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {tuple(shape)} does not hold the "
                         f"world's {n} ranks")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axis_names))


def axis_sizes(mesh) -> dict:
    """{axis name: size}."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate along axis ``name`` (``jax.lax.axis_index``);
    0 for an axis the mesh lacks."""
    if name not in mesh.mesh_dim_names:
        return 0
    return int(mesh.get_local_rank(name))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A rank's part of a leading axis: slice ``index`` of ``count`` equal
    slices (``count`` 1: the whole array, replicated)."""

    index: int
    count: int

    def cut(self, x):
        n = x.shape[0]
        if n % self.count:
            raise ValueError(f"leading axis {n} does not split into "
                             f"{self.count} shards")
        per = n // self.count
        return x[self.index * per:(self.index + 1) * per]


def batch_sharding(mesh) -> Sharding:
    """Split a (B, ...) batch across every mesh axis (flattened order, the
    first axis outermost)."""
    index = 0
    for name, size in axis_sizes(mesh).items():
        index = index * size + axis_index(mesh, name)
    return Sharding(index, int(mesh.mesh.numel()))


def replicated(mesh) -> Sharding:
    return Sharding(0, 1)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh, tree):
    """This rank's slice of every leaf's leading axis (the batch split over
    all mesh axes)."""
    return _tree_map(batch_sharding(mesh).cut, tree)


def replicate(mesh, tree):
    """Every tensor leaf broadcast from the mesh's first rank, in place;
    :return: the tree."""
    src = int(mesh.mesh.reshape(-1)[0])

    def bcast(x):
        if isinstance(x, Tensor) and dist.get_world_size() > 1:
            dist.broadcast(x, src)
        return x

    return _tree_map(bcast, tree)


# ----------------------------------------------------------------------------
# Collectives
# ----------------------------------------------------------------------------

def all_reduce_(x: Tensor, group=None) -> Tensor:
    """Sum ``x`` in place over ``group`` (None: the world); a group of one
    rank is skipped. Counts the elements moved."""
    if dist.get_world_size(group) > 1:
        all_reduce_.elements += x.numel()
        dist.all_reduce(x, group=group)
    return x


all_reduce_.elements = 0


class AllReduceSum(torch.autograd.Function):
    """psum: the sum over the group; its backward sums the cotangent
    over the group (every rank's loss depends on every rank's input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.group), None


def all_reduce_sum(x: Tensor, group=None) -> Tensor:
    """``jax.lax.psum`` over ``group``, differentiable."""
    return AllReduceSum.apply(x, group)


def exchange(x: Tensor, group) -> Tensor:
    """Every rank's ``x`` along ``group``: (group size, *x.shape), slot
    ``i`` the tensor of group rank ``i``. Differentiable (the sum's
    backward is the sum of the cotangent buffer)."""
    n = dist.get_world_size(group)
    if n == 1:
        return x[None]
    slots = torch.zeros((n,) + tuple(x.shape), dtype=x.dtype,
                        device=x.device)
    me = dist.get_rank(group)
    slots = slots.index_copy(0, torch.tensor([me], device=x.device), x[None])
    return all_reduce_sum(slots, group)


def ppermute(x: Tensor, group, perm) -> Tensor:
    """``jax.lax.ppermute``: ``perm`` lists (source, destination) group
    ranks; a rank receives its source's ``x``, or zeros when no pair
    names it as destination.

    Every rank's result stays in the autograd graph of the exchange (a
    rank that receives nothing gets its own slot times 0), so that every
    rank of the group runs the backward's all-reduce."""
    me = dist.get_rank(group) if dist.get_world_size(group) > 1 else 0
    src = [s for s, d in perm if d == me]
    slots = exchange(x, group)
    return slots[src[0]] if src else slots[0] * 0.0
