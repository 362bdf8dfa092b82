"""Multi-device train step over ('frame', 'view', 'tile') ranks (port of
``fpc_diffrend_tpu.parallel.train``).

* The global (camera, frame) sample batch is split over the 'frame' and
  'view' axes (data and view parallelism); reference images arrive cut to
  each rank's band rows (``shard_batch_for``).
* Each sample's render is split over the 'tile' axis into horizontal
  image bands with a one-row halo for the antialias seam
  (``parallel/spatial.py``). On the kernel route a rank renders all its
  samples' bands stacked: one K11, K1 and K2 a step forward, one K3, K4,
  K5 and K6 backward.
* Each rank takes the gradient of its local loss share; one all-reduce
  over all ranks gives the exact global gradient of the shared
  parameters. Then the port's corrective gate, the Adam ramp and the
  quaternion renorm (``fit.state.optimizer_step``).
* With ``shard_frames=True`` the per-frame parameters and their Adam
  moments live with their frame shard: a rank holds only its shard's rows
  of ``per_frame_t``/``per_frame_q`` and its columns of ``maps``/``m1``
  (``frame_shard``; the optimizer's moments follow the tensors it
  updates), their gradients are summed only over ('view', 'tile'), and
  the temporal-smoothness term takes its one-frame pose halo from the
  previous shard through one exchange. Each frame shard must sample
  frames from its own contiguous range (``sample_stratified``).

Loss sharing: the photometric sum over a rank's band pixels is divided by
the global batch's pixel count, the mesh regularizers by B and the number
of bands, the staging and temporal terms by the data-parallel groups and
the bands, so that the sum over ranks is the single-device loss.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from fpc_diffrend_tpu_torch.device import resolve_device
from fpc_diffrend_tpu_torch.fit import losses as losses_mod
from fpc_diffrend_tpu_torch.fit import state as state_mod
from fpc_diffrend_tpu_torch.fit.config import FitConfig
from fpc_diffrend_tpu_torch.fit.loop import (Batch, build_mvp,
                                             resolve_aa_max_pairs)
from fpc_diffrend_tpu_torch.fit.scene import Scene
from fpc_diffrend_tpu_torch.models import blendshape
from fpc_diffrend_tpu_torch.models.camera import transform_clip
from fpc_diffrend_tpu_torch.ops import mesh_ops
from fpc_diffrend_tpu_torch.ops.rasterize import check_impl
from fpc_diffrend_tpu_torch.parallel import spatial
from fpc_diffrend_tpu_torch.parallel.mesh import (all_reduce_, axis_index,
                                                  axis_sizes, exchange,
                                                  ppermute)

Tensor = torch.Tensor

AXES = ("frame", "view", "tile")

# Parameters (and their Adam moments) that live with their frame shard
# when shard_frames=True, and the dimension the frame indexes:
# per_frame_t/q by row (reference fit.py:451-454), maps and m1 by column
# (the frame one-hot, reference fit.py:104-129, 47-62).
FRAME_SHARDED = {"per_frame_t": 0, "per_frame_q": 0, "maps": 1, "m1": 1}


def _temporal_smoothness_sharded(config: FitConfig, params: dict,
                                 frame_idx, local_frame, nf: int,
                                 group=None):
    """``fit.losses.temporal_smoothness`` over frame-sharded pose rows.

    The only cross-shard coupling is each shard's first frame needing its
    predecessor's pose: one (3,) + (4,) halo from the previous shard's
    last row, through the frame axis's ``group``.
    """
    if config.weight_temporal == 0.0:
        return torch.zeros((), device=frame_idx.device)
    t = params["per_frame_t"]
    q = params["per_frame_q"]
    last = torch.cat([t[-1], q[-1]])
    if nf > 1:
        halo = ppermute(last, group, [(i, i + 1) for i in range(nf - 1)])
    else:
        halo = last
    prev = local_frame - 1
    prev_c = torch.clamp(prev, min=0)
    inside = (prev >= 0)[:, None]
    t_prev = torch.where(inside, t[prev_c], halo[None, :3])
    q_prev = torch.where(inside, q[prev_c], halo[None, 3:])
    dt = t[local_frame] - t_prev
    dq = q[local_frame] - q_prev
    gate = (frame_idx > 0).to(torch.float32)
    per = (torch.sum(dt * dt, dim=-1) + torch.sum(dq * dq, dim=-1)) * gate
    return config.weight_temporal * torch.mean(per)


def _mesh_regularizers(config: FitConfig, scene: Scene, verts3: Tensor):
    """(B,) weighted mesh regularizers of each sample, as
    ``fit.loop.loss_from_render`` takes them: a term of weight 0 is not
    computed (JAX's sharded loss computes all three and weighs them)."""
    reg = torch.zeros(verts3.shape[0], device=verts3.device)
    if config.weight_meshedge:
        reg = reg + config.weight_meshedge * mesh_ops.mesh_edge_loss(
            verts3, scene.edges, config.meshedge_target)
    if config.weight_laplacian:
        lap = mesh_ops.mesh_laplacian_smoothing_padded(
            verts3, scene.nbr_idx, scene.nbr_mask, scene.degree)
        reg = reg + config.weight_laplacian * lap ** 2
    if config.weight_normalconsistency:
        reg = reg + config.weight_normalconsistency * (
            mesh_ops.mesh_normal_consistency(verts3, scene.faces,
                                             scene.edge_face_pairs))
    return reg


class _Axes:
    """A mesh's sizes, this rank's coordinates and the groups the step
    reduces over: 'tile' (the seam), 'frame' (the pose halo), and the
    ('view', 'tile') ranks of this rank's frame shard."""

    def __init__(self, mesh):
        self.sizes = {a: axis_sizes(mesh).get(a, 1) for a in AXES}
        self.index = {a: axis_index(mesh, a) for a in AXES}
        self.tile = (mesh.get_group("tile") if "tile" in mesh.mesh_dim_names
                     else None)
        self.frame = (mesh.get_group("frame")
                      if "frame" in mesh.mesh_dim_names else None)
        self.nofr = None
        if self.sizes["frame"] > 1 and mesh.mesh.numel() > self.sizes[
                "frame"]:
            # one group per frame shard: its ('view', 'tile') ranks; every
            # rank creates every group, in the same order
            nf = self.sizes["frame"]
            dim = mesh.mesh_dim_names.index("frame")
            ranks = mesh.mesh.movedim(dim, 0).reshape(nf, -1).tolist()
            self.nofr, _ = dist.new_subgroups_by_enumeration(ranks)


def _local_loss(config: FitConfig, scene: Scene, params: dict, batch: Batch,
                step, n_bands: int, batch_scale: float,
                shard_frames: bool = False, nf: int = 1, axes=None):
    """Loss share of one rank (``axes``: the step's :class:`_Axes`)."""
    band = axes.index["tile"] if n_bands > 1 else 0
    hb = config.resolution[0] // n_bands
    band_res = (hb, config.resolution[1])

    if shard_frames:
        f_lo = axes.index["frame"] * params["per_frame_t"].shape[0]
        local_frame = batch.frame_idx - f_lo
    else:
        local_frame = batch.frame_idx

    vtx = blendshape.blend(config.mode, {**params, "deltas": scene.deltas},
                           scene.v_base, local_frame,
                           config.combined_corrective_coefficient)
    verts3 = vtx.reshape(local_frame.shape[0], -1, 3)
    mvp = build_mvp(scene, params, batch.cam_idx, local_frame)
    window = spatial.band_window_matrix(band, n_bands, mvp.device)
    band_clip = transform_clip(window @ mvp, verts3)
    imgs = spatial.render_band_stacked(
        band_clip, scene.faces, scene.uv, scene.uv_idx, params["tex"],
        band_res, scene.face_neighbors, band, n_bands,
        enable_mip=config.enable_mip, max_mip_level=config.max_mip_level,
        impl=config.raster_impl, group=axes.tile if n_bands > 1 else None,
        aa_max_pairs=resolve_aa_max_pairs(config),
        pair_cap=config.pair_cap if config.pair_cap > 0 else None)
    # the reference arrives cut to this rank's band rows
    pix_sum = torch.sum((batch.ref - imgs * 255.0) ** 2)
    reg = _mesh_regularizers(config, scene, verts3)
    n_px = config.resolution[0] * config.resolution[1]
    # the regularizers are the same on every band: divide by n_bands so
    # the sum over ranks counts them once, and by B for the mean
    local = (pix_sum / (batch_scale * n_px)
             + torch.sum(reg) / (batch_scale * n_bands))
    extra = losses_mod.staging_regularizers(config, params, local_frame,
                                            step)
    if shard_frames:
        extra = extra + _temporal_smoothness_sharded(
            config, params, batch.frame_idx, local_frame, nf, axes.frame)
    else:
        extra = extra + losses_mod.temporal_smoothness(config, params,
                                                       batch.frame_idx)
    dp_groups = batch_scale / batch.cam_idx.shape[0]
    return local + extra / (dp_groups * n_bands)


def _all_reduce_flat(tensors, group) -> None:
    """Sum tensors over ``group`` in place, as one flat buffer (nothing to
    do for a group of one rank)."""
    if not tensors or dist.get_world_size(group) == 1:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    all_reduce_(flat, group)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def make_sharded_train_step(config: FitConfig, scene: Scene, mesh,
                            shard_frames: bool = False, params_like=None):
    """Build this rank's sharded train step; every rank of ``mesh`` calls
    it (it creates process groups) and then each step, in the same order.

    The global batch size must be divisible by frame_size * view_size and
    the height by tile_size. Returns fn(state, batch) -> (state, metrics),
    where ``state`` is this rank's ``fit.state.TrainState`` (its
    parameters cut by :func:`frame_shard` under ``shard_frames``) and
    ``batch`` this rank's part of the global batch
    (:func:`shard_batch_for`). The step updates the state in place; the
    summed gradients stay in the parameters' ``.grad`` (the frame-sharded
    ones as this rank's shard), and ``metrics["loss"]`` is the global
    loss.

    :param shard_frames: shard the per-frame parameters and their Adam
        moments over the 'frame' axis (their gradients then skip the
        'frame' sum). Requires every sample on frame shard k to reference
        a frame of shard k's contiguous range (``sample_stratified``) and
        n_frames divisible by the axis size.
    :param params_like: the full parameter dict (or one of its shape),
        required with ``shard_frames``: the frame count is checked
        against the axis.
    """
    dev = resolve_device(mesh.device_type)
    if scene.device.type != dev.type:
        raise ValueError(f"the scene is on {scene.device}, the mesh's ranks "
                         f"own {dev.type} devices")
    config.validate()
    check_impl(config.raster_impl)
    axes = _Axes(mesh)
    n_bands = axes.sizes["tile"]
    nf = axes.sizes["frame"]
    dp = nf * axes.sizes["view"]
    if config.batch_size % dp:
        raise ValueError(f"batch {config.batch_size} does not split over "
                         f"frame x view = {dp} ranks")
    if config.resolution[0] % n_bands:
        raise ValueError(f"height {config.resolution[0]} does not split "
                         f"into {n_bands} bands")
    shard_frames = shard_frames and nf > 1
    if shard_frames:
        if params_like is None:
            raise ValueError("shard_frames=True requires params_like")
        n_frames = params_like["per_frame_t"].shape[0]
        if n_frames % nf:
            raise ValueError(f"{n_frames} frames do not split over {nf} "
                             "frame shards")
    batch_scale = float(config.batch_size)

    def train_step(state: state_mod.TrainState, batch: Batch):
        params = state.params
        for p in params.values():
            p.requires_grad_(True)
        state.optimizer.zero_grad(set_to_none=False)
        with torch.enable_grad():
            loss = _local_loss(config, scene, params, batch, state.step,
                               n_bands, batch_scale, shard_frames, nf, axes)
            loss.backward()
        for p in params.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        local = [k for k in params if shard_frames and k in FRAME_SHARDED]
        if axes.nofr is not None:
            _all_reduce_flat([params[k].grad for k in local], axes.nofr)
        total = loss.detach().reshape(1)
        _all_reduce_flat([params[k].grad for k in params if k not in local]
                         + [total], None)
        state_mod.optimizer_step(config, state)
        return state, {"loss": total[0]}

    return train_step


def shard_batch_for(mesh, batch: Batch) -> Batch:
    """This rank's part of a global batch: its samples of the split over
    ('frame', 'view'), the reference cut to its band's rows of the split
    over 'tile'."""
    sizes = {a: axis_sizes(mesh).get(a, 1) for a in AXES}
    dp = sizes["frame"] * sizes["view"]
    k = axis_index(mesh, "frame") * sizes["view"] + axis_index(mesh, "view")
    per = batch.cam_idx.shape[0] // dp
    hb = batch.ref.shape[1] // sizes["tile"]
    band = axis_index(mesh, "tile")
    sl = slice(k * per, (k + 1) * per)
    return Batch(cam_idx=batch.cam_idx[sl], frame_idx=batch.frame_idx[sl],
                 ref=batch.ref[sl, band * hb:(band + 1) * hb])


def frame_shard(params: dict, mesh) -> dict:
    """This rank's copy of the parameters with the per-frame ones
    (:data:`FRAME_SHARDED`) cut to its frame shard's rows or columns."""
    nf = axis_sizes(mesh).get("frame", 1)
    k = axis_index(mesh, "frame")
    out = {}
    for name, p in params.items():
        if name in FRAME_SHARDED and nf > 1:
            per = p.shape[FRAME_SHARDED[name]] // nf
            p = p.narrow(FRAME_SHARDED[name], k * per, per)
        out[name] = p.detach().clone()
    return out


def gather_frame_shards(tensors: dict, mesh) -> dict:
    """The inverse of :func:`frame_shard` (on every rank): the frame
    shards of the :data:`FRAME_SHARDED` entries joined over the frame
    axis; other entries as they are. Also for their gradients."""
    nf = axis_sizes(mesh).get("frame", 1)
    out = dict(tensors)
    if nf == 1:
        return out
    group = mesh.get_group("frame")
    for name, dim in FRAME_SHARDED.items():
        if name in tensors:
            parts = exchange(tensors[name].detach(), group)
            out[name] = torch.cat(list(parts), dim=dim)
    return out


def sample_stratified(rng, config: FitConfig, mesh, n_frames: int,
                      n_cams: int):
    """Sample a (cam_idx, frame_idx) batch compatible with shard_frames.

    Sample i of the global batch lands on frame shard i // (B / nf); its
    frame is drawn uniformly from that shard's contiguous range
    [k * n_frames / nf, (k + 1) * n_frames / nf). Cameras are uniform.
    The draws are the JAX package's, from the same numpy ``rng``.

    :return: (cam_idx, frame_idx), (B,) int64 CPU tensors.
    """
    nf = axis_sizes(mesh).get("frame", 1)
    B = config.batch_size
    if B % nf or n_frames % nf:
        raise ValueError(f"batch {B} and {n_frames} frames must split over "
                         f"{nf} frame shards")
    per = B // nf
    fper = n_frames // nf
    frames = np.concatenate([
        rng.integers(k * fper, (k + 1) * fper, per).astype(np.int32)
        for k in range(nf)])
    cams = rng.integers(0, n_cams, B).astype(np.int32)
    return (torch.from_numpy(cams.astype(np.int64)),
            torch.from_numpy(frames.astype(np.int64)))
