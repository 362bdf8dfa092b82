"""The batched fit step (port of ``fpc_diffrend_tpu.fit.loop``).

blend -> pose -> clip -> stacked-batch render (K1, K2; with mip, K1, K8
deriving the LOD, K2) -> composite -> photometric + mesh regularizer + staging/temporal
losses, then the backward (K3 -> K4 -> K5 -> K6, with mip K3 -> K9 -> K5
-> K6, and autograd for the rest), the corrective gate, Adam at the
ramped rates and the quaternion renorm. The mvp matches the JAX
package's:
  proj @ rigid(per-frame pose) @ rigid(per-camera correction) @ modelview

Entry points: ``evaluate`` (the loss forward for a few sampled batches),
``train_step`` (one step on a given batch), ``train_steps`` (k steps with
on-device sampling) and ``run_fit``; ``render_sample`` renders one
(camera, frame) sample. Nothing on the kernel route's step path reads a
device value on the host, so steps queue on the card without waiting.
With ``raster_impl="scan"`` the batch renders sample by sample through
``render_sample`` (the JAX package's ``vmap`` fallback), over the
O(T·H·W) reference rasterizer.

On a CUDA device on the kernel route, ``train_steps`` captures
``train_step`` as a CUDA graph once per state (:class:`StepGraph`) and
replays it, so that a step costs the host a few launches and one replay
in place of ~960 launches; the sampling stays eager and in the same
order. The CPU and the scan route run every step eagerly.

The step's layers are spans of ``utils.profiling`` (``fit.dispatch``,
``fit.sample``, ``fit.step``, ``fit.forward``, ``model.prologue``,
``fit.loss``, ``fit.backward``, ``fit.optimizer``, ``fit.replay``,
``fit.callbacks``; a view is ``view.render``), which cost nothing unless
``profiling.recording()`` is on; a replayed step records only
``fit.replay``, the step's inner spans are those of the step that
captured it. Counters: ``fit.eager_steps``, ``fit.graph_captures``,
``fit.graph_replays``, and ``fit.batch_samples`` (the samples each step
renders, counted on the host, replays included).
"""

from __future__ import annotations

import itertools
from typing import NamedTuple

import numpy as np
import torch

from fpc_diffrend_tpu_torch.fit import losses as losses_mod
from fpc_diffrend_tpu_torch.fit import state as state_mod
from fpc_diffrend_tpu_torch.fit.config import FitConfig
from fpc_diffrend_tpu_torch.fit.scene import Scene
from fpc_diffrend_tpu_torch.models import blendshape, pose
from fpc_diffrend_tpu_torch.models.camera import transform_clip
from fpc_diffrend_tpu_torch.ops import mesh_ops
from fpc_diffrend_tpu_torch.ops.pipeline import (render_batch_stacked,
                                                 render_from_clip)
from fpc_diffrend_tpu_torch.ops.precision import get_precision
from fpc_diffrend_tpu_torch.ops.rasterize import check_impl
from fpc_diffrend_tpu_torch.utils.profiling import count, span

Tensor = torch.Tensor


class Batch(NamedTuple):
    cam_idx: Tensor     # (B,) int
    frame_idx: Tensor   # (B,) int
    ref: Tensor         # (B, H, W, 1) float32 (already clipped + flipped)


def build_mvp(scene: Scene, params: dict, cam_idx: Tensor,
              frame_idx: Tensor) -> Tensor:
    """(B, 4, 4) modelview-projection per (camera, frame) sample."""
    rigid_cam = pose.rigid_from_pose(params["t_opt"][cam_idx],
                                     params["q_opt"][cam_idx])
    rigid_pose = pose.rigid_from_pose(params["per_frame_t"][frame_idx],
                                      params["per_frame_q"][frame_idx])
    return scene.proj[cam_idx] @ (rigid_pose @ (rigid_cam
                                                @ scene.mv[cam_idx]))


def sample_clip_positions(config: FitConfig, scene: Scene, params: dict,
                          cam_idx: Tensor, frame_idx: Tensor):
    """Blend + pose prologue.

    :return: (pos_clip (B, V, 4), verts3 (B, V, 3)).
    """
    with span("model.prologue"):
        vtx = blendshape.blend(config.mode,
                               {**params, "deltas": scene.deltas},
                               scene.v_base, frame_idx,
                               config.combined_corrective_coefficient)
        verts3 = vtx.reshape(frame_idx.shape[0], -1, 3)
        mvp = build_mvp(scene, params, cam_idx, frame_idx)
        return transform_clip(mvp, verts3), verts3


def resolve_aa_max_pairs(config: FitConfig) -> int | None:
    """``config.aa_max_pairs`` -> the scan route's antialias pair cap:
    0 = 8 (H + W), -1 = None (every pair, exact)."""
    if config.aa_max_pairs == -1:
        return None
    if config.aa_max_pairs == 0:
        h, w = config.resolution
        return 8 * (h + w)
    return config.aa_max_pairs


_view_ids = itertools.count().__next__      # the views' request ids


def render_sample(config: FitConfig, scene: Scene, params: dict, cam_idx,
                  frame_idx):
    """Blend, pose and render one (camera, frame) sample through
    ``ops.pipeline.render_from_clip`` with ``config.raster_impl``.

    :param cam_idx, frame_idx: ints or 0-d integer tensors.
    :return: (image (H, W, C), verts3 (V, 3)).
    """
    with span("view.render", request=_view_ids):
        cam, frame = (torch.as_tensor(i, device=scene.device).reshape(1)
                      for i in (cam_idx, frame_idx))
        pos_clip, verts3 = sample_clip_positions(config, scene, params, cam,
                                                 frame)
        img = render_from_clip(pos_clip[0], scene.faces, scene.uv,
                               scene.uv_idx, params["tex"],
                               tuple(config.resolution), scene.face_neighbors,
                               enable_mip=config.enable_mip,
                               max_mip_level=config.max_mip_level,
                               impl=config.raster_impl,
                               aa_max_pairs=resolve_aa_max_pairs(config),
                               pair_cap=config.pair_cap or None)
        return img, verts3[0]


def render_batch(config: FitConfig, scene: Scene, params: dict,
                 cam_idx: Tensor, frame_idx: Tensor):
    """Render a (B,) batch: through the stacked-batch kernel pipeline, or
    with ``config.raster_impl == "scan"`` sample by sample through
    :func:`render_sample` (the entry points check ``config.raster_impl``
    once, not each step).

    With ``config.enable_mip`` the texture is sampled trilinearly across
    its mip chain (K8, K9 in place of K1's tail and K4). The JAX package
    renders that configuration per sample under ``vmap``; the port renders
    it stacked, which gives each sample the same result (the JAX package
    calls its stacked path "functionally identical to vmapping"). The bins
    keep ``config.pair_cap`` entries a sample (0: all).

    :return: (imgs (B, H, W, C), verts3 (B, V, 3)).
    """
    if config.raster_impl == "scan":
        out = [render_sample(config, scene, params, c, f)
               for c, f in zip(cam_idx, frame_idx)]
        return (torch.stack([img for img, _ in out]),
                torch.stack([v for _, v in out]))
    pos_clip_b, verts3 = sample_clip_positions(config, scene, params,
                                               cam_idx, frame_idx)
    imgs = render_batch_stacked(pos_clip_b, scene.faces, scene.uv,
                                scene.uv_idx, params["tex"],
                                tuple(config.resolution),
                                scene.face_neighbors,
                                enable_mip=config.enable_mip,
                                max_mip_level=config.max_mip_level,
                                pair_cap=config.pair_cap)
    return imgs, verts3


def loss_from_render(config: FitConfig, scene: Scene, params: dict,
                     batch: Batch, imgs: Tensor, verts3: Tensor, step=0):
    """The loss terms from rendered images and blended vertices.

    :return: (total, metrics dict of scalar tensors).
    """
    with span("fit.loss"):
        pix = losses_mod.photometric_loss(batch.ref, imgs).mean()
        zero = torch.zeros((), dtype=torch.float32, device=imgs.device)
        mel_m = lap_m = mnc_m = zero
        if config.weight_meshedge:
            mel = mesh_ops.mesh_edge_loss(verts3, scene.edges,
                                          config.meshedge_target)
            mel_m = config.weight_meshedge * mel.mean()
        if config.weight_laplacian:
            lap = mesh_ops.mesh_laplacian_smoothing_padded(
                verts3, scene.nbr_idx, scene.nbr_mask, scene.degree)
            lap_m = config.weight_laplacian * (lap ** 2).mean()
        if config.weight_normalconsistency:
            mnc = mesh_ops.mesh_normal_consistency(verts3, scene.faces,
                                                   scene.edge_face_pairs)
            mnc_m = config.weight_normalconsistency * mnc.mean()
        extra = (losses_mod.staging_regularizers(config, params,
                                                 batch.frame_idx, step)
                 + losses_mod.temporal_smoothness(config, params,
                                                  batch.frame_idx))
        total = pix + (mel_m + lap_m + mnc_m) + extra
        return total, {"loss": total, "pix": pix, "mel": mel_m, "lap": lap_m,
                       "mnc": mnc_m}


def loss_fn(params: dict, config: FitConfig, scene: Scene, batch: Batch,
            step=0):
    """Forward of the fit loss for one batch: (total, metrics)."""
    imgs, verts3 = render_batch(config, scene, params, batch.cam_idx,
                                batch.frame_idx)
    return loss_from_render(config, scene, params, batch, imgs, verts3, step)


def decode_refs(frames_u8: Tensor, cam_idx: Tensor,
                frame_idx: Tensor) -> Tensor:
    """uint8 (C, F, H, W) frames -> (B, H, W, 1) float32 references."""
    return frames_u8[cam_idx, frame_idx].to(torch.float32)[..., None]


def sample_batches(config: FitConfig, n_frames: int,
                   generator: torch.Generator):
    """Endless sampler of (cam, frame) index batches from ``generator``
    (a CPU generator; the indices are moved to the device by the caller)."""
    cams = torch.tensor(config.cam_idxs, dtype=torch.int64)
    B = config.batch_size
    while True:
        pick = torch.randint(0, cams.shape[0], (B,), generator=generator)
        frame = torch.randint(0, n_frames, (B,), generator=generator)
        yield cams[pick], frame


def evaluate(config: FitConfig, scene: Scene, params: dict,
             frames_u8: Tensor, n_batches: int,
             generator: torch.Generator) -> dict:
    """Slice-1 entry point: the loss forward for ``n_batches`` sampled
    batches, without gradients.

    :param frames_u8: (C, F, H, W) uint8 reference frames on the scene's
        device.
    :return: metric name -> (n_batches,) tensor on the scene's device.
    """
    config.validate()
    check_impl(config.raster_impl)
    dev = scene.device
    sampler = sample_batches(config, frames_u8.shape[1], generator)
    rows = []
    with torch.no_grad():
        for _ in range(n_batches):
            cam, frame = (t.to(dev) for t in next(sampler))
            batch = Batch(cam, frame, decode_refs(frames_u8, cam, frame))
            rows.append(loss_fn(params, config, scene, batch)[1])
    return {k: torch.stack([m[k] for m in rows]) for k in rows[0]}


def train_step(config: FitConfig, scene: Scene, state: state_mod.TrainState,
               batch: Batch) -> dict:
    """One optimization step on ``batch``; updates ``state`` in place.

    Forward, backward, corrective gate, Adam at the ramped rates,
    quaternion renorm, ``state.step += 1``. A parameter the mode does not
    use gets a zero gradient (optax updates every leaf; ``torch.optim``
    would skip a parameter whose gradient is None).

    :return: metric name -> scalar tensor on the device.
    """
    with span("fit.step", request=state.step):
        params = state.params
        for p in params.values():
            p.requires_grad_(True)
        state.optimizer.zero_grad(set_to_none=False)
        with torch.enable_grad():
            with span("fit.forward"):
                total, metrics = loss_fn(params, config, scene, batch,
                                         state.step)
            with span("fit.backward"):
                total.backward()
        with span("fit.optimizer"):
            for p in params.values():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            state_mod.optimizer_step(config, state)
        return {k: v.detach() for k, v in metrics.items()}


def graph_engaged(config: FitConfig, state: state_mod.TrainState) -> bool:
    """Whether :func:`train_steps` runs the state's steps through a CUDA
    graph: its parameters are on a CUDA device, ``config.raster_impl`` is
    the kernel route (the scan route's ``render_sample`` copies each
    sample's indices from the host) and its optimizer is capturable
    (``fit.state.make_optimizer`` on CUDA)."""
    return (next(iter(state.params.values())).is_cuda
            and check_impl(config.raster_impl) == "pallas"
            and state_mod.is_capturable(state.optimizer))


def _graph_key(config: FitConfig, scene: Scene, state: state_mod.TrainState,
               frames_u8: Tensor) -> tuple:
    """What a captured step bakes in or reads by address: the config, the
    scene and the frames, every parameter, gradient, optimizer state and
    rate tensor (a checkpoint's restore replaces the optimizer's), the
    corrective gate (in combined mode the staging gate flips with it) and
    the precision modes."""
    opt = state.optimizer
    ptrs = []
    for p in state.params.values():
        ptrs.append(p.data_ptr())
        ptrs.append(0 if p.grad is None else p.grad.data_ptr())
        ptrs.extend(t.data_ptr() for t in opt.state.get(p, {}).values())
    ptrs.extend(g["lr"].data_ptr() for g in opt.param_groups)
    return (config, id(scene), id(frames_u8), frames_u8.data_ptr(),
            tuple(ptrs), state_mod.corrective_gate(config, state.step),
            get_precision())


class StepGraph:
    """A state's training step as a CUDA graph: :func:`train_step` on a
    batch whose camera and frame indices it reads from static buffers
    (``decode_refs`` inside), its metrics left in one static tensor.

    Kept in ``TrainState.graph`` with its memory pool, under the key
    (:func:`_graph_key`) of the state it was made for. A state's first
    step, and the first after its key changed, runs eagerly on the graph's
    side stream (the warm-up: kernel builds, Adam's state, the stream's
    cuBLAS workspace); the next step is captured on that stream and
    replayed, later steps replay. The kernel wrappers' ``.launches`` count
    the capture once and no replay (``ops.cuda.device_launches`` measures
    what a replay ran).
    """

    def __init__(self, key: tuple, config: FitConfig, stream, keep: tuple):
        self.key = key
        self.stream = stream
        self.keep = keep            # read by address: alive with the graph
        dev = stream.device
        self.cams = _cams(config, dev)
        self.cam = torch.empty((config.batch_size,), dtype=torch.int64,
                               device=dev)
        self.frame = torch.empty_like(self.cam)
        self.graph = self.out = None
        self.names = ()

    def capture(self, config: FitConfig, scene: Scene,
                state: state_mod.TrainState, frames_u8: Tensor) -> None:
        """Capture one step of ``state`` (its host step count is left as it
        was: the capture runs nothing). A capture that fails drops the
        state's graph."""
        step = state.step
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=self.stream):
                batch = Batch(self.cam, self.frame,
                              decode_refs(frames_u8, self.cam, self.frame))
                metrics = train_step(config, scene, state, batch)
                self.out = torch.stack(list(metrics.values()))
            state.step = step
            if _graph_key(config, scene, state, frames_u8) != self.key:
                raise RuntimeError(
                    "the captured step replaced a tensor it reads")
        except BaseException:
            state.graph = None
            raise
        finally:
            state.step = step
        self.names = tuple(metrics)
        self.graph = graph


def _cams(config: FitConfig, dev) -> Tensor:
    """``config.cam_idxs`` on the device (an asynchronous copy: no host
    sync)."""
    return torch.tensor(config.cam_idxs, dtype=torch.int64).to(
        dev, non_blocking=True)


def _sample(cams: Tensor, generator: torch.Generator, B: int, n_frames: int,
            cam=None, frame=None):
    """A step's (camera, frame) indices from ``generator``: the camera
    pick, then the frame (the order a checkpoint's resume replays), written
    into ``cam`` and ``frame`` where given."""
    pick = torch.randint(0, cams.shape[0], (B,), generator=generator,
                         device=cams.device)
    cam = torch.index_select(cams, 0, pick, out=cam)
    frame = torch.randint(0, n_frames, (B,), generator=generator,
                          device=cams.device, out=frame)
    return cam, frame


def _graph_steps(config: FitConfig, scene: Scene,
                 state: state_mod.TrainState, frames_u8: Tensor,
                 generator: torch.Generator, k: int, n_frames: int) -> dict:
    """:func:`train_steps` on the state's :class:`StepGraph`: each step a
    replay, sampled straight into the graph's index buffers (the graph is
    captured first where it is new), or eager (and a new graph) where
    there is none for the state's key. Each step's metrics are copied out
    of the graph's static tensor into a row of its own.

    :return: metric name -> (k,) tensor on the device.
    """
    dev = scene.device
    B = config.batch_size
    rows = names = None
    for i in range(k):
        rec = state.graph
        if rec is not None and rec.key == _graph_key(config, scene, state,
                                                     frames_u8):
            with span("fit.sample"):
                _sample(rec.cams, generator, B, n_frames, rec.cam, rec.frame)
            if rec.graph is None:
                rec.capture(config, scene, state, frames_u8)
                count("fit.graph_captures", 1)
            with span("fit.replay", request=state.step):
                rec.graph.replay()
            state.step += 1
            count("fit.graph_replays", 1)
            row, names = rec.out, rec.names
        else:
            state.graph = None          # a stale graph's pool goes first
            stream = torch.cuda.Stream(dev)
            with span("fit.sample"):
                cam, frame = _sample(_cams(config, dev), generator, B,
                                     n_frames)
            main = torch.cuda.current_stream(dev)
            stream.wait_stream(main)
            with torch.cuda.stream(stream):
                metrics = train_step(config, scene, state, Batch(
                    cam, frame, decode_refs(frames_u8, cam, frame)))
            main.wait_stream(stream)
            state.graph = StepGraph(
                _graph_key(config, scene, state, frames_u8), config, stream,
                (scene, frames_u8))
            count("fit.eager_steps", 1)
            row, names = torch.stack(list(metrics.values())), tuple(metrics)
        count("fit.batch_samples", B)
        if rows is None:
            rows = torch.empty((k, len(names)), device=dev)
        rows[i].copy_(row)
    return {m: rows[:, j] for j, m in enumerate(names)}


def train_steps(config: FitConfig, scene: Scene, state: state_mod.TrainState,
                frames_u8: Tensor, generator: torch.Generator, k: int,
                n_frames: int):
    """``k`` train steps, each on a (camera, frame) batch sampled on the
    device from ``generator`` (a generator of the scene's device): through
    the state's CUDA graph where :func:`graph_engaged`, else eagerly.

    :return: (state, metric name -> (k,) tensor on the device).
    """
    with span("fit.dispatch"):
        if graph_engaged(config, state):
            return state, _graph_steps(config, scene, state, frames_u8,
                                       generator, k, n_frames)
        cams = _cams(config, scene.device)
        B = config.batch_size
        rows = []
        for _ in range(k):
            with span("fit.sample"):
                cam, frame = _sample(cams, generator, B, n_frames)
                batch = Batch(cam, frame, decode_refs(frames_u8, cam, frame))
            rows.append(train_step(config, scene, state, batch))
            count("fit.eager_steps", 1)
            count("fit.batch_samples", B)
        return state, {m: torch.stack([r[m] for r in rows])
                       for m in rows[0]}


def run_fit(config: FitConfig, scene: Scene, frames_u8: Tensor,
            n_frames: int, callbacks=None, state=None, n_steps=None):
    """Drive the fit for ``n_steps`` (default ``config.max_iter``) steps.

    Steps run in dispatches of ``config.steps_per_dispatch`` through
    :func:`train_steps`, sampling on the device from a generator seeded
    with ``config.seed + state.step``.

    :param frames_u8: (C, F, H, W) uint8 reference frames on the scene's
        device.
    :param callbacks: fn(step, state, metrics) called after each dispatch
        with its last step's metrics; they gate on their own intervals.
    :param state: the TrainState to continue; default a fresh one, its
        texture drawn from ``config.seed``.
    :return: the final TrainState.
    :raises ValueError: ``config.raster_impl`` names no rasterizer
        (:func:`ops.rasterize.check_impl`).
    """
    config.validate()
    check_impl(config.raster_impl)
    if state is None:
        tex_init = np.random.default_rng(config.seed).uniform(
            size=config.texshape).astype(np.float32)
        params = state_mod.init_params(
            config, n_frames, scene.v_base.shape[0], scene.deltas.shape[1],
            tex_init, scene.n_cameras, device=scene.device)
        state = state_mod.init_state(config, params)
    total = config.max_iter if n_steps is None else n_steps
    k = max(int(config.steps_per_dispatch), 1)
    generator = torch.Generator(device=scene.device)
    generator.manual_seed(config.seed + state.step)
    i = 0
    while i < total:
        kk = min(k, total - i)
        state, metrics = train_steps(config, scene, state, frames_u8,
                                     generator, kk, n_frames)
        i += kk
        with span("fit.callbacks"):
            for cb in callbacks or ():
                cb(i - 1, state, {m: v[-1] for m, v in metrics.items()})
    return state
