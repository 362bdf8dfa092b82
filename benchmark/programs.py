"""The system under test, driven as its users drive it.

A fit cell follows ``fit.api.fit_take``'s path from in-memory inputs:
``fit.scene.build_scene``, ``fit.state.init_params``,
``fit.api.autotune_caps``, ``fit.state.init_state``, then
``fit.loop.run_fit`` in chunks on one continuing ``TrainState``, with a
callback that reads the loss to the host every ``log_interval`` steps as
``fit_take``'s does. The view cell renders single (camera, frame) views of
a fitted state through ``fit.loop.render_sample`` and takes each image to
the host. A sharded fit cell drives ``parallel/train.py``'s frame-sharded
step on every rank of a ``torch.distributed`` world (``benchmark/ranks.py``
starts the ranks), as its users must: the program has no loop of its own
for it.

The harness's own host-clock spans are kept here: per fit chunk, the
issue time (the chunk's span less the time the loss read waited for the
device); per view, its latency.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist

from fpc_diffrend_tpu_torch.data.obj import MeshData
from fpc_diffrend_tpu_torch.fit import api, loop
from fpc_diffrend_tpu_torch.fit import state as state_mod
from fpc_diffrend_tpu_torch.fit.config import FitConfig
from fpc_diffrend_tpu_torch.fit.scene import build_scene
from fpc_diffrend_tpu_torch.parallel import multihost
from fpc_diffrend_tpu_torch.parallel import train as ptrain


def fit_config(config: dict, traffic: dict, seed: int) -> FitConfig:
    """The FitConfig of a cell: the configuration's settings, then the
    traffic's, on FitConfig's defaults."""
    h, w = config["resolution"]
    fields = dict(config.get("fit", {}), **traffic.get("fit", {}))
    return FitConfig(resolution=(h, w), texshape=tuple(config["texshape"]),
                     enable_mip=config["enable_mip"],
                     max_mip_level=config["max_mip_level"],
                     cam_idxs=tuple(range(config["n_cameras"])), seed=seed,
                     **fields)


def scene_of(inputs, device):
    mesh = MeshData(vertices=inputs.vertices, uv=inputs.uv,
                    faces=inputs.faces, fuv=inputs.uv_idx)
    return build_scene(mesh, inputs.proj, inputs.mv, inputs.deltas,
                       device=device)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def snapshot(tensors: dict) -> dict:
    return {k: v.detach().clone() for k, v in tensors.items()}


class FitDriver:
    """A fit cell's program: set-up, the checked first steps, the window.
    One process on one card: the world of :class:`ShardedFitDriver` at
    size 1."""

    rank, world = 0, 1

    def __init__(self, config: dict, traffic: dict, inputs, seed: int,
                 device):
        self.device = device
        self.config = fit_config(config, traffic, seed)
        self.scene = scene_of(inputs, device)
        self.frames = inputs.frames
        self.n_frames = inputs.frames.shape[1]
        params = state_mod.init_params(
            self.config, self.n_frames, self.scene.v_base.shape[0],
            self.scene.deltas.shape[1], inputs.tex.cpu().numpy(),
            self.scene.n_cameras, device=device)
        self.config = api.autotune_caps(self.config, self.scene, params)
        self.state = state_mod.init_state(self.config, params)
        self.log_every = self.config.log_interval
        self.losses = []          # (step, loss) read by the logging callback
        self.read_wait = 0.0

    def _log(self, i, st, metrics):
        if st.step % self.log_every == 0:
            t0 = time.perf_counter()
            self.losses.append((st.step, float(metrics["loss"])))
            self.read_wait += time.perf_counter() - t0

    def steps(self, n: int) -> None:
        self.state = loop.run_fit(self.config, self.scene, self.frames,
                                  self.n_frames, callbacks=[self._log],
                                  state=self.state, n_steps=n)

    def first_steps(self, n: int) -> dict:
        """``n`` steps, one ``run_fit`` call each, as the window makes
        them, with what the check compares: the initial parameters, each
        step's loss, the first step's gradient as Adam keeps it
        (exp_avg / (1 - beta1)) and the parameters after step n."""
        params0 = snapshot(self.state.params)
        losses, grad1 = [], None
        for _ in range(n):
            got = []
            self.state = loop.run_fit(
                self.config, self.scene, self.frames, self.n_frames,
                callbacks=[lambda i, st, m: got.append(m["loss"].clone())],
                state=self.state, n_steps=1)
            losses.append(got[-1])
            if grad1 is None:
                grad1 = self.adam_grads()
        return {"params0": params0, "losses": [float(x) for x in losses],
                "grad1": grad1, "params": snapshot(self.state.params)}

    def adam_grads(self) -> dict:
        opt = self.state.optimizer
        out = {}
        for name, p in self.state.params.items():
            st = opt.state.get(p, {})
            beta1 = next(g["betas"][0] for g in opt.param_groups
                         if any(q is p for q in g["params"]))
            out[name] = (st["exp_avg"] / (1 - beta1) if "exp_avg" in st
                         else torch.zeros_like(p)).detach().clone()
        return out

    def window(self, seconds: float, chunk: int) -> dict:
        """Run chunks of ``chunk`` steps until ``seconds`` have passed,
        then synchronize; :return: steps, window_s, issue_s (per chunk,
        host time less the loss reads' waits)."""
        sync(self.device)
        steps, issue = 0, []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            c0, w0 = time.perf_counter(), self.read_wait
            self.steps(chunk)
            issue.append((time.perf_counter() - c0
                          - (self.read_wait - w0)) / chunk)
            steps += chunk
        sync(self.device)
        return {"steps": steps, "window_s": time.perf_counter() - t0,
                "issue_s": issue}

    def over_ranks(self, value: float, op: str) -> float:
        return value

    def barrier(self) -> None:
        pass

    def free(self) -> None:
        del self.state, self.scene


class ShardedFitDriver:
    """A sharded fit cell's program on one rank: the set-up that every rank
    makes alike, the frame-sharded step of ``parallel/train.py``, and the
    window in lock-step with the other ranks.

    Each step draws the global batch with ``sample_stratified`` from a
    numpy generator seeded by the seed (the same draws on every rank),
    takes this rank's part with ``shard_batch_for`` and decodes only that
    part's references from the rank's own copy of the take. The loss (the
    global one) is read to the host every ``log_interval`` steps.
    """

    def __init__(self, config: dict, traffic: dict, inputs, seed: int,
                 device):
        self.device = device
        self.config = fit_config(config, traffic, seed)
        self.scene = scene_of(inputs, device)
        self.frames = inputs.frames
        self.n_frames = inputs.frames.shape[1]
        params = state_mod.init_params(
            self.config, self.n_frames, self.scene.v_base.shape[0],
            self.scene.deltas.shape[1], inputs.tex.cpu().numpy(),
            self.scene.n_cameras, device=device)
        self.config = api.autotune_caps(self.config, self.scene, params)
        axes = traffic["mesh"]
        self.mesh = multihost.make_pod_mesh(axes["view"], axes["tile"],
                                            device_type=device.type)
        if dict(zip(self.mesh.mesh_dim_names, self.mesh.mesh.shape)) != axes:
            raise ValueError(f"the world's {dist.get_world_size()} ranks "
                             f"do not make the mesh {axes}")
        self.step_fn = ptrain.make_sharded_train_step(
            self.config, self.scene, self.mesh,
            shard_frames=traffic["shard_frames"], params_like=params)
        self.state = state_mod.init_state(
            self.config, ptrain.frame_shard(params, self.mesh)
            if traffic["shard_frames"] else params)
        self.rank, self.world = dist.get_rank(), dist.get_world_size()
        # the host's own exchanges (the window's open, close and go-ahead,
        # readings across ranks) go over gloo, so they never wait on the
        # device's queue
        self.host = dist.new_group(backend="gloo")
        self.rng = np.random.default_rng(seed)
        self.log_every = self.config.log_interval
        self.losses = []          # (step, global loss) read every log_every
        self.read_wait = 0.0
        self.drawn = None         # first_steps' global (cams, frames)

    def batch(self) -> loop.Batch:
        """The next global draw, cut to this rank's part."""
        cams, frames = ptrain.sample_stratified(
            self.rng, self.config, self.mesh, self.n_frames,
            self.scene.n_cameras)
        if self.drawn is not None:
            self.drawn.append((cams.tolist(), frames.tolist()))
        b, h = cams.shape[0], self.frames.shape[2]
        # row numbers stand in for the references, so that shard_batch_for
        # cuts out this rank's samples and band rows without a global decode
        part = ptrain.shard_batch_for(
            self.mesh, loop.Batch(cams, frames, torch.arange(h).expand(b, h)))
        rows = part.ref[0]
        cam = part.cam_idx.to(self.device, non_blocking=True)
        frame = part.frame_idx.to(self.device, non_blocking=True)
        ref = loop.decode_refs(self.frames, cam, frame)
        return loop.Batch(cam, frame,
                          ref[:, int(rows[0]):int(rows[-1]) + 1])

    def step(self) -> torch.Tensor:
        """One step; :return: the global loss, on the device."""
        self.state, metrics = self.step_fn(self.state, self.batch())
        return metrics["loss"]

    def steps(self, n: int) -> None:
        for _ in range(n):
            loss = self.step()
            if self.state.step % self.log_every == 0:
                t0 = time.perf_counter()
                self.losses.append((self.state.step, float(loss)))
                self.read_wait += time.perf_counter() - t0

    def gathered(self, tensors: dict) -> dict:
        """Full copies of per-leaf tensors (the frame shards joined)."""
        return snapshot(ptrain.gather_frame_shards(tensors, self.mesh))

    def first_steps(self, n: int) -> dict:
        """``n`` steps with what the check compares, as
        :meth:`FitDriver.first_steps` gives it (the frame-sharded leaves
        joined over the ranks), and ``batches``: each step's global
        (cams, frames)."""
        params0 = self.gathered(self.state.params)
        losses, grad1 = [], None
        self.drawn = []
        for _ in range(n):
            losses.append(self.step().clone())
            if grad1 is None:
                grad1 = self.gathered(FitDriver.adam_grads(self))
        batches, self.drawn = self.drawn, None
        return {"params0": params0, "losses": [float(x) for x in losses],
                "grad1": grad1, "params": self.gathered(self.state.params),
                "batches": batches}

    def over_ranks(self, value: float, op: str) -> float:
        """``value`` summed ("sum") or the largest ("max") over the ranks."""
        t = torch.tensor([float(value)], dtype=torch.float64)
        dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX}[op],
                        group=self.host)
        return float(t[0])

    def barrier(self) -> None:
        dist.barrier(group=self.host)

    def window(self, seconds: float, chunk: int) -> dict:
        """Chunks of ``chunk`` steps on every rank while rank 0's host
        clock is under ``seconds``, opened and closed by a synchronize and
        a barrier on every rank; :return: steps, window_s (rank 0's),
        issue_s (per chunk, the host time of its steps less the loss
        reads' waits)."""
        sync(self.device)
        self.barrier()
        steps, issue = 0, []
        t0 = time.perf_counter()
        while self.over_ranks(self.rank == 0
                              and time.perf_counter() - t0 < seconds,
                              "max"):
            c0, w0 = time.perf_counter(), self.read_wait
            self.steps(chunk)
            issue.append((time.perf_counter() - c0
                          - (self.read_wait - w0)) / chunk)
            steps += chunk
        sync(self.device)
        self.barrier()
        return {"steps": steps, "window_s": time.perf_counter() - t0,
                "issue_s": issue}

    def free(self) -> None:
        del self.state, self.scene, self.step_fn


@dataclasses.dataclass
class ViewRequests:
    """The closed loop's (camera, frame) requests, drawn from the seed."""

    cams: np.ndarray
    frames: np.ndarray


class ViewDriver:
    """The view cell's program: a fitted state rendered one view a
    request, each image taken to the host."""

    def __init__(self, config: dict, traffic: dict, inputs, seed: int,
                 device):
        self.device = device
        self.config = fit_config(config, traffic, seed)
        self.scene = scene_of(inputs, device)
        n_f = config["n_frames"]
        params = state_mod.init_params(
            self.config, n_f, self.scene.v_base.shape[0],
            self.scene.deltas.shape[1], inputs.tex.cpu().numpy(),
            self.scene.n_cameras, device=device)
        params.update({k: v.to(device) for k, v in inputs.state.items()})
        self.params = params
        rng = np.random.default_rng(seed)
        n = int(traffic["request_pool"])
        self.requests = ViewRequests(
            cams=rng.integers(0, config["n_cameras"], n),
            frames=rng.integers(0, n_f, n))
        self.keep = int(traffic["check_views"])
        self.rng = np.random.default_rng([seed, 1])

    def render(self, i: int) -> torch.Tensor:
        j = i % len(self.requests.cams)
        with torch.no_grad():
            img, _ = loop.render_sample(self.config, self.scene, self.params,
                                        int(self.requests.cams[j]),
                                        int(self.requests.frames[j]))
        return img.cpu()

    def request(self, i: int) -> tuple:
        return (int(self.requests.cams[i % len(self.requests.cams)]),
                int(self.requests.frames[i % len(self.requests.frames)]))

    def window(self, seconds: float, start: int = 0) -> dict:
        """Closed loop of one viewer for ``seconds``; a reservoir sample
        drawn from the seed keeps ``check_views`` of the images.

        :return: views, window_s, latency_s (each view's), kept
            (request index -> image)."""
        sync(self.device)
        lat, kept = [], {}
        i = start
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            r0 = time.perf_counter()
            img = self.render(i)
            lat.append(time.perf_counter() - r0)
            n = i - start
            if n < self.keep:
                kept[i] = img
            else:
                slot = int(self.rng.integers(0, n + 1))
                if slot < self.keep:
                    del kept[sorted(kept)[slot]]
                    kept[i] = img
            i += 1
        return {"views": i - start, "window_s": time.perf_counter() - t0,
                "latency_s": lat, "kept": kept}

    def free(self) -> None:
        del self.scene
