"""One rank of the port's sharded-fit tests on the CPU (gloo).

Usage: python _torch_parallel_child.py <coordinator> <world> <rank> <job>

``job`` is a ``torch.save`` file written by the test: the scene's numpy
arrays, the parameters, the config fields, the global batch and a list of
tasks. Every rank runs every task in order on its own mesh:

* ``{"kind": "step", "shape": (f, v, t), "shard_frames": bool,
  "config": {field: value}, "pod": bool}``: one sharded train step from
  the job's parameters and batch (or the task's ``params`` and
  ``batch``), on the pod mesh with ``pod``; each rank writes the global
  loss, the summed gradients and the parameters after the step (frame
  shards gathered) and the elements the step moved through the
  collectives;
* ``{"kind": "band", "shape": (f, v, t), "impl": str, "view": {...}}``:
  every rank writes its band of the view (``parallel.spatial.
  render_band``'s arguments ``mvp``, ``pos``, ``pos_idx``, ``uv``,
  ``uv_idx``, ``tex``, ``face_neighbors`` and the full ``resolution``),
  with the seam over the tile axis and without it;
* ``{"kind": "mesh"}``: the mesh helpers and collectives at (2, 2, 2)
  (``batch_sharding``, ``shard_batch``, ``replicate``, ``ppermute`` and
  ``all_reduce_sum`` with their gradients);
* ``{"kind": "frames", "n_frames": n}``: the pod mesh's
  ``local_frame_range`` of every rank.

Results go to ``<job>.<task>.<rank>.pt``. Imports only the port.
:func:`launch` starts the ranks from a test.
"""

import os
import socket
import subprocess
import sys

import torch

from fpc_diffrend_tpu_torch.data import obj as objlib
from fpc_diffrend_tpu_torch.fit import state as state_mod
from fpc_diffrend_tpu_torch.fit.config import FitConfig
from fpc_diffrend_tpu_torch.fit.loop import Batch
from fpc_diffrend_tpu_torch.fit.scene import build_scene
from fpc_diffrend_tpu_torch.parallel import mesh as mesh_mod
from fpc_diffrend_tpu_torch.parallel import multihost, spatial
from fpc_diffrend_tpu_torch.parallel import train as ptrain


def config_from(fields: dict) -> FitConfig:
    return FitConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in fields.items()})


def scene_from(job: dict):
    m = job["mesh"]
    mesh_d = objlib.MeshData(vertices=m["vertices"], uv=m["uv"],
                             faces=m["faces"], fuv=m["fuv"])
    return build_scene(mesh_d, job["proj"], job["mv"], device="cpu")


def run_step(job, task, scene):
    config = config_from({**job["config"], **task.get("config", {})})
    if task.get("pod"):
        mesh = multihost.make_pod_mesh(device_type="cpu")
    else:
        mesh = mesh_mod.make_mesh(("frame", "view", "tile"), task["shape"],
                                  "cpu")
    full = state_mod.params_from_numpy(task.get("params", job["params"]),
                                       "cpu")
    shard = task.get("shard_frames", False)
    params = ptrain.frame_shard(full, mesh) if shard else full
    step_fn = ptrain.make_sharded_train_step(config, scene, mesh, shard,
                                             params_like=full)
    state = state_mod.init_state(config, params)
    b = task.get("batch", job["batch"])
    batch = ptrain.shard_batch_for(mesh, Batch(
        torch.as_tensor(b["cam_idx"]), torch.as_tensor(b["frame_idx"]),
        torch.as_tensor(b["ref"])))
    before = mesh_mod.all_reduce_.elements
    state, metrics = step_fn(state, batch)
    moved = mesh_mod.all_reduce_.elements - before
    grads = {k: p.grad for k, p in state.params.items()}
    params = {k: p.detach() for k, p in state.params.items()}
    if shard:
        grads = ptrain.gather_frame_shards(grads, mesh)
        params = ptrain.gather_frame_shards(params, mesh)
    return {"loss": float(metrics["loss"]), "moved": moved,
            "grads": {k: v.numpy() for k, v in grads.items()},
            "params": {k: v.numpy() for k, v in params.items()}}


def run_band(task):
    mesh = mesh_mod.make_mesh(("frame", "view", "tile"), task["shape"],
                              "cpu")
    n_bands = task["shape"][2]
    band = mesh_mod.axis_index(mesh, "tile")
    v = task["view"]
    h, w = v["resolution"]
    imgs = [spatial.render_band(
        v["mvp"], v["pos"], v["pos_idx"], v["uv"], v["uv_idx"], v["tex"],
        (h // n_bands, w), v["face_neighbors"], band, n_bands,
        impl=task["impl"], group=group, device="cpu").numpy()
        for group in (mesh.get_group("tile"), None)]
    return {"band": band, "frame": mesh_mod.axis_index(mesh, "frame"),
            "view": mesh_mod.axis_index(mesh, "view"), "img": imgs[0],
            "img_no_seam": imgs[1]}


def run_mesh(rank):
    mesh = mesh_mod.make_mesh(("frame", "view", "tile"), (2, 2, 2), "cpu")
    out = {"coords": [mesh_mod.axis_index(mesh, a)
                      for a in ("frame", "view", "tile")],
           "sharding": mesh_mod.batch_sharding(mesh),
           "replicated": mesh_mod.replicated(mesh),
           "shard": mesh_mod.shard_batch(
               mesh, {"a": torch.arange(16), "b": (torch.arange(8),)})}
    out["replicate"] = mesh_mod.replicate(
        mesh, {"x": torch.full((2,), float(rank))})["x"]
    x = torch.full((3,), float(rank), requires_grad=True)
    y = mesh_mod.ppermute(x, mesh.get_group("tile"), [(0, 1)])
    s = mesh_mod.all_reduce_sum(x * 1.0, mesh.get_group("frame"))
    ((y + s) * (rank + 1)).sum().backward()
    out.update(ppermute=y.detach(), psum=s.detach(), grad=x.grad)
    return out


def main():
    coordinator, world, rank, job_path = sys.argv[1:5]
    world, rank = int(world), int(rank)
    multihost.initialize(coordinator, world, rank, backend="gloo")
    # a second call is a no-op
    multihost.initialize(coordinator, world, rank, backend="gloo")
    job = torch.load(job_path, weights_only=False)
    scene = scene_from(job)
    for i, task in enumerate(job["tasks"]):
        if task["kind"] == "step":
            out = run_step(job, task, scene)
        elif task["kind"] == "band":
            out = run_band(task)
        elif task["kind"] == "mesh":
            out = run_mesh(rank)
        else:
            mesh = multihost.make_pod_mesh(device_type="cpu")
            out = {"range": multihost.local_frame_range(
                mesh, task["n_frames"])}
        torch.save(out, f"{job_path}.{i}.{rank}.pt")
    torch.distributed.destroy_process_group()


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch(job: dict, world: int, tmp_path, timeout: float = 240.0):
    """Run ``job`` on ``world`` ranks, each a subprocess with its own
    timeout; a rank that fails or outlives it fails the caller.

    :return: results[task][rank].
    """
    path = os.path.join(str(tmp_path), "job.pt")
    torch.save(job, path)
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [os.path.dirname(here), os.environ.get("PYTHONPATH", "")]))
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               coord, str(world), str(r), path],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    bad = [(r, p.returncode, o[-3000:]) for r, (p, o) in
           enumerate(zip(procs, outs)) if p.returncode != 0]
    assert not bad, bad
    return [[torch.load(f"{path}.{i}.{r}.pt", weights_only=False)
             for r in range(world)] for i in range(len(job["tasks"]))]


if __name__ == "__main__":
    main()
