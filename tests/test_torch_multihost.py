"""The port's two-process case (``tests/test_multihost.py``): two real
processes form a gloo world through ``parallel.multihost.initialize``
(twice: the second call is a no-op), build the pod mesh over both ranks
and run one sharded train step of the shared tiny scene
(``tests/_tiny_scene.py``). Both ranks agree, own disjoint frame ranges
that cover the take, and their loss is the single-process step's within
1e-4 (JAX's tolerance), against JAX's step and the port's own.
"""

import dataclasses

import numpy as np
import torch

from fpc_diffrend_tpu.fit import loop as fit_loop
from fpc_diffrend_tpu.fit import state as state_mod
from fpc_diffrend_tpu_torch.data import obj as tobj
from fpc_diffrend_tpu_torch.fit import loop as tloop
from fpc_diffrend_tpu_torch.fit import state as tstate
from fpc_diffrend_tpu_torch.fit.config import FitConfig as TConfig
from fpc_diffrend_tpu_torch.fit.scene import build_scene as tbuild
from fpc_diffrend_tpu_torch.models import camera as tcamera

from _tiny_scene import N_CAMS, make_batch, make_setup
from _torch_parallel_child import launch


def test_two_process_sharded_step(tmp_path):
    scene, config, params = make_setup()
    batch = make_batch(config, scene, params)
    verts = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                     np.float32) * 3.0
    mesh = dict(vertices=verts.reshape(-1),
                uv=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
                faces=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
                fuv=np.array([[0, 1, 2], [0, 2, 3]], np.int32))
    proj = np.stack([tcamera.default_projection()] * N_CAMS)
    mv = np.stack([tcamera.default_modelview(zoffset=-40),
                   tcamera.default_modelview(zoffset=-42)
                   @ tcamera.rotate_y(0.2)])
    fields = {f.name: getattr(config, f.name)
              for f in dataclasses.fields(config)}
    fields["raster_impl"] = "auto"
    np_params = {k: np.array(v) for k, v in params.items()}
    np_batch = dict(cam_idx=np.array(batch.cam_idx),
                    frame_idx=np.array(batch.frame_idx),
                    ref=np.array(batch.ref))
    job = dict(mesh=mesh, proj=proj, mv=mv, config=fields, params=np_params,
               batch=np_batch, tasks=[dict(kind="frames", n_frames=4),
                                      dict(kind="step", pod=True)])
    (frames, steps) = launch(job, 2, tmp_path)

    assert [f["range"] for f in frames] == [(0, 2), (2, 4)]
    for k in steps[0]["params"]:
        np.testing.assert_array_equal(steps[1]["params"][k],
                                      steps[0]["params"][k])
    assert steps[0]["loss"] == steps[1]["loss"]

    _, metrics = fit_loop.train_step(config, scene,
                                     state_mod.init_state(config, params),
                                     batch)
    np.testing.assert_allclose(steps[0]["loss"], float(metrics["loss"]),
                               rtol=1e-4)

    md = tobj.MeshData(**mesh)
    tscene = tbuild(md, proj, mv, device="cpu")
    tconfig = TConfig(**fields)
    state = tstate.init_state(tconfig,
                              tstate.params_from_numpy(np_params, "cpu"))
    got = tloop.train_step(tconfig, tscene, state, tloop.Batch(
        *(torch.as_tensor(np_batch[k]) for k in ("cam_idx", "frame_idx",
                                                 "ref"))))
    np.testing.assert_allclose(steps[0]["loss"], float(got["loss"]),
                               rtol=1e-4)
    for k in ("per_frame_t", "tex", "m3"):
        np.testing.assert_allclose(steps[0]["params"][k],
                                   state.params[k].detach().numpy(),
                                   atol=5e-5, err_msg=k)
