"""The stacked batch (B > 1) on the CPU, through the kernels' plain versions.

* Each stack position renders and differentiates as its sample rendered
  alone (B = 1): the image bit for bit, the clip gradient within 1e-6 of
  its norm, at the full 1600x1200 of the face9 configurations, bilinear
  and trilinear-mip. The records stay in each sample's own frame and every
  kernel evaluates them at the sample's own rows; shifted into the
  stacked frame in f32 (the JAX package's stacked path) the positions past
  the first drift by 0.16-2.2 of that norm at this size.
* The program's stacked fit follows the benchmark's plain reference
  (``benchmark/reference/``, one sample at a time) over three steps at
  B = 3, bilinear and mip, on seeded random inputs at a small size.
* The stacked binning pools the batch's oversized triangles into one
  global list of ``MAX_GLOBAL`` rows: ``autotune_caps`` refuses a batch
  whose samples could together pass it while each alone stays under, and
  the bin counters ``bin.global_live`` and ``bin.global_kept`` count the
  pooled rows against the list.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import check, programs
from benchmark.inputs import make_inputs
from fpc_diffrend_tpu_torch.data.obj import MeshData
from fpc_diffrend_tpu_torch.fit import api, loop
from fpc_diffrend_tpu_torch.fit import state as state_mod
from fpc_diffrend_tpu_torch.fit.config import FitConfig
from fpc_diffrend_tpu_torch.fit.scene import build_scene
from fpc_diffrend_tpu_torch.ops.cuda import rasterize_cuda as rc
from fpc_diffrend_tpu_torch.ops.pipeline import render_batch_stacked
from fpc_diffrend_tpu_torch.utils import profiling

CPU = torch.device("cpu")
ROOT = Path(__file__).resolve().parents[1]
# (camera, frame) of each stack position: three cameras across the arc
SAMPLES = ((6, 3), (1, 0), (4, 2))


def face9_config(mip: bool, **over) -> dict:
    """The face9 configuration file as the benchmark runs it (1600x1200,
    the 9,976-triangle head, a 1024^2 texture), with 4 frames and 8
    blendshapes to keep the inputs small on the CPU."""
    name = "face9-mip" if mip else "face9-linear"
    with open(ROOT / "benchmark" / "configs" / f"{name}.json") as f:
        config = json.load(f)
    config.update(dict(n_frames=4, n_blendshapes=8), **over)
    return config


def fitted_clips(config: dict, seed: int, samples=SAMPLES):
    """(B, V, 4) clip positions of ``samples`` of a fitted state drawn
    from ``seed``, and the scene."""
    inputs = make_inputs(config, "view", seed, CPU)
    cfg = programs.fit_config(config, {}, seed)
    scene = programs.scene_of(inputs, CPU)
    params = state_mod.init_params(
        cfg, config["n_frames"], scene.v_base.shape[0],
        scene.deltas.shape[1], inputs.tex.numpy(), scene.n_cameras,
        device=CPU)
    params.update(inputs.state)
    cams, frames = (torch.tensor(x) for x in zip(*samples))
    with torch.no_grad():
        clip, _ = loop.sample_clip_positions(cfg, scene, params, cams,
                                             frames)
    return clip, scene, params["tex"]


def render_grad(clip, scene, tex, config, weights):
    """Images of the stacked render of ``clip`` (B, V, 4) and the gradient
    of sum(weights * image) with respect to it."""
    clip = clip.clone().requires_grad_(True)
    imgs = render_batch_stacked(
        clip, scene.faces, scene.uv, scene.uv_idx, tex,
        tuple(config["resolution"]), scene.face_neighbors,
        enable_mip=config["enable_mip"],
        max_mip_level=config["max_mip_level"])
    (imgs * weights).sum().backward()
    return imgs.detach(), clip.grad


@pytest.mark.parametrize("mip", [False, True], ids=["bilinear", "mip"])
def test_each_stack_position_equals_its_sample_alone(mip):
    """B = 3 at 1600x1200: every position's image equals the same sample
    rendered at B = 1 bit for bit, and its clip gradient within 1e-6 of
    its norm. The kernels' plain versions evaluate a sample's planes at
    the same rows in both renders and sum each bin entry's pixels in the
    same order, so the two agree to the last bit here; the 1e-6 leaves
    room only for the order of the triangle setup's batched autograd.
    The acceptance limit is 1e-4; the shifted records' error at this size
    is 0.16-2.2."""
    config = face9_config(mip)
    clip, scene, tex = fitted_clips(config, seed=1)
    h, w = config["resolution"]
    gen = torch.Generator().manual_seed(5)
    weights = torch.rand((len(SAMPLES), h, w, 1), generator=gen)
    imgs, grad = render_grad(clip, scene, tex, config, weights)
    for b in range(len(SAMPLES)):
        img1, grad1 = render_grad(clip[b:b + 1], scene, tex, config,
                                  weights[b:b + 1])
        assert torch.equal(imgs[b], img1[0]), b
        err = float((grad[b] - grad1[0]).norm() / grad1[0].norm())
        assert err <= 1e-6, (b, err)
    # the samples differ: the check is not of one image against itself
    assert not torch.equal(imgs[0], imgs[1])


def small_config(mip: bool) -> dict:
    """A small deployment of the face9 kind: 96x128 pixels, 3 cameras, 4
    frames, a 496-triangle head, a 64^2 texture (4 mip levels)."""
    config = face9_config(mip, resolution=[96, 128], n_cameras=3,
                          texshape=[64, 64, 1], n_blendshapes=5,
                          max_mip_level=4)
    config["mesh"] = dict(config["mesh"], n_ring=16, n_seg=16)
    config["calibration"] = dict(config["calibration"], focal_px=560.0,
                                 sensor=[128, 96])
    return config


@pytest.mark.parametrize("mip", [False, True], ids=["bilinear", "mip"])
def test_stacked_fit_follows_the_reference(mip):
    """Three steps at B = 3 from the benchmark's own set-up (cap
    autotune, ``run_fit`` one step a call) against the plain reference,
    which renders one sample at a time. Limits, each with its reason:
    a loss within 1e-5 relative (the two sum the same terms in another
    order: single-precision rounding of a mean over 36,864 pixels); the
    first gradient, each live leaf, within 1e-4 of its norm (the
    reference's own B = 1 limit, ``benchmark/tests``); the change after
    three steps within 1e-3 of each leaf's scale (Adam divides by the
    gradient's root mean square, so a leaf's rounding in step 1 moves the
    next steps' updates by up to its relative size)."""
    config = small_config(mip)
    traffic = {"kind": "fit", "fit": {"batch_size": 3}}
    seed = 2026
    inputs = make_inputs(config, "fit", seed, CPU)
    drv = programs.FitDriver(config, traffic, inputs, seed, CPU)
    got = drv.first_steps(3)
    want = check.reference_fit(drv.config, inputs, got, 3)
    for a, b in zip(got["losses"], want["losses"]):
        assert abs(a - b) <= 1e-5 * abs(b), (a, b)
    keep = check.live_leaves(want["grad1"])
    assert {"t_opt", "per_frame_t", "maps", "tex"} <= set(keep)
    for k in keep:
        g, w = got["grad1"][k], want["grad1"][k]
        assert float((g - w).norm()) <= 1e-4 * float(w.norm()), k
    gaps = check.change_gaps(got, want)
    assert max(gaps.values()) <= 1e-3, gaps


def column_scene(n_per_view: int, resolution=(64, 256)):
    """A scene whose one camera sees ``n_per_view`` thin triangles, each
    taller than the binning window (so each is oversized), and a FitConfig
    of one camera and two frames."""
    h, w = resolution
    n = n_per_view
    x = (np.arange(n) % (w - 2) + 0.5).astype(np.float32)
    # NDC corners: each triangle spans the image's full height
    xs = 2 * np.stack([x, x + 1.0, x], 1) / w - 1.0
    ys = np.tile(np.array([-0.99, -0.99, 0.99], np.float32), (n, 1))
    zs = np.tile(np.linspace(-0.5, 0.5, n, dtype=np.float32)[:, None],
                 (1, 3))
    verts = np.stack([xs, ys, zs], -1).reshape(-1, 3).astype(np.float32)
    faces = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    uv = np.full((3 * n, 2), 0.5, np.float32)
    mesh = MeshData(vertices=verts.reshape(-1), uv=uv, faces=faces,
                    fuv=faces)
    eye = np.eye(4, dtype=np.float32)[None]
    scene = build_scene(mesh, eye, eye, device=CPU)
    config = FitConfig(resolution=resolution, texshape=(8, 8, 1),
                       cam_idxs=(0,), mode="free", weight_laplacian=0.0)
    params = state_mod.init_params(config, 2, scene.v_base.shape[0],
                                   scene.deltas.shape[1],
                                   np.zeros((8, 8, 1), np.float32), 1,
                                   device=CPU)
    return config, scene, params


def test_pooled_global_list_is_checked_for_the_batch():
    """700 oversized triangles a view: one view fits the 1,024-row global
    list, a batch of two pools 1,400. ``autotune_caps`` passes B = 1 and
    refuses B = 2; the binning's counters read the pooled rows (1,400
    live, 1,024 kept) and the health warning names the batch."""
    config, scene, params = column_scene(700)
    health = api.measure_raster_health(config, scene, params)
    assert health["n_global"] == 700 and health["global_overflow"] == 0
    assert api.autotune_caps(config, scene, params).pair_cap > 0
    assert api.health_warnings(config, health) == []
    pair = dataclasses.replace(config, batch_size=2)
    assert api.batch_global_rows(pair, health) == 1400 > rc.MAX_GLOBAL
    with pytest.raises(RuntimeError, match="global-list overflow for the "
                       "batch"):
        api.autotune_caps(pair, scene, params)
    assert "overflow for the batch" in "\n".join(
        api.health_warnings(pair, health))
    cams = torch.zeros((2,), dtype=torch.int64)
    with profiling.recording() as log:
        pos_clip, _ = loop.sample_clip_positions(pair, scene, params, cams,
                                                 torch.tensor([0, 1]))
        aux = rc.aux_records(scene.uv, scene.uv_idx, pos_clip, scene.faces,
                             scene.face_neighbors, *config.resolution)
        _, _, bins = rc.bin_scene_stacked(pos_clip, scene.faces,
                                          *config.resolution, aux)
    assert log.counters["bin.global_live"] == 1400
    assert log.counters["bin.global_kept"] == rc.MAX_GLOBAL
    assert int(bins.n_global[0]) == rc.MAX_GLOBAL
