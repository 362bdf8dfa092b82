"""Slice 1 end to end: the port's loss forward against the JAX fit step's.

The port's workload (fpc_diffrend_tpu_torch.workload) and bench.py's
build_workload are built tiny from the same seed; the JAX side renders
through its exact XLA path (raster_impl="scan", aa_max_pairs=-1: every
pixel pair antialiased) and the port through K1 and K2's plain versions.

Tolerances:
* images: > 99.5 % of values within 2e-4, the allowance of
  tests/test_pipeline_fused.py. The rest are pixels where the two
  rasterizers' edge formulas resolve a pixel centre on an edge
  differently, or where two pixels of a pair lie on surfaces whose ndc
  depths tie to float32 precision (the far camera puts every z near 1) and
  the antialias picks the other occluder;
* lap: atol 1e-5, identical vertices through the same padded sums;
* pix: rtol 1e-3. It averages (ref - 255 * colour)^2 (~4e3) over all
  values, and the < 0.5 % of values that may differ move it by
  2 * 255 * |ref - 255 c| * dc / N; the port's pix is also held to the
  JAX formula on the port's own image at 1e-6.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import torch

from fpc_diffrend_tpu.fit import loop as jloop
from fpc_diffrend_tpu.fit import losses as jlosses
from fpc_diffrend_tpu_torch.fit import loop as tloop
from fpc_diffrend_tpu_torch.fit.state import params_from_numpy, \
    scene_from_numpy
from fpc_diffrend_tpu_torch.ops.cuda import antialias_cuda, rasterize_cuda
from fpc_diffrend_tpu_torch.workload import build_workload

H, W, GRID, BATCH, TEX = 48, 128, 5, 2, 64


def _jax_workload(monkeypatch):
    import bench

    for k, v in dict(CPU="1", RES_H=H, RES_W=W, GRID=GRID, BATCH=BATCH,
                     TEX=TEX, IMPL="scan").items():
        monkeypatch.setenv(f"FPC_BENCH_{k}", str(v))
    wl = bench.build_workload()
    wl["config"] = dataclasses.replace(wl["config"], raster_impl="scan",
                                       aa_max_pairs=-1)
    return wl


def _port_workload():
    return build_workload(H, W, grid=GRID, batch=BATCH, tex_size=TEX,
                          device="cpu")


def test_workload_matches_bench(monkeypatch):
    jw, tw = _jax_workload(monkeypatch), _port_workload()
    for k in ("v_base", "faces", "uv", "uv_idx", "face_neighbors",
              "nbr_idx", "nbr_mask", "degree"):
        np.testing.assert_array_equal(getattr(tw["scene"], k).numpy(),
                                      np.asarray(getattr(jw["scene"], k)),
                                      err_msg=k)
    for k in ("proj", "mv"):
        np.testing.assert_allclose(getattr(tw["scene"], k).numpy(),
                                   np.asarray(getattr(jw["scene"], k)),
                                   atol=1e-6, err_msg=k)
    for k, v in jw["params"].items():
        np.testing.assert_array_equal(tw["params"][k].numpy(),
                                      np.asarray(v), err_msg=k)
    np.testing.assert_array_equal(tw["frames_u8"].numpy(),
                                  np.asarray(jw["frames_u8"]))
    for k in ("cam_idx", "frame_idx", "ref"):
        np.testing.assert_array_equal(getattr(tw["batch"], k).numpy(),
                                      np.asarray(getattr(jw["batch"], k)))


def test_loss_forward_matches_jax(monkeypatch):
    jw, tw = _jax_workload(monkeypatch), _port_workload()
    cfg, js, jp, jb = jw["config"], jw["scene"], jw["params"], jw["batch"]
    jimgs, _ = jloop.render_batch(cfg, js, jp, jb.cam_idx, jb.frame_idx)
    _, jm = jloop.loss_fn(jp, cfg, js, jb, jnp.int32(0))

    tb = tw["batch"]
    with torch.no_grad():
        timgs, _ = tloop.render_batch(tw["config"], tw["scene"],
                                      tw["params"], tb.cam_idx,
                                      tb.frame_idx)
        _, tm = tloop.loss_fn(tw["params"], tw["config"], tw["scene"], tb)

    a, b = np.asarray(jimgs), timgs.numpy()
    assert a.shape == b.shape == (BATCH, H, W, 1)
    close = np.isclose(a, b, atol=2e-4)
    assert close.mean() > 0.995, f"{(~close).sum()} of {close.size} differ"
    assert (b != 45.0 / 255.0).mean() > 0.2      # the dome is in view

    np.testing.assert_allclose(float(tm["lap"]), float(jm["lap"]),
                               atol=1e-5)
    assert float(tm["mel"]) == float(jm["mel"]) == 0.0
    np.testing.assert_allclose(float(tm["pix"]), float(jm["pix"]),
                               rtol=1e-3)
    own = np.mean([float(jlosses.photometric_loss(np.asarray(tb.ref[i]),
                                                  b[i]))
                   for i in range(BATCH)])
    np.testing.assert_allclose(float(tm["pix"]), own, rtol=1e-6)
    np.testing.assert_allclose(float(tm["loss"]),
                               float(tm["pix"]) + float(tm["lap"]),
                               rtol=1e-6)


def test_evaluate_runs_on_cpu_without_launching_kernels():
    tw = _port_workload()
    rasterize_cuda.fused_raster.launches = 0
    antialias_cuda.antialias_planes.launches = 0
    metrics = tloop.evaluate(tw["config"], tw["scene"], tw["params"],
                             tw["frames_u8"], 3,
                             torch.Generator().manual_seed(0))
    assert set(metrics) == {"loss", "pix", "mel", "lap", "mnc"}
    for v in metrics.values():
        assert v.shape == (3,) and bool(torch.all(torch.isfinite(v)))
    assert float(metrics["loss"].min()) > 0
    assert rasterize_cuda.fused_raster.launches == 0
    assert antialias_cuda.antialias_planes.launches == 0


def test_carry_across_round_trips(monkeypatch):
    """The JAX parameter dict and Scene, as numpy, become the port's, and
    render exactly as the port's own workload does."""
    jw, tw = _jax_workload(monkeypatch), _port_workload()
    np_params = {k: np.asarray(v) for k, v in jw["params"].items()}
    params = params_from_numpy(np_params, device="cpu")
    assert set(params) == set(np_params)
    for k, v in np_params.items():
        assert params[k].dtype == torch.float32
        np.testing.assert_array_equal(params[k].numpy(), v)

    np_scene = {k: np.asarray(v) for k, v in jw["scene"]._asdict().items()
                if v is not None}
    scene = scene_from_numpy(np_scene, device="cpu")
    for k, v in np_scene.items():
        got = getattr(scene, k).numpy()
        assert got.dtype == v.dtype, k
        np.testing.assert_array_equal(got, v, err_msg=k)

    tb = tw["batch"]
    with torch.no_grad():
        carried, _ = tloop.render_batch(tw["config"], scene, params,
                                        tb.cam_idx, tb.frame_idx)
        own, _ = tloop.render_batch(tw["config"], tw["scene"], tw["params"],
                                    tb.cam_idx, tb.frame_idx)
    np.testing.assert_allclose(carried.numpy(), own.numpy(), atol=1e-6)
