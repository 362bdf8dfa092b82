"""The port's ``fit_take`` path against the JAX package, on the CPU.

* Loading, within 1e-6 of the JAX package on the same files (the values are
  equal: the same parsers in the same float32 order): ``load_obj`` /
  ``save_obj`` round trips, ``load_take`` on TIFFs written by PIL and by
  ``data.frames.save_tiff``, ``chip_smoke.py``'s writer (the native
  decoder), and on a compressed TIFF
  (the PIL fallback), ``load_calibration``, ``setup_dataset``.
* ``save_results`` on the same parameters: the same ``{i}.obj`` vertices
  (1e-6), ``pose.json`` and ``config.txt`` keys; the texture PNG's pixels
  equal.
* ``measure_raster_health`` equals the JAX one (band keys aside).
* The cases of ``tests/test_fit_api.py``, mirrored on the port: end to end
  with resume, bad mode, ``display_interval``, a crash that leaves a
  resumable checkpoint, global-list overflow aborting autotune, the
  pair-cap warning, a cap overflow surfaced in the fit, bit-exact
  checkpoint restore.
* ``mp4_interval``: without an mp4 encoder both packages write the same
  ``progress_{n:05d}.png`` frames, pixels within 1/255 of each other (the
  two fits sample different batches at a tiny learning rate).
* ``raster_impl``: ``fit_take``, ``run_fit`` and ``evaluate`` raise for
  an unknown value and run for "pallas" and "scan"; ``fit_take`` with
  "scan" logs JAX's first loss within 1e-6 relative.
"""

import dataclasses
import json
import os
import struct
import sys
import time
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from fpc_diffrend_tpu.data import frames as jframes
from fpc_diffrend_tpu.data import obj as jobj
from fpc_diffrend_tpu.fit import api as japi
from fpc_diffrend_tpu.fit import results as jresults
from fpc_diffrend_tpu.fit import scene as jscene
from fpc_diffrend_tpu.fit import state as jstate
from fpc_diffrend_tpu.fit.config import FitConfig as JConfig
from fpc_diffrend_tpu.models import blendshape as jblend
from fpc_diffrend_tpu_torch.data import frames as tframes
from fpc_diffrend_tpu_torch.data import obj as tobj
from fpc_diffrend_tpu_torch.fit import api as tapi
from fpc_diffrend_tpu_torch.fit import checkpoint as tckpt
from fpc_diffrend_tpu_torch.fit import results as tresults
from fpc_diffrend_tpu_torch.fit import scene as tscene
from fpc_diffrend_tpu_torch.fit import state as tstate
from fpc_diffrend_tpu_torch.fit.config import FitConfig
from fpc_diffrend_tpu_torch.models import blendshape as tblend
from fpc_diffrend_tpu_torch.runtime import native
from fpc_diffrend_tpu_torch.utils import image as timage

RES = (24, 24)
TOL = 1e-6
QUAD = np.array([[-15, -185, 0], [15, -185, 0], [15, -155, 0],
                 [-15, -155, 0]], np.float32)     # in view after +170 in y
QUAD_UV = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
QUAD_FACES = np.array([[0, 1, 2], [0, 2, 3]], np.int32)


def _calibration():
    """A pinhole looking at the origin from z = -30 (OpenCV convention)."""
    return {"cam0": {"intrinsic": [[24.0, 0, 12.0], [0, 24.0, 12.0],
                                   [0, 0, 1]],
                     "distortion": [[0], [0], [0], [0], [0]],
                     "rotation": np.eye(3).tolist(),
                     "translation": [[0.0], [0.0], [30.0]]}}


@pytest.fixture(autouse=True)
def _restore_fold_impl():
    """JAX's ``fit_take`` (``autotune_caps``) sets ``FPC_FOLD_IMPL`` for
    the rest of the process when a scene's id bands fit its banded fold;
    restore it, so later tests in this worker fold as they would alone."""
    before = os.environ.get("FPC_FOLD_IMPL")
    yield
    if before is None:
        os.environ.pop("FPC_FOLD_IMPL", None)
    else:
        os.environ["FPC_FOLD_IMPL"] = before


@pytest.fixture()
def take_dirs(tmp_path):
    """test_fit_api.py's take: a quad, two blendshapes, one camera, two
    flat grey frames (the quad sits where the calibration's +170 y-offset
    brings it into view)."""
    tobj.save_obj(str(tmp_path / "basemesh.obj"), QUAD, QUAD_UV, QUAD_FACES)
    bl_dir = tmp_path / "blendshapes"
    bl_dir.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        tobj.save_obj(str(bl_dir / f"bs{i}.obj"),
                      QUAD + rng.normal(scale=0.1, size=QUAD.shape)
                      .astype(np.float32), QUAD_UV, QUAD_FACES)
    (tmp_path / "calibration.json").write_text(json.dumps(_calibration()))
    camdir = tmp_path / "take" / "take_cam0"
    camdir.mkdir(parents=True)
    for f in range(2):
        Image.fromarray(np.full(RES, 90, np.uint8)).save(
            camdir / f"take_cam0_{f:02d}.tif")
    return tmp_path


def _config(take_dirs, tmp_path, config_class=FitConfig, **kw):
    base = dict(lr_base=1e-4, lr_t=1e-4, lr_q=1e-5,
                basemeshpath=str(take_dirs / "basemesh.obj"),
                localblpath=str(take_dirs / "blendshapes"),
                imdir=str(take_dirs / "take"),
                calibpath=str(take_dirs / "calibration.json"),
                resolution=RES, texshape=(8, 8, 1), mode="prior",
                cam_idxs=(0,), batch_size=2)
    base.update(kw)
    return config_class(**base)


# ------------------------------------------------------------ loading ----

def test_obj_round_trips_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    verts = rng.normal(size=(30, 3)).astype(np.float32)
    uv = rng.uniform(size=(25, 2)).astype(np.float32)
    faces = rng.integers(0, 30, size=(40, 3)).astype(np.int32)
    fuv = rng.integers(0, 25, size=(40, 3)).astype(np.int32)
    tobj.save_obj(str(tmp_path / "t.obj"), verts, uv, faces, fuv)
    jobj.save_obj(str(tmp_path / "j.obj"), verts, uv, faces, fuv)
    assert (tmp_path / "t.obj").read_text() == (tmp_path / "j.obj").read_text()
    for path in ("t.obj", "j.obj"):
        got = tobj.load_obj(str(tmp_path / path))
        want = jobj.load_obj(str(tmp_path / path))
        for k in ("vertices", "uv"):
            np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                       rtol=TOL, atol=TOL)
        for k in ("faces", "fuv"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
        np.testing.assert_allclose(got.vertices, verts.reshape(-1), rtol=TOL)
        np.testing.assert_array_equal(got.fuv, fuv)
        np.testing.assert_allclose(
            tobj.load_obj_vertices(str(tmp_path / path)),
            jobj.load_obj_vertices(str(tmp_path / path)), rtol=TOL, atol=TOL)
    (tmp_path / "quad.obj").write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
                                       "f 1 2 3 4\n")
    with pytest.raises(ValueError, match="non-triangle"):
        tobj.load_obj(str(tmp_path / "quad.obj"))


def _write_take(root, writer, n_cams=2, n_frames=3, hw=(20, 30)):
    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 256, size=(n_cams, n_frames) + hw).astype(
        np.uint8)
    cams = [f"take_c{c}" for c in range(n_cams)]
    for c, cam in enumerate(cams):
        os.makedirs(root / cam)
        for f in range(n_frames):
            writer(str(root / cam / f"{cam}_{f:02d}.tif"), imgs[c, f])
    return cams, imgs


def _pil_writer(compression=None):
    def write(path, img):
        Image.fromarray(img).save(path, compression=compression)
    return write


@pytest.mark.parametrize("writer", ["pil", "chip_smoke", "pil compressed"])
def test_load_take_matches_jax(tmp_path, writer):
    write = {"pil": _pil_writer(), "chip_smoke": tframes.save_tiff,
             "pil compressed": _pil_writer("tiff_lzw")}[writer]
    cams, imgs = _write_take(tmp_path, write)
    assert native.available(), native.unavailable_reason()
    before = native.load_tiffs.files
    got = tframes.load_take(str(tmp_path), cams)
    decoded = native.load_tiffs.files - before
    # the native decoder takes uncompressed TIFFs; PIL reads the rest
    assert decoded == (0 if writer == "pil compressed" else imgs[..., 0,
                                                                 0].size)
    want = jframes.load_take(str(tmp_path), cams)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.clip(imgs, 0, 140)[..., ::-1, :])
    cache = str(tmp_path / "take.npy")
    np.testing.assert_array_equal(tframes.load_take(str(tmp_path), cams,
                                                    cache=cache), got)
    np.testing.assert_array_equal(tframes.load_take("/nonexistent", cams,
                                                    cache=cache), got)


def test_assert_num_frames_rejects_uneven_cameras(tmp_path):
    cams, _ = _write_take(tmp_path, tframes.save_tiff)
    os.remove(tmp_path / cams[1] / f"{cams[1]}_02.tif")
    with pytest.raises(ValueError, match="same number of frames"):
        tframes.assert_num_frames(cams, str(tmp_path))
    assert tframes.frame_digits(99) == jframes.frame_digits(99) == 2
    assert tframes.frame_digits(100) == jframes.frame_digits(100) == 3


def test_load_calibration_matches_jax(tmp_path):
    calib = _calibration()
    rot = np.array([[0.96, -0.28, 0.0], [0.28, 0.96, 0.0], [0, 0, 1]])
    calib["cam1"] = {"intrinsic": [[7000.0, 0, 600.0], [0, 7010.0, 800.0],
                                   [0, 0, 1]],
                     "rotation": rot.tolist(),
                     "translation": [[1.5], [-2.0], [120.0]]}
    path = tmp_path / "calibration.json"
    path.write_text(json.dumps(calib))
    got = tscene.load_calibration(str(path), ["cam1", "cam0"])
    want = jscene.load_calibration(str(path), ["cam1", "cam0"])
    for g, w in zip(got, want):
        assert g.shape == (2, 4, 4) and g.dtype == np.float32
        np.testing.assert_allclose(g, np.asarray(w), rtol=TOL, atol=TOL)


def test_setup_dataset_matches_jax(take_dirs):
    base = tobj.load_obj(str(take_dirs / "basemesh.obj")).vertices
    bl = str(take_dirs / "blendshapes")
    before = native.parse_obj_vertices.files
    got = tblend.setup_dataset(bl, "", 5, base.shape[0], base)
    assert native.parse_obj_vertices.files == before + 2
    want = jblend.setup_dataset(bl, "", 5, base.shape[0], base)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=TOL, atol=TOL)
    assert got[0].shape == (12, 2)
    with pytest.raises(NotImplementedError):
        tblend.setup_dataset(bl, "global", 5, base.shape[0], base)


def _load_both(path, monkeypatch):
    """load_image through PIL, and again with PIL hidden (the standard-
    library reader); the two must agree."""
    with_pil = timage.load_image(str(path))
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "PIL", None)
        without = timage.load_image(str(path))
    np.testing.assert_array_equal(without, with_pil)
    return with_pil


def test_png_round_trip_and_pil_files(tmp_path, monkeypatch):
    rng = np.random.default_rng(4)
    for shape in ((17, 23), (17, 23, 1), (9, 11, 3), (5, 7, 4)):
        img = rng.integers(0, 256, size=shape).astype(np.uint8)
        timage.save_image(str(tmp_path / "a.png"), img)
        want = img if img.ndim == 3 else img[..., None]
        np.testing.assert_array_equal(
            _load_both(tmp_path / "a.png", monkeypatch), want)
        np.testing.assert_array_equal(
            np.array(Image.open(tmp_path / "a.png")).reshape(want.shape),
            want)
    # PIL's adaptive filters (Sub, Up, Average, Paeth) on a smooth image
    yy, xx = np.mgrid[0:40, 0:33]
    smooth = np.stack([xx * 7, yy * 5, (xx + yy) * 3], -1).astype(np.uint8)
    Image.fromarray(smooth).save(tmp_path / "pil.png", optimize=True)
    np.testing.assert_array_equal(
        _load_both(tmp_path / "pil.png", monkeypatch), smooth)
    timage.save_image(str(tmp_path / "f.png"), np.array([[0.0, 0.5, 1.0]]))
    np.testing.assert_array_equal(np.array(Image.open(tmp_path / "f.png")),
                                  [[0, 128, 255]])
    grid = timage.make_img(np.zeros((4, 3, 5, 1)), ncols=2)
    assert grid.shape == (6, 10, 1)


def _filtered_png(img, kinds):
    """An 8-bit PNG of img (H, W, C) with row y filtered by kinds[y]."""
    h, w, c = img.shape
    prev = np.zeros(w * c, np.int32)
    rows = []
    for y in range(h):
        line = img[y].reshape(-1).astype(np.int32)
        left = np.concatenate([np.zeros(c, np.int32), line[:-c]])
        ul = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        p = left + prev - ul
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, prev, ul))
        pred = [0, left, prev, (left + prev) >> 1, paeth][kinds[y]]
        rows.append(bytes([kinds[y]])
                    + ((line - pred) & 255).astype(np.uint8).tobytes())
        prev = line
    header = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 2: 4, 3: 2, 4: 6}[c],
                         0, 0, 0)
    chunk = timage._chunk
    return (timage._PNG_SIG + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("shape", [(37, 41, 3), (5, 1, 1), (1, 9, 4),
                                   (23, 17, 2)])
def test_png_reader_undoes_every_row_filter(tmp_path, monkeypatch, shape):
    """Each of the five row filters alone and mixed row by row, through the
    standard-library reader and PIL: equal to the image."""
    rng = np.random.default_rng(7)
    img = rng.integers(0, 256, size=shape).astype(np.uint8)
    for kinds in [np.full(shape[0], k) for k in range(5)] + [
            rng.integers(0, 5, shape[0])]:
        (tmp_path / "r.png").write_bytes(_filtered_png(img, kinds))
        np.testing.assert_array_equal(
            _load_both(tmp_path / "r.png", monkeypatch), img)


def test_png_reader_without_pil_takes_a_large_texture(tmp_path,
                                                      monkeypatch):
    """A 1024^2 RGB PNG written by PIL with its adaptive row filters loads
    exactly through the standard-library reader within 20 s on the CPU
    (well under 1 s on a desktop core)."""
    rng = np.random.default_rng(6)
    yy, xx = np.mgrid[0:1024, 0:1024]
    img = (np.stack([xx // 4, yy // 4, (xx + yy) // 8], -1) % 256
           + rng.integers(0, 3, (1024, 1024, 3))).astype(np.uint8)
    Image.fromarray(img).save(tmp_path / "tex.png")
    data = (tmp_path / "tex.png").read_bytes()
    pos, idat = 8, b""
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        idat += data[pos + 8:pos + 8 + n] if kind == b"IDAT" else b""
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(1024, -1)
    assert set(rows[:, 0].tolist()) & {1, 3, 4}   # left-dependent filters
    monkeypatch.setitem(sys.modules, "PIL", None)
    t0 = time.perf_counter()
    got = timage.load_image(str(tmp_path / "tex.png"))
    assert time.perf_counter() - t0 < 20.0
    np.testing.assert_array_equal(got, img)


# ------------------------------------------------------------ results ----

def test_save_results_matches_jax(take_dirs, tmp_path):
    cfg = _config(take_dirs, tmp_path, out_dir=str(tmp_path / "t"))
    jcfg = JConfig(**dataclasses.asdict(cfg))
    jcfg = dataclasses.replace(jcfg, out_dir=str(tmp_path / "j"))
    scene, _, n_frames, _ = tapi.setup_from_config(cfg, device="cpu")
    jsc, _, jn, _ = japi.setup_from_config(jcfg)
    assert jn == n_frames == 2
    rng = np.random.default_rng(3)
    params = {k: np.asarray(v) for k, v in jstate.init_params(
        jcfg, n_frames, jsc.v_base.shape[0], jsc.deltas.shape[1],
        rng.uniform(size=(8, 8, 1)).astype(np.float32), 1).items()}
    params["maps"] = rng.normal(size=params["maps"].shape).astype(
        np.float32)
    params["per_frame_t"] = rng.normal(size=(2, 3)).astype(np.float32)
    params["per_frame_q"] = rng.normal(size=(2, 4)).astype(np.float32)
    d_t = tresults.save_results(cfg, scene, tstate.params_from_numpy(
        params, device="cpu"), n_frames)
    d_j = jresults.save_results(jcfg, jsc, params, n_frames)
    for i in range(n_frames):
        got = tobj.load_obj(os.path.join(d_t, f"{i}.obj"))
        want = jobj.load_obj(os.path.join(d_j, f"{i}.obj"))
        np.testing.assert_allclose(got.vertices, want.vertices, rtol=TOL,
                                   atol=TOL)
        np.testing.assert_array_equal(got.faces, want.faces)
        np.testing.assert_array_equal(got.uv, want.uv)
    for f in ("pose.json",):
        assert (json.load(open(os.path.join(d_t, f)))
                == json.load(open(os.path.join(d_j, f))))
    np.testing.assert_array_equal(tresults.load_pose(d_t)[1],
                                  jresults.load_pose(d_j)[1])
    np.testing.assert_array_equal(
        np.array(Image.open(os.path.join(d_t, "texture.png"))),
        np.array(Image.open(os.path.join(d_j, "texture.png"))))

    def keys(path):
        return [ln.split(":")[0] for ln in open(path)]
    assert keys(tmp_path / "t" / "config.txt") == keys(tmp_path / "j" /
                                                       "config.txt")


# ------------------------------------------- the cases of test_fit_api ----

def test_fit_take_end_to_end(take_dirs, tmp_path):
    out_dir = str(tmp_path / "out")
    config = _config(take_dirs, tmp_path, max_iter=6, out_dir=out_dir,
                     log_interval=2, checkpoint_dir=str(tmp_path / "ckpt"),
                     checkpoint_interval=4)
    state = tapi.fit_take(config, device="cpu")
    assert state.step == 6
    assert bool(torch.isfinite(state.params["tex"]).all())
    result = os.path.join(out_dir, "result")
    for f in ("0.obj", "1.obj", "pose.json", "texture.png"):
        assert os.path.exists(os.path.join(result, f)), f
    assert os.path.exists(os.path.join(out_dir, "config.txt"))
    records = [json.loads(ln) for ln in open(os.path.join(out_dir,
                                                          "metrics.jsonl"))]
    assert [r["step"] for r in records] == [1, 3, 5]
    assert records[0]["pair_cap"] == 128 and records[0]["n_valid_pairs"] > 0
    assert all(np.isfinite(r["loss"]) for r in records)
    latest = tckpt.latest_checkpoint(str(tmp_path / "ckpt"))
    assert latest.endswith("step_000000006.pt")

    state2 = tapi.fit_take(dataclasses.replace(config, max_iter=8),
                           resume=True, device="cpu")
    assert state2.step == 8


def test_fit_take_returns_no_step_graph(take_dirs, tmp_path, monkeypatch):
    """The state ``fit_take`` returns holds no CUDA graph of its step: the
    graph, its memory pool and what it keeps alive (the scene, the take)
    go when the fit ends, before the results are saved."""
    run_fit = tapi.loop_mod.run_fit
    seen = []

    def fit_with_graph(*args, **kw):
        state = run_fit(*args, **kw)
        state.graph = object()      # stands in for the step's CUDA graph
        seen.append(state)
        return state

    monkeypatch.setattr(tapi.loop_mod, "run_fit", fit_with_graph)
    state = tapi.fit_take(_config(take_dirs, tmp_path, max_iter=2,
                                  out_dir=str(tmp_path / "out")),
                          device="cpu")
    assert len(seen) == 1 and seen[0] is state
    assert state.step == 2 and state.graph is None


def test_fit_take_rejects_bad_mode(take_dirs, tmp_path):
    with pytest.raises(ValueError, match="bogus"):
        FitConfig(mode="bogus").validate()
    with pytest.raises(ValueError, match="bogus"):
        tapi.fit_take(_config(take_dirs, tmp_path, mode="bogus"),
                      device="cpu")
    with pytest.raises(ValueError, match="bogus"):
        tapi.fit_take(_config(take_dirs, tmp_path, raster_impl="bogus"),
                      device="cpu")


def test_fit_take_scan_matches_jax(take_dirs, tmp_path):
    """``fit_take`` with raster_impl="scan" (the reference rasterizer,
    sample by sample) on the tiny take: no cap is autotuned and no bin
    health is logged, as in JAX; the first logged loss equals JAX's within
    1e-6 relative (one texture file for both; the frames are equal, so the
    two packages' different batch draws see the same references), the
    later ones within 1e-4 (the draws update other frames' parameters;
    measured 2.8e-5)."""
    tex = np.random.default_rng(3).integers(0, 256, (8, 8), np.uint8)
    Image.fromarray(tex).save(take_dirs / "tex.png")
    kw = dict(max_iter=3, lr_base=1e-6, lr_t=1e-6, lr_q=1e-6,
              texpath=str(take_dirs / "tex.png"), log_interval=1,
              raster_impl="scan")
    t_out, j_out = tmp_path / "t", tmp_path / "j"
    state = tapi.fit_take(_config(take_dirs, tmp_path, out_dir=str(t_out),
                                  **kw), resume=False, device="cpu")
    japi.fit_take(_config(take_dirs, tmp_path, JConfig, out_dir=str(j_out),
                          **kw), resume=False)
    got, want = ([json.loads(ln) for ln in open(d / "metrics.jsonl")]
                 for d in (t_out, j_out))
    assert state.step == 3 and [r["step"] for r in got] == [1, 2, 3]
    assert set(got[0]) == set(want[0]) == {"step", "loss", "it_per_s",
                                           "pair_cap"}
    assert got[0]["pair_cap"] == want[0]["pair_cap"] == 0
    losses = [[r["loss"] for r in x] for x in (got, want)]
    np.testing.assert_allclose(losses[0][0], losses[1][0], rtol=1e-6)
    np.testing.assert_allclose(*losses, rtol=1e-4)


def test_fit_take_display_interval(take_dirs, tmp_path):
    out_dir = str(tmp_path / "out_disp")
    config = _config(take_dirs, tmp_path, max_iter=3, lr_base=1e-5,
                     out_dir=out_dir, log_interval=0, display_interval=2)
    tapi.fit_take(config, resume=False, device="cpu")
    preview = timage.load_image(os.path.join(out_dir, "preview.png"))
    assert preview.shape == (RES[0], 2 * RES[1], 1)
    assert np.all(preview[:, :RES[1]] == 90)          # the reference frame
    assert np.any(preview[:, RES[1]:] != 45)          # the quad is in view


def _no_imageio(monkeypatch):
    """Make ``import imageio`` fail, as on a machine without it."""
    import builtins

    real_import = builtins.__import__

    def no_imageio(name, *a, **k):
        if name == "imageio":
            raise ImportError("gated for the test")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_imageio)


def test_fit_take_mp4_interval_writes_jax_progress_frames(take_dirs,
                                                          tmp_path,
                                                          monkeypatch):
    _no_imageio(monkeypatch)
    # one texture file for both packages (their noise textures differ)
    tex = np.random.default_rng(3).integers(0, 256, (8, 8), np.uint8)
    Image.fromarray(tex).save(take_dirs / "tex.png")
    kw = dict(max_iter=3, lr_base=1e-6, lr_t=1e-6, lr_q=1e-6,
              mp4_interval=1, texpath=str(take_dirs / "tex.png"),
              log_interval=0)
    t_out, j_out = tmp_path / "t", tmp_path / "j"
    tapi.fit_take(_config(take_dirs, tmp_path, out_dir=str(t_out), **kw),
                  resume=False, device="cpu")
    japi.fit_take(_config(take_dirs, tmp_path, JConfig, out_dir=str(j_out),
                          **kw), resume=False)
    names = sorted(p.name for p in t_out.glob("progress_*.png"))
    assert names == [f"progress_{i:05d}.png" for i in range(3)]
    assert names == sorted(p.name for p in j_out.glob("progress_*.png"))
    for name in names:
        got = timage.load_image(str(t_out / name)).astype(np.int16)
        want = np.asarray(Image.open(j_out / name)).astype(np.int16)
        assert got.shape == (RES[0], 2 * RES[1], 1)
        np.testing.assert_array_less(np.abs(got[..., 0] - want), 2)
        assert np.all(got[:, :RES[1], 0] == 90)      # the reference frame
        assert np.any(got[:, RES[1]:] != 45)         # the quad is in view


@pytest.mark.parametrize("impl, error", [("scan", None),
                                         ("bogus", ValueError),
                                         ("pallas", None)])
def test_fit_entry_points_check_raster_impl(take_dirs, tmp_path, impl,
                                            error):
    from fpc_diffrend_tpu_torch.fit import loop as tloop

    config = _config(take_dirs, tmp_path, max_iter=1, raster_impl=impl,
                     out_dir=str(tmp_path / "out"), log_interval=0)
    scene, frames, n_frames, _ = tapi.setup_from_config(config, "cpu")
    calls = [lambda: tapi.fit_take(config, resume=False, device="cpu"),
             lambda: tloop.run_fit(config, scene, frames, n_frames),
             lambda: tloop.evaluate(config, scene, tloop.run_fit(
                 dataclasses.replace(config, raster_impl="auto"), scene,
                 frames, n_frames).params, frames, 1, torch.Generator())]
    for call in calls:
        if error is None:
            call()
        else:
            with pytest.raises(error, match=impl):
                call()


def test_fit_take_crash_leaves_resumable_checkpoint(take_dirs, tmp_path,
                                                     monkeypatch):
    out_dir = str(tmp_path / "out_crash")
    config = _config(take_dirs, tmp_path, max_iter=8, out_dir=out_dir,
                     log_interval=1,
                     checkpoint_dir=str(tmp_path / "ckpt_crash"))
    orig_run_fit = tapi.loop_mod.run_fit

    def bomb(i, st, metrics):
        if i >= 3:
            raise RuntimeError("injected fault")

    def run_fit_with_bomb(cfg, scene, frames, n_frames, callbacks=None,
                          state=None, n_steps=None):
        return orig_run_fit(cfg, scene, frames, n_frames,
                            callbacks=(callbacks or []) + [bomb],
                            state=state, n_steps=n_steps)

    monkeypatch.setattr(tapi.loop_mod, "run_fit", run_fit_with_bomb)
    with pytest.raises(RuntimeError, match="injected fault"):
        tapi.fit_take(config, device="cpu")
    monkeypatch.setattr(tapi.loop_mod, "run_fit", orig_run_fit)
    latest = tckpt.latest_checkpoint(config.checkpoint_dir)
    assert latest.endswith("step_000000004.pt")     # the last completed
    assert os.path.exists(os.path.join(out_dir, "result", "texture.png"))
    state = tapi.fit_take(config, device="cpu")
    assert state.step == 8
    assert bool(torch.isfinite(state.params["tex"]).all())


def _adversarial_scene(n_tall: int, n_small: int = 0, res: int = 128):
    """test_fit_api.py's scene: n_tall thin triangles spanning more tile
    rows than the binning window (the global list) and n_small that fit,
    through an identity camera; both packages' scenes and parameters."""
    rng = np.random.default_rng(7)
    n = n_tall + n_small
    xs = rng.uniform(-0.9, 0.9, size=n).astype(np.float32)
    y0 = rng.uniform(-0.95, 0.2, size=n).astype(np.float32)
    span = np.concatenate([np.full(n_tall, 0.7), np.full(n_small, 0.1)]
                          ).astype(np.float32)
    verts = np.zeros((n * 3, 3), np.float32)
    verts[0::3] = np.stack([xs, y0, np.zeros(n)], axis=1)
    verts[1::3] = np.stack([xs + 0.01, y0, np.zeros(n)], axis=1)
    verts[2::3] = np.stack([xs, y0 + span, np.zeros(n)], axis=1)
    faces = np.arange(n * 3, dtype=np.int32).reshape(n, 3)
    uv = np.tile(np.array([[0.2, 0.2], [0.8, 0.2], [0.5, 0.8]], np.float32),
                 (n, 1))
    eye = np.eye(4, dtype=np.float32)[None]
    kw = dict(max_iter=2, resolution=(res, res), texshape=(8, 8, 1),
              mode="free", cam_idxs=(0,), batch_size=1)
    tex = np.full((8, 8, 1), 0.5, np.float32)
    out = []
    for objlib, scene_mod, st, cfg, dev in (
            (tobj, tscene, tstate, FitConfig(**kw), {"device": "cpu"}),
            (jobj, jscene, jstate, JConfig(raster_impl="pallas", **kw), {})):
        mesh = objlib.MeshData(vertices=verts.reshape(-1), uv=uv,
                               faces=faces, fuv=faces)
        scene = scene_mod.build_scene(mesh, eye, eye, **dev)
        params = st.init_params(cfg, 2, scene.v_base.shape[0],
                                scene.deltas.shape[1], tex, 1, **dev)
        out.append((cfg, scene, params))
    return out


def test_global_list_overflow_aborts_autotune():
    from fpc_diffrend_tpu_torch.ops.cuda.rasterize_cuda import MAX_GLOBAL

    (config, scene, params), jax_side = _adversarial_scene(MAX_GLOBAL + 76)
    health = tapi.measure_raster_health(config, scene, params)
    want = japi.measure_raster_health(*jax_side)
    assert health == {k: want[k] for k in tapi.HEALTH_KEYS}
    assert health["global_overflow"] == 76
    with pytest.raises(RuntimeError, match="global-list overflow"):
        tapi.autotune_caps(config, scene, params)
    assert "WARNING: raster global-list overflow" in "\n".join(
        tapi.health_warnings(config, health))


def test_health_warnings_pair_cap():
    (config, scene, params), jax_side = _adversarial_scene(0, n_small=8)
    health = tapi.measure_raster_health(config, scene, params)
    want = japi.measure_raster_health(*jax_side)
    assert health == {k: want[k] for k in tapi.HEALTH_KEYS}
    assert health["n_valid_pairs"] > 2
    msgs = "\n".join(tapi.health_warnings(
        dataclasses.replace(config, pair_cap=2), health))
    assert "exceed pair_cap" in msgs
    assert tapi.health_warnings(config, health) == []
    tuned = tapi.autotune_caps(config, scene, params)
    assert tuned.pair_cap == -(-int(health["n_valid_pairs"] * 1.25)
                               // 128) * 128


def test_fit_surfaces_cap_overflow_warning(take_dirs, tmp_path, capsys):
    config = _config(take_dirs, tmp_path, max_iter=2, lr_base=1e-5,
                     out_dir=str(tmp_path / "out_ovf"), batch_size=1,
                     pair_cap=1, log_interval=1)
    tapi.fit_take(config, resume=False, device="cpu")
    assert "exceed pair_cap" in capsys.readouterr().out


def test_checkpoint_restore_is_bit_exact(tmp_path):
    config = FitConfig(max_iter=2, resolution=RES, texshape=(8, 8, 1),
                       mode="free", cam_idxs=(0,), batch_size=1)
    rng = np.random.default_rng(1)
    tex = rng.uniform(size=(8, 8, 1)).astype(np.float32)
    state = tstate.init_state(config, tstate.init_params(
        config, 2, 12, 2, tex, 1, device="cpu"))
    # nonzero moments, so the round trip covers the optimizer state
    for p in state.params.values():
        p.grad = torch.as_tensor(rng.normal(size=p.shape).astype(np.float32))
    for _ in range(3):
        tstate.optimizer_step(config, state)
    path = tckpt.save_checkpoint(str(tmp_path / "ck"), state)
    fresh = tstate.init_state(config, tstate.init_params(
        config, 2, 12, 2, np.zeros_like(tex), 1, device="cpu"))
    restored = tckpt.restore_checkpoint(path, fresh)
    assert restored.step == state.step == 3
    for k, v in state.params.items():
        assert torch.equal(restored.params[k], v), k
    saved, got = state.optimizer.state_dict(), \
        restored.optimizer.state_dict()
    assert saved["param_groups"] == got["param_groups"]
    for i, s in saved["state"].items():
        for name, t in s.items():
            assert torch.equal(got["state"][i][name], t), (i, name)
