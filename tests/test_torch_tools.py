"""The port's host modules and offline tools against the JAX package's
(``tests/test_tools_and_io.py``'s cases): ``data/seq.py``,
``tools/comparisons.py``, ``tools/batchmodify.py``,
``tools/undistort.py`` (the torch remap against ``undistort_image_jax``
within 1e-4, the cv2 path against JAX's exactly), ``tools/
render_reference.py`` and ``tools/calibrate.py`` (OpenCV on the host).
"""

import json
import os

import numpy as np
import pytest
from PIL import Image

from fpc_diffrend_tpu.data import seq as jseq
from fpc_diffrend_tpu.tools import batchmodify as jbatch
from fpc_diffrend_tpu.tools import calibrate as jcal
from fpc_diffrend_tpu.tools import comparisons as jcomp
from fpc_diffrend_tpu.tools import undistort as jund
from fpc_diffrend_tpu_torch.data import obj as tobj
from fpc_diffrend_tpu_torch.data import seq as tseq
from fpc_diffrend_tpu_torch.runtime import native
from fpc_diffrend_tpu_torch.tools import batchmodify as tbatch
from fpc_diffrend_tpu_torch.tools import calibrate as tcal
from fpc_diffrend_tpu_torch.tools import comparisons as tcomp
from fpc_diffrend_tpu_torch.tools import render_reference as trender
from fpc_diffrend_tpu_torch.tools import undistort as tund

INTR = np.array([[40.0, 0, 31.5], [0, 42.0, 24.0], [0, 0, 1]], np.float32)
DIST = np.array([-0.21, 0.08, 0.003, -0.002, 0.01], np.float32)


@pytest.mark.parametrize("bulk", [True, False])
def test_seq_roundtrip_matches_jax(tmp_path, monkeypatch, bulk):
    """write_seq -> SeqReader -> timestamps -> extract_to_tif, byte for
    byte the JAX module's; the TIFs come from the native bulk reader where
    it is built, else frame by frame."""
    if not bulk:
        monkeypatch.setattr(native, "available", lambda: False)
    frames = (np.arange(3 * 8 * 16, dtype=np.uint8)
              .reshape(3, 8, 16) * 3 % 251)
    tpath, jpath = str(tmp_path / "t.seq"), str(tmp_path / "j.seq")
    tseq.write_seq(tpath, frames, frame_rate=24.0)
    jseq.write_seq(jpath, frames, frame_rate=24.0)
    assert open(tpath, "rb").read() == open(jpath, "rb").read()
    r = tseq.SeqReader(tpath)
    assert r.header == tseq.SeqHeader(**vars(jseq.SeqReader(jpath).header))
    assert len(r) == 3 and not r.header.compressed
    for i in range(3):
        np.testing.assert_array_equal(r.read_frame(i), frames[i])
    assert r.timestamps() == [0.0, 1.0, 2.0]
    r.close()
    assert tseq.extract_to_tif(tpath, str(tmp_path / "t"), "cam0") == 3
    assert jseq.extract_to_tif(jpath, str(tmp_path / "j"), "cam0") == 3
    for i in range(3):
        name = f"cam0_{i:03d}.tif"
        got = np.array(Image.open(tmp_path / "t" / name))
        np.testing.assert_array_equal(got, frames[i])
        np.testing.assert_array_equal(
            got, np.array(Image.open(tmp_path / "j" / name)))


def test_seq_rejects_garbage(tmp_path):
    p = tmp_path / "bad.seq"
    p.write_bytes(b"\x00" * 4096)
    with pytest.raises(ValueError):
        tseq.SeqReader(str(p))
    p.write_bytes(b"\x00" * 100)
    with pytest.raises(ValueError, match="too small"):
        tseq.SeqReader(str(p))


def test_comparisons_match_jax(tmp_path):
    inf, ref = tmp_path / "inf", tmp_path / "ref"
    inf.mkdir()
    ref.mkdir()
    rng = np.random.default_rng(0)
    for i in range(2):
        a = rng.integers(0, 255, (20, 20), dtype=np.uint8)
        b = np.clip(a.astype(np.int32) + 10, 0, 255).astype(np.uint8)
        Image.fromarray(a).save(inf / f"frame{i}_pose.png")
        Image.fromarray(b).save(ref / f"pod2colour_pod2primary_{i:03d}.tif")
    kw = dict(n_frames=2, rows=(2, 18), cols=(2, 18))
    got = tcomp.compare_sequence_numerical(str(inf), str(ref),
                                           str(tmp_path / "t"), **kw)
    want = jcomp.compare_sequence_numerical(str(inf), str(ref),
                                            str(tmp_path / "j"), **kw)
    assert got == want and all(5.0 < m <= 10.0 for m in got)
    assert ((tmp_path / "t" / "numerical_clip.csv").read_text()
            == (tmp_path / "j" / "numerical_clip.csv").read_text())
    for colour in (True, False):
        tcomp.compare_sequence(str(inf), str(ref), str(tmp_path / "tc"), 2,
                               colour=colour)
        jcomp.compare_sequence(str(inf), str(ref), str(tmp_path / "jc"), 2,
                               colour=colour)
        for i in range(2):
            np.testing.assert_array_equal(
                np.array(Image.open(tmp_path / "tc" / f"colcomp_{i}.png")),
                np.array(Image.open(tmp_path / "jc" / f"colcomp_{i}.png")))
    img = np.full((4, 4), 120, np.uint8)
    base = np.full((4, 4), 100, np.uint8)
    comp = tcomp.diff_heatmap(img, base, colour=True)
    assert (comp[..., 0] == 255).all() and (comp[..., 1] == 215).all()
    for colour in (True, False):
        np.testing.assert_array_equal(
            tcomp.diff_heatmap(base, img, colour),
            jcomp.diff_heatmap(base, img, colour))


def test_batchmodify_matches_jax(tmp_path):
    base = tmp_path / "base.obj"
    base.write_text("# rig\nv 0 0 0\nv 1 0 0\nv 0 1 0\nvt 0 0\nvt 1 0\n"
                    "vt 0 1\nf 1/1 2/2 3/3\n")
    for side in ("t", "j"):
        bl = tmp_path / side
        bl.mkdir()
        (bl / "shape0.obj").write_text("v 0 0 1\nv 1 0 1\nv 0 1 1\n")
        (bl / "notes.txt").write_text("kept")
    assert tbatch.rewrite_blendshapes(str(tmp_path / "t"), str(base)) == 1
    assert jbatch.rewrite_blendshapes(str(tmp_path / "j"), str(base)) == 1
    assert ((tmp_path / "t" / "shape0.obj").read_text()
            == (tmp_path / "j" / "shape0.obj").read_text())
    mesh = tobj.load_obj(str(tmp_path / "t" / "shape0.obj"))
    assert mesh.uv.shape == (3, 2)
    np.testing.assert_allclose(mesh.verts3[:, 2], 1.0)
    out = tmp_path / "out"
    assert tbatch.rewrite_blendshapes(str(tmp_path / "t"), str(base),
                                      str(out)) == 1
    assert (out / "shape0.obj").exists()


def test_undistort_identity_and_torch_remap_match_jax(rng):
    img = np.arange(64, dtype=np.float32).reshape(8, 8)
    intr = np.array([[8.0, 0, 4.0], [0, 8.0, 4.0], [0, 0, 1]], np.float32)
    out = tund.undistort_image_torch(img, intr, np.zeros(5), device="cpu")
    np.testing.assert_allclose(out.numpy(), img, atol=1e-4)
    for shape in ((48, 64), (48, 64, 3)):
        im = rng.uniform(0, 255, size=shape).astype(np.float32)
        got = tund.undistort_image_torch(im, INTR, DIST, device="cpu")
        want = np.asarray(jund.undistort_image_jax(im, INTR, DIST))
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(
        tund.undistort_map(INTR, DIST, 48, 64, device="cpu").numpy(),
        np.asarray(jund.undistort_map(INTR, DIST, 48, 64)), atol=1e-4)


def _take(root, rng):
    calib = {"pod1texture": {"intrinsic": INTR.tolist(),
                             "distortion": DIST.tolist()}}
    (root / "calib.json").write_text(json.dumps(calib))
    cam = root / "take" / "t1_pod1texture"
    cam.mkdir(parents=True)
    for i in range(2):
        Image.fromarray(rng.integers(0, 255, (48, 64), dtype=np.uint8)).save(
            cam / f"t1_pod1texture_{i:03d}.tif")
    return str(root / "take"), str(root / "calib.json")


@pytest.mark.parametrize("use_cv2", [True, False])
def test_undistort_take_matches_jax(tmp_path, rng, use_cv2):
    """The cv2 path writes JAX's frames exactly; the remap path (no cv2)
    within 1 count (uint8 truncation of values that agree to 1e-4)."""
    take, calib = _take(tmp_path, rng)
    tund.undistort_take(take, str(tmp_path / "t"), calib, use_cv2,
                        device="cpu")
    jund.undistort_take(take, str(tmp_path / "j"), calib, use_cv2)
    names = sorted(os.listdir(tmp_path / "t" / "t1_pod1texture"))
    assert len(names) == 2
    for n in names:
        got = np.array(Image.open(tmp_path / "t" / "t1_pod1texture" / n))
        want = np.array(Image.open(tmp_path / "j" / "t1_pod1texture" / n))
        assert got.dtype == np.uint8
        if use_cv2:
            np.testing.assert_array_equal(got, want)
        else:
            assert np.abs(got.astype(int) - want).max() <= 1


def test_render_reference_needs_an_mp4_encoder(tmp_path):
    """Without imageio_ffmpeg the tool fails as the JAX tool does."""
    try:
        import imageio_ffmpeg  # noqa: F401
    except ImportError:
        pass
    else:
        pytest.skip("imageio_ffmpeg is installed here")
    Image.fromarray(np.zeros((8, 8), np.uint8)).save(tmp_path / "a.tif")
    errors = []
    for fn in (trender.render_reference, jtrender()):
        with pytest.raises(Exception) as e:
            fn(str(tmp_path), str(tmp_path / "out.mp4"))
        errors.append(type(e.value))
    assert errors[0] is errors[1]


def jtrender():
    from fpc_diffrend_tpu.tools import render_reference

    return render_reference.render_reference


def _grid_image():
    """A 10x10 grid of bright circles on black (the detector inverts the
    image before it thresholds)."""
    import cv2

    img = np.zeros((1200, 1600), np.uint8)   # the rig's frame size
    for r in range(10):
        for c in range(10):
            cv2.circle(img, (520 + 60 * c + 2 * r, 330 + 60 * r + c), 14,
                       255, -1)
    return img


def test_calibrate_matches_jax(tmp_path):
    pytest.importorskip("cv2")
    assert tcal.change_cam_name("pod1bottom_colour") == \
        jcal.change_cam_name("pod1bottom_colour") == "pod1primary_texture"
    np.testing.assert_array_equal(tcal.grid_object_points(),
                                  jcal.grid_object_points())
    img = _grid_image()
    got, want = tcal.detect_circle_grid(img), jcal.detect_circle_grid(img)
    assert got is not None and got.shape == (100, 2)
    np.testing.assert_array_equal(got, want)
    objp = tcal.grid_object_points()[None]
    t = tcal.calibrate_camera(objp, got[None], img.shape)
    j = jcal.calibrate_camera(objp, want[None], img.shape)
    assert t == j and len(t["rotation"]) == 3
    import cv2

    for i in range(2):
        cv2.imwrite(str(tmp_path / f"pod1bottom_{i}.png"), _grid_image())
    out = tcal.calibrate_directory(str(tmp_path), str(tmp_path / "t.json"))
    ref = jcal.calibrate_directory(str(tmp_path), str(tmp_path / "j.json"))
    assert list(out) == ["pod1primary"] and out == ref
    rod = tcal.add_rodrigues(str(tmp_path / "t.json"))
    assert rod == jcal.add_rodrigues(str(tmp_path / "j.json"))
    assert len(rod["pod1primary"]["rotation_rodrigues"]) == 3
