"""The single-view render and the result renderers against the JAX package.

On the 9x9 dome of ``tests/test_pipeline_fused.py`` at 48x128 with a
64x128 texture (the CPU runs each kernel's plain version):

* the three routes ("sepaa": K1 -> K2; "aa_fused": K10; "separate": K1
  -> K7 -> K2) agree: image within 1e-6, gradients within 1e-6 + 1e-5
  relative (``test_pipeline_fused.py``'s tolerances for its three routes);
* ``render(impl="scan")`` against JAX's within 5e-5 (image) and 1e-4 of
  the largest magnitude (gradients): the same formulas on clip positions
  a few ulp apart;
* each route against JAX ``render(impl="scan", aa_max_pairs=None)`` with
  that file's own tolerances (>= 99.5 % of pixels within 2e-4; texture
  gradient within 5e-5 + 5e-3 relative, vertex gradient within 2 % of its
  largest magnitude): the two visibility formulations round differently
  at coverage edges;
* each route against JAX ``render(impl="pallas")`` on the matching TPU
  route (``FPC_AA_FUSE=1`` / ``FPC_FUSE_TEX=0``, Pallas in interpret
  mode): the forward at 24x128 in the fast set, the gradients (slow);
  images within 5e-5, as the TPU kernel's uv differ from the port's by
  up to 2e-5 (``test_torch_raster.py``) and its hat-matrix sampler rounds
  elsewhere (1e-5, ``test_texture_pallas.py:83``);
* the single view's bins (a batch of one of the stacked binning) equal
  JAX ``bin_scene``'s at the same entry cap: offsets, the live entries and
  their records, the global list;
* ``simple_render`` and ``render_result`` on a tiny take write images
  within one grey level of the JAX tools' on >= 99.5 % of the pixels.
"""

import json
import shutil

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fpc_diffrend_tpu.ops.pallas import rasterize_tpu as jr
from fpc_diffrend_tpu.ops.pipeline import render as jrender
from fpc_diffrend_tpu.utils.debugging import pallas_interpret_mode
from fpc_diffrend_tpu_torch.data.frames import save_tiff
from fpc_diffrend_tpu_torch.data.obj import save_obj
from fpc_diffrend_tpu_torch.models import camera
from fpc_diffrend_tpu_torch.ops import render
from fpc_diffrend_tpu_torch.ops.cuda import rasterize_cuda as tr
from fpc_diffrend_tpu_torch.ops.cuda import texture_cuda as ttc
from fpc_diffrend_tpu_torch.ops.rasterize import bin_stacked
from fpc_diffrend_tpu_torch.utils.image import load_image, save_image

from _torch_scenes import quads_scene
from test_pipeline_fused import scene as dome_scene

RES = (48, 128)
ROUTES = ("sepaa", "aa_fused", "separate")
TPU_ENV = {"sepaa": {}, "aa_fused": {"FPC_AA_FUSE": "1"},
           "separate": {"FPC_FUSE_TEX": "0"}}


def _dome():
    rng = np.random.default_rng(0)
    arrays = [np.array(x) for x in dome_scene(rng)]
    tex = rng.uniform(size=(64, 128, 1)).astype(np.float32)
    ref = rng.uniform(size=RES + (1,)).astype(np.float32)
    return arrays, tex, ref


def _port(route, res=RES, grads=True, impl="auto"):
    """(image, vertex gradient, texture gradient) of the loss
    mean((ref - img)^2) on the CPU."""
    (mvp, verts, faces, uv, uv_idx, neigh), tex, ref = _dome()
    v = torch.tensor(verts, requires_grad=grads)
    t = torch.tensor(tex, requires_grad=grads)
    img = render(mvp, v, faces, uv, uv_idx, t, res, neigh, route=route,
                 impl=impl, device="cpu")
    if not grads:
        return img.numpy(), None, None
    torch.mean((torch.as_tensor(ref[:res[0]]) - img) ** 2).backward()
    return img.detach().numpy(), v.grad.numpy(), t.grad.numpy()


def _jax(impl, res=RES, grads=True):
    (mvp, verts, faces, uv, uv_idx, neigh), tex, ref = _dome()
    ref = jnp.asarray(ref[:res[0]])

    def loss(v, t):
        img = jrender(mvp, v, faces, uv, uv_idx, t, res, neigh, impl=impl,
                      aa_max_pairs=None)
        return jnp.mean((ref - img) ** 2), img

    if not grads:
        return np.asarray(loss(jnp.asarray(verts), jnp.asarray(tex))[1])
    (_, img), (gv, gt) = jax.value_and_grad(loss, argnums=(0, 1),
                                            has_aux=True)(jnp.asarray(verts),
                                                          jnp.asarray(tex))
    return np.asarray(img), np.asarray(gv), np.asarray(gt)


@pytest.fixture(scope="module")
def port_routes():
    return {r: _port(r) for r in ROUTES}


@pytest.fixture(scope="module")
def jax_scan():
    return _jax("scan")


@pytest.mark.parametrize("route", ROUTES[1:])
def test_routes_agree(port_routes, route):
    img, gv, gt = port_routes[route]
    img0, gv0, gt0 = port_routes["sepaa"]
    assert img.shape == RES + (1,)
    np.testing.assert_allclose(img, img0, atol=1e-6, rtol=0)
    np.testing.assert_allclose(gt, gt0, atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(gv, gv0, atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("route", ROUTES)
def test_route_matches_jax_scan(port_routes, jax_scan, route):
    img, gv, gt = port_routes[route]
    img_s, gv_s, gt_s = jax_scan
    close = np.isclose(img, img_s, atol=2e-4)
    assert close.mean() > 0.995, f"{(~close).sum()} of {close.size} differ"
    np.testing.assert_allclose(gt, gt_s, atol=5e-5, rtol=5e-3)
    assert np.abs(gv - gv_s).max() / np.abs(gv_s).max() < 0.02


def test_scan_route_matches_jax_scan(jax_scan):
    """render(impl="scan"): JAX's scan route composed of the port's
    primitives (the visibility scan, interpolate, the sampler's and the
    gathered antialias's plain versions) on the same formulas: every id
    equal, the image within 5e-5 and the gradients within 1e-4 of their
    largest magnitude (measured 9.8e-6 and 1.5e-5: the two packages'
    clip transforms round a few ulp apart, and the 128-texel texture
    scales a uv ulp by its width)."""
    img, gv, gt = _port("sepaa", impl="scan")
    img_s, gv_s, gt_s = jax_scan
    bg = 45.0 / 255.0
    np.testing.assert_array_equal(img == bg, img_s == bg)
    np.testing.assert_allclose(img, img_s, atol=5e-5, rtol=0)
    for g, want in ((gv, gv_s), (gt, gt_s)):
        np.testing.assert_allclose(g, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


def _jax_pallas(route, monkeypatch, res, grads):
    for k in ("FPC_AA_FUSE", "FPC_FUSE_TEX", "FPC_AA_COMBINED"):
        monkeypatch.delenv(k, raising=False)
    for k, v in TPU_ENV[route].items():
        monkeypatch.setenv(k, v)
    jax.clear_caches()
    try:
        with pallas_interpret_mode():
            return _jax("pallas", res, grads)
    finally:
        jax.clear_caches()


@pytest.mark.parametrize("route", ROUTES[1:])
def test_route_forward_matches_tpu_route(route, monkeypatch):
    """The small case of the fast set: the forward at 24x128."""
    res = (24, 128)
    got = _port(route, res, grads=False)[0]
    want = _jax_pallas(route, monkeypatch, res, grads=False)
    np.testing.assert_allclose(got, want, atol=5e-5, rtol=0)


@pytest.mark.slow
@pytest.mark.parametrize("route", ROUTES)
def test_route_gradients_match_tpu_route(port_routes, route, monkeypatch):
    img, gv, gt = port_routes[route]
    img_p, gv_p, gt_p = _jax_pallas(route, monkeypatch, RES, grads=True)
    np.testing.assert_allclose(img, img_p, atol=5e-5, rtol=0)
    np.testing.assert_allclose(gt, gt_p, atol=1e-5, rtol=1e-3)
    assert np.abs(gv - gv_p).max() / np.abs(gv_p).max() < 1e-3


def _clip(verts, mvp):
    posw = np.concatenate([verts, np.ones_like(verts[:, :1])], 1)
    return (posw @ mvp.T).astype(np.float32)


@pytest.mark.parametrize("scene_name,cap", [("dome", None), ("dome", 128),
                                            ("quads", None)])
def test_single_view_bins_match_bin_scene(scene_name, cap):
    """A batch of one of the stacked binning is JAX's single-view binning:
    bin offsets, the live entries' triangles and records, and the global
    list (the quads' large triangles fill it) equal bit for bit. Past the
    live prefix the port writes its sentinel, JAX the key's triangle."""
    rng = np.random.default_rng(1)
    if scene_name == "dome":
        (mvp, verts, faces, uv, uv_idx, neigh), _, _ = _dome()
        pc = _clip(verts, mvp)
        H, W = RES
    else:
        verts, faces, uv, neigh = quads_scene(rng)
        uv_idx = faces
        pc = _clip(verts, np.eye(4, dtype=np.float32))
        H, W = 96, 256              # quads taller than the binning window
    _, _, bins = bin_stacked(torch.as_tensor(pc)[None],
                             torch.as_tensor(faces), torch.as_tensor(uv),
                             torch.as_tensor(uv_idx), torch.as_tensor(neigh),
                             (H, W), cap or 0)
    aux = jr.aux_records(jnp.asarray(uv), jnp.asarray(uv_idx),
                         jnp.asarray(pc), jnp.asarray(faces),
                         jnp.asarray(neigh), H, W)
    _, want = jr.bin_scene(jnp.asarray(pc), jnp.asarray(faces), H, W,
                           aux=aux, entry_cap=cap)
    bs = bins.bin_start.numpy()
    live = int(bs[-1])
    np.testing.assert_array_equal(bs, np.asarray(want.bin_start))
    np.testing.assert_array_equal(bins.sorted_tri.numpy()[:live],
                                  np.asarray(want.sorted_tri)[:live])
    assert bins.sorted_tri.shape == want.sorted_tri.shape
    np.testing.assert_array_equal(bins.sorted_rec.numpy()[:live],
                                  np.asarray(want.sorted_rec_t).T[:live])
    n_global = int(bins.n_global[0])
    assert n_global == int(want.n_global[0])
    np.testing.assert_array_equal(bins.global_idx.numpy(),
                                  np.asarray(want.global_idx))
    np.testing.assert_array_equal(bins.global_rec.numpy(),
                                  np.asarray(want.global_rec_t).T)
    if scene_name == "quads":
        assert n_global > 0
    if cap:
        assert live == bins.sorted_tri.shape[0] == cap


def test_render_arguments():
    (mvp, verts, faces, uv, uv_idx, neigh), tex, _ = _dome()
    args = (mvp, verts, faces, uv, uv_idx, tex, RES, neigh)
    # the scan route reads the antialias pair cap and not the route
    scan = render(*args, impl="scan", device="cpu")
    capped = render(*args, impl="scan", aa_max_pairs=8, route="fused",
                    device="cpu")
    assert scan.shape == capped.shape == RES + (1,)
    assert 0 < int((scan != capped).sum()) < scan.numel() // 10
    with pytest.raises(ValueError, match="bogus"):
        render(*args, impl="bogus", device="cpu")
    with pytest.raises(ValueError, match="route"):
        render(*args, route="fused", device="cpu")
    # a 2-D texture is one channel; the mip path runs at a batch of one
    img2d = render(mvp, verts, faces, uv, uv_idx, tex[..., 0], RES, neigh,
                   device="cpu")
    img = render(*args, device="cpu")
    np.testing.assert_array_equal(img2d.numpy(), img.numpy())
    mip = render(*args, enable_mip=True, max_mip_level=3, device="cpu")
    assert mip.shape == RES + (1,) and bool(torch.isfinite(mip).all())
    assert tr.fused_raster_aa.launches == ttc.texture_planes.launches == 0


# ---------------------------------------------------------------- tools ----

TOOL_RES = (48, 64)


@pytest.fixture(scope="module")
def tiny_take(tmp_path_factory):
    """A result directory of two fitted frames of the dome, its base mesh,
    a two-camera calibration and reference TIFFs."""
    root = tmp_path_factory.mktemp("take")
    (_, verts, faces, uv, uv_idx, _), _, _ = _dome()
    rng = np.random.default_rng(2)
    result = root / "result"
    result.mkdir()
    save_obj(str(root / "basemesh.obj"), verts, uv, faces, uv_idx)
    for i in range(2):
        save_obj(str(result / f"{i}.obj"),
                 verts + rng.normal(scale=0.02, size=verts.shape), uv, faces,
                 uv_idx)
    save_image(str(result / "texture.png"),
               rng.integers(0, 256, size=(64, 64, 1), dtype=np.uint8))
    with open(result / "pose.json", "w") as f:
        json.dump({"translation": [[0.0, 0.0, 0.0], [0.05, 0.0, 0.0]],
                   "rotation": [[0.0, 0.0, 0.0, 1.0],
                                [0.0, 0.02, 0.0, 0.9998]]}, f)
    calib = {}
    for c, angle in enumerate((0.0, 0.15)):
        rot = camera.rotate_y(angle)[:3, :3].tolist()
        calib[f"cam{c}"] = {
            "intrinsic": [[60.0, 0.0, 32.0], [0.0, 60.0, 24.0],
                          [0.0, 0.0, 1.0]],
            "distortion": [[0.0]] * 5, "rotation": rot,
            "translation": [[0.0], [0.0], [5.0]]}
    with open(root / "calibration.json", "w") as f:
        json.dump(calib, f)
    refs = root / "refs"
    refs.mkdir()
    for i in range(2):
        save_tiff(str(refs / f"cam0_{i:03d}.tif"), rng.integers(
            0, 256, size=TOOL_RES, dtype=np.uint8))
    return root


def _within_one_level(got, want):
    assert got.shape == want.shape
    near = np.abs(got.astype(np.int16) - want.astype(np.int16)) <= 1
    assert near.mean() >= 0.995, f"{(~near).sum()} of {near.size} differ"


@pytest.mark.parametrize("mode,cams", [("grid", ["cam0", "cam1"]),
                                       ("side-by-side", ["cam0"])])
def test_render_result_matches_jax_tool(tiny_take, tmp_path, mode, cams):
    from fpc_diffrend_tpu.tools.render_result import (
        render_result as jax_render_result)
    from fpc_diffrend_tpu_torch.tools.render_result import render_result

    out = {}
    for name, fn, kw in (("jax", jax_render_result, {}),
                         ("port", render_result, {"device": "cpu"})):
        result = tmp_path / name
        shutil.copytree(tiny_take / "result", result)
        fn(str(result), str(tiny_take / "calibration.json"),
           str(tiny_take / "basemesh.obj"), cams, 2,
           refdir=str(tiny_take / "refs"), resolution=TOOL_RES, mode=mode,
           write_imgs=True, **kw)
        out[name] = [load_image(str(result / f"frame{i}_{mode}.png"))
                     for i in range(2)]
    for got, want in zip(out["port"], out["jax"]):
        assert (got > 45).any()                       # the mesh is in view
        _within_one_level(got, want)


def test_simple_render_matches_jax_tool(tiny_take, tmp_path):
    from fpc_diffrend_tpu.tools.simple_render import (
        simple_render as jax_simple_render)
    from fpc_diffrend_tpu_torch.tools.simple_render import simple_render

    args = (str(tiny_take / "calibration.json"), "cam1",
            str(tiny_take / "result" / "0.obj"),
            str(tiny_take / "result" / "texture.png"), TOOL_RES)
    want = jax_simple_render(*args, str(tmp_path / "jax.png"))
    got = simple_render(*args, str(tmp_path / "port.png"), device="cpu")
    assert got.shape == TOOL_RES + (1,) and (got > 0).mean() > 0.05
    np.testing.assert_array_equal(load_image(str(tmp_path / "port.png")),
                                  got)
    _within_one_level(got, want)
    # the constant texture when none is given
    flat = simple_render(*args[:3], "", TOOL_RES, "", device="cpu")
    assert set(np.unique(flat)) <= {0, 178}
