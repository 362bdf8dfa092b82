"""The public helpers the fit examples reach, against the JAX package's.

Tolerances:
* quaternions, image utilities, the gaussian kernels and blur, the
  Laplacian and the mesh regularizers: 1e-6 relative (the same float32
  formulas; the blur and the index sums add in another order);
* the Laplacian's gradient: 1e-6 of its largest value (the JAX
  segment-sum transpose against the port's self-adjoint index sum);
* ``sync``'s checksum: 1e-6 relative (float32 sums of the same values);
* ``FitConfig.to_json``, ``assert_finite``'s message, ``finite_or_zero``
  and a TIFF written by ``save_tiff`` and read back: exactly equal.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fpc_diffrend_tpu.data import frames as jframes
from fpc_diffrend_tpu.data import obj as jobj
from fpc_diffrend_tpu.fit import losses as jlosses
from fpc_diffrend_tpu.fit import scene as jscene
from fpc_diffrend_tpu.fit.config import FitConfig as JConfig
from fpc_diffrend_tpu.models import pose as jpose
from fpc_diffrend_tpu.ops import mesh_ops as jmesh
from fpc_diffrend_tpu.utils import debugging as jdebug
from fpc_diffrend_tpu.utils import image as jimage
from fpc_diffrend_tpu.utils import profiling as jprof
from fpc_diffrend_tpu_torch.data import frames as tframes
from fpc_diffrend_tpu_torch.fit import losses as tlosses
from fpc_diffrend_tpu_torch.fit import scene as tscene
from fpc_diffrend_tpu_torch.fit.config import FitConfig
from fpc_diffrend_tpu_torch.models import pose as tpose
from fpc_diffrend_tpu_torch.ops import mesh_ops as tmesh
from fpc_diffrend_tpu_torch.utils import debugging as tdebug
from fpc_diffrend_tpu_torch.utils import image as timage
from fpc_diffrend_tpu_torch.utils import profiling as tprof


def _close(got, want, rtol=1e-6):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


# ---- models/pose.py (tests/test_camera.py:66-90) ----

def test_quat_identity_and_axes():
    for shape in ((), (3,), (2, 5)):
        assert tpose.quat_identity(shape).equal(
            torch.tensor(np.asarray(jpose.quat_identity(shape))))
    np.testing.assert_allclose(
        tpose.quat_to_rotmat(tpose.quat_identity()).numpy(), np.eye(3),
        atol=1e-7)
    s = np.sin(np.pi / 4)
    R = tpose.quat_to_rotmat(torch.tensor([0.0, 0.0, s, s])).numpy()
    want = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], dtype=np.float32)
    np.testing.assert_allclose(R, want, atol=1e-6)


def test_quat_normalize_and_multiply_match_jax(rng):
    q = rng.normal(size=(5, 4)).astype(np.float32)
    qn = tpose.quat_normalize(q)
    _close(qn, jpose.quat_normalize(q))
    R = tpose.quat_to_rotmat(qn).numpy()
    for i in range(5):
        np.testing.assert_allclose(R[i] @ R[i].T, np.eye(3), atol=1e-5)
        assert np.linalg.det(R[i]) > 0.99
    q1 = np.asarray(jpose.quat_normalize(rng.normal(size=(3, 4))))
    q2 = np.asarray(jpose.quat_normalize(rng.normal(size=(3, 4))))
    prod = tpose.quat_multiply(q1, q2)
    _close(prod, jpose.quat_multiply(q1, q2))
    R12 = tpose.quat_to_rotmat(prod).numpy()
    want = (tpose.quat_to_rotmat(torch.as_tensor(q1))
            @ tpose.quat_to_rotmat(torch.as_tensor(q2))).numpy()
    np.testing.assert_allclose(R12, want, atol=1e-5)


# ---- ops/mesh_ops.py (tests/test_mesh_ops.py:31,58) and fit/losses.py ----

def _quad():
    verts = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]],
                     np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return verts, faces, jobj.build_topology(faces, 4)


def _topo_args(topo, tensors):
    wrap = torch.as_tensor if tensors else jnp.asarray
    return [wrap(getattr(topo, k)) for k in ("neighbor_src", "neighbor_dst",
                                             "degree")]


def test_uniform_laplacian_values():
    verts, _, topo = _quad()
    lap = tmesh.uniform_laplacian(torch.as_tensor(verts),
                                  *_topo_args(topo, True)).numpy()
    np.testing.assert_allclose(lap[0], [2 / 3, 2 / 3, 0], rtol=1e-5)
    np.testing.assert_allclose(lap[1], [-0.5, 0.5, 0], rtol=1e-5)
    _close(torch.as_tensor(lap), jmesh.uniform_laplacian(
        jnp.asarray(verts), *_topo_args(topo, False)))


def _sphere_scene():
    from fpc_diffrend_tpu_torch.examples.rig import head_mesh

    verts, uvs, faces = head_mesh(n_ring=12, n_seg=8)
    mesh = jobj.MeshData(vertices=verts.reshape(-1), uv=uvs, faces=faces,
                         fuv=faces)
    eye = np.eye(4, dtype=np.float32)[None]
    return verts, (jscene.build_scene(mesh, eye, eye),
                   tscene.build_scene(mesh, eye, eye, device="cpu"))


def test_laplacian_smoothing_and_gradient_match_jax(rng):
    """Values and gradients of the unpadded Laplacian on a closed mesh with
    degenerate pole caps, batched over two meshes on the port's side."""
    verts, (js, ts) = _sphere_scene()
    v = verts + rng.normal(scale=0.1, size=(2,) + verts.shape).astype(
        np.float32)
    jargs = (js.neighbor_src, js.neighbor_dst, js.degree)
    targs = (ts.neighbor_src, ts.neighbor_dst, ts.degree)

    def jloss(x):
        return jnp.sum(jax.vmap(
            lambda y: jmesh.mesh_laplacian_smoothing(y, *jargs))(x) ** 2)

    want = jax.vmap(lambda y: jmesh.mesh_laplacian_smoothing(y, *jargs))(
        jnp.asarray(v))
    vt = torch.as_tensor(v).requires_grad_(True)
    got = tmesh.mesh_laplacian_smoothing(vt, *targs)
    _close(got, want)
    (got ** 2).sum().backward()
    gwant = np.asarray(jax.grad(jloss)(jnp.asarray(v)))
    np.testing.assert_allclose(vt.grad.numpy(), gwant, rtol=0,
                               atol=1e-6 * np.abs(gwant).max())
    # the padded table gives the same values
    _close(tmesh.mesh_laplacian_smoothing_padded(
        torch.as_tensor(v), ts.nbr_idx, ts.nbr_mask, ts.degree), want,
        rtol=1e-5)


def test_segment_neighbor_sum_backward_is_autograds(rng):
    """The directed edge lists hold both directions of every edge, so the
    neighbour sum is self-adjoint: its Function's backward (the same sum
    of the cotangent) equals autograd's through ``index_add_``."""
    _, (_, ts) = _sphere_scene()
    src, dst = ts.neighbor_src, ts.neighbor_dst
    pairs = sorted(zip(src.tolist(), dst.tolist()))
    assert pairs == sorted(zip(dst.tolist(), src.tolist()))
    x = torch.as_tensor(rng.normal(size=(2, int(ts.degree.shape[0]), 3))
                        .astype(np.float32))
    g = torch.as_tensor(rng.normal(size=x.shape).astype(np.float32))
    a, b = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    (tmesh._SegmentNeighborSum.apply(a, src, dst) * g).sum().backward()
    (tmesh._segment_sum(b, src, dst) * g).sum().backward()
    np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=0,
                               atol=1e-6 * float(b.grad.abs().max()))


def test_mesh_regularizers_match_jax(rng):
    verts, (js, ts) = _sphere_scene()
    v = verts + rng.normal(scale=0.1, size=verts.shape).astype(np.float32)
    kw = dict(meshedge_target=0.3)
    want = jlosses.mesh_regularizers(JConfig(**kw), js, jnp.asarray(v))
    got = tlosses.mesh_regularizers(FitConfig(**kw), ts, torch.as_tensor(v))
    assert len(got) == 3
    for g, w in zip(got, want):
        _close(g, w)


def test_fit_config_to_json_matches_jax():
    kw = dict(max_iter=123, resolution=(64, 48), cam_idxs=(0, 2),
              mode="free", lr_t=2e-3)
    text = FitConfig(**kw).to_json()
    assert text == JConfig(**kw).to_json()
    assert json.loads(text)["resolution"] == [64, 48]
    assert set(json.loads(text)) == {f.name for f in
                                     dataclasses.fields(FitConfig)}


# ---- utils/image.py (tests/test_tools_and_io.py:155-165) ----

def test_image_utils_match_jax(rng):
    img = rng.uniform(size=(8, 8, 1)).astype(np.float32)
    w = timage.whiten(img, 0.5, 0.25)
    np.testing.assert_allclose(w.numpy(), (img - 0.5) / 0.25, rtol=1e-6)
    _close(w, jimage.whiten(img, 0.5, 0.25))
    blurred = timage.gaussian_blur(torch.as_tensor(img), 5, 2.0)
    assert blurred.shape == img.shape
    assert blurred.std() < img.std()
    grid = timage.make_img(np.stack([img, img]), ncols=2)
    assert grid.shape == (8, 16, 1)

    x = rng.uniform(10, 200, size=(6, 7, 3)).astype(np.float32)
    for name, a in (("reduce_highlights", (60.0,)),
                    ("normalize_highlights", ()),
                    ("normalize_highlights", (0.8, 0.3)),
                    ("whiten", (50.0, 25.0)),
                    ("normalize_image", (10.0, 140.0))):
        _close(getattr(timage, name)(x, *a), getattr(jimage, name)(x, *a))
    for m, std in ((5, 1.5), (8, 128.0)):
        _close(timage.gaussian_1d(m, std), jimage.gaussian_1d(m, std))
        _close(timage.gaussian_kernel(m, std),
               jimage.gaussian_kernel(m, std))
    _close(timage.gaussian_kernel(7), jimage.gaussian_kernel(7))


@pytest.mark.parametrize("size,sigma", [(5, 2.0), (4, 1.0), (9, 3.0)])
def test_gaussian_blur_matches_jax(rng, size, sigma):
    """Odd and even kernels ("same" pads the extra tap after) on a
    non-square image; three channels blur each channel as JAX's blurs one
    (JAX's own raises for more than one: its depthwise convolution puts
    the channels on the batch axis)."""
    x = rng.uniform(size=(13, 10, 3)).astype(np.float32)
    got = timage.gaussian_blur(torch.as_tensor(x), size, sigma)
    want = np.concatenate([np.asarray(jimage.gaussian_blur(
        jnp.asarray(x[..., c:c + 1]), size, sigma)) for c in range(3)], -1)
    _close(got, want)
    _close(timage.gaussian_blur(torch.as_tensor(x[..., :1]), size, sigma),
           jimage.gaussian_blur(jnp.asarray(x[..., :1]), size, sigma))
    with pytest.raises(ValueError, match="feature_group_count"):
        jimage.gaussian_blur(jnp.asarray(x), size, sigma)


# ---- utils/debugging.py and utils/profiling.py ----

def test_assert_finite_names_the_leaf_as_jax_does():
    bad = np.ones((2, 3), np.float32)
    bad[1, 2] = np.nan
    bad[0, 0] = np.inf
    ok = np.zeros(4, np.float32)
    for tree in ({"b": [ok, (ok, bad)], "a": ok}, [ok, {"x": bad}], bad):
        with pytest.raises(FloatingPointError) as want:
            jdebug.assert_finite(jax.tree.map(jnp.asarray, tree), "p")
        ttree = jax.tree.map(torch.as_tensor, tree)
        with pytest.raises(FloatingPointError) as got:
            tdebug.assert_finite(ttree, "p")
        assert str(got.value) == str(want.value)
    tdebug.assert_finite({"a": torch.zeros(3), "b": [torch.ones(2)]})
    x = np.array([1.0, np.nan, -np.inf, 2.0], np.float32)
    assert tdebug.finite_or_zero(torch.as_tensor(x)).equal(torch.as_tensor(
        np.asarray(jdebug.finite_or_zero(jnp.asarray(x)))))


def test_nan_checks_raise_at_a_nan_backward():
    x = torch.tensor([0.0, 1.0], requires_grad=True)
    with tdebug.nan_checks():
        y = torch.sqrt(x * 0.0 - 1.0).sum()       # NaN forward and backward
        with pytest.raises(RuntimeError, match="nan"):
            y.backward()
    assert not torch.is_anomaly_enabled()
    torch.sqrt(x * 0.0 - 1.0).sum().backward()    # outside: no check
    assert torch.isnan(x.grad).all()


def test_sync_and_time_fn_match_jax(rng):
    tree = {"a": rng.normal(size=(4, 5)).astype(np.float32),
            "b": [rng.normal(size=3).astype(np.float32), 7]}
    want = jprof.sync(jax.tree.map(jnp.asarray, tree))
    ttree = jax.tree.map(torch.as_tensor, tree)
    np.testing.assert_allclose(tprof.sync(ttree), want, rtol=1e-6)
    assert tprof.sync({"a": ttree["a"], "b": [ttree["b"][0], 7]}) < want
    assert tprof.sync([1, "x"]) == jprof.sync([1, "x"]) == 0.0
    calls = []

    def fn(a):
        calls.append(a)
        return {"y": a * 2}

    dt, r = tprof.time_fn(fn, torch.ones(3), iters=3, warmup=2)
    assert len(calls) == 5 and dt >= 0 and r["y"].equal(torch.full((3,), 2.))


def test_trace_annotate_and_memory_stats(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with tprof.trace(str(tmp_path / "prof")):
        with tprof.annotate("region_under_test"):
            torch.ones(64).sum()
    with open(tmp_path / "prof" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "region_under_test" for e in events)
    assert tprof.device_memory_stats() == {"cpu": None}


# ---- data/frames.py save_tiff ----

def test_save_tiff_reads_back_through_both_packages(rng, tmp_path):
    img = rng.integers(0, 256, size=(2, 3, 11, 7), dtype=np.uint8)
    cams = ["take_a", "take_b"]
    for c, cam in enumerate(cams):
        os.makedirs(tmp_path / cam)
        for f in range(3):
            path = str(tmp_path / cam / f"{cam}_{f:02d}.tif")
            tframes.save_tiff(path, img[c, f])
            assert tframes.load_tiff(path).tobytes() == img[c, f].tobytes()
    want = jframes.load_take(str(tmp_path), cams)
    np.testing.assert_array_equal(want, np.clip(img, 0, 140)[:, :, ::-1])
    np.testing.assert_array_equal(tframes.load_take(str(tmp_path), cams),
                                  want)
