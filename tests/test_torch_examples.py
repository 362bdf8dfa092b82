"""The fit examples and their synthetic rig against the JAX package's, on
the CPU.

* ``examples.rig.head_mesh`` equals the JAX example's exactly; the
  synthetic calibration loads alike through both packages (1e-6 of the
  largest entry) and puts every camera on the arc, looking at the head.
* The ground-truth take: ``render_sample`` of the rig scene (prior mode,
  64^2, cameras 0, 4 and 8 of the nine, both frames) against JAX's scan
  route with every pixel pair antialiased; the vertices within 1e-5.
  With the cameras at a depth range that resolves the head, [50, 250]:
  the port's scan route within 1e-5 (``test_render_sample_matches_jax``'s
  limit; measured 5.4e-6), its kernel route within 2e-4 on >= 99.5 % of
  values (measured 99.99 %) and at most 1 apart in uint8 on >= 99.9 % of
  pixels (99.99 %). At the rig's own range [0.01, 200] the head's z_ndc
  spans only 1.6e-5 (~270 float32 steps below 1), so adjacent triangles
  tie in depth and the antialias's occluder follows the rounding of the
  clip positions. Witness: each route agrees with JAX's as well as with
  itself when the ground truth's pose moves by NUDGE (1e-5, ~1e-6 of the
  head), to within 1 % of pixels, in uint8 at most 1 apart (the scan
  route 99.39 % against JAX, 99.44 % against itself nudged; the kernel
  route 92.1 % and 92.3 %). Held too: the scan route within 1e-5 on
  >= 97 % of values (98.0 %) and uint8 on >= 99 % (99.39 %); the kernel
  route's uint8 on >= 90 % (92.1 %) and K1's ids against JAX's
  visibility scan on >= 92 % of covered pixels (93.9 %).
* The kernel route's gradients differ from the scan route's only where
  the occluder does: from the first step's state at [50, 250], with the
  residual against JAX's frames as the cotangent, the texture gradient
  2.6-6.0e-2 and ``per_frame_t``'s up to 1.1e-2 apart in relative L2
  (limits 0.1 and 2e-2); with the 3-27 pixels (<= 1 %) where the two
  images differ by more than 1e-6 given no cotangent, both within 5e-4
  (measured <= 1.3e-4).
* Five ``train_step``s on fixed (camera, frame) batches with the
  convergence study's config (batch 8) at [50, 250], from JAX's frames.
  The first step's raw gradients against ``jax.grad(loss_fn)`` in
  relative L2: the scan route 1e-4 (``test_scan_step_gradients_match_
  jax``'s limit; measured <= 3.5e-5); the kernel route 1e-2 (pose,
  camera and maps: measured <= 6.2e-3) and 0.1 for the texture (4.6e-2:
  the occluder flips above; ``test_step_gradients_match_jax``'s limit
  where they occur). Then the loss at every step, and ``per_frame_t``,
  ``tex`` and ``maps_intermediate`` at the end. Not within
  ``test_optimizer_matches_optax``'s 2e-5 of the largest value: Adam
  maps a gradient of any size to a step of ~lr, so a gradient that
  differs by rounding on an element near zero moves it by up to 2 lr a
  step. Held instead: each parameter's update (end minus start) in
  relative L2, and the loss relatively. The port's kernel route (the
  study's own) against JAX's scan: loss 2e-3 (measured <= 8.6e-4),
  ``per_frame_t`` 3e-3 (7.3e-4), ``tex`` and ``maps_intermediate`` 6e-2
  (1.9e-2, 2.0e-2); the port's scan route: loss 1e-4 (2.1e-5),
  ``per_frame_t`` 2e-4 (3.9e-5), ``tex`` 4e-3 (8.2e-4),
  ``maps_intermediate`` 1e-2 (3.3e-3).
* Each example's ``main`` at a tiny size on the CPU finishes, and the
  files it writes parse; without ``--cpu`` and without a card each
  raises.
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import chip_smoke
from fpc_diffrend_tpu.data import obj as jobj
from fpc_diffrend_tpu.fit import loop as jloop
from fpc_diffrend_tpu.fit import scene as jscene
from fpc_diffrend_tpu.fit import state as jstate
from fpc_diffrend_tpu.fit.config import FitConfig as JConfig
from fpc_diffrend_tpu.models import camera as jcamera
from fpc_diffrend_tpu.ops.rasterize import visibility_scan
from fpc_diffrend_tpu_torch.data import frames as tframes
from fpc_diffrend_tpu_torch.examples import convergence_study, fit_cube
from fpc_diffrend_tpu_torch.examples import fit_rig_synthetic, rig
from fpc_diffrend_tpu_torch.fit import loop as tloop
from fpc_diffrend_tpu_torch.fit import scene as tscene
from fpc_diffrend_tpu_torch.fit import state as tstate
from fpc_diffrend_tpu_torch.ops.cuda import rasterize_cuda as trc
from fpc_diffrend_tpu_torch.ops.rasterize import bin_stacked
from fpc_diffrend_tpu_torch.utils.image import load_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES, CAMS, FRAMES = 64, (0, 4, 8), 2
RESOLVED = (50.0, 250.0)       # a depth range that resolves the head
NUDGE = 1e-5                   # a pose nudge, ~1e-6 of the head's size


def _jax_example():
    path = os.path.join(REPO, "examples", "fit_rig_synthetic.py")
    spec = importlib.util.spec_from_file_location("jax_fit_rig_example",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_head_mesh_equals_jax():
    want = _jax_example().head_mesh()
    got = rig.head_mesh()
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[2].shape == (3072, 3)


def test_synthetic_calibration_loads_alike(tmp_path):
    path = str(tmp_path / "calibration.json")
    names = rig.write_synthetic_calibration(path)
    assert names == [f"cam{i}" for i in range(9)]
    assert rig.camera_names(path, 3) == names[:3]
    got = tscene.load_calibration(path, names)
    want = jscene.load_calibration(path, names)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-6 * np.abs(w).max())
    with open(path) as f:
        calib = json.load(f)
    centre = np.array([0.0, rig.HEAD_Y, 0.0])
    for name in names:
        c = calib[name]
        rot = np.asarray(c["rotation"])
        t = np.asarray(c["translation"])[:, 0]
        np.testing.assert_allclose(rot @ rot.T, np.eye(3), atol=1e-12)
        assert np.asarray(c["intrinsic"]).shape == (3, 3)
        assert np.asarray(c["distortion"]).shape == (1, 5)
        # the camera centre on the arc, on the face's side, looking at it
        pos = -rot.T @ t
        np.testing.assert_allclose(np.linalg.norm(pos - centre),
                                   rig.DISTANCE)
        assert pos[2] < 0
        np.testing.assert_allclose(rot @ (centre - pos),
                                   [0.0, 0.0, rig.DISTANCE], atol=1e-9)


def _projection(path, names, near_far):
    with open(path) as f:
        calib = json.load(f)
    return np.stack([np.asarray(jcamera.intrinsic_to_projection(
        np.asarray(calib[n]["intrinsic"], np.float32), *near_far))
        for n in names])


@pytest.fixture(scope="module")
def rig_scenes(tmp_path_factory):
    """The study's scene at 64^2 through cameras 0, 4 and 8 (the same
    numpy arrays into both packages), at the rig's depth range and at
    RESOLVED; the ground truth of each, rendered by JAX."""
    path = str(tmp_path_factory.mktemp("rig") / "calibration.json")
    names = [rig.write_synthetic_calibration(path)[i] for i in CAMS]
    rng = np.random.default_rng(0)
    verts, uvs, faces = rig.head_mesh()
    mesh = jobj.MeshData(vertices=verts.reshape(-1), uv=uvs, faces=faces,
                         fuv=faces)
    deltas = rig.blendshape_deltas(verts, rng)
    deltas = np.ascontiguousarray(deltas.reshape(len(deltas), -1).T)
    gt_t = rng.normal(scale=0.4, size=(FRAMES, 3)).astype(np.float32)
    tex = fit_rig_synthetic.ground_truth_texture()
    args = convergence_study.parse_args(["--cpu", "--res", str(RES),
                                         "--frames", str(FRAMES)])
    tcfg = dataclasses.replace(
        convergence_study.make_config(args, 8, len(CAMS)), aa_max_pairs=-1)
    jcfg = JConfig(**{f.name: getattr(tcfg, f.name)
                      for f in dataclasses.fields(JConfig)})
    jcfg = dataclasses.replace(jcfg, raster_impl="scan")
    proj, mv = jscene.load_calibration(path, names)
    render = jax.jit(jloop.render_sample, static_argnums=0)
    out = {}
    for label, p in (("rig", proj),
                     ("resolved", _projection(path, names, RESOLVED))):
        js = jscene.build_scene(mesh, p, mv, jnp.asarray(deltas))
        ts = tscene.build_scene(mesh, p, mv, deltas, device="cpu")
        jgt = jstate.init_params(jcfg, FRAMES, js.v_base.shape[0],
                                 rig.N_BLENDSHAPES, tex, len(CAMS))
        jgt["per_frame_t"] = jnp.asarray(gt_t)
        tgt = tstate.init_params(tcfg, FRAMES, ts.v_base.shape[0],
                                 rig.N_BLENDSHAPES, tex, len(CAMS),
                                 device="cpu")
        tgt["per_frame_t"] = torch.tensor(gt_t)
        jimgs = np.stack([np.stack([np.asarray(render(
            jcfg, js, jgt, jnp.int32(c), jnp.int32(f))[0])
            for f in range(FRAMES)]) for c in range(len(CAMS))])
        out[label] = dict(js=js, ts=ts, jgt=jgt, tgt=tgt, jimgs=jimgs)
    return dict(out, tcfg=tcfg, jcfg=jcfg, tex=tex, names=names,
                render=render)


def _u8(img):
    return np.clip(np.rint(img * 255), 0, 139).astype(np.uint8)


def _render_take(cfg, r, params):
    """(cams, FRAMES, RES, RES, 1) images of ``render_sample``."""
    with torch.no_grad():
        return np.stack([np.stack([tloop.render_sample(
            cfg, r["ts"], params, c, f)[0].numpy() for f in range(FRAMES)])
            for c in range(len(CAMS))])


def _same_u8(a, b) -> float:
    """The share of pixels whose uint8 values are at most 1 apart."""
    return float((np.abs(_u8(a).astype(int) - _u8(b)) <= 1).mean())


def _nudged_same_u8(cfg, r, imgs) -> float:
    """The route's agreement with itself (``_same_u8``) when the ground
    truth's ``per_frame_t`` moves by +-NUDGE, the least of the two."""
    t = r["tgt"]["per_frame_t"]
    return min(_same_u8(imgs, _render_take(
        cfg, r, dict(r["tgt"], per_frame_t=t + eps)))
        for eps in (NUDGE, -NUDGE))


def test_ground_truth_take_matches_jax(rig_scenes):
    tcfg, jcfg = rig_scenes["tcfg"], rig_scenes["jcfg"]
    for label in ("rig", "resolved"):
        r = rig_scenes[label]
        for c in range(len(CAMS)):
            for f in range(FRAMES):
                with torch.no_grad():
                    _, v = tloop.render_sample(tcfg, r["ts"], r["tgt"], c, f)
                _, jv = rig_scenes["render"](jcfg, r["js"], r["jgt"],
                                             jnp.int32(c), jnp.int32(f))
                np.testing.assert_allclose(v.numpy(), np.asarray(jv),
                                           rtol=0, atol=1e-5)
        timgs = _render_take(tcfg, r, r["tgt"])
        want = r["jimgs"]
        assert (want != 45.0 / 255.0).mean() > 0.2       # the head in view
        same_u8 = _same_u8(timgs, want)
        if label == "resolved":
            assert np.isclose(timgs, want, atol=2e-4).mean() >= 0.995
            assert same_u8 >= 0.999, same_u8
            frames = _u8(timgs[..., 0])[:, :, ::-1]
            cov = rig.check_coverage(frames, rig_scenes["names"])
            assert all(0.1 < x < 0.6 for x in cov), cov
            continue
        # at the rig's range the route agrees with JAX's scan as well as
        # it agrees with itself under a 1e-5 nudge of the pose
        assert same_u8 >= 0.9, same_u8
        assert same_u8 >= _nudged_same_u8(tcfg, r, timgs) - 0.01, same_u8
        # the winners: K1's plain version against JAX's visibility scan
        cams = torch.tensor(range(len(CAMS)))
        with torch.no_grad():
            pc, _ = tloop.sample_clip_positions(
                tcfg, r["ts"], r["tgt"], cams, torch.zeros_like(cams))
            _, _, bins = bin_stacked(pc, r["ts"].faces, r["ts"].uv,
                                     r["ts"].uv_idx, r["ts"].face_neighbors,
                                     (RES, RES))
            ph, pw = trc.pad_resolution(RES, RES)
            ids = trc.fused_raster(bins, r["tgt"]["tex"], len(CAMS) * ph,
                                   pw)[0].numpy()
        agree = covered = 0
        for c in range(len(CAMS)):
            jpc, _ = jloop.sample_clip_positions(jcfg, r["js"], r["jgt"],
                                                 jnp.int32(c), jnp.int32(0))
            want_ids = np.asarray(visibility_scan(jpc, r["js"].faces, RES,
                                                  RES))
            got_ids = ids[c * ph:c * ph + RES, :RES]
            hit = (want_ids >= 0) | (got_ids >= 0)
            covered += int(hit.sum())
            agree += int((got_ids == want_ids)[hit].sum())
        assert agree >= 0.92 * covered, (agree, covered)


@pytest.mark.parametrize("label", ["rig", "resolved"])
def test_ground_truth_take_scan_route_matches_jax(rig_scenes, label):
    r = rig_scenes[label]
    tcfg = dataclasses.replace(rig_scenes["tcfg"], raster_impl="scan")
    timgs = _render_take(tcfg, r, r["tgt"])
    if label == "resolved":
        np.testing.assert_allclose(timgs, r["jimgs"], rtol=0, atol=1e-5)
        return
    close = float(np.isclose(timgs, r["jimgs"], rtol=0, atol=1e-5).mean())
    same_u8 = _same_u8(timgs, r["jimgs"])
    assert close >= 0.97 and same_u8 >= 0.99, (close, same_u8)
    assert same_u8 >= _nudged_same_u8(tcfg, r, timgs) - 0.01, same_u8


def test_kernel_route_gradients_differ_where_the_occluder_does(rig_scenes):
    """From the first step's state (the identity pose; the cotangent the
    residual against JAX's frames, as the L2 loss's), at RESOLVED: the
    kernel route's texture and pose gradients against the scan route's,
    in relative L2, on every pixel and with the pixels where the two
    images differ (by > 1e-6) given no cotangent."""
    r = rig_scenes["resolved"]
    init = dict(r["tgt"], per_frame_t=torch.zeros_like(
        r["tgt"]["per_frame_t"]))
    for c, f in ((0, 0), (1, 1), (2, 0)):
        imgs, grads = {}, {}
        for impl in ("scan", "auto"):
            cfg = dataclasses.replace(rig_scenes["tcfg"], raster_impl=impl)
            p = {k: init[k].clone().requires_grad_(True)
                 for k in ("tex", "per_frame_t")}
            imgs[impl] = tloop.render_sample(cfg, r["ts"], dict(init, **p),
                                             c, f)[0]
            grads[impl] = p
        ref = torch.as_tensor(_u8(r["jimgs"][c, f]) / np.float32(255.0))
        resid = imgs["scan"].detach() - ref
        flips = ((imgs["scan"] - imgs["auto"]).abs() > 1e-6).detach()
        assert int(flips.sum()) <= 0.01 * flips.numel()
        for masked in (False, True):
            g = torch.where(flips, 0.0, resid) if masked else resid
            err = {}
            for k in ("tex", "per_frame_t"):
                got, want = (torch.autograd.grad(
                    (imgs[i] * g).sum(), grads[i][k], retain_graph=True)[0]
                    for i in ("auto", "scan"))
                err[k] = float((got - want).norm() / want.norm())
            if masked:
                assert max(err.values()) < 5e-4, err
            else:
                assert err["tex"] < 0.1 and err["per_frame_t"] < 0.02, err


def _fixed_batches():
    rng = np.random.default_rng(1)
    return [(rng.integers(0, len(CAMS), 8), rng.integers(0, FRAMES, 8))
            for _ in range(5)]


@pytest.fixture(scope="module")
def jax_steps(rig_scenes):
    """JAX's five steps from the identity init on its own frames."""
    r, jcfg = rig_scenes["resolved"], rig_scenes["jcfg"]
    frames = jnp.asarray(_u8(r["jimgs"][..., 0]))
    p0 = {k: np.array(v) for k, v in jstate.init_params(
        jcfg, FRAMES, r["js"].v_base.shape[0], rig.N_BLENDSHAPES,
        rig_scenes["tex"], len(CAMS)).items()}
    # train_step donates its state: it takes copies
    st = jstate.init_state(jcfg, {k: jnp.array(v) for k, v in p0.items()})
    losses, grad0 = [], None
    for cam, frame in _fixed_batches():
        cam, frame = jnp.asarray(cam, jnp.int32), jnp.asarray(frame,
                                                             jnp.int32)
        batch = jloop.Batch(cam, frame, jloop.decode_refs(frames, cam, frame))
        if grad0 is None:
            grad0 = jax.jit(jax.grad(jloop.loss_fn, has_aux=True),
                            static_argnums=1)(
                {k: jnp.asarray(v) for k, v in p0.items()}, jcfg, r["js"],
                batch, jnp.int32(0))[0]
        st, m = jloop.train_step(jcfg, r["js"], st, batch)
        losses.append(float(m["loss"]))
    return (p0, {k: np.asarray(v) for k, v in st.params.items()}, losses,
            {k: np.asarray(v) for k, v in grad0.items()})


@pytest.mark.parametrize("impl,limits", [
    ("auto", dict(grad=1e-2, grad_tex=0.1, loss=2e-3, per_frame_t=3e-3,
                  tex=6e-2, maps_intermediate=6e-2)),
    ("scan", dict(grad=1e-4, grad_tex=1e-4, loss=1e-4, per_frame_t=2e-4,
                  tex=4e-3, maps_intermediate=1e-2))])
def test_five_steps_match_jax(rig_scenes, jax_steps, impl, limits):
    r = rig_scenes["resolved"]
    tcfg = dataclasses.replace(rig_scenes["tcfg"], raster_impl=impl)
    p0, want, jlosses, jgrad = jax_steps
    frames = torch.as_tensor(_u8(r["jimgs"][..., 0]))
    st = tstate.init_state(tcfg, tstate.params_from_numpy(p0, "cpu"))
    losses = []
    for cam, frame in _fixed_batches():
        cam, frame = torch.as_tensor(cam), torch.as_tensor(frame)
        batch = tloop.Batch(cam, frame, tloop.decode_refs(frames, cam, frame))
        if not losses:        # the first step's raw gradients
            params = {k: v.clone().requires_grad_(True)
                      for k, v in st.params.items()}
            tloop.loss_fn(params, tcfg, r["ts"], batch)[0].backward()
            for k, w in jgrad.items():
                got = (np.zeros_like(w) if params[k].grad is None
                       else params[k].grad.numpy())
                if not np.linalg.norm(w):
                    assert not got.any(), k
                    continue
                err = np.linalg.norm(got - w) / np.linalg.norm(w)
                bound = limits["grad_tex"] if k == "tex" else limits["grad"]
                assert err < bound, (
                    f"{k}: relative L2 of the first gradient {err:.3g}")
            assert np.linalg.norm(jgrad["per_frame_t"]) > 0
        losses.append(float(tloop.train_step(tcfg, r["ts"], st,
                                             batch)["loss"]))
    assert st.step == 5
    np.testing.assert_allclose(losses, jlosses, rtol=limits["loss"])
    for k in ("per_frame_t", "tex", "maps_intermediate"):
        moved = want[k] - p0[k]
        got = st.params[k].detach().numpy() - p0[k]
        err = np.linalg.norm(got - moved) / np.linalg.norm(moved)
        assert err < limits[k], f"{k}: relative L2 of the update {err:.3g}"


def test_fit_cube_main_on_cpu(tmp_path):
    preview = str(tmp_path / "preview.png")
    out = fit_cube.run(fit_cube.parse_args(
        ["--cpu", "--res", "32", "--steps", "4", "--save-preview",
         preview]))
    assert len(out["losses"]) == 4 and np.isfinite(out["losses"]).all()
    assert isinstance(out["ok"], bool) and out["renders"] == 4
    assert load_image(preview).shape == (32, 32, 1)
    # the module runs as a script
    r = subprocess.run([sys.executable, "-m",
                        "fpc_diffrend_tpu_torch.examples.fit_cube", "--cpu",
                        "--res", "16", "--steps", "2"], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode in (0, 1) and "CONVERGE" in r.stdout, r.stderr


def test_fit_rig_synthetic_main_on_cpu(tmp_path):
    work = str(tmp_path / "rig")
    args = fit_rig_synthetic.parse_args(
        ["--cpu", "--res", "32", "--steps", "2", "--cams", "2", "--frames",
         "2", "--batch", "2", "--workdir", work])
    out = fit_rig_synthetic.run(args)
    cfg = out["config"]
    assert out["state"].step == 2 and out["renders"] == 4
    assert len(out["coverage"]) == 2 and isinstance(out["ok"], bool)
    cams = sorted(os.listdir(cfg.imdir))
    assert cams == ["take_cam0", "take_cam1"]
    take = tframes.load_take(cfg.imdir, cams)
    assert take.shape == (2, 2, 32, 32) and take.max() <= 139
    chip_smoke.check_fit_outputs(cfg, 1584, 3072, 2, "fit_rig_synthetic")
    assert out["results"] == ["0.obj", "1.obj", "pose.json", "texture.png"]
    assert load_image(cfg.texpath).shape == (256, 256, 1)


def test_convergence_study_main_on_cpu(tmp_path):
    out_dir = str(tmp_path / "study")
    out = convergence_study.run(convergence_study.parse_args(
        ["--cpu", "--res", "32", "--steps", "3", "--cams", "2", "--frames",
         "2", "--out", out_dir]))
    with open(os.path.join(REPO, "results", "convergence_512",
                           "convergence.json")) as f:
        ref = json.load(f)
    with open(os.path.join(out_dir, "convergence.json")) as f:
        got = json.load(f)
    assert got.keys() == ref.keys()
    for k in ("batch8", "batch1"):
        assert got[k].keys() == ref[k].keys()
        assert [set(p) for p in got[k]["curve"]] == [set(ref[k]["curve"][0])]
        assert np.isfinite(got[k]["final_loss"])
    assert got["meta"].keys() == ref["meta"].keys()
    assert got["meta"]["cams"] == 2 and isinstance(out["ok"], bool)
    with open(os.path.join(out_dir, "convergence.md")) as f:
        md = f.read().splitlines()
    with open(os.path.join(REPO, "results", "convergence_512",
                           "convergence.md")) as f:
        ref_md = f.read().splitlines()
    assert [ln[:12] for ln in md[1:]] == [ln[:12] for ln in ref_md[1:]]


@pytest.mark.parametrize("module", [fit_cube, fit_rig_synthetic,
                                    convergence_study])
def test_examples_raise_without_cuda(monkeypatch, tmp_path, module):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--workdir", str(tmp_path)] if module is fit_rig_synthetic \
        else ["--out", str(tmp_path)] if module is convergence_study else []
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.main(argv)
    assert not os.listdir(tmp_path)


def test_chip_drift_runs_are_bit_equal_on_cpu(tmp_path):
    """``chip_drift.py`` on the CPU (the plain versions, no atomics): two
    runs of the study at [50, 250] from one seed are bit-equal."""
    import chip_drift

    out = str(tmp_path / "drift.json")
    assert chip_drift.main(["--cpu", "--res", "32", "--steps", "2",
                            "--runs", "2", "--cams", "2", "--frames", "2",
                            "--batches", "1", "--ranges", "50-250",
                            "--out", out]) == 0
    with open(out) as f:
        cell, = json.load(f)["cells"]
    assert cell["depth_range"] == "50-250" and cell["batch"] == 1
    assert len(cell["final_pose_err"]) == 2
    assert cell["first_parted_step"] is None
    assert not any(cell["spread"].values()), cell["spread"]
