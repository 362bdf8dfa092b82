"""The port's camera, pose and blend models against the JAX package.

Tolerance: atol 1e-5 on unit-scale values. Both sides compute in float32;
matrix products may sum in another order (XLA's dot against PyTorch's
matmul), which moves results by a few ulp.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from fpc_diffrend_tpu.fit import loop as jloop
from fpc_diffrend_tpu.models import blendshape as jblend
from fpc_diffrend_tpu.models import camera as jcam
from fpc_diffrend_tpu.models import pose as jpose
from fpc_diffrend_tpu_torch.fit import loop as tloop
from fpc_diffrend_tpu_torch.models import blendshape as tblend
from fpc_diffrend_tpu_torch.models import camera as tcam
from fpc_diffrend_tpu_torch.models import pose as tpose

ATOL = 1e-5


def _t(x):
    return torch.as_tensor(np.asarray(x))


def test_camera_matrices_match(rng):
    intr = np.array([[7000.0, 0, 610.0], [0, 6990.0, 795.0], [0, 0, 1]],
                    np.float32)
    np.testing.assert_allclose(
        tcam.intrinsic_to_projection(intr).numpy(),
        np.asarray(jcam.intrinsic_to_projection(intr)), atol=ATOL)
    rot = jcam.rotate_y(0.4)[:3, :3] @ jcam.rotate_x(-0.2)[:3, :3]
    t = rng.normal(size=(3,)).astype(np.float32)
    np.testing.assert_allclose(
        tcam.extrinsic_to_modelview(rot, t).numpy(),
        np.asarray(jcam.extrinsic_to_modelview(rot, t)), atol=ATOL)
    for name in ("default_projection", "default_modelview"):
        np.testing.assert_array_equal(getattr(tcam, name)(),
                                      getattr(jcam, name)())
    np.testing.assert_array_equal(tcam.rotate_y(0.3), jcam.rotate_y(0.3))
    np.testing.assert_array_equal(tcam.rotate_x(0.3), jcam.rotate_x(0.3))
    np.testing.assert_array_equal(tcam.translate(1, 2, 3),
                                  jcam.translate(1, 2, 3))


def test_transform_clip_batched(rng):
    mvp = rng.normal(size=(3, 4, 4)).astype(np.float32)
    pos = rng.normal(size=(3, 20, 3)).astype(np.float32)
    out = tcam.transform_clip(_t(mvp), _t(pos)).numpy()
    for b in range(3):
        np.testing.assert_allclose(
            out[b], np.asarray(jcam.transform_clip(mvp[b], pos[b])),
            atol=ATOL)


def test_pose_matches(rng):
    q = rng.normal(size=(5, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = rng.normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_allclose(tpose.quat_to_rotmat(_t(q)).numpy(),
                               np.asarray(jpose.quat_to_rotmat(q)),
                               atol=ATOL)
    got = tpose.rigid_from_pose(_t(t), _t(q)).numpy()
    for i in range(5):
        np.testing.assert_allclose(
            got[i], np.asarray(jpose.rigid_from_pose(t[i], q[i])), atol=ATOL)


def _blend_params(rng, V=12, F=5, Bs=4):
    p = {"m1": rng.normal(size=(F, F)), "m2": rng.normal(size=(F, F)),
         "m3": 0.1 * rng.normal(size=(3 * V, F)),
         "maps": rng.normal(size=(F, F)),
         "maps_intermediate": rng.normal(size=(Bs, F)),
         "deltas": 0.1 * rng.normal(size=(3 * V, Bs))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    v_base = rng.normal(size=(3 * V,)).astype(np.float32)
    return p, v_base


@pytest.mark.parametrize("mode", ["prior", "free", "combined"])
def test_blend_modes_match(rng, mode):
    p, v_base = _blend_params(rng)
    frames = np.array([0, 3, 1, 4], np.int32)
    want = np.stack([np.asarray(jblend.blend(
        mode, {k: jnp.asarray(v) for k, v in p.items()}, v_base, int(f),
        0.7)) for f in frames])
    got = tblend.blend(mode, {k: _t(v) for k, v in p.items()}, _t(v_base),
                       torch.as_tensor(frames.astype(np.int64)), 0.7)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_setup_dataset_free_matches():
    for a, b in zip(tblend.setup_dataset_free(4, 30),
                    jblend.setup_dataset_free(4, 30)):
        np.testing.assert_array_equal(a, b)


def test_build_mvp_and_clip_positions_match(rng):
    """The prologue: blend, pose and clip for a batch of samples."""
    from fpc_diffrend_tpu.fit.config import FitConfig as JConfig
    from fpc_diffrend_tpu_torch.fit.config import FitConfig as TConfig

    V, F, C = 12, 5, 3
    p, v_base = _blend_params(rng, V=V, F=F)
    q = rng.normal(size=(C + F, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    p.update(t_opt=rng.normal(size=(C, 3)).astype(np.float32),
             q_opt=q[:C], per_frame_t=rng.normal(size=(F, 3)).astype(
                 np.float32), per_frame_q=q[C:])
    proj = np.stack([np.asarray(jcam.intrinsic_to_projection(
        [[70.0, 0, 64.0], [0, 50.0, 48.0], [0, 0, 1]]))] * C)
    mv = np.stack([jcam.rotate_y(0.2 * c) @ jcam.translate(0, 0, -2)
                   for c in range(C)]).astype(np.float32)
    cam = np.array([0, 2, 1], np.int32)
    frame = np.array([4, 0, 2], np.int32)

    # the scene fields the prologue reads
    js = SimpleNamespace(proj=jnp.asarray(proj), mv=jnp.asarray(mv),
                         deltas=jnp.asarray(p["deltas"]),
                         v_base=jnp.asarray(v_base))
    jp = {k: jnp.asarray(v) for k, v in p.items() if k != "deltas"}
    ts = SimpleNamespace(proj=_t(proj), mv=_t(mv), deltas=_t(p["deltas"]),
                         v_base=_t(v_base))
    tp = {k: _t(v) for k, v in p.items() if k != "deltas"}
    for mode in ("prior", "free", "combined"):
        jcfg = JConfig(mode=mode, combined_corrective_coefficient=0.5)
        tcfg = TConfig(mode=mode, combined_corrective_coefficient=0.5)
        tc = torch.as_tensor(cam.astype(np.int64))
        tf = torch.as_tensor(frame.astype(np.int64))
        mvp_t = tloop.build_mvp(ts, tp, tc, tf).numpy()
        clip_t, v3_t = tloop.sample_clip_positions(tcfg, ts, tp, tc, tf)
        for b in range(3):
            np.testing.assert_allclose(
                mvp_t[b], np.asarray(jloop.build_mvp(js, jp, cam[b],
                                                     frame[b])), atol=ATOL)
            clip_j, v3_j = jloop.sample_clip_positions(jcfg, js, jp, cam[b],
                                                       frame[b])
            np.testing.assert_allclose(v3_t[b].numpy(), np.asarray(v3_j),
                                       atol=ATOL)
            np.testing.assert_allclose(clip_t[b].numpy(), np.asarray(clip_j),
                                       atol=ATOL)


# ------------------------------------------------------- signatures ----

# The port's deliberate differences from the JAX package's public
# signatures (ROADMAP.md §3), keyed by JAX's "module.name" (a function
# the port renamed is keyed by its JAX name, test_torch_surface.SURFACE).
# RENAMED: JAX parameter name -> torch name. DROPPED: JAX parameters the
# port has no counterpart of (TPU switches). ADDED: the port's own
# parameters, after JAX's.
RENAMED = {
    "fit.loop.sample_batches": {"rng": "generator"},
    "fit.loop.train_steps": {"rng_key": "generator"},
    "fit.state.TrainState": {"opt_state": "optimizer"},
    "fit.state.apply_corrective_gate": {"grads": "params"},
    # a process group in place of a mesh axis name, a device type in
    # place of a device list
    "parallel.mesh.make_mesh": {"devices": "device_type"},
    "parallel.spatial.render_band": {"axis_name": "group"},
}
DROPPED = {
    "ops.pipeline.render_from_clip": ("inc",),
    "ops.pipeline.render_batch_stacked": ("inc", "interpret"),
    "ops.rasterize.rasterize": ("interpret",),
    "ops.rasterize.rasterize_with_uv": ("interpret",),
    "ops.rasterize.rasterize_pallas_textured_sepaa_stacked": ("interpret",
                                                              "inc"),
}
ADDED = {
    "fit.api.fit_take": ("device",),
    "fit.api.load_texture": ("seed",),
    "fit.api.setup_from_config": ("device",),
    "fit.scene.build_scene": ("device",),
    "fit.state.init_params": ("device",),
    # the CUDA graph of the step that fit.loop.train_steps replays
    "fit.state.TrainState": ("graph",),
    "fit.state.make_optimizer": ("params",),
    "models.camera.extrinsic_to_modelview": ("device",),
    "models.camera.intrinsic_to_projection": ("device",),
    "ops.pipeline.render": ("route", "device"),
    "ops.pipeline.render_from_clip": ("route",),
    "ops.pipeline.render_batch_stacked": ("enable_mip", "max_mip_level"),
    # edge_rows: the band render's seam rows (parallel.spatial)
    "ops.rasterize.rasterize_pallas_textured_sepaa_stacked": (
        "enable_mip", "max_mip_level", "route", "edge_rows"),
    "parallel.multihost.initialize": ("backend",),
    "parallel.multihost.make_pod_mesh": ("device_type",),
    "parallel.spatial.band_window_matrix": ("device",),
    "parallel.spatial.render_band": ("device",),
    "tools.undistort.undistort_map": ("device",),
    "tools.undistort.undistort_image_jax": ("device",),
    "tools.undistort.undistort_take": ("device",),
    "tools.render_result.render_result": ("route", "device"),
    "tools.simple_render.simple_render": ("route", "device"),
}
# defaults that differ: Scene requires the padded neighbour table; the
# port's loss_fn starts at step 0 unless told
DEFAULTS = {"fit.scene.Scene": {"nbr_idx", "nbr_mask"},
            "fit.loop.loss_fn": {"step"}}
# private helpers that are part of the ported primitives' surface
PRIVATE = ("ops.rasterize._tri_screen", "ops.rasterize._pixel_db_from_data",
           "ops.antialias._pair_blend", "ops.antialias._antialias_compact",
           "ops.pipeline._bary_db_to_uv_da")


def _shared_callables():
    """{"module.name": (torch object, JAX object)} for every public
    callable a port module defines that the JAX module of the same name
    has, the PRIVATE ones, and the renamed pairs of
    ``test_torch_surface.SURFACE`` under their JAX names."""
    import importlib
    import inspect
    import pkgutil

    import fpc_diffrend_tpu_torch
    from test_torch_surface import SURFACE

    out = {}
    for info in pkgutil.walk_packages(fpc_diffrend_tpu_torch.__path__,
                                      "fpc_diffrend_tpu_torch."):
        name = info.name.split(".", 1)[1]
        try:
            jmod = importlib.import_module("fpc_diffrend_tpu." + name)
        except ImportError:
            continue
        tmod = importlib.import_module(info.name)
        for attr, obj in vars(tmod).items():
            key = f"{name}.{attr}"
            if ((attr.startswith("_") and key not in PRIVATE)
                    or not hasattr(jmod, attr) or not callable(obj)
                    or getattr(obj, "__module__", None) != tmod.__name__):
                continue
            try:
                inspect.signature(obj)
            except (TypeError, ValueError):
                continue
            out[key] = (obj, getattr(jmod, attr))
    for key, row in SURFACE.items():
        if row.kind == "renamed":
            (tkey,) = row.port
            tmod, tname = tkey.rsplit(".", 1)
            jmod, jname = key.rsplit(".", 1)
            out[key] = (
                getattr(importlib.import_module("fpc_diffrend_tpu_torch."
                                                + tmod), tname),
                getattr(importlib.import_module("fpc_diffrend_tpu."
                                                + jmod), jname))
    return out


def test_shared_signatures_follow_jax():
    """Every public function and class both packages share takes JAX's
    parameter names in JAX's order with JAX's defaults, but for the named
    differences; the new primitives included."""
    import inspect

    shared = _shared_callables()
    for key in ("ops.rasterize.rasterize", "ops.rasterize.rasterize_with_uv",
                "ops.rasterize.visibility_scan",
                "ops.rasterize.pixel_attributes",
                "ops.rasterize.screen_vertices",
                "ops.interpolate.interpolate", "ops.antialias.antialias",
                "ops.texture.texture", "fit.loop.render_sample",
                "fit.loop.resolve_aa_max_pairs",
                "models.blendshape.load_blendshape_deltas",
                "parallel.mesh.make_mesh", "parallel.multihost.initialize",
                "parallel.spatial.render_band",
                "parallel.train.make_sharded_train_step",
                "parallel.train.sample_stratified", "data.seq.SeqReader",
                "tools.undistort.undistort_map",
                "tools.calibrate.calibrate_camera",
                "ops.rasterize.rasterize_pallas_textured_sepaa_stacked",
                "tools.undistort.undistort_image_jax", *PRIVATE):
        assert key in shared, key
    assert len(shared) > 80
    for key in set(RENAMED) | set(DROPPED) | set(ADDED) | set(DEFAULTS):
        assert key in shared, f"stale exception {key}"
    for key, (tobj, jobj) in sorted(shared.items()):
        tp = inspect.signature(tobj).parameters
        jp = inspect.signature(jobj).parameters
        rename = RENAMED.get(key, {})
        want = [rename.get(p, p) for p in jp if p not in DROPPED.get(key, ())]
        assert list(tp) == want + list(ADDED.get(key, ())), key
        for p in jp:
            if rename.get(p, p) in tp and p not in DEFAULTS.get(key, ()):
                a, b = tp[rename.get(p, p)].default, jp[p].default
                assert a is b or a == b, f"{key}({p}): {a!r} != {b!r}"


def test_jax_order_calls_match_jax(rng, tmp_path, capsys, monkeypatch):
    """A positional call in JAX's order of ``texture`` (uv_da,
    filter_mode, boundary_mode, max_mip_level) matches JAX's within 1e-6;
    ``load_blendshape_deltas(..., progress_every)`` matches JAX's deltas
    and, on the fallback parser, its progress lines (none at 0)."""
    from fpc_diffrend_tpu.ops.texture import texture as jtexture
    from fpc_diffrend_tpu.runtime import native as jnative
    from fpc_diffrend_tpu_torch.data.obj import save_obj
    from fpc_diffrend_tpu_torch.ops.texture import texture

    tex = rng.uniform(size=(16, 16, 2)).astype(np.float32)
    uv = rng.uniform(-0.2, 1.2, size=(9, 7, 2)).astype(np.float32)
    uv_da = rng.uniform(-0.2, 0.2, size=(9, 7, 4)).astype(np.float32)
    for da, *rest in ((uv_da, "linear-mipmap-linear", "clamp", 3),
                      (None, "linear", "clamp"), (None, "linear", "wrap", 0)):
        got = texture(_t(tex), _t(uv), None if da is None else _t(da), *rest)
        want = jtexture(jnp.asarray(tex), jnp.asarray(uv), da, *rest)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)

    base = rng.normal(size=(5, 3)).astype(np.float32)
    faces = np.array([[0, 1, 2], [2, 3, 4]], np.int32)
    (tmp_path / "bl").mkdir()
    for i in range(3):
        save_obj(str(tmp_path / "bl" / f"b{i}.obj"),
                 base + 0.1 * i + rng.normal(scale=0.01, size=base.shape)
                 .astype(np.float32), np.zeros((5, 2), np.float32), faces)
    path = str(tmp_path / "bl")
    for fallback in (False, True):
        if fallback:
            monkeypatch.setattr(tblend.native, "available", lambda: False)
            monkeypatch.setattr(jnative, "available", lambda: False)
        for every in (0, 2):
            capsys.readouterr()
            got = tblend.load_blendshape_deltas(path, base, every)
            printed = capsys.readouterr().out
            want = jblend.load_blendshape_deltas(path, base,
                                                 progress_every=every)
            assert got.shape == (15, 3)
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
            assert printed == capsys.readouterr().out
            assert printed == ("Blendshape 0/3\nBlendshape 2/3\n"
                               if fallback and every else "")


# The JAX package's environment knobs that are the port's arguments (the
# port reads no environment variable; ROADMAP.md §3): port callable, its
# parameter, the JAX file that reads the knob, the knob, and whether the
# defaults agree. The precision modes default to exact in the port, where
# JAX's default to fast (FPC_GRAD_PREC) and fast2 (FPC_TEX_PREC).
KNOB_ARGUMENTS = [
    ("ops.cuda.raster_grad_cuda.pixel_grad", "fast",
     "fpc_diffrend_tpu/ops/pallas/raster_grad_tpu.py", "FPC_GRAD_PREC",
     False),
    ("ops.cuda.raster_grad_cuda.pixel_grad_plain", "fast",
     "fpc_diffrend_tpu/ops/pallas/raster_grad_tpu.py", "FPC_GRAD_PREC",
     False),
    ("ops.cuda.texture_cuda.texture_planes_bwd", "tex_prec",
     "fpc_diffrend_tpu/ops/pallas/texture_tpu.py", "FPC_TEX_PREC", False),
    ("ops.cuda.texture_cuda.texture_planes_bwd_plain", "tex_prec",
     "fpc_diffrend_tpu/ops/pallas/texture_tpu.py", "FPC_TEX_PREC", False),
    ("workload.build_workload", "weight_temporal", "bench.py",
     "FPC_BENCH_TEMPORAL", True),
    ("workload.build_workload", "impl", "bench.py", "FPC_BENCH_IMPL", True),
]


# The JAX package's forward-precision knobs, which the port leaves out
# (ROADMAP.md §3): opt-in TPU savings of MXU passes that make the render
# inexact. The port always computes JAX's default forward, the exact one:
# the JAX file that reads the knob, the knob, and its default.
LEFT_OUT_KNOBS = [
    ("fpc_diffrend_tpu/ops/pallas/rasterize_tpu.py", "FPC_FWD_SPLITS", "3"),
    ("fpc_diffrend_tpu/ops/pallas/texture_tpu.py", "FPC_TEX_FWD_PREC",
     "exact"),
]


def test_forward_precision_knobs_are_left_out_at_jax_defaults():
    """Each knob of LEFT_OUT_KNOBS is read by its JAX file with the exact
    default, the JAX modules the parity tests compare with run at that
    default, and the port's precision setting has no forward field."""
    import os
    import re

    import jax
    from fpc_diffrend_tpu.ops.pallas import rasterize_tpu as jr
    from fpc_diffrend_tpu.ops.pallas import texture_tpu as jtt
    from fpc_diffrend_tpu_torch.ops import precision as prec

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for jfile, knob, default in LEFT_OUT_KNOBS:
        src = open(os.path.join(repo, jfile)).read()
        found = re.findall(r'environ\.get\(\s*"' + knob + r'",\s*"([^"]*)"',
                           src)
        assert found == [default], (jfile, knob, found)
    assert jr._FWD_SPLITS == 3
    assert jtt.FWD_PRECISION == jax.lax.Precision.HIGHEST
    assert prec.Precision._fields == ("grad", "tex")


def test_jax_environment_knobs_are_port_arguments():
    """Each knob named in KNOB_ARGUMENTS is read by its JAX file and is a
    parameter of the port's callable; the defaults agree where the table
    says so, and the precision arguments default to exact."""
    import importlib
    import inspect
    import os
    import re

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for key, param, jfile, knob, same in KNOB_ARGUMENTS:
        mod, name = key.rsplit(".", 1)
        obj = getattr(importlib.import_module("fpc_diffrend_tpu_torch."
                                              + mod), name)
        default = inspect.signature(obj).parameters[param].default
        src = open(os.path.join(repo, jfile)).read()
        found = re.findall(r'environ\.get\(\s*"' + knob + r'",\s*"([^"]*)"',
                           src)
        assert len(found) == 1, (jfile, knob)
        if same:
            assert type(default)(found[0]) == default, (key, param)
        else:
            assert default in (False, "exact") and found[0] in (
                "fast", "fast2"), (key, param, found)
