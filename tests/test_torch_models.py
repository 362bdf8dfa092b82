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
