"""The port's sharded fit (``fpc_diffrend_tpu_torch.parallel``) against the
JAX package's, on the CPU: the tiny two-triangle scene of
``tests/test_parallel.py``, run by 8 gloo ranks (subprocesses,
``tests/_torch_parallel_child.py``) on the port's side and by JAX's
``shard_map`` over conftest's 8 virtual devices on the other.

Tolerances (JAX's own, ``tests/test_parallel.py``):
* the banded render stitched against the full frame, 2e-3 absolute;
* the sharded step's loss 2e-4 relative, the parameters after the step
  5e-5 absolute, against JAX's sharded step and the port's
  single-device ``train_step``;
* the kernel route's banded step against the same step through the scan
  route (autograd of the plain primitives and of the antialias's and the
  seam's pair math; the sampler's backward is K4's plain version): each
  gradient within 1e-4 of its largest magnitude;
* the band pass's backward (``RasterizeTextured`` with its edge rows)
  against autograd of the plain forward, 1e-5 of the largest value
  (``tests/test_torch_backward.py``'s); the pass with its edge rows
  against the pass without them, bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.sharding import PartitionSpec as P

from fpc_diffrend_tpu.data import obj as objlib
from fpc_diffrend_tpu.fit import loop as fit_loop
from fpc_diffrend_tpu.fit import state as state_mod
from fpc_diffrend_tpu.fit.config import FitConfig
from fpc_diffrend_tpu.fit.scene import build_scene
from fpc_diffrend_tpu.models import camera
from fpc_diffrend_tpu.parallel import mesh as mesh_mod
from fpc_diffrend_tpu.parallel import spatial, train as ptrain
from fpc_diffrend_tpu_torch.fit import loop as tloop
from fpc_diffrend_tpu_torch.fit import state as tstate
from fpc_diffrend_tpu_torch.fit.config import FitConfig as TConfig
from fpc_diffrend_tpu_torch.ops import rasterize as trast
from fpc_diffrend_tpu_torch.ops.cuda import rasterize_cuda as tr
from fpc_diffrend_tpu_torch.ops.cuda.texture_mip_cuda import mip_sample_plain
from fpc_diffrend_tpu_torch.ops.texture import bilinear
from fpc_diffrend_tpu_torch.ops.texture_mip import lod_from_texc, mip_pyramid
from fpc_diffrend_tpu_torch.parallel import train as tptrain

from _torch_parallel_child import launch
from _torch_scenes import (clip_batch, close_to_max, quads_scene,
                          reference_forward)

RES = (32, 32)
N_CAMS, N_FRAMES = 2, 2
MESHES = [(8, 1, 1), (2, 2, 2), (1, 1, 8)]
STEP_KEYS = ("per_frame_t", "tex", "m3", "q_opt")
SHARDED_KEYS = ("per_frame_t", "per_frame_q", "maps", "m1", "tex", "q_opt")


def _mesh_data():
    verts = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                     np.float32) * 3.0
    return objlib.MeshData(
        vertices=verts.reshape(-1),
        uv=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32),
        faces=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        fuv=np.array([[0, 1, 2], [0, 2, 3]], np.int32))


def _render_refs(config, scene, params, cam, frame):
    refs = [np.asarray(fit_loop.render_sample(
        config, scene, params, jnp.int32(c), jnp.int32(f))[0][..., 0])
        for c, f in zip(cam, frame)]
    return np.stack(refs)[..., None].astype(np.float32) * 255.0


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The JAX scene, config, start parameters and batches, and the port's
    8-rank results of every task."""
    mesh_d = _mesh_data()
    proj = np.stack([camera.default_projection()] * N_CAMS)
    mv = np.stack([camera.default_modelview(zoffset=-40),
                   camera.default_modelview(zoffset=-42)
                   @ camera.rotate_y(0.2)])
    scene = build_scene(mesh_d, proj, mv)
    config = FitConfig(max_iter=100, lr_base=1e-4, lr_t=1e-3, lr_q=1e-5,
                       resolution=RES, texshape=(16, 16, 1), mode="free",
                       cam_idxs=(0, 1), batch_size=8, raster_impl="scan",
                       weight_laplacian=10.0, log_interval=0)
    yy, xx = np.meshgrid(np.linspace(-1, 1, 16), np.linspace(-1, 1, 16),
                         indexing="ij")
    tex = (0.3 + 0.6 * np.exp(-(xx ** 2 + yy ** 2) / 0.4)
           ).astype(np.float32)[..., None]
    params = state_mod.init_params(config, N_FRAMES, scene.v_base.shape[0],
                                   scene.deltas.shape[1], tex, N_CAMS)
    params["per_frame_t"] = jnp.asarray(
        np.array([[0.1, -0.1, 0], [-0.1, 0.1, 0]], np.float32))

    # the replicated steps' batch (test_parallel._make_batch)
    rng = np.random.default_rng(1)
    cam = rng.integers(0, N_CAMS, 8).astype(np.int32)
    frame = rng.integers(0, N_FRAMES, 8).astype(np.int32)
    batch = dict(cam_idx=cam, frame_idx=frame,
                 ref=_render_refs(config, scene, params, cam, frame))
    # the frame-sharded step's: shard 0 frame 0, shard 1 frame 1
    rng = np.random.default_rng(3)
    cam2 = rng.integers(0, N_CAMS, 8).astype(np.int32)
    frame2 = np.array([0] * 4 + [1] * 4, np.int32)
    batch2 = dict(cam_idx=cam2, frame_idx=frame2,
                  ref=_render_refs(config, scene, params, cam2, frame2))

    # steps start away from the optimum (gradients there are float noise);
    # the frame-sharded one with distinct poses, so the temporal term and
    # its halo have a gradient
    start = {k: np.array(v) for k, v in params.items()}
    start["per_frame_t"] = np.zeros((N_FRAMES, 3), np.float32)
    start2 = dict(start)
    start2["per_frame_t"] = np.array([[0.03, -0.02, 0.0],
                                      [-0.02, 0.03, 0.01]], np.float32)
    temporal = {"weight_temporal": 0.5}
    mvp = np.asarray(fit_loop.build_mvp(scene, params, jnp.int32(0),
                                        jnp.int32(0)))
    view = dict(mvp=mvp, pos=np.asarray(scene.v_base).reshape(-1, 3),
                pos_idx=np.asarray(scene.faces), uv=np.asarray(scene.uv),
                uv_idx=np.asarray(scene.uv_idx), tex=start["tex"],
                face_neighbors=np.asarray(scene.face_neighbors),
                resolution=RES)
    tconfig = {f.name: getattr(config, f.name)
               for f in dataclasses.fields(config)}
    tconfig["raster_impl"] = "auto"
    tasks = [dict(kind="step", shape=s) for s in MESHES]
    tasks += [dict(kind="step", shape=(2, 2, 2), shard_frames=True,
                   config=temporal, params=start2, batch=batch2),
              dict(kind="step", shape=(2, 2, 2), config=temporal,
                   params=start2, batch=batch2),
              dict(kind="step", shape=(1, 1, 8),
                   config={"raster_impl": "scan"}),
              dict(kind="band", shape=(2, 1, 4), impl="auto", view=view),
              dict(kind="band", shape=(2, 1, 4), impl="scan", view=view)]
    # a view whose silhouette crosses every band boundary at a shallow
    # slope, so that the seam's pairs change the image
    tri = np.array([[-0.9, -0.1, 0.0], [0.0, -0.9, 0.0], [0.9, 0.1, 0.0],
                    [-0.31, 0.93, 0.0]], np.float32)
    seam_view = dict(mvp=np.eye(4, dtype=np.float32), pos=tri,
                     pos_idx=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
                     uv=tri[:, :2] * 0.5 + 0.5,
                     uv_idx=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
                     tex=np.random.default_rng(4).uniform(
                         size=(8, 8, 1)).astype(np.float32),
                     face_neighbors=np.array([[-1, 1, -1], [0, -1, -1]],
                                             np.int32),
                     resolution=(32, 40))
    tasks += [dict(kind="band", shape=(2, 2, 2), impl=impl, view=seam_view)
              for impl in ("auto", "scan")]
    # the collectives' traffic of both steps at 16 frames
    p16 = {k: np.array(v) for k, v in state_mod.init_params(
        config, 16, scene.v_base.shape[0], scene.deltas.shape[1], tex,
        N_CAMS).items()}
    batch16 = dict(batch2, frame_idx=np.array([0, 3, 5, 7, 8, 10, 12, 15],
                                              np.int32))
    tasks += [dict(kind="step", shape=(2, 2, 2), shard_frames=shard,
                   config=temporal, params=p16, batch=batch16)
              for shard in (True, False)]
    tasks.append(dict(kind="mesh"))
    job = dict(mesh=dict(vertices=mesh_d.vertices, uv=mesh_d.uv,
                         faces=mesh_d.faces, fuv=mesh_d.fuv),
               proj=proj, mv=mv, config=tconfig, params=start, batch=batch,
               tasks=tasks)
    results = launch(job, 8, tmp_path_factory.mktemp("ranks"))
    return dict(seam_view=seam_view,
                scene=scene, config=config, params=params, start=start,
                start2=start2, batch=batch, batch2=batch2, mvp=mvp,
                results=results, tconfig=tconfig, mesh_d=mesh_d, proj=proj,
                mv=mv)


def _jax_batch(b):
    return fit_loop.Batch(cam_idx=jnp.asarray(b["cam_idx"]),
                          frame_idx=jnp.asarray(b["frame_idx"]),
                          ref=jnp.asarray(b["ref"]))


def _port_step(w, params, batch, **overrides):
    """The port's single-device train_step on the CPU."""
    from fpc_diffrend_tpu_torch.data import obj as tobj
    from fpc_diffrend_tpu_torch.fit.scene import build_scene as tbuild

    md = w["mesh_d"]
    scene = tbuild(tobj.MeshData(vertices=md.vertices, uv=md.uv,
                                 faces=md.faces, fuv=md.fuv),
                   w["proj"], w["mv"], device="cpu")
    fields = {**w["tconfig"], **overrides}
    config = TConfig(**fields)
    state = tstate.init_state(config, tstate.params_from_numpy(params,
                                                               "cpu"))
    metrics = tloop.train_step(config, scene, state, tloop.Batch(
        *(torch.as_tensor(batch[k]) for k in ("cam_idx", "frame_idx",
                                              "ref"))))
    return float(metrics["loss"]), {k: p.detach().numpy()
                                    for k, p in state.params.items()}


def _check_step(got, loss, params, keys):
    np.testing.assert_allclose(got["loss"], loss, rtol=2e-4)
    for k in keys:
        np.testing.assert_allclose(got["params"][k], np.asarray(params[k]),
                                   atol=5e-5, err_msg=k)


@pytest.mark.parametrize("i", range(len(MESHES)))
def test_sharded_step_matches_jax_and_single_device(world, i):
    """At meshes (8, 1, 1), (2, 2, 2) and (1, 1, 8), the port's sharded
    step on the kernel route matches JAX's sharded step (scan route) and
    the port's own single-device step; every rank ends with one state."""
    got = world["results"][i]
    for r in got[1:]:
        np.testing.assert_array_equal(r["loss"], got[0]["loss"])
        for k in got[0]["params"]:
            np.testing.assert_array_equal(r["params"][k],
                                          got[0]["params"][k])
    mesh = mesh_mod.make_mesh(("frame", "view", "tile"), MESHES[i])
    step_fn = ptrain.make_sharded_train_step(world["config"], world["scene"],
                                             mesh)
    state = state_mod.init_state(world["config"], {
        k: jnp.array(v) for k, v in world["start"].items()})
    jstate, jmetrics = step_fn(state, ptrain.shard_batch_for(
        mesh, _jax_batch(world["batch"])))
    _check_step(got[0], float(jmetrics["loss"]), jstate.params, STEP_KEYS)
    loss, params = _port_step(world, world["start"], world["batch"])
    _check_step(got[0], loss, params, STEP_KEYS)


def test_frame_sharded_step_matches_jax_and_moves_less(world):
    """shard_frames=True at (2, 2, 2) with the temporal term: the
    per-frame rows and columns and their Adam moments live on their frame
    shard, the temporal halo crosses shards, and one step matches JAX's
    frame-sharded step and the port's single-device step, per-frame
    parameters included; it moves strictly fewer elements through the
    collectives than the replicated step at 16 frames. At the test's 2
    frames it moves 17 more: the pose halo's exchange (a 2 x 7 buffer
    forward and backward) outweighs the 11 gradient elements the
    sharding takes off the 'frame' all-reduce."""
    config = dataclasses.replace(world["config"], weight_temporal=0.5)
    sharded, repl = world["results"][3], world["results"][4]
    mesh = mesh_mod.make_mesh(("frame", "view", "tile"), (2, 2, 2))
    params0 = {k: jnp.array(v) for k, v in world["start2"].items()}
    step_fn = ptrain.make_sharded_train_step(config, world["scene"], mesh,
                                             shard_frames=True,
                                             params_like=params0)
    jstate, jmetrics = step_fn(state_mod.init_state(config, params0),
                               ptrain.shard_batch_for(
                                   mesh, _jax_batch(world["batch2"])))
    _check_step(sharded[0], float(jmetrics["loss"]), jstate.params,
                SHARDED_KEYS)
    loss, params = _port_step(world, world["start2"], world["batch2"],
                              weight_temporal=0.5)
    _check_step(sharded[0], loss, params, SHARDED_KEYS)
    _check_step(repl[0], loss, params, SHARDED_KEYS)
    # the halo reaches the previous shard's last pose row
    assert np.abs(sharded[0]["grads"]["per_frame_t"][0]).max() > 0
    halo = 2 * (2 * 7)
    saved = sum(world["start2"][k].size for k in tptrain.FRAME_SHARDED) // 2
    sharded16, repl16 = world["results"][10], world["results"][11]
    for r in range(8):
        assert sharded[r]["moved"] - repl[r]["moved"] == halo - saved
        assert sharded16[r]["moved"] < repl16[r]["moved"], (
            r, sharded16[r]["moved"], repl16[r]["moved"])


def test_banded_step_gradients_match_autograd_of_plain_forward(world):
    """The kernel route's banded step at (1, 1, 8), whose backward is the
    band Function's (K3 -> K4 -> K5 -> K6 with the seam rows' cotangents),
    against the same step through the scan route, where autograd runs
    through the plain primitives and the seam's pair math."""
    kernel, scan = world["results"][2][0], world["results"][5][0]
    np.testing.assert_allclose(kernel["loss"], scan["loss"], rtol=1e-5)
    for k, g in scan["grads"].items():
        if np.abs(g).max() == 0:        # a parameter the mode does not use
            np.testing.assert_array_equal(kernel["grads"][k], g, k)
        else:
            close_to_max(kernel["grads"][k], g, 1e-4)
    assert np.abs(scan["grads"]["tex"]).max() > 0


@pytest.mark.parametrize("task,impl", [(6, "auto"), (7, "scan")])
def test_banded_render_matches_full(world, task, impl):
    """Four bands stitched against the full-frame render of the view, on
    the kernel route and the scan route, and against JAX's bands."""
    got = sorted((r["band"], r["img"]) for r in world["results"][task]
                 if r["frame"] == 0)
    assert [b for b, _ in got] == [0, 1, 2, 3]
    stitched = np.concatenate([img for _, img in got])
    full = fit_loop.render_sample(world["config"], world["scene"],
                                  world["params"], jnp.int32(0),
                                  jnp.int32(0))[0]
    np.testing.assert_allclose(stitched, np.asarray(full), atol=2e-3)

    n_bands, hb = 4, RES[0] // 4
    scene, params = world["scene"], world["params"]
    mvp = jnp.asarray(world["mvp"])

    def band_render(_):
        band = jax.lax.axis_index("tile")
        return spatial.render_band(
            mvp, scene.v_base.reshape(-1, 3), scene.faces, scene.uv,
            scene.uv_idx, params["tex"], (hb, RES[1]), scene.face_neighbors,
            band, n_bands, impl="scan", axis_name="tile")

    mesh = mesh_mod.make_mesh(("tile",), (n_bands,), jax.devices()[:n_bands])
    bands = jax.jit(jax.shard_map(
        band_render, mesh=mesh, in_specs=(P("tile"),), out_specs=P("tile"),
        check_vma=False))(jnp.zeros((n_bands, 1)))
    np.testing.assert_allclose(stitched, np.asarray(bands), atol=2e-3)


@pytest.mark.parametrize("task,impl", [(8, "auto"), (9, "scan")])
def test_band_seam_blends_across_ranks(world, task, impl):
    """Two bands of a view whose silhouette crosses the boundary at a
    shallow slope: stitched with the seam they equal the full-frame render
    within 1e-5; without it they miss the boundary rows' antialias."""
    from fpc_diffrend_tpu_torch.ops.pipeline import render

    v = world["seam_view"]
    full = render(v["mvp"], v["pos"], v["pos_idx"], v["uv"], v["uv_idx"],
                  v["tex"], v["resolution"], v["face_neighbors"], impl=impl,
                  device="cpu").numpy()
    got = sorted((r["band"], r["img"], r["img_no_seam"])
                 for r in world["results"][task]
                 if r["frame"] == 0 and r["view"] == 0)
    assert [b for b, _, _ in got] == [0, 1]
    seam = np.concatenate([img for _, img, _ in got])
    np.testing.assert_allclose(seam, full, rtol=0, atol=1e-5)
    no_seam = np.concatenate([img for _, _, img in got])
    off = np.abs(no_seam - full).max(axis=(1, 2))
    assert off.max() > 0.02 and set(np.nonzero(off > 1e-5)[0]) <= {15, 16}


@pytest.mark.parametrize("mip", [False, True])
def test_band_function_backward_matches_autograd_of_plain_forward(rng, mip):
    """The pass's edge rows (``edge_rows``: each sample's first and last
    rows of the pre-antialias colour and of u, v, z) carry their
    cotangents into K4 (K9) and K5: the Function's gradients equal
    autograd of the plain forward with the same rows read from it."""
    B, H, W = 2, 40, 100
    verts, faces, uv, fn = quads_scene(rng)
    t = {k: torch.as_tensor(v) for k, v in dict(
        pc=clip_batch(verts, rng, B), faces=faces, uv=uv, fn=fn,
        tex=rng.uniform(size=(16, 16, 2)).astype(np.float32)).items()}
    data_b, aux_b, bins = trast.bin_stacked(t["pc"], t["faces"], t["uv"],
                                            t["faces"], t["fn"], (H, W))
    ph, pw = tr.pad_resolution(H, W)
    k1 = tr.fused_raster(bins, None if mip else t["tex"], B * ph, pw)
    pyramid, sizes = mip_pyramid(t["tex"], 3)
    lam = lod_from_texc(k1[2][3], k1[2][4], k1[0], 16, 16, H, W, ph)
    first = torch.arange(B) * ph
    rows = torch.stack([first, first + H - 1], 1).reshape(-1)
    R = [torch.as_tensor(rng.normal(size=s).astype(np.float32)) for s in
         ((2, B * ph, pw), (2, B, 2, pw), (3, B, 2, pw))]
    grads = []
    for use_function in (True, False):
        d, a, x = (v.detach().clone().requires_grad_(True)
                   for v in (data_b, aux_b, pyramid if mip else t["tex"]))
        if use_function:
            _, aa, crow, uvz = trast.RasterizeTextured.apply(
                d, a, x, bins, ph, H, W, "mip" if mip else "sepaa",
                sizes if mip else None, True)
        else:
            planes = {}

            def sample(tu, tv):
                planes["uv"] = (tu, tv)
                if mip:
                    c = mip_sample_plain(x, sizes, tu, tv, lam)
                else:
                    c = bilinear(x, tu, tv, "wrap").movedim(-1, 0)
                planes["colour"] = c
                return c

            aa = reference_forward(d, a, bins, k1, H, W, ph, sample)
            crow = planes["colour"][:, rows].reshape(2, B, 2, pw)
            # u, v, z of the resolved payload: the plain forward's planes
            hit = k1[1] >= 0
            rec = torch.cat([d, a], -1).reshape(-1, tr.REC)
            tri = torch.cat([bins.sorted_tri.long(), torch.zeros(
                bins.gbase - bins.sorted_tri.shape[0], dtype=torch.long),
                bins.global_idx.long()]).clamp(max=rec.shape[0] - 1)
            F = torch.where(hit[..., None],
                            rec[tri[k1[1].long().clamp(min=0)]], 0.0)
            xs = torch.arange(pw, dtype=torch.float32) + 0.5
            # each pixel at its row within its sample
            ys = (torch.remainder(torch.arange(B * ph), ph).to(
                torch.float32) + 0.5)[:, None]
            z = F[..., 9] * xs + (F[..., 10] * ys + F[..., 11])
            pay, _ = tr.resolve_payload(F, xs, ys, hit, z)
            uvz = torch.stack(pay[:3])[:, rows].reshape(3, B, 2, pw)
        loss = sum((o * r).sum() for o, r in zip((aa, crow, uvz), R))
        loss.backward()
        grads.append((d.grad, a.grad, x.grad))
    for got, want in zip(*grads):
        close_to_max(got.numpy(), want.numpy(), 1e-5)
    # the edge rows' u, v, z cotangents reach the records through K5
    assert float(grads[0][0][..., 9:12].abs().max()) > 0


@pytest.mark.parametrize("mip", [False, True])
def test_edge_rows_leave_the_pass_unchanged(rng, mip):
    """The pass with its edge rows on gives the ids and the antialiased
    colour of the pass without them bit for bit, and, with zero
    cotangents of the rows, the same gradients into the records and the
    texture (the pyramid) bit for bit."""
    B, H, W = 2, 40, 100
    verts, faces, uv, fn = quads_scene(rng)
    t = {k: torch.as_tensor(v) for k, v in dict(
        pc=clip_batch(verts, rng, B), faces=faces, uv=uv * 4.0, fn=fn,
        tex=rng.uniform(size=(64, 64, 2)).astype(np.float32)).items()}
    data_b, aux_b, bins = trast.bin_stacked(t["pc"], t["faces"], t["uv"],
                                            t["faces"], t["fn"], (H, W))
    ph, pw = tr.pad_resolution(H, W)
    x0, sizes = mip_pyramid(t["tex"], 6) if mip else (t["tex"], None)
    R = torch.as_tensor(rng.normal(size=(2, B * ph, pw)).astype(np.float32))
    outs = []
    for edge_rows in (False, True):
        d, a, x = (v.detach().clone().requires_grad_(True)
                   for v in (data_b, aux_b, x0))
        idbuf, aa, *rows = trast.RasterizeTextured.apply(
            d, a, x, bins, ph, H, W, "mip" if mip else "sepaa", sizes,
            edge_rows)
        assert len(rows) == (2 if edge_rows else 0)
        loss = (aa * R).sum() + sum((r * 0.0).sum() for r in rows)
        loss.backward()
        outs.append((idbuf, aa.detach(), d.grad, a.grad, x.grad))
    assert float(outs[0][3][..., 6:12].abs().max()) > 0  # screen corners
    for got, want in zip(*outs):
        assert torch.equal(got, want)


def test_mesh_helpers_and_collectives(world):
    """At (2, 2, 2): each rank's batch slice (the flattened coordinate,
    frame outermost), the broadcast from the first rank, ``ppermute``
    (a rank named by no pair receives zeros) and ``all_reduce_sum`` over
    an axis, with their gradients summed over the receivers."""
    got = world["results"][12]
    weight = {tuple(r["coords"]): rank + 1 for rank, r in enumerate(got)}
    for rank, r in enumerate(got):
        f, v, t = r["coords"]
        k = (f * 2 + v) * 2 + t
        assert k == rank and (r["sharding"].index,
                              r["sharding"].count) == (k, 8)
        assert (r["replicated"].index, r["replicated"].count) == (0, 1)
        np.testing.assert_array_equal(r["shard"]["a"], [2 * k, 2 * k + 1])
        np.testing.assert_array_equal(r["shard"]["b"][0], [k])
        np.testing.assert_array_equal(r["replicate"], [0.0, 0.0])
        peer = {a: b for a, b in ((0, 1), (1, 0))}[t]
        sender = [q for q, x in enumerate(got)
                  if x["coords"] == [f, v, peer]][0]
        np.testing.assert_array_equal(r["ppermute"],
                                      [float(sender) if t == 1 else 0.0] * 3)
        group = [q for q, x in enumerate(got) if x["coords"][1:] == [v, t]]
        np.testing.assert_array_equal(r["psum"], [float(sum(group))] * 3)
        # d/dx: the psum's receivers' weights, and the tile peer's weight
        # where this rank sends (tile 0 to tile 1)
        want = sum(weight[tuple(got[q]["coords"])] for q in group)
        if t == 0:
            want += weight[(f, v, 1)]
        np.testing.assert_array_equal(r["grad"], [float(want)] * 3)


def test_sample_stratified_equals_jax(world):
    """The port's stratified draws are JAX's, from the same numpy rng."""
    jmesh = mesh_mod.make_mesh(("frame", "view"), (2, 4))
    fake = type("Mesh", (), {"mesh_dim_names": ("frame", "view"),
                             "mesh": torch.zeros(2, 4)})()
    for seed in (0, 5):
        jc, jf = ptrain.sample_stratified(np.random.default_rng(seed),
                                          world["config"], jmesh, 4, 3)
        tc, tf = tptrain.sample_stratified(np.random.default_rng(seed),
                                           world["config"], fake, 4, 3)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    per = world["config"].batch_size // 2
    assert set(tf[:per].tolist()) <= {0, 1} and set(tf[per:].tolist()) <= {
        2, 3}
