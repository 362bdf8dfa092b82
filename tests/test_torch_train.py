"""Slice 2: the fit step's gradients and optimizer against the JAX package,
and the training entry points on the CPU.

Tolerances:
* step gradients, relative L2 error per parameter against
  ``jax.grad(fit.loop.loss_fn)`` on ``bench.build_workload`` (raster_impl
  "scan", every pixel pair antialiased): 1e-3 on the grid-3 dome, where
  ids and images agree (measured <= 7e-5: the same math rounded in
  another order, summed over every pixel); 0.1 on the grid-5 dome, whose
  ids agree but whose images differ on 24 of 12,288 values where two
  pixels' depths tie to float32 precision and the antialias picks the
  other occluder (measured <= 5.2 %: a silhouette pair's vertex gradient
  outweighs many interior pixels');
* the Laplacian's gradient, 1e-6 of its largest value (the same padded
  sums on both sides);
* the optimizer, 2e-5 of each parameter's largest value after 6 updates:
  optax takes Adam's bias corrections in float32, and 1 - 0.999f is
  1.3e-5 off 1e-3, so its first update is 6.4e-6 smaller than the exact
  one torch.optim.Adam takes (a parameter that starts at 0 is made of
  updates alone; measured <= 8e-6). Parameters that start at O(1) agree
  within 2e-7.
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from fpc_diffrend_tpu.fit import loop as jloop
from fpc_diffrend_tpu.fit import state as jstate
from fpc_diffrend_tpu.fit.config import FitConfig as JConfig
from fpc_diffrend_tpu.ops import mesh_ops as jmesh
from fpc_diffrend_tpu.ops.rasterize import visibility_scan
from fpc_diffrend_tpu_torch.fit import loop as tloop
from fpc_diffrend_tpu_torch.fit import state as tstate
from fpc_diffrend_tpu_torch.fit.config import FitConfig
from fpc_diffrend_tpu_torch.ops import mesh_ops as tmesh
from fpc_diffrend_tpu_torch.ops.cuda import antialias_cuda as tac
from fpc_diffrend_tpu_torch.ops.cuda import raster_grad_cuda as tgc
from fpc_diffrend_tpu_torch.ops.cuda import rasterize_cuda as trc
from fpc_diffrend_tpu_torch.ops.cuda import texture_cuda as ttc
from fpc_diffrend_tpu_torch.ops.rasterize import bin_stacked
from fpc_diffrend_tpu_torch.workload import build_workload

H, W, BATCH, TEX = 48, 128, 2, 64
COUNTERS = (trc.fused_raster, tac.antialias_planes, tac.antialias_planes_bwd,
            ttc.texture_planes_bwd, tgc.pixel_grad, tgc.fold_entries)


def _workloads(monkeypatch, grid):
    import bench

    for k, v in dict(CPU="1", RES_H=H, RES_W=W, GRID=grid, BATCH=BATCH,
                     TEX=TEX, IMPL="scan").items():
        monkeypatch.setenv(f"FPC_BENCH_{k}", str(v))
    jw = bench.build_workload()
    jw["config"] = dataclasses.replace(jw["config"], raster_impl="scan",
                                       aa_max_pairs=-1)
    return jw, build_workload(H, W, grid=grid, batch=BATCH, tex_size=TEX,
                              device="cpu")


def _ids_differ(jw, tw):
    """Pixels whose winning triangle differs between the JAX scan
    rasterizer and K1's plain version on the workload's batch."""
    cfg, sc, tb = tw["config"], tw["scene"], tw["batch"]
    pc, _ = tloop.sample_clip_positions(cfg, sc, tw["params"], tb.cam_idx,
                                        tb.frame_idx)
    _, _, bins = bin_stacked(pc, sc.faces, sc.uv, sc.uv_idx,
                             sc.face_neighbors, (H, W))
    ph, pw = trc.pad_resolution(H, W)
    ids = trc.fused_raster(bins, tw["params"]["tex"], BATCH * ph,
                           pw)[0].numpy()
    jb = jw["batch"]
    n = 0
    for b in range(BATCH):
        jpc, _ = jloop.sample_clip_positions(jw["config"], jw["scene"],
                                             jw["params"], jb.cam_idx[b],
                                             jb.frame_idx[b])
        want = np.asarray(visibility_scan(jpc, jw["scene"].faces, H, W))
        n += int((ids[b * ph:b * ph + H, :W] != want).sum())
    return n


@pytest.mark.parametrize("grid,bound", [(3, 1e-3), (5, 0.1)])
def test_step_gradients_match_jax(monkeypatch, grid, bound):
    jw, tw = _workloads(monkeypatch, grid)
    assert _ids_differ(jw, tw) == 0
    jg, jm = jax.grad(jloop.loss_fn, has_aux=True)(
        jw["params"], jw["config"], jw["scene"], jw["batch"], jnp.int32(0))
    params = {k: v.clone().requires_grad_(True)
              for k, v in tw["params"].items()}
    total, tm = tloop.loss_fn(params, tw["config"], tw["scene"], tw["batch"])
    total.backward()
    np.testing.assert_allclose(float(tm["loss"].detach()),
                               float(jm["loss"]), rtol=1e-3)
    for k, want in jg.items():
        want = np.asarray(want)
        got = (np.zeros_like(want) if params[k].grad is None
               else params[k].grad.numpy())
        norm = np.linalg.norm(want)
        if norm == 0:      # unused by free mode, or m1/m2 behind m3 = 0
            assert not got.any(), k
            continue
        err = np.linalg.norm(got - want) / norm
        assert err < bound, f"{k}: relative L2 error {err:.3g}"
    assert np.linalg.norm(np.asarray(jg["tex"])) > 0
    assert np.linalg.norm(np.asarray(jg["per_frame_q"])) > 0


def test_laplacian_gradient_matches_jax(rng):
    tw = build_workload(32, 32, grid=7, batch=1, tex_size=4, device="cpu")
    sc = tw["scene"]
    verts = rng.normal(size=(2, sc.n_vertices, 3)).astype(np.float32)

    nbr = [jnp.asarray(t.numpy()) for t in (sc.nbr_idx, sc.nbr_mask,
                                            sc.degree)]

    def jloss(v):
        return jnp.sum(jax.vmap(
            lambda x: jmesh.mesh_laplacian_smoothing_padded(x, *nbr))(v) ** 2)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(verts)))
    v = torch.as_tensor(verts).requires_grad_(True)
    (tmesh.mesh_laplacian_smoothing_padded(v, sc.nbr_idx, sc.nbr_mask,
                                           sc.degree) ** 2).sum().backward()
    np.testing.assert_allclose(v.grad.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("mode", ["free", "prior", "combined"])
def test_optimizer_matches_optax(rng, mode):
    """Six updates from one numpy gradient sequence: the ramp moves
    (max_iter 8) and combined mode's gate opens after step 4."""
    kw = dict(mode=mode, max_iter=8, lr_base=1e-2, lr_t=1e-3, lr_q=1e-3)
    jcfg, tcfg = JConfig(**kw), FitConfig(**kw)
    tex = rng.uniform(size=(8, 8, 1)).astype(np.float32)
    jparams = jstate.init_params(jcfg, 4, 30, 2, tex, 3)
    tparams = tstate.init_params(tcfg, 4, 30, 2, tex, 3, device="cpu")
    opt = jstate.make_optimizer(jcfg)
    jst = jstate.init_state(jcfg, jparams)
    opt_state, step = jst.opt_state, 0
    tst = tstate.init_state(tcfg, tparams)
    for _ in range(6):
        grads = {k: rng.normal(size=v.shape).astype(np.float32)
                 for k, v in jparams.items()}
        g = jstate.apply_corrective_gate(
            jcfg, jnp.int32(step), {k: jnp.asarray(v) for k, v in
                                    grads.items()})
        updates, opt_state = opt.update(g, opt_state, jparams)
        jparams = jstate.normalize_quaternions(
            optax.apply_updates(jparams, updates))
        step += 1
        for k, p in tparams.items():
            p.grad = torch.as_tensor(grads[k])
        tstate.optimizer_step(tcfg, tst)
    assert tst.step == 6
    for k, want in jparams.items():
        want = np.asarray(want)
        np.testing.assert_allclose(tparams[k].detach().numpy(), want,
                                   rtol=0, atol=2e-5 * np.abs(want).max(),
                                   err_msg=k)
    moved = {k for k in jparams
             if not np.array_equal(np.asarray(jparams[k]),
                                   jstate.init_params(jcfg, 4, 30, 2, tex,
                                                      3)[k])}
    assert ({"m1", "m2", "m3"} <= moved) == (mode != "prior")


def test_train_step_lowers_the_loss_on_cpu():
    tw = build_workload(H, W, grid=5, batch=BATCH, tex_size=TEX,
                        device="cpu")
    state = tw["state"]
    losses = [float(tloop.train_step(tw["config"], tw["scene"], state,
                                     tw["batch"])["loss"])
              for _ in range(4)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert state.step == 4
    p = state.params
    assert p["maps"].grad is not None and not p["maps"].grad.any()
    assert not p["maps"].any()           # free mode leaves the prior alone
    for k in ("q_opt", "per_frame_q"):
        norms = torch.linalg.vector_norm(p[k].detach(), dim=-1)
        torch.testing.assert_close(norms, torch.ones_like(norms))


def test_train_steps_and_run_fit_on_cpu():
    tw = build_workload(H, W, grid=5, batch=BATCH, tex_size=TEX,
                        device="cpu")
    for f in COUNTERS:
        f.launches = 0
    gen = torch.Generator().manual_seed(0)
    state, metrics = tloop.train_steps(tw["config"], tw["scene"], tw["state"],
                                       tw["frames_u8"], gen, 3,
                                       tw["n_frames"])
    assert state.step == 3
    assert set(metrics) == {"loss", "pix", "mel", "lap", "mnc"}
    for v in metrics.values():
        assert v.shape == (3,) and bool(torch.all(torch.isfinite(v)))

    cfg = dataclasses.replace(tw["config"], steps_per_dispatch=2, seed=1)
    seen = []
    state = tloop.run_fit(cfg, tw["scene"], tw["frames_u8"], tw["n_frames"],
                          callbacks=[lambda i, s, m: seen.append(
                              (i, float(m["loss"])))], n_steps=3)
    assert state.step == 3 and [i for i, _ in seen] == [1, 2]
    assert all(np.isfinite(loss) for _, loss in seen)
    assert state.params["tex"].shape == cfg.texshape
    state = tloop.run_fit(cfg, tw["scene"], tw["frames_u8"], tw["n_frames"],
                          state=state, n_steps=2)
    assert state.step == 5
    for k in ("q_opt", "per_frame_q"):
        norms = torch.linalg.vector_norm(state.params[k].detach(), dim=-1)
        torch.testing.assert_close(norms, torch.ones_like(norms))
    assert all(f.launches == 0 for f in COUNTERS)


@pytest.mark.parametrize("aa_max_pairs", [-1, 0], ids=["every-pair",
                                                       "capped"])
def test_scan_step_gradients_match_jax(monkeypatch, aa_max_pairs):
    """raster_impl="scan" on both sides (the port renders sample by sample
    through ``render_sample``: the visibility scan, the primitives'
    autograd, K7/K4's and K2/K3's plain versions, or the pair-capped
    antialias at aa_max_pairs 0 = 8 (H + W)): the loss within 1e-6 and
    every parameter gradient within 1e-4 relative L2 of
    ``jax.grad(loss_fn)`` on the grid-3 dome (measured <= 4.5e-6: the same
    formulas on clip positions a few ulp apart, summed in another order;
    the kernel route's are held to 1e-3 there). The grid-5 dome's depth
    ties (see the module docstring) move this route as they move the
    kernel route."""
    jw, tw = _workloads(monkeypatch, 3)
    jcfg = dataclasses.replace(jw["config"], aa_max_pairs=aa_max_pairs)
    tcfg = dataclasses.replace(tw["config"], raster_impl="scan",
                               aa_max_pairs=aa_max_pairs)
    jg, jm = jax.grad(jloop.loss_fn, has_aux=True)(
        jw["params"], jcfg, jw["scene"], jw["batch"], jnp.int32(0))
    params = {k: v.clone().requires_grad_(True)
              for k, v in tw["params"].items()}
    for f in COUNTERS:
        f.launches = 0
    total, tm = tloop.loss_fn(params, tcfg, tw["scene"], tw["batch"])
    total.backward()
    assert all(f.launches == 0 for f in COUNTERS)
    np.testing.assert_allclose(float(tm["loss"].detach()),
                               float(jm["loss"]), rtol=1e-6)
    for k, want in jg.items():
        want = np.asarray(want)
        got = (np.zeros_like(want) if params[k].grad is None
               else params[k].grad.numpy())
        norm = np.linalg.norm(want)
        if norm == 0:
            assert not got.any(), k
            continue
        err = np.linalg.norm(got - want) / norm
        assert err < 1e-4, f"{k}: relative L2 error {err:.3g}"
    assert np.linalg.norm(np.asarray(jg["per_frame_q"])) > 0


@pytest.mark.parametrize("impl", ["scan", "auto"])
def test_render_sample_matches_jax(monkeypatch, impl):
    """``fit.loop.render_sample`` of one (camera, frame) against JAX's
    (scan, every pair) on the grid-3 dome: the vertices within 1e-5; the
    image within 1e-5 on the scan route (the same formulas on clip
    positions a few ulp apart), on >= 99.5 % of values within 2e-4 on the
    kernel route (``tests/test_pipeline_fused.py``'s limits between two
    renderers); a batch of scan samples stacks them."""
    jw, tw = _workloads(monkeypatch, 3)
    tcfg = dataclasses.replace(tw["config"], raster_impl=impl,
                               aa_max_pairs=-1)
    jb, tb = jw["batch"], tw["batch"]
    cam, frame = int(jb.cam_idx[1]), int(jb.frame_idx[1])
    want, jv = jloop.render_sample(jw["config"], jw["scene"], jw["params"],
                                   jnp.int32(cam), jnp.int32(frame))
    with torch.no_grad():
        img, v = tloop.render_sample(tcfg, tw["scene"], tw["params"],
                                     tb.cam_idx[1], tb.frame_idx[1])
        img2, _ = tloop.render_sample(tcfg, tw["scene"], tw["params"], cam,
                                      frame)
    assert img.shape == (H, W, 1) and img2.equal(img)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=0, atol=1e-5)
    want = np.asarray(want)
    assert (want != 45.0 / 255.0).mean() > 0.2          # the dome is in view
    if impl == "scan":
        np.testing.assert_allclose(img.numpy(), want, rtol=0, atol=1e-5)
        with torch.no_grad():
            imgs, verts = tloop.render_batch(tcfg, tw["scene"], tw["params"],
                                             tb.cam_idx, tb.frame_idx)
        assert imgs[1].equal(img) and verts.shape == (BATCH,) + v.shape
    else:
        assert np.isclose(img.numpy(), want, atol=2e-4).mean() >= 0.995
