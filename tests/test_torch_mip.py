"""The mip path (``enable_mip``): K8 and K9's plain versions, the LOD, the
mip render Function and the mip fit step against the JAX package.

Inputs are numpy draws from a seed, handed to both sides. The JAX side
runs ``mip_texture_pallas`` in interpret mode, or ``jax.grad`` of its XLA
trilinear sampler with ``uv_da`` pinning the LOD to a given plane
(``uv_da = [2^lam / tw, 0, 0, 0]``, as ``tests/test_texture_mip_pallas.py``
does).

Tolerances:
* K8, 1e-5 absolute against the Pallas kernel (values in [0, 1]; the
  kernel blends per level with matmuls, the port with a direct gather);
* K9 against autodiff of the XLA sampler: the texture gradient within
  1e-5 of its largest value (sums over ~60 pixels in another order), the
  uv gradient within 1e-4 relative L2 (the pinned LOD is 2^lam squared
  and logged again, a few ulp off lam, which moves the level weights of
  pixels near an integer LOD by ~1e-6);
* K9 against the Pallas kernel's own VJP, that file's tolerances (1e-4
  texture, 2e-3 + 1e-3 relative uv): its patch gates zero the uv
  gradient where a VMEM patch clamps, and the scene keeps every pixel
  inside its patch, which the XLA comparison of the same scene shows;
* the LOD, 1e-6 absolute and relative (0.5 * log2 on each side);
* the Function, 1e-5 of the largest value, as in
  ``tests/test_torch_backward.py``;
* the step, ``tests/test_torch_train.py``'s bounds: 1e-3 relative L2 per
  parameter on the grid-3 dome, 0.1 on the grid-5 dome (antialias depth
  ties).
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fpc_diffrend_tpu.data.obj import build_topology
from fpc_diffrend_tpu.fit import loop as jloop
from fpc_diffrend_tpu.ops import antialias as jaa
from fpc_diffrend_tpu.ops import texture as jtexture
from fpc_diffrend_tpu.ops.pallas import texture_mip_tpu as jmip
from fpc_diffrend_tpu.ops.pipeline import BACKGROUND as JBACKGROUND
from fpc_diffrend_tpu.ops.rasterize import rasterize_with_uv
from fpc_diffrend_tpu_torch.fit import loop as tloop
from fpc_diffrend_tpu_torch.ops import texture as ttexture
from fpc_diffrend_tpu_torch.ops import texture_mip as tmip
from fpc_diffrend_tpu_torch.ops.cuda import antialias_cuda as tac
from fpc_diffrend_tpu_torch.ops.cuda import raster_grad_cuda as tgc
from fpc_diffrend_tpu_torch.ops.cuda import rasterize_cuda as tr
from fpc_diffrend_tpu_torch.ops.cuda import texture_cuda as ttc
from fpc_diffrend_tpu_torch.ops.cuda import texture_mip_cuda as tmc
from fpc_diffrend_tpu_torch.ops.rasterize import RasterizeTextured
from fpc_diffrend_tpu_torch.utils import profiling
from fpc_diffrend_tpu_torch.workload import build_workload

from _torch_scenes import (clip_batch, close_to_max, quads_scene,
                          reference_forward)

H, W, BATCH, TEX = 48, 128, 2, 256    # LOD ~2-3 on the dome: levels 2, 3
COUNTERS = (tr.fused_raster, tac.antialias_planes, tac.antialias_planes_bwd,
            ttc.texture_planes_bwd, tgc.pixel_grad, tgc.fold_entries,
            tmc.mip_sample, tmc.mip_sample_bwd)


def _planes(uv):
    return (torch.as_tensor(np.ascontiguousarray(uv[..., 0])),
            torch.as_tensor(np.ascontiguousarray(uv[..., 1])))


def _sampler_scene(rng, C, th=64, tw=64, rows=16, pw=256, lo=-0.7, hi=3.6):
    """test_texture_mip_pallas.py's scene, with the LOD spanning past both
    clamps of a 4-level chain (max level 3)."""
    tex = rng.uniform(size=(th, tw, C)).astype(np.float32)
    yy, xx = np.meshgrid(np.linspace(0.15, 0.85, rows),
                         np.linspace(0.1, 0.9, pw), indexing="ij")
    uv = np.stack([xx, yy], axis=-1).astype(np.float32)
    lam = np.linspace(lo, hi, rows * pw).reshape(rows, pw).astype(np.float32)
    uv_da = np.zeros((rows, pw, 4), np.float32)
    uv_da[..., 0] = (2.0 ** lam) / tw
    g = rng.normal(size=(C, rows, pw)).astype(np.float32)
    return tex, uv, lam, uv_da, g


# ------------------------------------------------------- the pyramid ----

def test_build_mip_pyramid_matches_jax(rng):
    tex = rng.uniform(size=(64, 64, 2)).astype(np.float32)
    got = ttexture.build_mip_pyramid(torch.as_tensor(tex), 6)
    want = jtexture.build_mip_pyramid(jnp.asarray(tex), 6)
    assert len(got) == len(want) == 7 and got[-1].shape == (1, 1, 2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-7)
    assert tmip.level_sizes(64, 64, 6) == jmip._level_sizes(64, 64, 6)
    assert tmip.level_sizes(64, 64, 6) == [g.shape[:2] for g in got]
    pyr, sizes = tmip.mip_pyramid(torch.as_tensor(tex), 6)
    assert pyr.shape == (sum(h * w for h, w in sizes), 2)
    assert tmc.level_offsets(sizes)[-1] == pyr.shape[0] - 1


# ---------------------------------------------------------------- K8 ----

@pytest.mark.parametrize("C", [1, 3])
def test_k8_plain_matches_pallas_kernel_interpret(rng, C):
    tex, uv, lam, _, _ = _sampler_scene(rng, C)
    want = jmip.mip_texture_pallas(jnp.asarray(tex), jnp.asarray(uv),
                                   jnp.asarray(lam), 3, interpret=True)
    got = tmip.mip_texture(torch.as_tensor(tex), *_planes(uv),
                           torch.as_tensor(lam), 3)
    assert tmc.mip_sample.launches == 0
    np.testing.assert_allclose(got.permute(1, 2, 0).numpy(),
                               np.asarray(want), rtol=0, atol=1e-5)


def test_k8_plain_matches_xla_trilinear_sampler(rng):
    tex, uv, lam, uv_da, _ = _sampler_scene(rng, 2)
    want = jtexture.texture(jnp.asarray(tex), jnp.asarray(uv),
                            uv_da=jnp.asarray(uv_da),
                            filter_mode="linear-mipmap-linear",
                            max_mip_level=3)
    got = tmip.mip_texture(torch.as_tensor(tex), *_planes(uv),
                           torch.as_tensor(lam), 3)
    np.testing.assert_allclose(got.permute(1, 2, 0).numpy(),
                               np.asarray(want), rtol=0, atol=1e-5)
    # the port's own XLA-style sampler is the same function
    ref = ttexture.texture(torch.as_tensor(tex), torch.as_tensor(uv),
                           filter_mode="linear-mipmap-linear",
                           uv_da=torch.as_tensor(uv_da), max_mip_level=3)
    np.testing.assert_allclose(ref.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


# ---------------------------------------------------------------- K9 ----

def _port_grads(tex, uv, lam, g):
    t, u, v = (torch.as_tensor(x).clone().requires_grad_(True)
               for x in (tex, *_planes(uv)))
    out = tmip.mip_texture(t, u, v, torch.as_tensor(lam), 3)
    (out * torch.as_tensor(g)).sum().backward()
    assert tmc.mip_sample_bwd.launches == 0
    return t.grad.numpy(), np.stack([u.grad.numpy(), v.grad.numpy()], -1)


def _jax_grads(sample, tex, uv, g):
    gl = jnp.asarray(g.transpose(1, 2, 0))
    return [np.asarray(x) for x in jax.grad(
        lambda t, c: jnp.sum(sample(t, c) * gl), argnums=(0, 1))(
            jnp.asarray(tex), jnp.asarray(uv))]


def _rel_l2(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("C", [1, 3])
def test_k9_plain_matches_autodiff_of_xla_sampler(rng, C):
    tex, uv, lam, uv_da, g = _sampler_scene(rng, C)
    gtex, guv = _port_grads(tex, uv, lam, g)
    jtex, juv = _jax_grads(lambda t, c: jtexture.texture(
        t, c, uv_da=jnp.asarray(uv_da), filter_mode="linear-mipmap-linear",
        max_mip_level=3), tex, uv, g)
    close_to_max(gtex, jtex, 1e-5)
    assert _rel_l2(guv, juv) < 1e-4
    # and the explicit VJP is autograd of the plain forward
    pyr, sizes = tmip.mip_pyramid(torch.as_tensor(tex), 3)
    u, v = (x.clone().requires_grad_(True) for x in _planes(uv))
    p = pyr.clone().requires_grad_(True)
    (tmc.mip_sample_plain(p, sizes, u, v, torch.as_tensor(lam))
     * torch.as_tensor(g)).sum().backward()
    gp, gu, gv = tmc.mip_sample_bwd(pyr, sizes, u.detach(), v.detach(),
                                    torch.as_tensor(lam), torch.as_tensor(g))
    torch.testing.assert_close(gp, p.grad, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(gu, u.grad, atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(gv, v.grad, atol=1e-4, rtol=1e-5)


def test_k9_plain_matches_pallas_kernel_vjp(rng):
    tex, uv, lam, _, g = _sampler_scene(rng, 1)
    gtex, guv = _port_grads(tex, uv, lam, g)
    jtex, juv = _jax_grads(lambda t, c: jmip.mip_texture_pallas(
        t, c, jnp.asarray(lam), 3, interpret=True), tex, uv, g)
    np.testing.assert_allclose(gtex, jtex, atol=1e-4)
    np.testing.assert_allclose(guv, juv, atol=2e-3, rtol=1e-3)


def test_k9_skips_dead_pixels_and_checks_shapes(rng):
    tex, uv, lam, _, g = _sampler_scene(rng, 2)
    pyr, sizes = tmip.mip_pyramid(torch.as_tensor(tex), 3)
    g[:, 4:6] = 0.0
    tu, tv = _planes(uv)
    _, gu, gv = tmc.mip_sample_bwd(pyr, sizes, tu, tv, torch.as_tensor(lam),
                                   torch.as_tensor(g))
    assert not gu[4:6].any() and not gv[4:6].any() and gu.any()
    with pytest.raises(ValueError):
        tmc.mip_sample(pyr, sizes[:-1], tu, tv, torch.as_tensor(lam))
    with pytest.raises(ValueError):
        tmc.mip_sample(pyr, sizes, tu, tv, torch.as_tensor(lam).double())
    with pytest.raises(ValueError):
        tmc.mip_sample_bwd(pyr, sizes, tu, tv, torch.as_tensor(lam),
                           torch.as_tensor(g[:1]))
    assert tmc.mip_sample.launches == tmc.mip_sample_bwd.launches == 0


# ---------------------------------------------------------------- LOD ----

def _lod_scene(rng, B=2, Hs=20, Ws=100):
    """A perspective quad larger than the image behind a small one, so
    triangles cover the padded columns and rows, and sample 0's padded
    rows hold the same local ids as sample 1's first row."""
    verts = np.array([[-1.4, -1.5, 0.5], [1.5, -1.4, 0.5], [1.4, 1.5, 0.5],
                      [-1.5, 1.4, 0.5], [-0.4, -0.3, 0.0], [0.3, -0.4, 0.0],
                      [0.4, 0.5, 0.0], [-0.3, 0.3, 0.0]], np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7]], np.int32)
    uv = np.array([[0.0, 0.0], [2.5, 0.1], [2.2, 1.9], [0.1, 1.7],
                   [0.3, 0.3], [0.6, 0.3], [0.6, 0.7], [0.3, 0.6]],
                  np.float32)
    fn = build_topology(faces, verts.shape[0]).face_neighbors
    pc = clip_batch(verts, rng, B)
    pc[:, :4] *= np.array([1.0, 1.8, 2.6, 1.4], np.float32)[:, None]
    t = {k: torch.as_tensor(v) for k, v in
         dict(pc=pc, faces=faces, uv=uv, fn=fn).items()}
    aux = tr.aux_records(t["uv"], t["faces"], t["pc"], t["faces"], t["fn"],
                         Hs, Ws)
    data_b, aux_b, bins = tr.bin_scene_stacked(t["pc"], t["faces"], Hs, Ws,
                                               aux)
    ph, pw = tr.pad_resolution(Hs, Ws)
    return tr.fused_raster(bins, None, B * ph, pw), ph, (data_b, aux_b, bins)


def test_lod_from_texc_stacked_matches_jax_per_sample(rng):
    B, Hs, Ws, th, tw = 2, 20, 100, 64, 128
    (idbuf, _, payload, _, colour), ph, _ = _lod_scene(rng, B, Hs, Ws)
    assert colour.shape[0] == 0
    rows, pw = idbuf.shape
    tu, tv = payload[3], payload[4]
    lam = tmip.lod_from_texc(tu, tv, idbuf, th, tw, Hs, Ws, ph).numpy()
    unmasked = tmip.lod_from_texc(tu, tv, idbuf, th, tw, rows, pw,
                                  rows).numpy()
    ids = idbuf.numpy()
    # triangles cover the padding, and a local id spans the boundary
    assert (ids[:Hs, Ws:] >= 0).any() and (ids[Hs:ph] >= 0).any()
    assert ((ids[ph - 1] == ids[ph]) & (ids[ph] >= 0)).any()
    n_moved = 0
    for b in range(B):
        sl = np.s_[b * ph:b * ph + Hs, :Ws]
        texc = np.stack([tu.numpy()[sl], tv.numpy()[sl]], -1)
        want = np.asarray(jmip.lod_from_texc(jnp.asarray(texc),
                                             jnp.asarray(ids[sl]), th, tw))
        np.testing.assert_allclose(lam[sl], want, rtol=1e-6, atol=1e-6)
        n_moved += int((np.abs(unmasked[sl] - want) > 1e-3).sum())
    assert n_moved > 0       # without the masks the edges would differ


# ------------------------------------------------------- the Function ----

def test_mip_function_derives_the_lod_in_k8(rng):
    """The mip Function's forward goes through ``mip_sample_lod``:
    ``mip.lod_fused`` counts every stacked pixel, and the colour and LOD it
    keeps for K9 equal ``lod_from_texc`` then ``mip_sample_plain`` bit for
    bit, on three samples with padding rows and columns, missed pixels and
    a local id that two samples share across their seam."""
    B, Hs, Ws = 3, 20, 100
    _, ph, (data_b, aux_b, bins) = _lod_scene(rng, B, Hs, Ws)
    tex = torch.as_tensor(rng.uniform(size=(64, 128, 1)).astype(np.float32))
    pyr, sizes = tmip.mip_pyramid(tex, 6)
    with profiling.recording() as log:
        _, aa = RasterizeTextured.apply(
            data_b.requires_grad_(True), aux_b, pyr, bins, ph, Hs, Ws, "mip",
            sizes)
    idbuf, _, payload, _, colour, _, lam = aa.grad_fn.saved_tensors
    rows, pw = idbuf.shape
    ids = idbuf.numpy()
    assert ph > Hs and pw > Ws and (ids == -1).any() and (ids >= 0).any()
    assert any(((ids[b * ph - 1] == ids[b * ph]) & (ids[b * ph] >= 0)).any()
               for b in range(1, B))
    assert log.counters["mip.lod_fused"] == rows * pw == B * ph * pw
    want = tmc.lod_from_texc(payload[3], payload[4], idbuf, 64, 128, Hs, Ws,
                             ph)
    assert torch.equal(lam, want)
    assert torch.equal(colour, tmc.mip_sample_plain(pyr, sizes, payload[3],
                                                    payload[4], want))
    assert tmc.mip_sample.launches == 0


def test_mip_function_backward_matches_autograd_of_plain_forward(rng):
    B, Hs, Ws = 2, 40, 100
    verts, faces, uv, fn = quads_scene(rng)
    pc = clip_batch(verts, rng, B)
    tex = torch.as_tensor(rng.uniform(size=(64, 64, 2)).astype(np.float32))
    t = {k: torch.as_tensor(v) for k, v in
         dict(pc=pc, faces=faces, uv=uv * 4.0, fn=fn).items()}
    aux = tr.aux_records(t["uv"], t["faces"], t["pc"], t["faces"], t["fn"],
                         Hs, Ws)
    data_b, aux_b, bins = tr.bin_scene_stacked(t["pc"], t["faces"], Hs, Ws,
                                               aux)
    ph, pw = tr.pad_resolution(Hs, Ws)
    k1 = tr.fused_raster(bins, None, B * ph, pw)
    lam = tmip.lod_from_texc(k1[2][3], k1[2][4], k1[0], 64, 64, Hs, Ws, ph)
    assert float(lam[k1[0] >= 0].max()) > 1.0        # minified: mip levels
    R = torch.as_tensor(rng.normal(size=(2, B * ph, pw)).astype(np.float32))
    grads = []
    for use_function in (True, False):
        d, a, tx = (x.detach().clone().requires_grad_(True)
                    for x in (data_b, aux_b, tex))
        pyr, sizes = tmip.mip_pyramid(tx, 6)
        if use_function:
            idbuf, aa = RasterizeTextured.apply(d, a, pyr, bins, ph, Hs, Ws,
                                                "mip", sizes)
            assert torch.equal(idbuf, k1[0])
        else:
            aa = reference_forward(
                d, a, bins, k1, Hs, Ws, ph,
                lambda tu, tv: tmc.mip_sample_plain(pyr, sizes, tu, tv, lam))
        (aa * R).sum().backward()
        grads.append((aa.detach(), d.grad, a.grad, tx.grad))
    (aa0, *g0), (aa1, *g1) = grads
    torch.testing.assert_close(aa0, aa1, atol=1e-6, rtol=0)
    for got, want in zip(g0, g1):
        close_to_max(got.numpy(), want.numpy(), 1e-5)
    assert float(g0[1][..., 6:12].abs().max()) > 0   # screen corners


# ----------------------------------------------------------- the step ----

def _workloads(monkeypatch, grid):
    """bench.py's workload with ``FPC_BENCH_MIP=1`` and the port's, on a
    batch of camera 0 (frames 1 and 3): camera 1 sees the dome's diagonals
    through pixel centres, where the scan rasterizer and K1 break the tie
    differently, and camera 2 the grid-3 dome's apex at two depths equal
    to float32 precision, where the antialias picks either occluder."""
    import bench

    for k, v in dict(CPU="1", RES_H=H, RES_W=W, GRID=grid, BATCH=BATCH,
                     TEX=TEX, IMPL="scan", MIP="1").items():
        monkeypatch.setenv(f"FPC_BENCH_{k}", str(v))
    jw = bench.build_workload()
    jw["config"] = dataclasses.replace(jw["config"], raster_impl="scan",
                                       aa_max_pairs=-1)
    tw = build_workload(H, W, grid=grid, batch=BATCH, tex_size=TEX, mip=True,
                        device="cpu")
    assert jw["config"].enable_mip and tw["config"].enable_mip
    assert jw["config"].max_mip_level == tw["config"].max_mip_level == 6
    cam, frame = np.array([0, 0]), np.array([1, 3])
    jc, jf = jnp.asarray(cam, jnp.int32), jnp.asarray(frame, jnp.int32)
    jw["batch"] = jloop.Batch(jc, jf, jloop.decode_refs(jw["frames_u8"], jc,
                                                        jf))
    tc, tf = torch.as_tensor(cam), torch.as_tensor(frame)
    tw["batch"] = tloop.Batch(tc, tf, tloop.decode_refs(tw["frames_u8"], tc,
                                                        tf))
    return jw, tw


def _reference_render_batch(config, scene, params, cam_idx, frame_idx):
    """render_from_clip's mip branch per sample, with the scan rasterizer
    in place of K1: finite-difference LOD, the XLA trilinear sampler with
    ``uv_da`` pinning its LOD to that plane, the exact XLA antialias, the
    composite. (``mip_texture_pallas`` is not used here: see
    :func:`test_mip_sampler_on_rendered_uv_follows_xla`.)"""
    th, tw = params["tex"].shape[:2]
    imgs, verts = [], []
    for b in range(cam_idx.shape[0]):
        pc, v3 = jloop.sample_clip_positions(config, scene, params,
                                             cam_idx[b], frame_idx[b])
        rast, texc = rasterize_with_uv(pc, scene.faces, scene.uv,
                                       scene.uv_idx, tuple(config.resolution),
                                       impl="scan")
        lam = jmip.lod_from_texc(jax.lax.stop_gradient(texc),
                                 rast[..., 3].astype(jnp.int32), th, tw)
        uv_da = jnp.zeros(lam.shape + (4,)).at[..., 0].set(2.0 ** lam / tw)
        colour = jtexture.texture(params["tex"], texc, uv_da=uv_da,
                                  filter_mode="linear-mipmap-linear",
                                  max_mip_level=config.max_mip_level)
        colour = jaa.antialias(colour, rast, pc, scene.faces,
                               scene.face_neighbors, max_pairs=None)
        imgs.append(jnp.where(rast[..., 3:] > 0, colour, JBACKGROUND))
        verts.append(v3)
    return jnp.stack(imgs), jnp.stack(verts)


def _rendered_uv(jw, b):
    """(rast, texc, FD LOD) of sample b of the JAX workload's batch."""
    config, scene, params = jw["config"], jw["scene"], jw["params"]
    pc, _ = jloop.sample_clip_positions(config, scene, params,
                                        jw["batch"].cam_idx[b],
                                        jw["batch"].frame_idx[b])
    rast, texc = rasterize_with_uv(pc, scene.faces, scene.uv, scene.uv_idx,
                                   (H, W), impl="scan")
    lam = jmip.lod_from_texc(texc, rast[..., 3].astype(jnp.int32), TEX, TEX)
    return rast, texc, lam


def test_mip_sampler_on_rendered_uv_follows_xla(monkeypatch):
    """On a rendered uv image K8's plain version is the XLA sampler with
    the LOD pinned (1e-6). ``mip_texture_pallas`` departs from both where
    a 128-pixel tile straddles the silhouette: its texel window is placed
    from all the tile's uv, missed pixels' (0, 0) included, and the
    samples that fall outside it are clamped (a VMEM layout artefact the
    port does not copy)."""
    jw, tw = _workloads(monkeypatch, 3)
    tex = jw["params"]["tex"]
    rast, texc, lam = _rendered_uv(jw, 0)
    uv_da = jnp.zeros(lam.shape + (4,)).at[..., 0].set(2.0 ** lam / TEX)
    xla = np.asarray(jtexture.texture(tex, texc, uv_da=uv_da,
                                      filter_mode="linear-mipmap-linear",
                                      max_mip_level=6))[..., 0]
    got = tmip.mip_texture(tw["params"]["tex"], *_planes(np.asarray(texc)),
                           torch.as_tensor(np.array(lam)), 6)[0]
    np.testing.assert_allclose(got.detach().numpy(), xla, rtol=0, atol=1e-6)
    pallas = np.asarray(jmip.mip_texture_pallas(tex, texc, lam, 6,
                                                interpret=True))[..., 0]
    hit = np.asarray(rast[..., 3]) > 0
    assert np.abs(pallas - xla)[hit].max() > 1e-2


@pytest.mark.parametrize("grid,bound", [(3, 1e-3), (5, 0.1)])
def test_mip_step_gradients_match_jax(monkeypatch, grid, bound):
    jw, tw = _workloads(monkeypatch, grid)
    monkeypatch.setattr(jloop, "render_batch", _reference_render_batch)
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


def test_mip_image_against_the_analytic_lod_of_the_cpu_path(monkeypatch):
    """The port's image against ``jloop.render_batch`` on the CPU (scan
    rasterizer, analytic LOD from the barycentric derivatives, XLA
    trilinear sampler), in same-triangle interiors: how far the
    finite-difference LOD that the port shares with the TPU path sits from
    the CPU branch's. ``test_texture_mip_pallas.py``'s pipeline test bounds
    the 0.9, 0.99 quantiles and the largest error by 1e-4, 2e-2 and 0.1 on
    a flat quad; on this dome the 0.9 quantile measures 2.1e-4 (2.2e-4 at
    96x256: it does not fall with resolution), so it is bounded by 3e-4;
    the other two bounds are that test's (measured 4.6e-4 and 6.5e-4)."""
    jw, tw = _workloads(monkeypatch, 5)
    jb, tb = jw["batch"], tw["batch"]
    want = np.asarray(jloop.render_batch(jw["config"], jw["scene"],
                                         jw["params"], jb.cam_idx,
                                         jb.frame_idx)[0])
    got = tloop.render_batch(tw["config"], tw["scene"], tw["params"],
                             tb.cam_idx, tb.frame_idx)[0].numpy()
    pc, _ = tloop.sample_clip_positions(tw["config"], tw["scene"],
                                        tw["params"], tb.cam_idx,
                                        tb.frame_idx)
    sc = tw["scene"]
    _, _, bins = tr.bin_scene_stacked(
        pc, sc.faces, H, W, tr.aux_records(sc.uv, sc.uv_idx, pc, sc.faces,
                                           sc.face_neighbors, H, W))
    ph, pw = tr.pad_resolution(H, W)
    ids = tr.fused_raster(bins, None, BATCH * ph, pw)[0].numpy()
    errs = []
    for b in range(BATCH):
        i = ids[b * ph:b * ph + H, :W]
        c = i[1:-1, 1:-1]
        m = ((c >= 0) & (c == i[:-2, 1:-1]) & (c == i[2:, 1:-1])
             & (c == i[1:-1, :-2]) & (c == i[1:-1, 2:]))
        d = np.abs(got[b, 1:-1, 1:-1, 0] - want[b, 1:-1, 1:-1, 0])
        errs.append(d[m])
    err = np.concatenate(errs)
    assert err.size > 1500
    assert np.quantile(err, 0.9) < 3e-4, np.quantile(err, 0.9)
    assert np.quantile(err, 0.99) < 2e-2, np.quantile(err, 0.99)
    assert err.max() < 0.1, err.max()


def test_mip_train_steps_and_run_fit_on_cpu():
    tw = build_workload(H, W, grid=5, batch=BATCH, tex_size=TEX, mip=True,
                        device="cpu")
    for f in COUNTERS:
        f.launches = 0
    state = tw["state"]
    losses = [float(tloop.train_step(tw["config"], tw["scene"], state,
                                     tw["batch"])["loss"])
              for _ in range(3)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    gen = torch.Generator().manual_seed(0)
    state, metrics = tloop.train_steps(tw["config"], tw["scene"], state,
                                       tw["frames_u8"], gen, 2,
                                       tw["n_frames"])
    assert state.step == 5
    assert all(bool(torch.isfinite(v).all()) for v in metrics.values())
    cfg = dataclasses.replace(tw["config"], steps_per_dispatch=2, seed=1)
    state = tloop.run_fit(cfg, tw["scene"], tw["frames_u8"], tw["n_frames"],
                          n_steps=3)
    assert state.step == 3 and state.params["tex"].shape == cfg.texshape
    metrics = tloop.evaluate(cfg, tw["scene"], state.params, tw["frames_u8"],
                             2, torch.Generator().manual_seed(0))
    assert bool(torch.isfinite(metrics["loss"]).all())
    assert all(f.launches == 0 for f in COUNTERS)
