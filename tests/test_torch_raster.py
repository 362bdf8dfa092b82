"""K1's plain version (the fused raster + texture pass) against the JAX package.

Two references:

* the XLA scan path (``ops/rasterize.py`` visibility_scan and
  pixel_attributes, ``ops/interpolate.py``, ``ops/texture.py``), which
  evaluates edges as edge functions times 1/area where K1 evaluates the
  normalized planes a*x + (b*y + c): pixels whose centre lies on an edge
  may resolve differently, so up to 0.2 % of ids may differ (the allowance
  of tests/test_rasterize_pallas.py); values are compared on the pixels
  whose ids agree;
* the Pallas kernel itself in interpret mode on identical bins, where ids
  and entries must be equal (both evaluate the same planes; the TPU kernel
  steps rows incrementally, an ulp of drift, and this scene has no pixel on
  that knife edge).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fpc_diffrend_tpu.ops.interpolate import interpolate
from fpc_diffrend_tpu.ops.pallas import rasterize_tpu as jr
from fpc_diffrend_tpu.ops.rasterize import pixel_attributes, visibility_scan
from fpc_diffrend_tpu.ops.texture import texture
from fpc_diffrend_tpu_torch.ops.cuda import rasterize_cuda as tr

from _torch_scenes import clip_batch, quads_scene

B, H, W = 2, 40, 100


def _render(rng, tex_shape):
    verts, faces, uv, fn = quads_scene(rng)
    pc = clip_batch(verts, rng, B)
    tex = rng.uniform(size=tex_shape).astype(np.float32)
    t = {k: torch.as_tensor(v) for k, v in
         dict(pc=pc, faces=faces, uv=uv, fn=fn, tex=tex).items()}
    aux = tr.aux_records(t["uv"], t["faces"], t["pc"], t["faces"], t["fn"],
                         H, W)
    _, _, bins = tr.bin_scene_stacked(t["pc"], t["faces"], H, W, aux)
    ph, pw = tr.pad_resolution(H, W)
    out = tr.fused_raster(bins, t["tex"], B * ph, pw)
    return (pc, faces, uv, fn, tex, aux, bins), [o.numpy() for o in out]


def test_plain_matches_xla_references(rng):
    (pc, faces, uv, _, tex, _, _), out = _render(rng, (64, 64, 2))
    idbuf, entry, payload, _, colour = out
    ph, _ = tr.pad_resolution(H, W)
    for b in range(B):
        rows = slice(b * ph, b * ph + H)
        ids = idbuf[rows, :W]
        want = np.asarray(visibility_scan(jnp.asarray(pc[b]), faces, H, W))
        mism = ids != want
        assert mism.mean() < 0.002, f"{mism.sum()} ids differ"
        assert (want >= 0).sum() > 1000     # the scene covers the image
        ok = ~mism & (want >= 0)
        u, v, z, _ = pixel_attributes(jnp.asarray(pc[b]), faces,
                                      jnp.asarray(want), H, W)
        # perspective-correct barycentrics from two formulations of the
        # same planes: a few ulp of each term, divided by D ~ 1
        np.testing.assert_allclose(payload[0, rows, :W][ok],
                                   np.asarray(u)[ok], atol=2e-5)
        np.testing.assert_allclose(payload[1, rows, :W][ok],
                                   np.asarray(v)[ok], atol=2e-5)
        np.testing.assert_allclose(payload[2, rows, :W][ok],
                                   np.asarray(z)[ok], atol=1e-5)
        rast = jnp.stack([u, v, z, (jnp.asarray(want) + 1).astype(
            jnp.float32)], axis=-1)
        texc, _ = interpolate(jnp.asarray(uv), rast, jnp.asarray(faces))
        texc = np.asarray(texc)
        # uv in [0, 1]: ulp-level differences of the barycentrics
        np.testing.assert_allclose(payload[3, rows, :W][ok],
                                   texc[..., 0][ok], atol=2e-5)
        np.testing.assert_allclose(payload[4, rows, :W][ok],
                                   texc[..., 1][ok], atol=2e-5)
        # colour: the same bilinear gather at those uv; a 64-texel texture
        # turns a 2e-5 uv difference into ~1e-3 texel, times the texel
        # contrast (< 1)
        col = np.asarray(texture(jnp.asarray(tex), jnp.asarray(texc)))
        np.testing.assert_allclose(colour[:, rows, :W].transpose(1, 2, 0)[ok],
                                   col[ok], atol=2e-3)
        # misses sample uv (0, 0) and carry entry -1
        miss = ids < 0
        assert np.all(entry[rows, :W][miss] == -1)
        np.testing.assert_allclose(
            colour[:, rows, :W].transpose(1, 2, 0)[miss],
            np.broadcast_to(np.asarray(texture(jnp.asarray(tex),
                                               jnp.zeros((1, 2))))[0],
                            (int(miss.sum()), tex.shape[2])), atol=1e-6)


@pytest.mark.slow
def test_plain_matches_pallas_kernel_interpret(rng):
    """K1 plain against _fused_kernel run by the Pallas interpreter on the
    same bins. The 4x64 texture keeps every tile's texel footprint inside
    the TPU sampler's patch (texture_tpu.py clamps larger ones); within it
    the two samplers differ by float rounding of the hat weights."""
    (_, _, _, _, tex, _, bins), out = _render(rng, (4, 64, 1))
    idbuf, entry, payload, extra, colour = out
    ph, pw = tr.pad_resolution(H, W)
    jbins = jr.Bins(
        sorted_rec_t=jnp.asarray(bins.sorted_rec.numpy().T),
        bin_start=jnp.asarray(bins.bin_start.numpy()),
        global_rec_t=jnp.asarray(bins.global_rec.numpy().T),
        n_global=jnp.asarray(bins.n_global.numpy()),
        sorted_tri=jnp.asarray(bins.sorted_tri.numpy()),
        global_idx=jnp.asarray(bins.global_idx.numpy()),
        gblk_ty=jnp.stack([jnp.full((jr.MAX_GLOBAL // jr.CHUNK,), 1 << 20),
                           jnp.full((jr.MAX_GLOBAL // jr.CHUNK,), -1)]
                          ).astype(jnp.int32))
    assert int(bins.n_global[0]) == 0    # the block ranges above are empty
    jid, jpay, jent, jext, jcol = jr.fused_rasterize_from_bins(
        jbins, B * ph, W, interpret=True, padded=True, tex=jnp.asarray(tex))
    np.testing.assert_array_equal(idbuf, np.asarray(jid))
    np.testing.assert_array_equal(entry, np.asarray(jent).astype(np.int32))
    hit = idbuf >= 0
    # payload / extra: identical formulas; the TPU gathers the record with
    # a 3-way bf16 split matmul, exact to ~2^-24 relative
    np.testing.assert_allclose(payload[:, hit], np.asarray(jpay)[:, hit],
                               atol=1e-5)
    np.testing.assert_allclose(extra[:, hit], np.asarray(jext)[:, hit],
                               atol=1e-5)
    np.testing.assert_allclose(colour, np.stack([np.asarray(c)
                                                 for c in jcol]), atol=1e-5)


def test_cpu_call_leaves_launch_counter_and_checks_shapes(rng):
    (_, _, _, _, tex, _, bins), _ = _render(rng, (8, 8, 1))
    assert tr.fused_raster.launches == 0
    ph, pw = tr.pad_resolution(H, W)
    with pytest.raises(ValueError):
        tr.fused_raster(bins, torch.as_tensor(tex), B * ph + 8, pw)
    with pytest.raises(ValueError):
        tr.fused_raster(bins, torch.as_tensor(tex).double(), B * ph, pw)
    with pytest.raises(ValueError):
        tr.fused_raster(bins, torch.as_tensor(tex), B * ph, pw + 1)
