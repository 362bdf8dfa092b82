"""The backward kernels' plain versions (K3-K6) and the render Function
against the JAX package.

Planes come from K1's plain version on stacked quads scenes; cotangents
are numpy draws from a seed. The JAX side runs its Pallas kernels in
interpret mode on identical inputs, or ``jax.vjp`` of its XLA functions.
The port evaluates each sample's records at the sample's own rows, where
JAX's stacked kernels take them shifted into the stacked frame; so the
JAX side of a stacked case runs sample by sample (each a batch of one,
where the two agree), and its results are stacked.

Tolerances:
* K3, 1e-6 absolute (the values are O(1)): the same pair math in the same
  order; what remains is the order XLA sums a vjp's terms in;
* K4, gtu/gtv within 1e-6 relative and 1e-6 times the texture's width
  (height) absolute, as they are a texel slope scaled by that size (one
  pixel's 4 texels); gtex within 1e-5 of its largest value (sums over ~30
  pixels in another order);
* K5 + K6, 1e-5 of the largest per-triangle value: the TPU kernel sums
  pixels with one-hot matmuls of a 3-way bf16 split (exact to ~2^-24 per
  product), the port with index_add_;
* the Function, 1e-5 of the largest value: its K3-K6 backward against
  autograd straight through the plain forward, which rounds each chain
  rule step differently.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from chip_smoke import k5_planes
from fpc_diffrend_tpu.ops import antialias as jaa
from fpc_diffrend_tpu.ops.pallas import antialias_tpu as jat
from fpc_diffrend_tpu.ops.pallas import rasterize_tpu as jr
from fpc_diffrend_tpu.ops.pallas.raster_grad_tpu import pixel_grad_pallas
from fpc_diffrend_tpu.ops.texture import texture as jtexture
from fpc_diffrend_tpu_torch.ops.cuda import antialias_cuda as tac
from fpc_diffrend_tpu_torch.ops.cuda import raster_grad_cuda as tgc
from fpc_diffrend_tpu_torch.ops.cuda import rasterize_cuda as tr
from fpc_diffrend_tpu_torch.ops.cuda import texture_cuda as ttc
from fpc_diffrend_tpu_torch.ops.rasterize import (RasterizeKernel,
                                                  RasterizeTextured)
from fpc_diffrend_tpu_torch.ops.texture import bilinear
from fpc_diffrend_tpu_torch.utils import profiling

from _torch_scenes import (clip_batch, close_to_max, quads_scene,
                          reference_forward)

# (B, H, W): the wide case spills triangles into the global list
SCENES = [(2, 40, 100), (3, 72, 300)]


def _scene(rng, B, H, W, C=1, tex_size=16):
    verts, faces, uv, fn = quads_scene(rng)
    pc = clip_batch(verts, rng, B)
    tex = rng.uniform(size=(tex_size, tex_size, C)).astype(np.float32)
    t = {k: torch.as_tensor(v) for k, v in
         dict(pc=pc, faces=faces, uv=uv, fn=fn, tex=tex).items()}
    aux = tr.aux_records(t["uv"], t["faces"], t["pc"], t["faces"], t["fn"],
                         H, W)
    data_b, aux_b, bins = tr.bin_scene_stacked(t["pc"], t["faces"], H, W,
                                               aux)
    ph, pw = tr.pad_resolution(H, W)
    k1 = tr.fused_raster(bins, t["tex"], B * ph, pw)
    return dict(pc=pc, faces=faces, uv=uv, fn=fn, tex=t["tex"], aux=aux,
                data_b=data_b, aux_b=aux_b, bins=bins, k1=k1, ph=ph, pw=pw,
                T=faces.shape[0])


def _jax_rows_per_sample(s, gpl, H, W):
    """JAX's K5 (``pixel_grad_pallas`` in interpret mode) sample by sample
    of a ``_scene``, each a stacked batch of one on its own bins and on the
    port's planes of that sample rendered alone (equal to its stacked
    planes), with the cotangent planes ``gpl`` (11, B * ph, pw) of its
    rows: the per-triangle rows (B * T, 32), samples in order."""
    ph, T, want = s["ph"], s["T"], []
    faces = torch.as_tensor(s["faces"])
    for b in range(s["pc"].shape[0]):
        r = slice(b * ph, (b + 1) * ph)
        pc = s["pc"][b:b + 1]
        aux_j = jax.vmap(lambda p: jr.aux_records(
            jnp.asarray(s["uv"]), jnp.asarray(s["faces"]), p,
            jnp.asarray(s["faces"]), jnp.asarray(s["fn"]), H, W))(
                jnp.asarray(pc))
        _, _, bins_j = jr.bin_scene_stacked(jnp.asarray(pc),
                                            jnp.asarray(s["faces"]), H, W,
                                            aux_j)
        aux = tr.aux_records(torch.as_tensor(s["uv"]), faces,
                             torch.as_tensor(pc), faces,
                             torch.as_tensor(s["fn"]), H, W)
        _, _, bins = tr.bin_scene_stacked(torch.as_tensor(pc), faces, H, W,
                                          aux)
        np.testing.assert_array_equal(np.asarray(bins_j.sorted_tri),
                                      bins.sorted_tri.numpy())
        _, entry, payload, extra, _ = tr.fused_raster(bins, s["tex"], ph,
                                                      s["pw"])
        assert torch.equal(payload, s["k1"][2][:, r])   # as stacked
        gd, ga = pixel_grad_pallas(
            bins_j, jnp.asarray(entry.numpy().astype(np.float32)),
            jnp.asarray(payload[0].numpy()), jnp.asarray(payload[1].numpy()),
            jnp.asarray(extra.numpy()), jnp.asarray(np.asarray(gpl)[:, r]),
            T, ph, W, pair_cap=bins.sorted_tri.shape[0], interpret=True,
            stacked=True)
        want.append(np.concatenate([np.asarray(gd), np.asarray(ga)], 1))
    return np.concatenate(want)


# ---------------------------------------------------------------- K3 ----

def test_k3_plain_matches_pallas_kernel_interpret_stacked(rng):
    B, H, W = 3, 36, 100
    s = _scene(rng, B, H, W, C=2)
    idbuf, _, payload, _, colour = s["k1"]
    g = rng.normal(size=colour.shape).astype(np.float32)
    gcol, gverts = tac.antialias_planes_bwd(idbuf, payload, colour,
                                            torch.as_tensor(g), H, W,
                                            s["ph"])
    assert tac.antialias_planes_bwd.launches == 0
    assert float(gverts.abs().max()) > 0     # silhouettes carry gradient
    # JAX's kernel sample by sample, each a stacked batch of one
    ph, pw = s["ph"], idbuf.shape[1]
    jcol, jverts = [], []
    for b in range(B):
        r = slice(b * ph, (b + 1) * ph)
        packed = jat._pack_planes(
            tuple(jnp.asarray(c[r].numpy()) for c in colour),
            jnp.asarray(idbuf[r].numpy()), jnp.asarray(payload[:, r].numpy()))
        c, v = jat.aa_planes_bwd_core(packed, jnp.asarray(g[:, r]), H, W, 2,
                                      ph, pw, True, sample_ph=ph)
        jcol.append(np.stack(c))
        jverts.append(np.asarray(v))
    np.testing.assert_allclose(gcol.numpy(), np.concatenate(jcol, 1),
                               atol=1e-6)
    np.testing.assert_allclose(gverts.numpy(), np.concatenate(jverts, 1),
                               atol=1e-6)


def test_k3_plain_matches_vjp_of_xla_antialias_single_image(rng):
    """One unstacked image against jax.vjp of ops/antialias.py
    antialias_fused (every pair, XLA)."""
    H, W = 40, 100
    s = _scene(rng, 1, H, W)
    idbuf, _, payload, _, colour = s["k1"]
    g = np.zeros(colour.shape, np.float32)
    g[:, :H, :W] = rng.normal(size=(colour.shape[0], H, W))
    gcol, gverts = tac.antialias_planes_bwd(idbuf, payload, colour,
                                            torch.as_tensor(g), H, W, H)
    rast = np.stack([payload[0], payload[1], payload[2],
                     idbuf.float() + 1.0], -1)[:H, :W]
    verts = payload[5:11].permute(1, 2, 0)[:H, :W].numpy()
    neigh = payload[11:14].permute(1, 2, 0)[:H, :W].numpy()
    col = colour.permute(1, 2, 0)[:H, :W].numpy()
    _, vjp = jax.vjp(lambda c, v: jaa.antialias_fused(
        c, jnp.asarray(rast), v, jnp.asarray(neigh)), jnp.asarray(col),
        jnp.asarray(verts))
    jcol, jverts = vjp(jnp.asarray(g[:, :H, :W].transpose(1, 2, 0)))
    np.testing.assert_allclose(gcol.permute(1, 2, 0)[:H, :W].numpy(),
                               np.asarray(jcol), atol=1e-6)
    np.testing.assert_allclose(gverts.permute(1, 2, 0)[:H, :W].numpy(),
                               np.asarray(jverts), atol=1e-6)


# ---------------------------------------------------------------- K4 ----

def test_k4_plain_matches_vjp_of_xla_texture(rng):
    """Wrap-mode gtex, gtu, gtv against jax.vjp of ops/texture.py, with
    samples across the seams and missed pixels at uv (0, 0)."""
    rows, pw, C = 24, 128, 2
    tex = rng.uniform(size=(16, 32, C)).astype(np.float32)
    tu = rng.uniform(-0.2, 1.2, size=(rows, pw)).astype(np.float32)
    tv = rng.uniform(-0.2, 1.2, size=(rows, pw)).astype(np.float32)
    tu[:, :8] = rng.uniform(0.97, 1.03, size=(rows, 8))     # the seams
    tv[:4] = rng.uniform(-0.03, 0.03, size=(4, pw))
    tu[-4:], tv[-4:] = 0.0, 0.0                              # misses
    g = rng.normal(size=(C, rows, pw)).astype(np.float32)
    g[:, 10:12] = 0.0                                        # dead pixels
    gtex, gtu, gtv = ttc.texture_planes_bwd(
        torch.as_tensor(tex), torch.as_tensor(tu), torch.as_tensor(tv),
        torch.as_tensor(g))
    assert ttc.texture_planes_bwd.launches == 0
    uv = jnp.stack([jnp.asarray(tu), jnp.asarray(tv)], -1)
    _, vjp = jax.vjp(lambda t, q: jtexture(t, q, boundary_mode="wrap"),
                     jnp.asarray(tex), uv)
    jtex, juv = vjp(jnp.asarray(g.transpose(1, 2, 0)))
    close_to_max(gtex.numpy(), jtex, 1e-5)
    np.testing.assert_allclose(gtu.numpy(), np.asarray(juv[..., 0]),
                               atol=1e-6 * 32, rtol=1e-6)
    np.testing.assert_allclose(gtv.numpy(), np.asarray(juv[..., 1]),
                               atol=1e-6 * 16, rtol=1e-6)
    assert np.all(gtu.numpy()[10:12] == 0) and np.all(gtex.numpy()[0, 0])


def test_k4_plain_matches_autograd_of_the_forward_sampler(rng):
    """The explicit backward equals autograd of ops.texture.bilinear."""
    tex = torch.as_tensor(rng.uniform(size=(8, 8, 1)).astype(np.float32))
    tu = torch.as_tensor(rng.uniform(-1, 2, size=(8, 128)).astype(
        np.float32))
    tv = torch.as_tensor(rng.uniform(-1, 2, size=(8, 128)).astype(
        np.float32))
    g = torch.as_tensor(rng.normal(size=(1, 8, 128)).astype(np.float32))
    gtex, gtu, gtv = ttc.texture_planes_bwd(tex, tu, tv, g)
    t, u, v = (x.clone().requires_grad_(True) for x in (tex, tu, tv))
    (bilinear(t, u, v, "wrap").movedim(-1, 0) * g).sum().backward()
    torch.testing.assert_close(gtex, t.grad, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(gtu, u.grad, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(gtv, v.grad, atol=1e-5, rtol=1e-5)


# ----------------------------------------------------------- K5 + K6 ----

@pytest.mark.parametrize("B,H,W", SCENES)
def test_k5_k6_plain_match_pallas_kernel_interpret(rng, B, H, W):
    """Per-triangle rows against pixel_grad_pallas in interpret mode on
    bins made from the same clip positions (bit-equal to the port's), the
    wide scene through the global list; JAX sample by sample."""
    s = _scene(rng, B, H, W)
    bins = s["bins"]
    _, entry, payload, extra, _ = s["k1"]
    rows, pw = entry.shape
    gpl = rng.normal(size=(tgc.N_GPL, rows, pw)).astype(np.float32)
    ge, gg = tgc.pixel_grad(bins, entry, payload[0], payload[1], extra,
                            *k5_planes(torch.as_tensor(gpl)))
    grad = tgc.fold_entries(ge, gg, bins, B * s["T"]).numpy()
    assert tgc.pixel_grad.launches == tgc.fold_entries.launches == 0
    if W > 256:
        assert int(bins.n_global[0]) > 0
        assert float(gg.abs().max()) > 0     # global winners have rows

    close_to_max(grad, _jax_rows_per_sample(s, gpl, H, W), 1e-5)
    assert np.all(grad[:, [12, 28, 29, 30, 31]] == 0)


def test_k5_rows_hold_only_their_own_pixels(rng):
    """A pixel adds to its winner entry only: a triangle's entry rows sum
    the coefficients of exactly the pixels K1 gave it, so a pixel of a
    global triangle's box that K1 did not give it adds nothing to it."""
    B, H, W = 3, 72, 300
    s = _scene(rng, B, H, W)
    bins = s["bins"]
    _, entry, payload, extra, _ = s["k1"]
    rows, pw = entry.shape
    gpl = torch.as_tensor(rng.normal(size=(tgc.N_GPL, rows, pw)).astype(
        np.float32))
    _, gg = tgc.pixel_grad(bins, entry, payload[0], payload[1], extra,
                           *k5_planes(gpl))
    x = torch.arange(pw, dtype=torch.float32) + 0.5
    # each pixel at its row within its sample, as K1 and K5 evaluate it
    y = (torch.remainder(torch.arange(rows), s["ph"]).to(torch.float32)
         + 0.5)[:, None]
    coeff = tgc.coefficient_planes(payload[0], payload[1], extra,
                                   *k5_planes(gpl), x, y)
    for g in range(int(bins.n_global[0])):
        mine = coeff[:, entry == bins.gbase + g]
        # sums of ~1e3 pixels in another order: 1e-5 of their magnitude
        err = (gg[g] - mine.sum(dim=1)).abs()
        assert bool(torch.all(err <= 1e-5 * mine.abs().sum(dim=1))), g
    assert int(bins.n_global[0]) > 0


def _k5_inputs(rng, B=3, H=40, W=100):
    """A stacked scene's K5 arguments up to the cotangents, and random
    cotangent planes (gtu, gtv, gcorners, guvz), each a tensor of its own."""
    s = _scene(rng, B, H, W)
    _, entry, payload, extra, _ = s["k1"]
    gpl = torch.as_tensor(rng.normal(
        size=(tgc.N_GPL,) + tuple(entry.shape)).astype(np.float32))
    return ((s["bins"], entry, payload[0], payload[1], extra),
            tuple(p.clone() for p in k5_planes(gpl)))


def _bits_equal(got, want):
    """K5's outputs (grad_entries, grad_global) equal bit for bit."""
    return all(torch.equal(a.view(torch.int32), b.view(torch.int32))
               for a, b in zip(got, want))


def _stacked_pixel_grad(bins, entry, u, v, extra, gpl, fast):
    """K5's plain version as it read one (11, rows, pw) stack ``gpl`` of
    cotangents, plane k that of payload plane k: the layout the backward
    built with ``torch.cat`` before K5 read its planes in place (the
    coefficients of raster_grad_tpu.py :286-310, operand for operand)."""
    rows, pw = entry.shape
    x = torch.arange(pw, dtype=torch.float32) + 0.5
    y = (torch.remainder(torch.arange(rows), bins.sample_ph)
         .to(torch.float32) + 0.5)[:, None]
    D, iw0, iw1, iw2, du02, du12, dv02, dv12 = extra
    gz, gtu, gtv = gpl[2], gpl[3], gpl[4]
    d0 = u * D
    d1 = v * D
    d2 = (D - d0) - d1
    gu = (gpl[0] + gtu * du02) + gtv * dv02
    gv = (gpl[1] + gtu * du12) + gtv * dv12
    rD = 1.0 / torch.where(torch.abs(D) > 1e-12, D, 1.0)
    S = ((gu * d0 + gv * d1) * rD) * rD
    gd0, gd1, gd2 = gu * rD - S, gv * rD - S, -S
    gl0, gl1, gl2 = gd0 * iw0, gd1 * iw1, gd2 * iw2
    wp = (1.0 - u) - v
    zero = torch.zeros_like(u)
    planes = [gl0 * x, gl0 * y, gl0, gl1 * x, gl1 * y, gl1,
              gl2 * x, gl2 * y, gl2, gz * x, gz * y, gz, zero,
              -gd0 * d0 * iw0, -gd1 * d1 * iw1, -gd2 * d2 * iw2,
              gtu * u, gtv * u, gtu * v, gtv * v, gtu * wp, gtv * wp,
              *gpl[5:11], zero, zero, zero, zero]
    coeff = torch.stack([p.expand_as(u) for p in planes])
    if fast:
        coeff = coeff.to(torch.bfloat16).float()
    coeff = coeff.reshape(tgc.REC, -1).T
    e = entry.reshape(-1).long()
    ent = torch.zeros((bins.gbase, tgc.REC))
    glob = torch.zeros((tgc.MAX_GLOBAL, tgc.REC))
    binned = (e >= 0) & (e < bins.gbase)
    ent.index_add_(0, e[binned], coeff[binned])
    ge = e >= bins.gbase
    glob.index_add_(0, e[ge] - bins.gbase, coeff[ge])
    return ent, glob


@pytest.mark.parametrize("fast", [False, True])
def test_k5_without_uvz_equals_zero_planes(rng, fast):
    """``guvz`` None: K5 (plain, on the CPU) equals the same call on
    explicit zero u, v, z planes bit for bit, exact and fast; only the call
    without them counts its stacked pixels on ``k5.uvz_skipped``."""
    args, (gtu, gtv, gcorners, _) = _k5_inputs(rng)
    zeros = torch.zeros((3,) + tuple(gtu.shape))
    with profiling.recording() as log:
        skip = tgc.pixel_grad(*args, gtu, gtv, gcorners, fast=fast)
    with profiling.recording() as log_fed:
        fed = tgc.pixel_grad(*args, gtu, gtv, gcorners, zeros, fast)
    assert _bits_equal(skip, fed)
    assert float(skip[0].abs().max()) > 0
    assert log.counters == {"k5.uvz_skipped": gtu.numel()}
    assert log_fed.counters == {}


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("uvz", ["live", "none"])
def test_k5_split_planes_equal_the_stacked_layout(rng, uvz, fast):
    """K5 on its cotangent planes where they lie equals, bit for bit, K5 on
    the stack the backward built before (``torch.cat`` of the u, v, z
    planes, zero where there are none, gtu, gtv and the corners), in the
    formula as it read that stack; exact and fast."""
    args, (gtu, gtv, gcorners, guvz) = _k5_inputs(rng)
    if uvz == "none":
        guvz = None
    stack = torch.cat([torch.zeros((3,) + tuple(gtu.shape))
                       if guvz is None else guvz,
                       gtu[None], gtv[None], gcorners])
    got = tgc.pixel_grad(*args, gtu, gtv, gcorners, guvz, fast)
    assert _bits_equal(got, _stacked_pixel_grad(*args, stack, fast))
    if int(args[0].n_global[0]):
        assert float(got[1].abs().max()) > 0


@pytest.mark.parametrize("bad", ["non_contiguous", "five_planes", "one_plane",
                                 "guvz_non_contiguous"])
def test_k5_rejects_cotangent_planes_it_cannot_read_in_place(rng, bad):
    """K5 reads each plane where it lies, so it takes only contiguous
    float32 planes of its shape (gcorners (6, rows, pw), guvz (3, rows,
    pw)) and copies none: anything else raises."""
    args, (gtu, gtv, gcorners, guvz) = _k5_inputs(rng, B=2)
    rows, pw = gtu.shape
    if bad == "non_contiguous":
        gcorners = torch.zeros((6, pw, rows)).transpose(1, 2)
    elif bad == "five_planes":
        gcorners = gcorners[:5]
    elif bad == "one_plane":
        gcorners = gcorners[0]
    else:
        guvz = torch.zeros((3, pw, rows)).transpose(1, 2)
    with pytest.raises(ValueError):
        tgc.pixel_grad(*args, gtu, gtv, gcorners, guvz)


def test_k5_uvz_skipped_counts_the_textured_backward_only(rng):
    """Recorded on the CPU: the textured stacked pass's backward, whose u,
    v and z never leave it, counts every stacked pixel on
    ``k5.uvz_skipped``; ``RasterizeKernel``'s, whose u, v, z cotangents
    are live, counts none."""
    B, H, W = 3, 40, 100
    s = _scene(rng, B, H, W)
    ph, pw = s["ph"], s["pw"]
    R = torch.as_tensor(rng.normal(size=(14, B * ph, pw)).astype(np.float32))
    d, a = (x.detach().clone().requires_grad_(True)
            for x in (s["data_b"], s["aux_b"]))
    with profiling.recording() as textured:
        _, aa = RasterizeTextured.apply(d, a, s["tex"], s["bins"], ph, H, W)
        (aa * R[:1]).sum().backward()
    with profiling.recording() as kernel:
        _, payload = RasterizeKernel.apply(d, a, s["bins"], ph, H, W)
        (payload * R).sum().backward()
    assert textured.counters == {"k5.uvz_skipped": B * ph * pw}
    assert kernel.counters == {}
    assert float(d.grad.abs().max()) > 0


# ----------------------------------------------------- the Function ----

@pytest.mark.parametrize("B,H,W", SCENES)
def test_function_backward_matches_autograd_of_plain_forward(rng, B, H, W):
    s = _scene(rng, B, H, W, C=2)
    ph, bins = s["ph"], s["bins"]
    R = torch.as_tensor(rng.normal(size=(2, B * ph, s["pw"])).astype(
        np.float32))
    grads = []
    for use_function in (True, False):
        d, a, t = (x.detach().clone().requires_grad_(True)
                   for x in (s["data_b"], s["aux_b"], s["tex"]))
        if use_function:
            idbuf, aa = RasterizeTextured.apply(d, a, t, bins, ph, H, W)
            assert torch.equal(idbuf, s["k1"][0])
        else:
            aa = reference_forward(
                d, a, bins, s["k1"], H, W, ph,
                lambda tu, tv: bilinear(t, tu, tv, "wrap").movedim(-1, 0))
        (aa * R).sum().backward()
        grads.append((aa.detach(), d.grad, a.grad, t.grad))
    (aa0, *g0), (aa1, *g1) = grads
    assert torch.equal(aa0, aa1)
    for got, want in zip(g0, g1):
        close_to_max(got.numpy(), want.numpy(), 1e-5)
    assert float(g0[1][..., 6:12].abs().max()) > 0   # screen corners


def test_function_texture_gradient_matches_finite_differences(rng):
    """The loss is linear in the texture, so central differences in float32
    are exact to rounding: a few texels, 1e-3 relative (each difference
    of two ~1e2 sums divided by 2h = 0.2 loses ~1e-5 absolute)."""
    B, H, W = 2, 40, 100
    s = _scene(rng, B, H, W)
    R = torch.as_tensor(rng.normal(size=(1, B * s["ph"], s["pw"])).astype(
        np.float32))

    def loss(tex):
        _, aa = RasterizeTextured.apply(
            s["data_b"].detach(), s["aux_b"].detach(), tex, s["bins"],
            s["ph"], H, W)
        return (aa.double() * R.double()).sum()

    tex = s["tex"].clone().requires_grad_(True)
    loss(tex).backward()
    h = 0.1
    flat = tex.grad.reshape(-1)
    for i in np.argsort(-np.abs(flat.numpy()))[:4]:
        e = torch.zeros_like(flat)
        e[i] = h
        e = e.reshape(tex.shape)
        with torch.no_grad():
            fd = (loss(s["tex"] + e) - loss(s["tex"] - e)) / (2 * h)
        np.testing.assert_allclose(float(flat[i]), float(fd), rtol=1e-3)


def test_cpu_calls_leave_counters_and_check_shapes(rng):
    s = _scene(rng, 2, 16, 40)
    idbuf, entry, payload, extra, colour = s["k1"]
    g = torch.zeros_like(colour)
    with pytest.raises(ValueError):
        tac.antialias_planes_bwd(idbuf, payload, colour, g[:, :8], 16, 40,
                                 16)
    with pytest.raises(ValueError):
        ttc.texture_planes_bwd(s["tex"], payload[3], payload[4],
                               g.double())
    gpl = torch.zeros((tgc.N_GPL,) + entry.shape)
    with pytest.raises(ValueError):
        tgc.pixel_grad(s["bins"], entry.long(), payload[0], payload[1],
                       extra, *k5_planes(gpl))
    ge, gg = tgc.pixel_grad(s["bins"], entry, payload[0], payload[1], extra,
                            *k5_planes(gpl))
    with pytest.raises(ValueError):
        tgc.fold_entries(ge[:-1], gg, s["bins"], 2 * s["T"])
    assert (tac.antialias_planes_bwd.launches, ttc.texture_planes_bwd.launches,
            tgc.pixel_grad.launches, tgc.fold_entries.launches) == (0,) * 4
