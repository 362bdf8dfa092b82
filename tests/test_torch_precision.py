"""The gradient-precision modes (``ops.precision``): K5 ``fast``, K4
``fast`` and ``fast2``, against the JAX package.

* K5 ``fast``, plain, against ``pixel_grad_pallas`` in interpret mode with
  ``raster_grad_tpu._GRAD_FAST`` set (JAX's ``FPC_GRAD_PREC=fast``), on the
  scenes of ``test_torch_backward.py`` (JAX sample by sample, as there):
  per-triangle rows within 1e-4 of
  the largest, and all but 0.1 % of them within that test's 1e-5. The two
  packages' f32 coefficients may differ by an ulp, and where one lies next
  to a bf16 rounding boundary they round a bf16 ulp apart (1.5e-5 of the
  largest at most here); the exact rows are ~2.5e-3 of the largest away
  from the fast ones, so the limit tells rounding from none. (One bf16
  rounding of each row's summed magnitude would not: it bounds the whole
  change the mode makes.)
* K4 ``fast`` and ``fast2``, plain, against a numpy transcription of the
  TPU kernel's contractions (``texture_tpu.py:520-540``) with the stated
  operands rounded to bf16 by JAX: gtu, gtv within 1e-6; gtex within 1e-6
  of each texel's summed share magnitudes (f32 sums in another order).
  XLA:CPU ignores ``Precision.DEFAULT``, so the interpreted kernel cannot
  stand in for the TPU here.
* JAX's tripwire (``tests/test_raster_grad_pallas.py``) for each fast mode
  against exact: RMS of the change below 10 % and its largest below 50 %
  of the exact gradient's, and the mode really changes the gradient.
* A backward after ``precision(...)`` has exited takes the forward's mode.
* ``TextureBilinear`` takes its mode to K4; the scan route (its sampler
  ``ops.texture.texture`` too) and K6 ignore the setting (bit-equal), and
  the kernel route's textured render follows it.
* The fit step's gradients on the tiny bench workload under
  ("fast", "fast2") stay within JAX's tripwire of exact.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from fpc_diffrend_tpu.ops.pallas import raster_grad_tpu as rg
from fpc_diffrend_tpu_torch.fit import loop as tloop
from fpc_diffrend_tpu_torch.ops import precision as prec_mod
from fpc_diffrend_tpu_torch.ops.cuda import raster_grad_cuda as tgc
from fpc_diffrend_tpu_torch.ops.cuda import texture_cuda as ttc
from fpc_diffrend_tpu_torch.ops.precision import (get_precision, precision,
                                                  set_precision)
from fpc_diffrend_tpu_torch.ops.rasterize import rasterize
from fpc_diffrend_tpu_torch.ops.texture import texture
from fpc_diffrend_tpu_torch.workload import build_workload

from chip_smoke import k5_planes
from test_torch_backward import SCENES, _jax_rows_per_sample, _scene
from test_torch_render import _port


def _bf16(x):
    """Round to bf16 (nearest even) and back, as the TPU's DEFAULT
    precision takes an operand (JAX's astype)."""
    return np.asarray(jnp.asarray(np.asarray(x, np.float32)).astype(
        jnp.bfloat16).astype(jnp.float32))


def _tripwire(fast, exact):
    """JAX's bounds of a fast gradient against exact (raster_grad_pallas
    test): it changed, RMS of the change < 10 %, largest < 50 %."""
    d, ge = np.asarray(fast, np.float64), np.asarray(exact, np.float64)
    d = d - ge
    assert np.abs(d).max() > 0.0
    assert np.sqrt((d ** 2).mean()) / np.sqrt((ge ** 2).mean()) < 0.10
    assert np.abs(d).max() / np.abs(ge).max() < 0.5


def test_setting_defaults_to_exact_and_restores():
    assert get_precision() == ("exact", "exact")
    with precision(grad="fast", tex="fast2") as p:
        assert p == get_precision() == ("fast", "fast2")
        with precision(tex="exact"):
            assert get_precision() == ("fast", "exact")
        assert get_precision() == ("fast", "fast2")
    assert get_precision() == ("exact", "exact")
    with pytest.raises(ValueError):
        set_precision(grad="fast2")
    with pytest.raises(ValueError):
        set_precision(tex="bf16")
    prev = set_precision(grad="fast")
    try:
        assert prev == ("exact", "exact") and get_precision().grad == "fast"
    finally:
        set_precision(*prev)
    assert prec_mod.GRAD_MODES == ("exact", "fast")
    assert prec_mod.TEX_MODES == ("exact", "fast", "fast2")


# ---------------------------------------------------------------- K5 ----

@pytest.mark.parametrize("B,H,W", SCENES)
def test_k5_fast_matches_pallas_kernel_fast_interpret(rng, B, H, W,
                                                      monkeypatch):
    s = _scene(rng, B, H, W)
    bins = s["bins"]
    _, entry, payload, extra, _ = s["k1"]
    rows, pw = entry.shape
    n = B * s["T"]
    gpl = torch.as_tensor(rng.normal(size=(tgc.N_GPL, rows, pw)).astype(
        np.float32))
    args = (bins, entry, payload[0], payload[1], extra, *k5_planes(gpl))
    fast = tgc.fold_entries(*tgc.pixel_grad(*args, fast=True), bins, n)
    exact = tgc.fold_entries(*tgc.pixel_grad(*args), bins, n)
    assert tgc.pixel_grad.launches == 0

    monkeypatch.setattr(rg, "_GRAD_FAST", True)
    jax.clear_caches()          # the knob is read while tracing
    try:
        # JAX sample by sample: its stacked path shifts the records
        want = _jax_rows_per_sample(s, gpl.numpy(), H, W)
    finally:
        monkeypatch.setattr(rg, "_GRAD_FAST", False)
        jax.clear_caches()      # no fast trace leaks into other tests
    scale = np.abs(want).max()
    err = np.abs(fast.numpy() - want) / scale
    assert err.max() <= 1e-4 and (err > 1e-5).mean() < 1e-3, (
        err.max(), (err > 1e-5).sum())
    # not rounding is more than 10x further off
    assert np.abs(exact.numpy() - want).max() / scale > 10 * err.max()
    _tripwire(fast.numpy(), exact.numpy())


# ---------------------------------------------------------------- K4 ----

def _tpu_contractions(tex, tu, tv, g, mode):
    """The TPU backward's contractions for one pixel at a time, written
    over each pixel's 4x4 texel window (texture_tpu.py:520-540): the hat
    weights wx, wy are 0 but at the two taps, where they are 1 - f and f;
    dwx, dwy are -1 and +1 there. "fast" rounds ``sub`` and ``wx`` of
    ``b = sub @ wx`` and ``b2 = sub @ dwx``; "fast2" also both operands of
    ``gsub = (wy g) x wx``. f32 sums, gtex accumulated in f64.

    :return: (gtex (TH, TW, C) f64, each texel's summed share magnitudes,
        gtu, gtv f32).
    """
    th, tw, C = tex.shape
    f32 = np.float32
    s = tu * f32(tw) - f32(0.5)
    t = tv * f32(th) - f32(0.5)
    s0, t0 = np.floor(s), np.floor(t)
    fs, ft = s - s0, t - t0
    assert (fs > 0).all() and (ft > 0).all()   # dwx, dwy as at the taps
    k = np.arange(-1, 3)
    wx = np.zeros(tu.shape + (4,), f32)
    wx[..., 1], wx[..., 2] = f32(1) - fs, fs
    wy = np.zeros(tu.shape + (4,), f32)
    wy[..., 1], wy[..., 2] = f32(1) - ft, ft
    dw = np.array([0, -1, 1, 0], f32)
    cols = np.mod(s0.astype(np.int64)[..., None] + k, tw)      # (..., 4)
    rws = np.mod(t0.astype(np.int64)[..., None] + k, th)
    sub = tex[rws[..., :, None], cols[..., None, :]]          # (..., 4, 4, C)
    sub = np.moveaxis(sub, -1, 0)                             # (C, ..., 4, 4)
    rx = _bf16(wx)
    rsub = _bf16(sub)
    b = np.sum(rsub * rx[..., None, :], axis=-1, dtype=f32)   # (C, ..., 4)
    b2 = np.sum(rsub * dw, axis=-1, dtype=f32)
    gs = np.sum(np.sum(wy * b2, axis=-1, dtype=f32) * g, axis=0, dtype=f32)
    gt = np.sum(np.sum(dw * b, axis=-1, dtype=f32) * g, axis=0, dtype=f32)
    wyg = wy * g[..., None]                                   # (C, ..., 4)
    if mode == "fast2":
        gsub = _bf16(wyg)[..., :, None] * rx[..., None, :]
    else:
        gsub = wyg[..., :, None] * wx[..., None, :]
    gtex = np.zeros((th, tw, C))
    mag = np.zeros((th, tw, C))
    for c in range(C):
        np.add.at(gtex[..., c], (rws[..., :, None], cols[..., None, :]),
                  gsub[c].astype(np.float64))
        np.add.at(mag[..., c], (rws[..., :, None], cols[..., None, :]),
                  np.abs(gsub[c]).astype(np.float64))
    return gtex, mag, gs * f32(tw), gt * f32(th)


@pytest.mark.parametrize("mode", ["fast", "fast2"])
def test_k4_fast_modes_match_tpu_contractions(rng, mode):
    rows, pw, C = 24, 128, 2
    tex = rng.uniform(size=(16, 16, C)).astype(np.float32)
    tu = rng.uniform(-0.2, 1.2, size=(rows, pw)).astype(np.float32)
    tv = rng.uniform(-0.2, 1.2, size=(rows, pw)).astype(np.float32)
    g = rng.normal(size=(C, rows, pw)).astype(np.float32)
    t = [torch.as_tensor(x) for x in (tex, tu, tv, g)]
    gtex, gtu, gtv = ttc.texture_planes_bwd(*t, "wrap", mode)
    assert ttc.texture_planes_bwd.launches == 0
    wtex, mag, wtu, wtv = _tpu_contractions(tex, tu, tv, g, mode)
    np.testing.assert_allclose(gtu.numpy(), wtu, rtol=0, atol=1e-6)
    np.testing.assert_allclose(gtv.numpy(), wtv, rtol=0, atol=1e-6)
    assert np.all(np.abs(gtex.numpy() - wtex) <= 1e-6 * mag)

    etex, etu, etv = ttc.texture_planes_bwd(*t)
    _tripwire(gtu.numpy(), etu.numpy())
    _tripwire(gtv.numpy(), etv.numpy())
    if mode == "fast":          # the texel gradient stays exact
        assert torch.equal(gtex, etex)
    else:
        _tripwire(gtex.numpy(), etex.numpy())


def test_k4_modes_take_clamp_and_reject_unknown(rng):
    tex = torch.as_tensor(rng.uniform(size=(8, 8, 1)).astype(np.float32))
    tu, tv = (torch.as_tensor(rng.uniform(-0.3, 1.3, size=(8, 128)).astype(
        np.float32)) for _ in range(2))
    g = torch.as_tensor(rng.normal(size=(1, 8, 128)).astype(np.float32))
    exact = ttc.texture_planes_bwd(tex, tu, tv, g, "clamp")
    for mode in ("fast", "fast2"):
        got = ttc.texture_planes_bwd(tex, tu, tv, g, "clamp", mode)
        assert not torch.equal(got[1], exact[1])
        _tripwire(got[1].numpy(), exact[1].numpy())
    with pytest.raises(ValueError):
        ttc.texture_planes_bwd(tex, tu, tv, g, "wrap", "bf16")


# ------------------------------------------------ the modes end to end ----

def _random_scene(rng, n_tris=25):
    """JAX's raster_grad_pallas test scene: random triangles, spread
    depths and w."""
    v = rng.uniform(-1.1, 1.1, size=(n_tris * 3, 2)).astype(np.float32)
    z = rng.uniform(-0.8, 0.8, size=(n_tris * 3, 1)).astype(np.float32)
    w = rng.uniform(0.8, 1.5, size=(n_tris * 3, 1)).astype(np.float32)
    pos = np.concatenate([v * w, z * w, w], axis=1)
    faces = np.arange(n_tris * 3, dtype=np.int32).reshape(n_tris, 3)
    return torch.as_tensor(pos), torch.as_tensor(faces)


def _raster_loss(rast, res):
    wu = torch.linspace(0.3, 1.7, res[0] * res[1]).reshape(res)
    wv = torch.linspace(1.1, 0.2, res[0] * res[1]).reshape(res)
    return ((rast[..., 0] * wu).sum() + (rast[..., 1] * wv).sum()
            + 0.31 * rast[..., 2].sum())


def _raster_grad(pos, faces, res, impl="auto", mode="exact",
                 backward_inside=True):
    p = pos.clone().requires_grad_(True)
    with precision(grad=mode):
        loss = _raster_loss(rasterize(p, faces, res, impl, with_db=False),
                            res)
        if backward_inside:
            loss.backward()
    if not backward_inside:
        loss.backward()
    return p.grad


def test_k5_fast_tripwire_and_forward_mode_reaches_backward(rng):
    pos, faces = _random_scene(rng)
    res = (64, 64)
    exact = _raster_grad(pos, faces, res)
    fast = _raster_grad(pos, faces, res, mode="fast")
    _tripwire(fast.numpy(), exact.numpy())
    after = _raster_grad(pos, faces, res, mode="fast",
                         backward_inside=False)
    assert torch.equal(after, fast)
    # the mode set after the forward does not reach its backward
    p = pos.clone().requires_grad_(True)
    loss = _raster_loss(rasterize(p, faces, res, with_db=False), res)
    with precision(grad="fast"):
        loss.backward()
    assert torch.equal(p.grad, exact)


@pytest.mark.parametrize("mode", ["fast", "fast2"])
def test_texture_bilinear_takes_its_mode_and_texture_ignores_the_setting(
        rng, mode):
    """``TextureBilinear`` runs K4 at the mode it is given; ``texture``,
    the scan route's sampler, gives none (exact), under any setting, as
    JAX's XLA sampler reads no ``FPC_TEX_PREC``."""
    tex = torch.as_tensor(rng.uniform(size=(16, 16, 2)).astype(np.float32))
    uv = torch.as_tensor(rng.uniform(-0.2, 1.2, size=(24, 40, 2)).astype(
        np.float32))
    g = torch.as_tensor(rng.normal(size=(24, 40, 2)).astype(np.float32))

    def grads(sample):
        t, q = tex.clone().requires_grad_(True), uv.clone().requires_grad_(
            True)
        (sample(t, q) * g).sum().backward()
        return t.grad, q.grad

    def bilinear(m):
        return lambda t, q: ttc.TextureBilinear.apply(
            t, q[..., 0].contiguous(), q[..., 1].contiguous(), "wrap",
            m).movedim(0, -1)

    exact = grads(bilinear("exact"))
    fast = grads(bilinear(mode))
    _tripwire(fast[1].numpy(), exact[1].numpy())
    if mode == "fast2":
        _tripwire(fast[0].numpy(), exact[0].numpy())
    else:
        assert torch.equal(fast[0], exact[0])
    with precision("fast", mode):
        inside = grads(texture)
    assert all(torch.equal(a, b) for a, b in zip(inside, exact))


def test_scan_route_and_k6_ignore_the_setting(rng):
    pos, faces = _random_scene(rng, n_tris=12)
    res = (32, 48)
    exact = _raster_grad(pos, faces, res, impl="scan")
    with precision(tex="fast2"):
        fast = _raster_grad(pos, faces, res, impl="scan", mode="fast")
    assert torch.equal(fast, exact)

    # the textured render: the scan route bit-equal under JAX's modes, the
    # kernel route not (the setting reaches it)
    for impl in ("scan", "auto"):
        exact = _port("sepaa", impl=impl)
        with precision("fast", "fast2"):
            fast = _port("sepaa", impl=impl)
        same = [np.array_equal(a, b) for a, b in zip(fast, exact)]
        assert same == ([True] * 3 if impl == "scan" else [True, False,
                                                           False]), impl

    s = _scene(rng, 2, 40, 100)
    _, entry, payload, extra, _ = s["k1"]
    gpl = torch.as_tensor(rng.normal(
        size=(tgc.N_GPL,) + tuple(entry.shape)).astype(np.float32))
    rows = tgc.pixel_grad(s["bins"], entry, payload[0], payload[1], extra,
                          *k5_planes(gpl), fast=True)
    n = 2 * s["T"]
    want = tgc.fold_entries(*rows, s["bins"], n)
    with precision("fast", "fast2"):
        got = tgc.fold_entries(*rows, s["bins"], n)
    assert torch.equal(got, want)
    assert torch.equal(want, tgc.fold_entries_plain(*rows, s["bins"], n))


def test_step_gradients_in_jax_s_default_modes_stay_near_exact():
    wl = build_workload(48, 128, grid=5, batch=2, tex_size=64, device="cpu")
    params = wl["params"]

    def grads(mode):
        for p in params.values():
            p.grad = None
            p.requires_grad_(True)
        with precision(*mode):
            total, _ = tloop.loss_fn(params, wl["config"], wl["scene"],
                                     wl["batch"])
            total.backward()
        return {k: p.grad.clone() for k, p in params.items()
                if p.grad is not None and float(p.grad.abs().max()) > 0}

    exact, fast = grads(("exact", "exact")), grads(("fast", "fast2"))
    assert set(fast) == set(exact) and "tex" in exact
    for k in exact:
        _tripwire(fast[k].numpy(), exact[k].numpy())
