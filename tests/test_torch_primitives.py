"""The port's nvdiffrast-style primitives against the JAX package.

``ops.rasterize`` (``visibility_scan``, ``pixel_attributes``,
``_pixel_db_from_data``, ``rasterize``, ``rasterize_with_uv`` on the scan
and the kernel route), ``ops.interpolate.interpolate``,
``ops.antialias.antialias`` (every pair through K2/K3's route, and the
pair-capped ``_antialias_compact``) and ``ops.pipeline._bary_db_to_uv_da``,
on the CPU (each kernel's plain version), with the same seeded numpy
inputs on both sides. Tolerances:

* the scan route evaluates JAX's formulas in JAX's order: ids exactly,
  planes and derivatives within 1e-6;
* the kernel route resolves visibility from K1's normalised planes, which
  round differently at coverage edges: its ids agree with JAX's scan on
  >= 99.8 % of pixels (``tests/test_rasterize_pallas.py``'s allowance);
  its gradient (K5 -> K6, the cotangents of u, v, z and the uv live, then
  the records' autograd) agrees with ``jax.vjp`` of ``pixel_attributes`` /
  ``interpolate`` on the kernel route's own ids within 1e-5 of the largest
  magnitude: the same function of the clip positions in another formula;
* interpolate, ``_bary_db_to_uv_da`` and the antialias forward within
  1e-6, their gradients within 1e-5 of the largest magnitude (the scatter
  sums of a gather's backward add in another order).

The behaviour tests of ``tests/test_rasterize.py`` and
``tests/test_shading.py`` run on both routes.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import fpc_diffrend_tpu.ops.rasterize as jr
from fpc_diffrend_tpu.data.obj import build_topology
from fpc_diffrend_tpu.ops import antialias as jaa
from fpc_diffrend_tpu.ops.interpolate import interpolate as jinterpolate
from fpc_diffrend_tpu.ops.pipeline import _bary_db_to_uv_da as jbary_uv_da
from fpc_diffrend_tpu_torch.ops import antialias as taa
from fpc_diffrend_tpu_torch.ops import rasterize as tr
from fpc_diffrend_tpu_torch.ops.cuda import antialias_cuda as tac
from fpc_diffrend_tpu_torch.ops.cuda import rasterize_cuda as trc
from fpc_diffrend_tpu_torch.ops.interpolate import interpolate
from fpc_diffrend_tpu_torch.ops.pipeline import _bary_db_to_uv_da, render
from fpc_diffrend_tpu_torch.ops.texture import texture

from _torch_scenes import clip_batch, close_to_max, quads_scene
from test_pipeline_fused import scene as dome_scene

H, W = 40, 100
EXACT_ATOL = 1e-6
GRAD_RTOL = 1e-5
ROUTES = ("scan", "auto")


def _t(x):
    return torch.as_tensor(np.array(x))


def _quads(seed=0):
    """(pos_clip (V, 4), faces, uv, face_neighbors) of one perspective
    sample of the overlapping quads."""
    rng = np.random.default_rng(seed)
    verts, faces, uv, fn = quads_scene(rng)
    return clip_batch(verts, rng, 1)[0], faces, uv, fn


def _dome(res=(48, 128)):
    """The 9x9 dome of ``tests/test_pipeline_fused.py`` in clip space."""
    mvp, verts, faces, uv, uv_idx, fn = (np.array(x) for x in dome_scene(
        np.random.default_rng(0)))
    pc = np.concatenate([verts, np.ones((len(verts), 1), np.float32)],
                        1) @ mvp.T
    return pc.astype(np.float32), faces, uv, uv_idx, fn


SCENES = {"quads": lambda: _quads()[:2] + ((H, W),),
          "dome": lambda: _dome()[:2] + ((48, 128),)}


@pytest.mark.parametrize("name", SCENES)
def test_scan_matches_jax(name):
    """visibility_scan ids exactly; pixel_attributes' u, v, z, mask and
    derivatives within 1e-6; rasterize(impl="scan") is their stack."""
    pc, faces, (h, w) = SCENES[name]()
    ids = tr.visibility_scan(_t(pc), _t(faces), h, w)
    want = np.asarray(jr.visibility_scan(jnp.asarray(pc), faces, h, w))
    np.testing.assert_array_equal(ids.numpy(), want)
    assert (want >= 0).mean() > 0.3
    got = tr.pixel_attributes(_t(pc), _t(faces), ids, h, w, with_db=True)
    ref = jr.pixel_attributes(jnp.asarray(pc), faces, want, h, w,
                              with_db=True)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=EXACT_ATOL)
    rast, db = tr.rasterize(_t(pc), _t(faces), (h, w), impl="scan")
    jrast, jdb = jr.rasterize(jnp.asarray(pc), faces, (h, w), impl="scan")
    np.testing.assert_allclose(rast.numpy(), np.asarray(jrast), rtol=0,
                               atol=EXACT_ATOL)
    np.testing.assert_allclose(db.numpy(), np.asarray(jdb), rtol=0,
                               atol=EXACT_ATOL)


@pytest.mark.parametrize("name", SCENES)
def test_kernel_route_ids_match_jax_scan(name):
    """rasterize(impl="auto"): K11's bins and K1 at B = 1; its ids agree
    with JAX's scan on >= 99.8 % of pixels, and u, v, z with it within
    1e-5 where they agree."""
    pc, faces, (h, w) = SCENES[name]()
    before = trc.fused_raster.launches
    rast = tr.rasterize(_t(pc), _t(faces), (h, w), with_db=False)
    assert trc.fused_raster.launches == before      # plain version on CPU
    jrast = np.asarray(jr.rasterize(jnp.asarray(pc), faces, (h, w),
                                    impl="scan", with_db=False))
    agree = rast[..., 3].numpy() == jrast[..., 3]
    assert agree.mean() >= 0.998, f"{(~agree).sum()} ids differ"
    np.testing.assert_allclose(rast.numpy()[agree][:, :3],
                               jrast[agree][:, :3], rtol=0, atol=1e-5)
    assert tr.rasterize(_t(pc), _t(faces), (h, w), impl="pallas",
                        with_db=False).equal(rast)
    with pytest.raises(ValueError, match="bogus"):
        tr.rasterize(_t(pc), _t(faces), (h, w), impl="bogus")


def _jax_attributes(pc, faces, uv, uv_idx, ids, h, w):
    """fn(pos_clip, uv) -> (rast[..., :3], rast_db, texc) of JAX's
    pixel_attributes and interpolate on fixed ids."""
    idf = jnp.where(ids >= 0, (ids + 1).astype(jnp.float32), 0.0)

    def fn(p, q):
        u, v, z, _, db = jr.pixel_attributes(p, faces, ids, h, w,
                                             with_db=True)
        rast = jnp.stack([u, v, z, idf], axis=-1)
        return rast[..., :3], db, jinterpolate(q, rast, uv_idx)[0]

    return fn


@pytest.mark.parametrize("name", ["quads", "dome"])
def test_kernel_route_gradient_matches_jax_vjp(name):
    """The kernel route's backward (K5 with live gu, gv, gz planes and
    gtu, gtv, then K6 and the records' autograd; the derivatives through
    ``_pixel_db_from_data``'s record gather) against ``jax.vjp`` of
    ``pixel_attributes`` and ``interpolate`` on the kernel route's own
    ids: the forward within 1e-5, the gradients to the clip positions and
    the uv within 1e-5 of their largest magnitude."""
    if name == "quads":
        pc, faces, uv, _ = _quads(3)
        uv_idx, (h, w) = faces, (H, W)
    else:
        pc, faces, uv, uv_idx, _ = _dome()
        h, w = 48, 128
    rng = np.random.default_rng(5)
    g_rast = rng.normal(size=(h, w, 3)).astype(np.float32)
    g_db = rng.normal(size=(h, w, 4)).astype(np.float32)
    g_texc = rng.normal(size=(h, w, 2)).astype(np.float32)

    p = _t(pc).requires_grad_(True)
    q = _t(uv).requires_grad_(True)
    rast, texc = tr.rasterize_with_uv(p, _t(faces), q, _t(uv_idx), (h, w))
    rast2, db = tr.rasterize(p, _t(faces), (h, w))
    assert rast2.equal(rast)
    ids = rast[..., 3].detach().numpy().astype(np.int32) - 1
    loss = ((rast[..., :3] * _t(g_rast)).sum() + (db * _t(g_db)).sum()
            + (texc * _t(g_texc)).sum())
    loss.backward()

    fn = _jax_attributes(pc, faces, uv, uv_idx, jnp.asarray(ids), h, w)
    (j_rast, j_db, j_texc), vjp = jax.vjp(fn, jnp.asarray(pc),
                                          jnp.asarray(uv))
    for a, b in ((rast[..., :3], j_rast), (db, j_db), (texc, j_texc)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=0, atol=1e-5)
    gp, gq = vjp((jnp.asarray(g_rast), jnp.asarray(g_db),
                  jnp.asarray(g_texc)))
    close_to_max(p.grad.numpy(), gp, GRAD_RTOL)
    close_to_max(q.grad.numpy(), gq, GRAD_RTOL)
    assert np.abs(np.asarray(gp)[:, :3]).max() > 0


@pytest.mark.parametrize("route", ROUTES)
def test_rast_db_matches_jax_on_each_route(route):
    """rast_db on the scan route equals JAX's within 1e-6; on the kernel
    route ``_pixel_db_from_data`` of the records equals JAX's on the same
    ids within 1e-5 (JAX's records from its own triangle setup); both
    match neighbour differences of u (``tests/test_rasterize.py``)."""
    pc, faces, _, _ = _quads(1)
    rast, db = tr.rasterize(_t(pc), _t(faces), (H, W), impl=route)
    ids = rast[..., 3].numpy().astype(np.int32) - 1
    if route == "scan":
        _, want = jr.rasterize(jnp.asarray(pc), faces, (H, W), impl="scan")
        atol = EXACT_ATOL
    else:
        from fpc_diffrend_tpu.ops.pallas import rasterize_tpu as jrt

        data, _, _ = jrt.triangle_setup(jnp.asarray(pc), jnp.asarray(faces),
                                        H, W)
        want = jr._pixel_db_from_data(data, jnp.asarray(ids), H, W)
        atol = 1e-5
    np.testing.assert_allclose(db.numpy(), np.asarray(want), rtol=0,
                               atol=atol)
    u = rast[..., 0].numpy()
    inside = (ids[:, :-1] == ids[:, 1:]) & (ids[:, 1:] >= 0)
    pred = 0.5 * (db[:, 1:, 0] + db[:, :-1, 0]).numpy()
    np.testing.assert_allclose((u[:, 1:] - u[:, :-1])[inside], pred[inside],
                               atol=1e-3)


def test_interpolate_matches_jax(rng):
    """interpolate with and without diff_attrs="all" (JAX's (H, W, 2A)
    layout): forward within 1e-6, gradients to the attributes, rast and
    rast_db within 1e-5 of their largest magnitude."""
    pc, faces, _, _ = _quads(2)
    jrast, jdb = jr.rasterize(jnp.asarray(pc), faces, (H, W), impl="scan")
    attr = rng.normal(size=(pc.shape[0], 3)).astype(np.float32)
    g_out = rng.normal(size=(H, W, 3)).astype(np.float32)
    g_da = rng.normal(size=(H, W, 6)).astype(np.float32)

    a, r, d = (_t(x).requires_grad_(True) for x in (attr, jrast, jdb))
    out, out_da = interpolate(a, r, _t(faces), rast_db=d, diff_attrs="all")
    assert out_da.shape == (H, W, 6)
    ((out * _t(g_out)).sum() + (out_da * _t(g_da)).sum()).backward()
    (j_out, j_da), vjp = jax.vjp(
        lambda x, y, z: jinterpolate(x, y, faces, rast_db=z,
                                     diff_attrs="all"),
        jnp.asarray(attr), jrast, jdb)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               rtol=0, atol=EXACT_ATOL)
    np.testing.assert_allclose(out_da.detach().numpy(), np.asarray(j_da),
                               rtol=0, atol=EXACT_ATOL)
    for got, want in zip((a.grad, r.grad, d.grad),
                         vjp((jnp.asarray(g_out), jnp.asarray(g_da)))):
        close_to_max(got.numpy(), want, GRAD_RTOL)
    plain, none = interpolate(_t(attr), _t(jrast), _t(faces))
    assert none is None and plain.equal(out.detach())
    with pytest.raises(ValueError, match="rast_db"):
        interpolate(_t(attr), _t(jrast), _t(faces), diff_attrs="all")
    with pytest.raises(NotImplementedError):
        interpolate(_t(attr), _t(jrast), _t(faces), rast_db=_t(jdb),
                    diff_attrs="some")


def test_bary_db_to_uv_da_matches_jax():
    """The analytic uv derivatives from barycentric ones, within 1e-6,
    and held out of the uv's gradient as in JAX."""
    pc, faces, uv, _ = _quads(4)
    jrast, jdb = jr.rasterize(jnp.asarray(pc), faces, (H, W), impl="scan")
    q = _t(uv).requires_grad_(True)
    got = _bary_db_to_uv_da(_t(jdb), q, _t(faces), _t(jrast))
    want = jbary_uv_da(jdb, jnp.asarray(uv), faces, jrast)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=EXACT_ATOL)
    assert not got.requires_grad


def _aa_scene(seed=3, res=(72, 136)):
    """Three overlapping quads (tests/test_antialias.py's occlusion scene)
    with per-triangle colours, rasterized by JAX's scan."""
    rng = np.random.default_rng(seed)
    quads, faces = [], []
    for q, (cx, cy, z, s) in enumerate([(-0.2, 0.0, 0.2, 0.55),
                                        (0.25, 0.1, -0.3, 0.4),
                                        (0.0, -0.3, 0.0, 0.3)]):
        quads.append(np.array([[cx - s, cy - s, z, 1], [cx + s, cy - s, z, 1],
                               [cx + s, cy + s, z, 1],
                               [cx - s, cy + s, z, 1]], np.float32))
        faces.append(np.array([[0, 1, 2], [0, 2, 3]], np.int32) + 4 * q)
    pos = np.concatenate(quads)
    pos[:, :2] += rng.uniform(-0.03, 0.03, size=(len(pos), 2))
    faces = np.concatenate(faces)
    fn = build_topology(faces, len(pos)).face_neighbors
    rast = np.asarray(jr.rasterize(jnp.asarray(pos), faces, res, impl="scan",
                                   with_db=False))
    tex_colors = rng.uniform(0.2, 1.0, size=(len(faces), 2))
    ids = rast[..., 3].astype(np.int32) - 1
    color = np.where((ids >= 0)[..., None], tex_colors[np.maximum(ids, 0)],
                     0.1).astype(np.float32)
    g = rng.normal(size=color.shape).astype(np.float32)
    return pos, faces, fn, rast, color, g


@pytest.mark.parametrize("max_pairs", [None, 4096, 40],
                         ids=["full", "compact", "compact-overflow"])
def test_antialias_matches_jax(max_pairs):
    """antialias: every pair (K2/K3's route, plain versions on the CPU),
    the compacted pairs under a cap they fit, and a cap they overflow
    (the pairs past it dropped as JAX drops them): the image within 1e-6,
    the gradients to the colour and the clip positions within 1e-5 of
    their largest magnitude."""
    pos, faces, fn, rast, color, g = _aa_scene()
    if max_pairs == 40:       # the cap drops pairs in both directions
        ids = rast[..., 3]
        assert (ids[:, 1:] != ids[:, :-1]).sum() > 40
        assert (ids[1:] != ids[:-1]).sum() > 40
    p = _t(pos).requires_grad_(True)
    c = _t(color).requires_grad_(True)
    out = taa.antialias(c, _t(rast), p, _t(faces), _t(fn), max_pairs)
    (out * _t(g)).sum().backward()
    want, vjp = jax.vjp(lambda x, y: jaa.antialias(
        y, jnp.asarray(rast), x, faces, jnp.asarray(fn), max_pairs),
        jnp.asarray(pos), jnp.asarray(color))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=0, atol=EXACT_ATOL)
    assert not np.array_equal(np.asarray(want), color)
    gp, gc = vjp(jnp.asarray(g))
    close_to_max(p.grad.numpy(), gp, GRAD_RTOL)
    close_to_max(c.grad.numpy(), gc, GRAD_RTOL)


def test_gathered_antialias_matches_pair_blend():
    """The winner planes gathered from rast through K2/K3's route (their
    plain versions here) against the plain per-pair ``_pair_blend`` over
    every pair (``_antialias_compact`` with a cap above the pair count):
    image within 1e-6, gradients within 1e-5 of the largest magnitude; K2
    and K3 not launched on the CPU."""
    pos, faces, fn, rast, color, g = _aa_scene(5, res=(40, 100))
    outs, grads = [], []
    before = (tac.antialias_planes.launches,
              tac.antialias_planes_bwd.launches)
    for max_pairs in (None, 40 * 100):
        p = _t(pos).requires_grad_(True)
        c = _t(color).requires_grad_(True)
        out = taa.antialias(c, _t(rast), p, _t(faces), _t(fn), max_pairs)
        (out * _t(g)).sum().backward()
        outs.append(out.detach().numpy())
        grads.append((p.grad.numpy(), c.grad.numpy()))
    assert before == (tac.antialias_planes.launches,
                      tac.antialias_planes_bwd.launches)
    np.testing.assert_allclose(outs[0], outs[1], rtol=0, atol=EXACT_ATOL)
    assert np.abs(outs[0] - color).max() > 0.05
    for a, b in zip(*grads):
        close_to_max(a, b, GRAD_RTOL)


def test_primitives_compose_like_render():
    """rasterize -> interpolate(diff_attrs="all") -> texture -> antialias ->
    composite (``chip_smoke.py`` phase 5e's chain) against
    ``render(route="separate")`` of the same view (K1 -> K7 -> K2: the same
    kernels, its uv from K1 rather than interpolate): image within 2e-4 on
    >= 99.5 % of pixels, gradients within 5e-5 + 5e-3 relative (texture)
    and 2 % of the largest magnitude (vertices), the limits JAX sets
    between two renderers (``tests/test_pipeline_fused.py``)."""
    from fpc_diffrend_tpu_torch.models.camera import transform_clip
    from fpc_diffrend_tpu_torch.ops.pipeline import BACKGROUND

    mvp, verts, faces, uv, uv_idx, fn = (np.array(x) for x in dome_scene(
        np.random.default_rng(0)))
    res = (48, 128)
    rng = np.random.default_rng(1)
    tex = rng.uniform(size=(64, 128, 1)).astype(np.float32)
    g = rng.normal(size=res + (1,)).astype(np.float32)
    out = []
    for compose in (True, False):
        v = _t(verts).requires_grad_(True)
        t = _t(tex).requires_grad_(True)
        if compose:
            pc = transform_clip(_t(mvp), v)
            rast, rast_db = tr.rasterize(pc, _t(faces), res)
            texc, texd = interpolate(_t(uv), rast, _t(uv_idx), rast_db,
                                     "all")
            colour = texture(t, texc)
            colour = taa.antialias(colour, rast, pc, _t(faces), _t(fn))
            img = torch.where(rast[..., 3:] > 0, colour, BACKGROUND)
        else:
            img = render(mvp, v, faces, uv, uv_idx, t, res, fn,
                         route="separate", device="cpu")
        (img * _t(g)).sum().backward()
        out.append((img.detach().numpy(), v.grad.numpy(), t.grad.numpy()))
    (img_c, gv_c, gt_c), (img_r, gv_r, gt_r) = out
    assert np.isclose(img_c, img_r, atol=2e-4).mean() >= 0.995
    np.testing.assert_allclose(gt_c, gt_r, atol=5e-5, rtol=5e-3)
    assert np.abs(gv_c - gv_r).max() <= 0.02 * np.abs(gv_r).max()


# ------------------------------------------------ behaviour, both routes ----

def _ndc_quad(z=0.5, w=1.0, scale=0.5):
    pos = np.array([[-scale, -scale, z, 1.0], [scale, -scale, z, 1.0],
                    [scale, scale, z, 1.0], [-scale, scale, z, 1.0]],
                   np.float32) * w
    return pos, np.array([[0, 1, 2], [0, 2, 3]], np.int32)


def _ids(pos, faces, res, route):
    rast = tr.rasterize(_t(pos), _t(faces), res, impl=route, with_db=False)
    return rast, rast[..., 3].numpy()


@pytest.mark.parametrize("route", ROUTES)
def test_coverage_ids_and_depth_order(route):
    """``tests/test_rasterize.py``'s coverage, diagonal split and depth
    order, on the route."""
    _, ids = _ids(*_ndc_quad(scale=0.5), (32, 32), route)
    assert ids[16, 16] > 0 and ids[0, 0] == 0 and ids[31, 31] == 0
    assert (ids > 0)[8:24, 8:24].all() and (ids > 0).sum() == 16 * 16
    _, ids = _ids(*_ndc_quad(scale=1.0), (16, 16), route)
    assert (ids > 0).all() and ids[2, 13] == 1 and ids[13, 2] == 2
    near, f = _ndc_quad(z=-0.5, scale=0.3)
    far, _ = _ndc_quad(z=0.5, scale=0.8)
    rast, ids = _ids(np.concatenate([near, far]),
                     np.concatenate([f, f + 4]), (64, 64), route)
    assert ids[32, 32] in (1, 2) and ids[32, 8] in (3, 4)
    z = rast[..., 2].numpy()
    np.testing.assert_allclose(z[32, 32], -0.5, atol=1e-5)
    np.testing.assert_allclose(z[32, 8], 0.5, atol=1e-5)


@pytest.mark.parametrize("route", ROUTES)
def test_perspective_and_degenerate_triangles(route):
    """Perspective-correct barycentrics; triangles behind the camera or of
    no area cover nothing (``tests/test_rasterize.py``)."""
    pos = np.array([[-0.9, -0.9, 0.0, 1.0], [3.6, -3.6, 0.0, 4.0],
                    [0.0, 3.6, 0.0, 4.0]], np.float32)
    rast, ids = _ids(pos, np.array([[0, 1, 2]], np.int32), (65, 65), route)
    assert ids[3, 32] == 1 and 0.6 < float(rast[3, 32, 0]) < 0.85
    pos = np.array([[-0.5, -0.5, 0, 1], [0.5, -0.5, 0, 1], [0, 0.5, 0, 1],
                    [-0.5, -0.5, 0, -1], [0.5, -0.5, 0, -1], [0, 0.5, 0, -1],
                    [0.1, 0.1, 0, 1]], np.float32)
    faces = np.array([[0, 1, 2], [3, 4, 5], [6, 6, 6]], np.int32)
    _, ids = _ids(pos, faces, (32, 32), route)
    assert set(np.unique(ids)) == {0.0, 1.0}


@pytest.mark.parametrize("route", ROUTES)
def test_uv_field_and_textured_roundtrip(route):
    """A full-screen quad: the interpolated uv equal the pixel centres,
    their derivatives 1/W and 1/H, and a ramp texture comes back
    (``tests/test_shading.py``), through ``rasterize_with_uv`` too."""
    pos, faces = _ndc_quad(z=0.0, scale=1.0)
    uv = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    n = 32
    rast, db = tr.rasterize(_t(pos), _t(faces), (n, n), impl=route)
    texc, texd = interpolate(_t(uv), rast, _t(faces), db, "all")
    centres = (np.arange(n) + 0.5) / n
    np.testing.assert_allclose(texc[..., 0].numpy(),
                               np.tile(centres, (n, 1)), atol=1e-5)
    np.testing.assert_allclose(texc[..., 1].numpy(),
                               np.tile(centres[:, None], (1, n)), atol=1e-5)
    np.testing.assert_allclose(texd.numpy(),
                               np.broadcast_to([1 / n, 0, 0, 1 / n],
                                               (n, n, 4)), atol=1e-5)
    rast2, texc2 = tr.rasterize_with_uv(_t(pos), _t(faces), _t(uv),
                                        _t(faces), (n, n), impl=route)
    assert rast2.equal(rast)
    np.testing.assert_allclose(texc2.numpy(), texc.numpy(), atol=1e-6)
    ramp = np.zeros((64, 64, 1), np.float32)
    ramp[..., 0] = np.linspace(0, 1, 64)[None, :]
    out = texture(_t(ramp), texc2).numpy()
    np.testing.assert_allclose(out[..., 0], np.tile(centres, (n, 1)),
                               atol=0.02)
