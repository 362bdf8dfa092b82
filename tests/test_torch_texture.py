"""The standalone bilinear sampler K7, K4's clamp mode and the ``texture``
Function against the JAX package.

* K7's plain version equals the XLA sampler within 1e-6 and the TPU
  sampler (``texture_pallas``, in interpret mode) on uv whose tile
  footprints fit its texel patch within 1e-5, the JAX package's own
  tolerance for that sampler (``tests/test_texture_pallas.py:83``: it
  weighs the texels through hat-matrix products, which round elsewhere).
  In clamp mode it equals the XLA sampler (index clamp) within 1e-6 and
  the TPU sampler, which clips the coordinate to ``size - 1.001``
  instead, within 1e-5 inside the texture and, past its high edges,
  within 1e-3 of the edge texel step in each axis.
* ``ops.texture.texture`` (K7 forward, K4 backward on the CPU's plain
  versions) has the gradients of ``jax.vjp`` of the XLA sampler in both
  modes: texture within 1e-5, uv within 1e-4 of their largest magnitude.
* K4's plain version on the missed pixels' hot spot (most pixels at uv
  (0, 0) with a cotangent) has the gradients of ``jax.vjp`` of the XLA
  sampler, within the same tolerances.
* K4's wrap mode is the default and gives the TPU kernel's backward
  (``texture_planes_bwd_impl`` in interpret mode): the texture cotangent
  within 1e-5 of its largest magnitude, the uv cotangents within the JAX
  package's own tolerance for that kernel (``tests/test_texture_pallas.py
  :65``: the subgradient at a texel centre differs there).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fpc_diffrend_tpu.ops.pallas import texture_tpu as jtt
from fpc_diffrend_tpu.ops.texture import texture as jtexture
from fpc_diffrend_tpu_torch.ops import texture as ttexture
from fpc_diffrend_tpu_torch.ops.cuda import texture_cuda as ttc

from _torch_scenes import close_to_max


def smooth_uv(h, w, scale, offset):
    """A coherent uv field, as ``tests/test_texture_pallas.py`` makes: each
    8x128 tile's footprint fits the TPU kernel's texel patch."""
    ys, xs = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    u = offset + scale * xs + 0.02 * np.sin(ys * 7)
    v = offset + scale * ys + 0.02 * np.cos(xs * 5)
    return np.stack([u, v], -1).astype(np.float32)


def _planes(uv):
    return (torch.as_tensor(np.ascontiguousarray(uv[..., 0])),
            torch.as_tensor(np.ascontiguousarray(uv[..., 1])))


@pytest.mark.parametrize("offset", [-0.15, 0.55])   # the low and high seams
def test_k7_plain_matches_tpu_sampler_wrap(rng, offset):
    tex = rng.uniform(size=(128, 128, 1)).astype(np.float32)
    uv = smooth_uv(16, 128, 0.6, offset)
    got = ttc.texture_planes(torch.as_tensor(tex), *_planes(uv), "wrap")
    got = got.movedim(0, -1).numpy()
    assert ttc.texture_planes.launches == 0
    xla = jtexture(jnp.asarray(tex), jnp.asarray(uv), boundary_mode="wrap")
    np.testing.assert_allclose(got, np.asarray(xla), atol=1e-6, rtol=0)
    want = jtt.texture_pallas(jnp.asarray(tex), jnp.asarray(uv), "wrap",
                              interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)


def test_k7_plain_clamp_matches_xla_and_tpu_sampler(rng):
    """The index clamp equals the XLA sampler everywhere, uv past every
    edge included; against the TPU sampler's coordinate clip it differs
    only past the high edges, by at most 1e-3 of the edge texel step."""
    tex = rng.uniform(size=(64, 128, 2)).astype(np.float32)
    wild = rng.uniform(-0.25, 1.25, size=(24, 128, 2)).astype(np.float32)
    got = ttc.texture_planes(torch.as_tensor(tex), *_planes(wild), "clamp")
    want = jtexture(jnp.asarray(tex), jnp.asarray(wild),
                    boundary_mode="clamp")
    np.testing.assert_allclose(got.movedim(0, -1).numpy(), np.asarray(want),
                               atol=1e-6, rtol=0)

    step = max(np.abs(tex[-1] - tex[-2]).max(),
               np.abs(tex[:, -1] - tex[:, -2]).max())
    for offset in (-0.15, 0.55):
        uv = smooth_uv(16, 128, 0.6, offset)
        got = ttc.texture_planes(torch.as_tensor(tex), *_planes(uv),
                                 "clamp").movedim(0, -1).numpy()
        tpu = np.asarray(jtt.texture_pallas(jnp.asarray(tex), jnp.asarray(uv),
                                            "clamp", interpret=True))
        inside = (uv[..., 0] * 128 - 0.5 < 127) & (uv[..., 1] * 64 - 0.5 < 63)
        np.testing.assert_allclose(got[inside], tpu[inside], atol=1e-5,
                                   rtol=0)
        assert np.abs(got - tpu).max() <= 2e-3 * step + 1e-5
        if offset > 0:
            assert not inside.all()                  # past the high edges


@pytest.mark.parametrize("mode", ["wrap", "clamp"])
def test_texture_function_gradients_match_vjp_of_xla(rng, mode):
    tex = rng.uniform(size=(32, 64, 2)).astype(np.float32)
    uv = rng.uniform(-0.3, 1.3, size=(24, 40, 2)).astype(np.float32)
    uv[:4, :8] = 0.0                                   # missed pixels
    g = rng.normal(size=(24, 40, 2)).astype(np.float32)
    t = torch.tensor(tex, requires_grad=True)
    q = torch.tensor(uv, requires_grad=True)
    out = ttexture.texture(t, q, boundary_mode=mode)
    (out * torch.as_tensor(g)).sum().backward()
    assert ttc.texture_planes_bwd.launches == 0
    want, vjp = jax.vjp(lambda a, b: jtexture(a, b, boundary_mode=mode),
                        jnp.asarray(tex), jnp.asarray(uv))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               atol=1e-6, rtol=0)
    gtex, guv = vjp(jnp.asarray(g))
    close_to_max(t.grad.numpy(), gtex, 1e-5)
    close_to_max(q.grad.numpy(), guv, 1e-4)


@pytest.mark.parametrize("mode", ["wrap", "clamp"])
def test_k4_plain_on_the_missed_pixels_hot_spot_matches_vjp_of_xla(rng,
                                                                    mode):
    """Most pixels at uv (0, 0) with a cotangent, as the missed side of
    every silhouette pair is on the step (K3 gives it one): their shares
    pile onto the four wrap-corner texels (one in clamp mode). K4's plain
    version, which the kernel is held to, gives ``jax.vjp`` of the XLA
    sampler there: texture within 1e-5, uv within 1e-4 of the largest
    magnitude."""
    tex = rng.uniform(size=(32, 48, 1)).astype(np.float32)
    uv = rng.uniform(0.2, 0.8, size=(40, 64, 2)).astype(np.float32)
    missed = rng.uniform(size=(40, 64)) < 0.8
    uv[missed] = 0.0
    g = rng.normal(size=(40, 64, 1)).astype(np.float32)
    gtex, gtu, gtv = ttc.texture_planes_bwd(
        torch.as_tensor(tex), torch.as_tensor(uv[..., 0].copy()),
        torch.as_tensor(uv[..., 1].copy()),
        torch.as_tensor(np.moveaxis(g, -1, 0).copy()), mode)
    assert ttc.texture_planes_bwd.launches == 0
    _, vjp = jax.vjp(lambda a, b: jtexture(a, b, boundary_mode=mode),
                     jnp.asarray(tex), jnp.asarray(uv))
    jgtex, jguv = vjp(jnp.asarray(g))
    close_to_max(gtex.numpy(), jgtex, 1e-5)
    close_to_max(np.stack([gtu.numpy(), gtv.numpy()], -1), jguv, 1e-4)
    # uv (0, 0) puts a quarter of each missed pixel's cotangent on each
    # wrap-corner texel, all of it on texel (0, 0) in clamp mode
    corners = ([(0, 0)] if mode == "clamp"
               else [(0, 0), (0, 47), (31, 0), (31, 47)])
    for c in corners:
        np.testing.assert_allclose(float(gtex[c]), float(g[missed].sum())
                                   / len(corners), rtol=1e-4)


def test_k4_wrap_is_the_default_and_matches_the_tpu_kernel(rng):
    tex = rng.uniform(size=(128, 128, 1)).astype(np.float32)
    uv = smooth_uv(16, 128, 0.6, -0.15)
    tu, tv = _planes(uv)
    g = rng.normal(size=(1, 16, 128)).astype(np.float32)
    t, gt = torch.as_tensor(tex), torch.as_tensor(g)
    default = ttc.texture_planes_bwd(t, tu, tv, gt)
    wrap = ttc.texture_planes_bwd(t, tu, tv, gt, "wrap")
    for a, b in zip(default, wrap):
        assert torch.equal(a, b)
    jg, jgu, jgv = jtt.texture_planes_bwd_impl(
        jnp.asarray(tex), jnp.asarray(uv[..., 0]), jnp.asarray(uv[..., 1]),
        16, 128, "wrap", True, (jnp.asarray(g[0]),))
    close_to_max(default[0].numpy(), jg, 1e-5)
    np.testing.assert_allclose(default[1].numpy(), np.asarray(jgu),
                               atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(default[2].numpy(), np.asarray(jgv),
                               atol=2e-3, rtol=1e-3)


def test_boundary_mode_is_checked():
    tex = torch.zeros((4, 4, 1))
    u = torch.zeros((2, 3))
    with pytest.raises(ValueError, match="boundary mode"):
        ttc.texture_planes(tex, u, u, "mirror")
    with pytest.raises(ValueError, match="boundary mode"):
        ttc.texture_planes_bwd(tex, u, u, torch.zeros((1, 2, 3)), "border")
