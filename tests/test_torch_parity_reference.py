"""The port held directly to the independent nvdiffrast anchor.

``tests/reference_impl/nvdiff_torch.py`` is a float64 PyTorch
implementation of nvdiffrast's published semantics that shares no code
with either package; ``tests/test_parity_reference.py`` holds the JAX
pipeline to it. Here the port's ``ops.render`` (on the CPU: each kernel's
plain version) is held to it on that file's five scenes (shared edges,
occlusion, a triangle behind the camera, a random soup), at that file's
tolerances: image rtol 1e-4 / atol 2e-4; the gradients to the positions,
the uv and the texture within 2e-3 of their largest magnitude. Both
routes: "scan" (the primitives over the visibility scan) and "auto" (the
kernels: K11, K1 -> K2, backward K3 -> K4 -> K5 -> K6). The op-level
``rasterize`` parity runs on both routes too. On the card the kernel route
is tied to this anchor through ``chip_smoke.py`` phase 5e, which holds it
to the scan route.
"""

import numpy as np
import pytest
import torch

from fpc_diffrend_tpu_torch.data.obj import build_topology
from fpc_diffrend_tpu_torch.ops import render
from fpc_diffrend_tpu_torch.ops.rasterize import rasterize

from reference_impl import nvdiff_torch as ref
from test_parity_reference import RES, SCENES, _mvp, _scene_occlusion, _tex

IMPLS = ("scan", "auto")


def _renders(scene_fn, rng, impl):
    """The port's image and gradients, and the anchor's, for the loss
    sum(img * g) with g seeded after the scene and texture, as
    ``test_parity_reference._renders`` draws them."""
    pos, faces, uv = scene_fn(rng)
    tex = _tex(rng)
    mvp = _mvp()
    fn = build_topology(faces, pos.shape[0]).face_neighbors
    h, w = RES
    g_img = rng.normal(size=(h, w, 1)).astype(np.float32)

    leaves = [torch.tensor(x, requires_grad=True) for x in (pos, uv, tex)]
    img = render(mvp, leaves[0], faces, leaves[1], faces, leaves[2], RES, fn,
                 impl=impl, device="cpu")
    (img * torch.as_tensor(g_img)).sum().backward()

    leaves64 = [torch.tensor(x, dtype=torch.float64, requires_grad=True)
                for x in (pos, uv, tex)]
    img_t = ref.render(torch.tensor(mvp, dtype=torch.float64), leaves64[0],
                       torch.tensor(faces), leaves64[1], torch.tensor(faces),
                       leaves64[2], h, w)
    (img_t * torch.tensor(g_img, dtype=torch.float64)).sum().backward()
    return (img.detach().numpy(), img_t.detach().numpy(),
            [x.grad.numpy() for x in leaves],
            [x.grad.numpy() for x in leaves64])


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("scene_fn", SCENES,
                         ids=[f.__name__[7:] for f in SCENES])
def test_image_and_gradient_parity(scene_fn, impl, rng):
    img, img_t, grads, grads_t = _renders(scene_fn, rng, impl)
    np.testing.assert_allclose(img, img_t, rtol=1e-4, atol=2e-4)
    for name, g, gt in zip(("d/dpos", "d/duv", "d/dtex"), grads, grads_t):
        scale = max(np.abs(gt).max(), 1e-6)
        np.testing.assert_allclose(
            g / scale, gt / scale, rtol=2e-3, atol=2e-3,
            err_msg=f"{name} mismatch in {scene_fn.__name__} ({impl})")


@pytest.mark.parametrize("impl", IMPLS)
def test_rasterize_op_parity(impl, rng):
    """rast (u, v, z, id) on the occlusion scene: ids on > 99.5 % of the
    pixels, u, v, z within 1e-4 / 1e-5 where they agree."""
    pos, faces, _ = _scene_occlusion(rng)
    h, w = RES
    pos_clip = np.concatenate([pos, np.ones((pos.shape[0], 1), np.float32)],
                              axis=1) @ _mvp().T
    rast = rasterize(torch.as_tensor(pos_clip.astype(np.float32)),
                     torch.as_tensor(faces), RES, impl=impl,
                     with_db=False).numpy()
    rast_t = ref.rasterize(torch.tensor(pos_clip, dtype=torch.float64),
                           torch.tensor(faces), h, w).numpy()
    agree = rast[..., 3] == rast_t[..., 3]
    assert agree.mean() > 0.995, f"winner ids differ on {(~agree).sum()} px"
    assert (rast_t[..., 3] > 0).mean() > 0.3
    np.testing.assert_allclose(rast[..., :3][agree], rast_t[..., :3][agree],
                               rtol=1e-4, atol=1e-5)
