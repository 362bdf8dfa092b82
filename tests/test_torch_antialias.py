"""K2's plain version (the silhouette antialias) against the JAX package.

Planes come from K1's plain version on a stacked quads scene. Tolerance
1e-6: both sides run nvdiffrast's pair blend with the same operations in
the same order on identical planes; what remains is XLA's freedom to
contract a multiply-add.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from fpc_diffrend_tpu.ops import antialias as jaa
from fpc_diffrend_tpu.ops.pallas import antialias_tpu as jat
from fpc_diffrend_tpu_torch.ops import antialias as taa
from fpc_diffrend_tpu_torch.ops.cuda import antialias_cuda as tac
from fpc_diffrend_tpu_torch.ops.cuda import rasterize_cuda as tr

from _torch_scenes import clip_batch, quads_scene

ATOL = 1e-6


def _planes(rng, B, H, W, C=2):
    verts, faces, uv, fn = quads_scene(rng)
    pc = torch.as_tensor(clip_batch(verts, rng, B))
    tex = torch.as_tensor(rng.uniform(size=(16, 16, C)).astype(np.float32))
    f = torch.as_tensor(faces)
    aux = tr.aux_records(torch.as_tensor(uv), f, pc, f,
                         torch.as_tensor(fn), H, W)
    _, _, bins = tr.bin_scene_stacked(pc, f, H, W, aux)
    ph, pw = tr.pad_resolution(H, W)
    idbuf, _, payload, _, colour = tr.fused_raster(bins, tex, B * ph, pw)
    return idbuf, payload, colour


def test_plain_matches_antialias_fused_single_image(rng):
    """One image (B = 1) against ops/antialias.py antialias_fused."""
    H, W = 40, 100
    idbuf, payload, colour = _planes(rng, 1, H, W)
    got = tac.antialias_planes(idbuf, payload, colour, H, W, 40)
    assert int((got != colour).sum()) > 20      # silhouettes were blended
    rast = np.stack([payload[0], payload[1], payload[2],
                     idbuf.float() + 1.0], -1)[:H, :W]
    verts = payload[5:11].permute(1, 2, 0)[:H, :W].numpy()
    neigh = payload[11:14].permute(1, 2, 0)[:H, :W].numpy()
    col = colour.permute(1, 2, 0)[:H, :W].numpy()
    want = np.asarray(jaa.antialias_fused(jnp.asarray(col),
                                          jnp.asarray(rast),
                                          jnp.asarray(verts),
                                          jnp.asarray(neigh)))
    np.testing.assert_allclose(got.permute(1, 2, 0)[:H, :W].numpy(), want,
                               atol=ATOL)
    port = taa.antialias_fused(torch.as_tensor(col), torch.as_tensor(rast),
                               torch.as_tensor(verts),
                               torch.as_tensor(neigh)).numpy()
    np.testing.assert_allclose(port, want, atol=ATOL)


def test_plain_matches_pallas_kernel_interpret_stacked(rng):
    """Stacked samples against antialias_tpu._fwd_kernel in interpret
    mode: vertical pairs must stop at each sample's last real row."""
    B, H, W = 3, 36, 100
    idbuf, payload, colour = _planes(rng, B, H, W)
    ph, pw = tr.pad_resolution(H, W)
    got = tac.antialias_planes(idbuf, payload, colour, H, W, ph).numpy()
    packed = jat._pack_planes(tuple(jnp.asarray(c.numpy()) for c in colour),
                              jnp.asarray(idbuf.numpy()),
                              jnp.asarray(payload.numpy()))
    want = np.asarray(jat._aa_fwd_from_packed(
        packed, colour.shape[0], H, W, True, sample_ph=ph))[:, :B * ph, :pw]
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_cpu_call_leaves_launch_counter_and_checks_shapes(rng):
    idbuf, payload, colour = _planes(rng, 2, 16, 40)
    assert tac.antialias_planes.launches == 0
    tac.antialias_planes(idbuf, payload, colour, 16, 40, 16)
    assert tac.antialias_planes.launches == 0
    with pytest.raises(ValueError):
        tac.antialias_planes(idbuf, payload, colour, 16, 40, 24)
    with pytest.raises(ValueError):
        tac.antialias_planes(idbuf.long(), payload, colour, 16, 40, 16)
    with pytest.raises(ValueError):
        tac.antialias_planes(idbuf, payload[:, :, :64].contiguous(), colour,
                             16, 40, 16)
