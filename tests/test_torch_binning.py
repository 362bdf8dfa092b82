"""The port's triangle setup and stacked binning against the JAX package.

The JAX side is rasterize_tpu's XLA code (no Pallas kernel runs). The bins
must be bit-equal: sorted_tri, bin_start, global_idx and n_global exactly,
and the records within 1e-6 relative (the same float32 formulas, in the
same order, on both sides). The port keeps each sample's records in its
own frame, where JAX's stacked binning shifts them into the stacked frame
(``shift_records_stacked``): the records are held to JAX's per-sample
``triangle_setup`` and ``aux_records``, placed by JAX's stacked bins.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fpc_diffrend_tpu.ops.pallas import rasterize_tpu as jr
from fpc_diffrend_tpu_torch.ops.cuda import rasterize_cuda as tr

from _torch_scenes import clip_batch, quads_scene


def _close_rel(got, want, rtol=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


def _inputs(rng, B):
    verts, faces, uv, fn = quads_scene(rng)
    return clip_batch(verts, rng, B), faces, uv, fn


@pytest.mark.parametrize("B,H,W", [(2, 40, 100), (3, 72, 300)])
def test_bin_scene_stacked_matches(rng, B, H, W):
    pc, faces, uv, fn = _inputs(rng, B)
    aux_j = jax.vmap(lambda p: jr.aux_records(
        jnp.asarray(uv), jnp.asarray(faces), p, jnp.asarray(faces),
        jnp.asarray(fn), H, W))(jnp.asarray(pc))
    aux_t = tr.aux_records(torch.as_tensor(uv), torch.as_tensor(faces),
                           torch.as_tensor(pc), torch.as_tensor(faces),
                           torch.as_tensor(fn), H, W)
    _close_rel(aux_t, aux_j)

    ds_j, as_j, bins_j = jr.bin_scene_stacked(jnp.asarray(pc),
                                              jnp.asarray(faces), H, W,
                                              aux_j)
    ds_t, as_t, bins_t = tr.bin_scene_stacked(torch.as_tensor(pc),
                                              torch.as_tensor(faces), H, W,
                                              aux_t)
    # JAX's per-sample records, in each sample's own frame
    data_j = jax.vmap(lambda p: jr.triangle_setup(
        p, jnp.asarray(faces), H, W)[0])(jnp.asarray(pc))
    _close_rel(ds_t, data_j)
    _close_rel(as_t, aux_j)
    assert bins_t.sample_ph == tr.pad_resolution(H, W)[0]
    for name in ("sorted_tri", "bin_start", "global_idx", "n_global"):
        np.testing.assert_array_equal(getattr(bins_t, name).numpy(),
                                      np.asarray(getattr(bins_j, name)),
                                      err_msg=name)
    rec = np.concatenate([np.asarray(data_j), np.asarray(aux_j)],
                         -1).reshape(B * faces.shape[0], tr.REC)
    n_rows = rec.shape[0]

    def placed(idx, rows, live):
        out = np.zeros((rows, tr.REC), np.float32)
        idx = np.asarray(idx)[:live]
        out[:live] = rec[np.minimum(idx, n_rows - 1)]
        return out

    P = bins_t.sorted_tri.shape[0]
    _close_rel(bins_t.sorted_rec, placed(bins_j.sorted_tri, bins_t.gbase, P))
    live = int(bins_t.n_global[0])
    _close_rel(bins_t.global_rec[:live],
               placed(bins_j.global_idx, tr.MAX_GLOBAL, live)[:live])
    assert not bins_t.global_rec[live:].any()
    if W > 256:   # the wide case spills triangles into the global list
        assert int(bins_t.n_global[0]) > 0


def test_global_bbox_holds_each_global_triangle(rng):
    """Each live global row carries its own sample's clipped tile box."""
    B, H, W = 3, 72, 300
    pc, faces, uv, fn = _inputs(rng, B)
    ph, pw = tr.pad_resolution(H, W)
    aux = tr.aux_records(torch.as_tensor(uv), torch.as_tensor(faces),
                         torch.as_tensor(pc), torch.as_tensor(faces),
                         torch.as_tensor(fn), H, W)
    _, _, bins = tr.bin_scene_stacked(torch.as_tensor(pc),
                                      torch.as_tensor(faces), H, W, aux)
    _, bbox, _ = tr.triangle_setup(torch.as_tensor(pc),
                                   torch.as_tensor(faces), H, W)
    T = faces.shape[0]
    n = int(bins.n_global[0])
    for g in range(n):
        b, t = divmod(int(bins.global_idx[g]), T)
        want = bbox[b, t].clone()
        want[1::2] += b * (ph // tr.TILE_H)
        np.testing.assert_array_equal(bins.global_bbox[g].numpy(),
                                      want.numpy())
    dead = bins.global_bbox[n:]
    assert bool(torch.all(dead[:, 0] > dead[:, 2]))


def test_triangle_setup_matches(rng):
    pc, faces, _, _ = _inputs(rng, 2)
    data_t, bbox_t, valid_t = tr.triangle_setup(torch.as_tensor(pc),
                                                torch.as_tensor(faces),
                                                40, 100)
    for b in range(2):
        data_j, bbox_j, valid_j = jr.triangle_setup(jnp.asarray(pc[b]),
                                                    jnp.asarray(faces), 40,
                                                    100)
        _close_rel(data_t[b], data_j)
        np.testing.assert_array_equal(bbox_t[b].numpy(), np.asarray(bbox_j))
        np.testing.assert_array_equal(valid_t[b].numpy(),
                                      np.asarray(valid_j))


def test_pad_resolution_matches():
    for hw in [(1600, 1200), (48, 128), (41, 129), (8, 1)]:
        assert tr.pad_resolution(*hw) == jr.pad_resolution(*hw)
