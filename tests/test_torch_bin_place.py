"""K11's plain version, the capped stacked binning and raster_stats against
the JAX package.

* ``place_pairs_plain`` equals ``_place_sort``, ``_place_rank`` and
  ``_place_pallas`` (the TPU kernels in interpret mode) exactly, at the
  size and the three entry caps of ``tests/test_rasterize_pallas.py``
  (uncapped, 128, half the live count): ``bin_start`` in full and
  ``sorted_tri`` over the live prefix (the port writes the sentinel B*T
  past it, ``_place_sort`` the key's triangle and the others 0).
* The stacked binning with an entry cap equals JAX ``bin_scene_stacked(
  entry_cap=...)`` exactly (ids, offsets; records within 1e-6 relative of
  JAX's per-sample records, which the port keeps in each sample's own
  frame where JAX's stacked binning shifts them into the stacked frame).
* ``raster_stats`` equals the JAX version on the grid-5 and grid-40 domes.
* A step at a cap at least the live count gives the uncapped step's loss
  and gradients within 1e-6 relative (the same entries, in the same order).
"""

import dataclasses

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fpc_diffrend_tpu.ops.pallas import rasterize_tpu as jr
from fpc_diffrend_tpu_torch.fit import loop as tloop
from fpc_diffrend_tpu_torch.ops.cuda import bin_place_cuda as bp
from fpc_diffrend_tpu_torch.ops.cuda import rasterize_cuda as tr
from fpc_diffrend_tpu_torch.workload import build_workload

from _torch_scenes import clip_batch, quads_scene


def _random_tile_ids(T=533, K=8, n_tiles=60, seed=3):
    """test_rasterize_pallas.py's pairs: K distinct tiles a triangle, a
    random number of them dead (sentinel n_tiles)."""
    rng = np.random.default_rng(seed)
    tile_ids = np.empty((T, K), np.int32)
    for t in range(T):
        picks = rng.choice(n_tiles, size=K, replace=False)
        picks[rng.integers(0, K + 1):] = n_tiles
        tile_ids[t] = picks
    return tile_ids, n_tiles


def _caps(tile_ids, n_tiles):
    T, K = tile_ids.shape
    live = int((tile_ids < n_tiles).sum())
    return {"uncapped": T * K, "128": 128,
            "half live": ((live // 2) // 128) * 128 or 128}


def _jax_place_sort(tid, T, n_tiles, P):
    tri, bs, _ = jr._place_sort(tid, T, n_tiles, P)
    return tri, bs


@pytest.mark.parametrize("cap", ["uncapped", "128", "half live"])
def test_place_plain_matches_jax_placements(cap):
    tile_ids, n_tiles = _random_tile_ids()
    T, _ = tile_ids.shape
    P = _caps(tile_ids, n_tiles)[cap]
    tid = jnp.asarray(tile_ids)
    bs, tri = bp.place_pairs(torch.as_tensor(tile_ids)[None], n_tiles, P)
    assert bp.place_pairs.launches == 0
    bs, tri = bs.numpy(), tri.numpy()
    live = int(bs[-1])
    assert tri.shape == (P,) and live <= P
    assert np.all(tri[live:] == T)                   # the port's sentinel
    want = {"sort": _jax_place_sort(tid, T, n_tiles, P),
            "rank": jr._place_rank(tid, T, n_tiles, P),
            "pallas": jr._place_pallas(tid, T, n_tiles, P, interpret=True)}
    for name, (w_tri, w_bs) in want.items():
        np.testing.assert_array_equal(bs, np.asarray(w_bs), err_msg=name)
        np.testing.assert_array_equal(tri[:live], np.asarray(w_tri)[:live],
                                      err_msg=name)
    if cap != "uncapped":
        assert live == P < int((tile_ids < n_tiles).sum())   # entries cut


def test_count_plain_matches_jax_bin_sizes():
    """K11's count step equals the bin sizes of ``_place_sort`` uncapped."""
    tile_ids, n_tiles = _random_tile_ids()
    T, K = tile_ids.shape
    _, w_bs = _jax_place_sort(jnp.asarray(tile_ids), T, n_tiles, T * K)
    counts = bp.count_pairs(torch.as_tensor(tile_ids)[None], n_tiles)
    assert counts.dtype == torch.int32 and counts.shape == (n_tiles,)
    np.testing.assert_array_equal(counts.numpy(), np.diff(np.asarray(w_bs)))


def test_place_plain_orders_stacked_bins_by_triangle():
    """B samples over disjoint tile ranges: each bin holds its sample's
    triangles, ascending, and a bin straddling P keeps its lowest ids."""
    B, n_s = 3, 40
    parts = [_random_tile_ids(T=97, n_tiles=n_s, seed=s)[0] for s in range(B)]
    tile_ids = np.stack([np.where(p < n_s, p + b * n_s, B * n_s)
                         for b, p in enumerate(parts)]).astype(np.int32)
    live_pairs = [(t, b * 97 + i) for b in range(B) for i in range(97)
                  for t in tile_ids[b, i] if t < B * n_s]
    order = sorted(live_pairs)
    for P in (tile_ids.size, 256, 300):
        bs, tri = bp.place_pairs_plain(torch.as_tensor(tile_ids), B * n_s, P)
        kept = order[:P]
        np.testing.assert_array_equal(tri.numpy()[:len(kept)],
                                      [i for _, i in kept])
        assert np.all(tri.numpy()[len(kept):] == B * 97)
        counts = np.bincount([t for t, _ in kept], minlength=B * n_s)
        np.testing.assert_array_equal(
            bs.numpy(), np.concatenate([[0], np.cumsum(counts)]))


def test_place_rejects_int32_overflow():
    huge = torch.zeros((1, 1, 1), dtype=torch.int32).expand(1 << 16, 1 << 12,
                                                            8)
    with pytest.raises(ValueError, match="int32"):
        bp.place_pairs(huge, 10, 128)
    pc = torch.zeros((8, 3, 4))
    faces = torch.zeros((1, 3), dtype=torch.int32).expand(1 << 25, 3)
    with pytest.raises(ValueError, match="int32"):
        tr.bin_scene_stacked(pc, faces, 16, 16, torch.zeros((8, 1, 16)))


def _bins_both(rng, B, H, W, cap):
    verts, faces, uv, fn = quads_scene(rng, n_quads=40)
    pc = clip_batch(verts, rng, B)
    aux_j = jax.vmap(lambda p: jr.aux_records(
        jnp.asarray(uv), jnp.asarray(faces), p, jnp.asarray(faces),
        jnp.asarray(fn), H, W))(jnp.asarray(pc))
    aux_t = tr.aux_records(torch.as_tensor(uv), torch.as_tensor(faces),
                           torch.as_tensor(pc), torch.as_tensor(faces),
                           torch.as_tensor(fn), H, W)
    _, _, bins_j = jr.bin_scene_stacked(jnp.asarray(pc), jnp.asarray(faces),
                                        H, W, aux_j, entry_cap=cap)
    _, _, bins_t = tr.bin_scene_stacked(torch.as_tensor(pc),
                                        torch.as_tensor(faces), H, W, aux_t,
                                        entry_cap=cap or 0)
    data_j = jax.vmap(lambda p: jr.triangle_setup(
        p, jnp.asarray(faces), H, W)[0])(jnp.asarray(pc))
    rec_j = np.concatenate([np.asarray(data_j), np.asarray(aux_j)],
                           -1).reshape(-1, tr.REC)
    return bins_j, bins_t, rec_j


@pytest.mark.parametrize("B,H,W", [(2, 40, 100), (3, 72, 300)])
def test_capped_binning_matches_jax(B, H, W):
    _, uncapped, _ = _bins_both(np.random.default_rng(5), B, H, W, None)
    live = int(uncapped.bin_start[-1])
    per_sample = -(-live // B)
    # a cap that keeps all, one that rounds up to 128, one that drops
    for cap in (None, per_sample, max(per_sample // 3, 1)):
        bins_j, bins_t, rec_j = _bins_both(np.random.default_rng(5), B, H,
                                           W, cap)
        P = bins_t.sorted_tri.shape[0]
        assert P == np.asarray(bins_j.sorted_tri).shape[0]
        if cap is not None:
            assert P == B * min(-(-cap // 128) * 128, 80 * 8)
        for name in ("sorted_tri", "bin_start", "global_idx", "n_global"):
            np.testing.assert_array_equal(getattr(bins_t, name).numpy(),
                                          np.asarray(getattr(bins_j, name)),
                                          err_msg=f"{name}, cap {cap}")
        # JAX's per-sample records in the order of its stacked bins
        want = np.zeros((bins_t.gbase, tr.REC), np.float32)
        want[:P] = rec_j[np.minimum(np.asarray(bins_j.sorted_tri),
                                    rec_j.shape[0] - 1)]
        np.testing.assert_allclose(bins_t.sorted_rec.numpy(), want,
                                   rtol=1e-6, atol=0)
        if cap == max(per_sample // 3, 1) and P < live:
            assert int(bins_t.bin_start[-1]) == P       # entries dropped


def _clip_all_cams(grid, H=256, W=384):
    wl = build_workload(H, W, grid=grid, batch=1, tex_size=4, device="cpu")
    s, p, cfg = wl["scene"], wl["params"], wl["config"]
    cams = torch.arange(s.n_cameras)
    zero = torch.zeros_like(cams)
    with torch.no_grad():
        pc, _ = tloop.sample_clip_positions(
            dataclasses.replace(cfg, mode="free"), s, p, cams, zero)
    return pc, s.faces, H, W


@pytest.mark.parametrize("grid", [5, 40])
def test_raster_stats_matches_jax(grid):
    pc, faces, H, W = _clip_all_cams(grid)
    got = tr.raster_stats(pc, faces, H, W)
    for c in range(pc.shape[0]):
        want = jax.device_get(jr.raster_stats(jnp.asarray(pc[c].numpy()),
                                              jnp.asarray(faces.numpy()),
                                              H, W))
        for k, v in want.items():
            assert int(got[k][c]) == int(v), (k, c)
    if grid == 5:
        assert int(got["n_global"].max()) > 0    # the large-triangle scene


def test_capped_step_equals_uncapped():
    """The autotuned cap (>= the live count) changes nothing: the same loss
    and gradients within 1e-6 relative."""
    wl = build_workload(48, 128, grid=5, batch=2, tex_size=16, device="cpu")
    cfg = wl["config"]
    assert cfg.pair_cap > 0 and cfg.pair_cap % 128 == 0
    results = []
    for c in (cfg, dataclasses.replace(cfg, pair_cap=0)):
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in wl["params"].items()}
        loss, _ = tloop.loss_fn(params, c, wl["scene"], wl["batch"])
        loss.backward()
        results.append((loss.detach(), {k: v.grad for k, v in
                                        params.items() if v.grad is not None}))
    (l0, g0), (l1, g1) = results
    torch.testing.assert_close(l0, l1, rtol=1e-6, atol=0)
    assert set(g0) == set(g1) and "tex" in g0
    for k in g0:
        torch.testing.assert_close(g0[k], g1[k], rtol=1e-6,
                                   atol=1e-6 * float(g1[k].abs().max()))
