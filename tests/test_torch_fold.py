"""K6, the fold of bin-entry gradient rows onto triangles, on the CPU.

* The entry each window slot finds in its bin (``fold_positions``, K6's
  search) equals the inverse permutation of JAX ``_place_sort(...,
  want_inv=True)`` on every live slot, uncapped and at a cap that cuts a
  bin; a slot the cap dropped is found nowhere (JAX: position P). Dead
  slots are not compared: JAX gives them real positions inside P.
* The plain fold, which adds a triangle's rows in ascending window slot,
  equals the former ``index_add_`` fold within 1e-6 of the summed
  magnitudes (the two add in other orders), on the rows K5's plain
  version makes from a rendered scene and on ``chip_smoke.fold_case``'s
  synthetic bins.
* It reads no row past the live prefix or past ``n_global``: NaN there
  changes nothing.
* ``chip_smoke.k6_design_bytes`` equals a slot-by-slot count.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import chip_smoke as cs
from fpc_diffrend_tpu.ops.pallas import rasterize_tpu as jr
from fpc_diffrend_tpu_torch.ops.cuda import raster_grad_cuda as tgc
from fpc_diffrend_tpu_torch.ops.cuda import rasterize_cuda as tr

from _torch_scenes import clip_batch, quads_scene

CPU = torch.device("cpu")


def _index_add_fold(ge, gg, bins, n_tris):
    """The fold before the gather design: ``index_add_`` of the live rows
    by ``sorted_tri`` and of the live global rows by ``global_idx``."""
    n_raw = bins.sorted_tri.shape[0]
    cols = torch.zeros(tr.REC, dtype=torch.bool)
    cols[tgc.LIVE_SLOTS] = True
    live = (torch.arange(n_raw) < bins.bin_start[-1])[:, None]
    out = torch.zeros((n_tris + 1, tr.REC))
    out.index_add_(0, torch.clamp(bins.sorted_tri, max=n_tris).long(),
                   torch.where(live & cols, ge[:n_raw], 0.0))
    live = (torch.arange(tr.MAX_GLOBAL) < bins.n_global)[:, None]
    out.index_add_(0, torch.clamp(bins.global_idx, max=n_tris).long(),
                   torch.where(live & cols, gg, 0.0))
    return out[:n_tris]


def _assert_within_magnitudes(got, ge, gg, bins, n_tris):
    want = _index_add_fold(ge, gg, bins, n_tris)
    mag = _index_add_fold(ge.abs(), gg.abs(), bins, n_tris)
    err = cs.atomic_err(got, want, mag)
    assert err <= 1e-6, err


@pytest.mark.parametrize("case", ["uncapped", "cap cuts a bin"])
def test_fold_positions_match_jax_inverse_permutation(case):
    _, _, bins, n_tris = cs.fold_case(case, CPU)
    n_tiles = bins.bin_start.shape[0] - 1
    P = bins.sorted_tri.shape[0]
    tid = bins.tile_ids.reshape(n_tris, -1).numpy()
    _, bs, inv = jr._place_sort(jnp.asarray(tid), n_tris, n_tiles, P,
                                want_inv=True)
    np.testing.assert_array_equal(np.asarray(bs), bins.bin_start.numpy())
    inv = np.asarray(inv)
    pos = tgc.fold_positions(bins).numpy()
    live = tid < n_tiles
    assert live.sum() > 0
    np.testing.assert_array_equal(pos[live], np.where(inv[live] < P,
                                                      inv[live], -1))
    assert np.all(pos[~live] == -1)
    if case == "cap cuts a bin":
        assert (inv[live] == P).any() and (inv[live] < P).any()


@pytest.mark.parametrize("case", cs.FOLD_EDGE_CASES)
def test_plain_fold_matches_index_add_fold_on_synthetic_bins(case):
    ge, gg, bins, n_tris = cs.fold_case(case, CPU)
    got = tgc.fold_entries(ge, gg, bins, n_tris)
    assert tgc.fold_entries.launches == 0
    _assert_within_magnitudes(got, torch.nan_to_num(ge),
                              torch.nan_to_num(gg), bins, n_tris)
    assert torch.all(got[:, [12, 28, 29, 30, 31]] == 0)


@pytest.mark.parametrize("B,H,W", [(2, 40, 100), (3, 72, 300)])
def test_plain_fold_matches_index_add_fold_on_rendered_rows(B, H, W):
    """K5's plain rows from a render of overlapping quads (the wide scene
    spills triangles into the global list)."""
    rng = np.random.default_rng(5)
    verts, faces, uv, fn = quads_scene(rng)
    pc = torch.as_tensor(clip_batch(verts, rng, B))
    faces, uv, fn = (torch.as_tensor(a) for a in (faces, uv, fn))
    aux = tr.aux_records(uv, faces, pc, faces, fn, H, W)
    _, _, bins = tr.bin_scene_stacked(pc, faces, H, W, aux)
    ph, pw = tr.pad_resolution(H, W)
    tex = torch.as_tensor(rng.uniform(size=(16, 16, 1)).astype(np.float32))
    _, entry, payload, extra, _ = tr.fused_raster(bins, tex, B * ph, pw)
    gpl = torch.as_tensor(rng.normal(size=(tgc.N_GPL, B * ph, pw))
                          .astype(np.float32))
    ge, gg = tgc.pixel_grad(bins, entry, payload[0], payload[1], extra,
                            *cs.k5_planes(gpl))
    n_tris = B * faces.shape[0]
    got = tgc.fold_entries(ge, gg, bins, n_tris)
    _assert_within_magnitudes(got, ge, gg, bins, n_tris)
    assert float(got.abs().max()) > 0
    if W > 256:
        assert int(bins.n_global[0]) > 0 and float(gg.abs().max()) > 0


@pytest.mark.parametrize("case", cs.FOLD_EDGE_CASES)
def test_plain_fold_reads_no_row_past_the_live_prefix(case):
    ge, gg, bins, n_tris = cs.fold_case(case, CPU)
    n_live, n_global = int(bins.bin_start[-1]), int(bins.n_global[0])
    assert torch.isnan(ge[n_live:]).all() and torch.isnan(gg[n_global:]).all()
    got = tgc.fold_entries_plain(ge, gg, bins, n_tris)
    want = tgc.fold_entries_plain(torch.nan_to_num(ge, 7.0),
                                  torch.nan_to_num(gg, 7.0), bins, n_tris)
    assert torch.isfinite(got).all()
    assert torch.equal(got, want)


def test_fold_entries_checks_the_tile_ids():
    ge, gg, bins, n_tris = cs.fold_case("uncapped", CPU)
    with pytest.raises(ValueError, match="tile_ids"):
        tgc.fold_entries(ge, gg, bins, n_tris - 1)
    bins.tile_ids = bins.tile_ids.long()
    with pytest.raises(ValueError, match="tile_ids"):
        tgc.fold_entries(ge, gg, bins, n_tris)
    assert tgc.fold_entries.launches == 0


def _slot_by_slot(bins, n_tris):
    """Each slot's search as the kernel runs it, one slot at a time."""
    n_tiles = bins.bin_start.shape[0] - 1
    bs = bins.bin_start.tolist()
    tri = bins.sorted_tri.tolist()
    gidx = bins.global_idx.tolist()[:int(bins.n_global[0])]
    tid = bins.tile_ids.reshape(n_tris, -1).tolist()

    def search(a, lo, hi, t):
        n = 0
        while lo < hi:
            mid = (lo + hi) // 2
            n += 1
            if a[mid] == t:
                return n, True
            lo, hi = (mid + 1, hi) if a[mid] < t else (lo, mid)
        return n, False

    c = dict.fromkeys(("found", "probes", "max_probes", "live_slots",
                       "global_found", "global_probes"), 0)
    for t, slots in enumerate(tid):
        live = [k for k in slots if k < n_tiles]
        for k in live:
            n, hit = search(tri, bs[k], bs[k + 1], t)
            c["found"] += hit
            c["probes"] += n
            c["max_probes"] = max(c["max_probes"], n)
            c["live_slots"] += 1
        if not live:
            n, hit = search(gidx, 0, len(gidx), t)
            c["global_found"] += hit
            c["global_probes"] += n
    return c


@pytest.mark.parametrize("case", ["cap cuts a bin", "global rows",
                                  "all dead, global list full"])
def test_k6_design_bytes_match_a_slot_by_slot_count(case):
    _, _, bins, n_tris = cs.fold_case(case, CPU)
    got = cs.k6_design_bytes(bins.tile_ids, bins)
    want = _slot_by_slot(bins, n_tris)
    for k, v in want.items():
        assert got[k] == v, k
    assert got["found"] == int(bins.bin_start[-1])
    K = bins.tile_ids.shape[-1]
    assert got["total"] == (128 * (want["found"] + want["global_found"])
                            + 4 * K * n_tris + 128 * n_tris)
    assert got["bin_bounds"] == 8 * want["live_slots"]
    assert got["ms"] == pytest.approx(got["total"] / cs.HBM_BYTES_PER_S
                                      * 1e3)
