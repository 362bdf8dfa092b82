"""The counts behind ``chip_smoke.py``'s bounds and design numbers, against
brute-force numpy counts on small synthetic planes.

* ``k2_bound_ms`` and ``k3_bound_ms``: the planes every pixel reads and
  writes, z for the covered pixels of a pair whose ids differ and the 9
  corner and neighbour planes of its occluder, under the pair masks
  (horizontal x < W - 1; vertical within a sample of pitch ``sample_ph`` >
  H, so padding rows lie between samples).
* ``k2_design_bytes`` (and ``occluder_sectors``, which K3's count shares):
  the occluder of each differing pair, and its 32-byte sectors.
* ``k4_design_reductions``: K4's warp instructions of 32 neighbouring
  pixels and its pairs of neighbours, on uv planes of two stacked samples
  (one rotated), missed pixels at uv (0, 0) with a cotangent (whole warps
  of them, and scattered), a minified band, and channels whose cotangent
  is 0.
* ``mip_level_counts`` and ``k9_design_reductions``: what K8 and K9
  sample level by level and the reductions K9's design issues (K4's rule
  in each of its two level slots, the level among the keys), on uv planes
  of two stacked samples with a minified band that reaches the coarse
  levels, an LOD below 0 and past the last level, runs of missed pixels at
  uv (0, 0) with a cotangent, and channels whose cotangent is 0.
* ``kernel_pairs``, ``mip_kernel_pairs`` and ``view_place_pairs``: the
  one set of inputs on which phase 6 and ``chip_turns.py`` time K2, K3,
  K4, K7, K8, K9, K10 and K11 and the library calls.
* ``k11_blocks``, ``k11_model`` and ``k11_design_bytes``: K11's blocks,
  each slot's block prefix and in-block rank against a slot-by-slot
  count, the placement they give against ``place_pairs_plain`` on the
  synthetic hot bin and 70,000 tiles, and the design's traffic.
* ``k10_design_bytes``: K1's planes and inputs, K2's design traffic and
  its pair evaluations on a small view.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from fpc_diffrend_tpu_torch.ops.texture_mip import level_sizes


def _ids(rng, rows, pw, block):
    ids = rng.integers(-1, 5, size=(-(-rows // block), -(-pw // block)))
    return np.repeat(np.repeat(ids, block, 0), block, 1)[:rows, :pw].astype(
        np.int32)


def _pairs(rows, pw, height, width, sample_ph):
    """Every (a, b) pixel pair under K2's masks."""
    for r in range(rows):
        for x in range(pw):
            if x < width - 1:
                yield (r, x), (r, x + 1)
            if r + 1 < rows and r % sample_ph < height - 1:
                yield (r, x), (r + 1, x)


SHAPES = [(2, 21, 18, 37, 30, 2),       # samples, pitch, H, pw, W, id block
          (3, 13, 13, 40, 40, 3)]       # no padding rows; W = pw


def _planes(seed, rows, pw, block):
    """Ids in blocks with missed pixels, and a payload with depth ties."""
    rng = np.random.default_rng(seed)
    idbuf = _ids(rng, rows, pw, block)
    payload = rng.uniform(size=(14, rows, pw)).astype(np.float32)
    payload[2][rng.uniform(size=(rows, pw)) < 0.2] = 0.5
    return idbuf, payload


def _geometry_brute(idbuf, payload, H, W, sph):
    """(differing pairs, bytes of z of their covered pixels and of their
    occluders' 9 planes), pair by pair."""
    rows, pw = idbuf.shape
    pairs, covered, occluders = 0, set(), set()
    for a, b in _pairs(rows, pw, H, W, sph):
        if idbuf[a] == idbuf[b]:
            continue
        pairs += 1
        covered.update(q for q in (a, b) if idbuf[q] >= 0)
        za = payload[2][a] if idbuf[a] >= 0 else np.inf
        zb = payload[2][b] if idbuf[b] >= 0 else np.inf
        occ = a if za <= zb else b
        if idbuf[occ] >= 0:
            occluders.add(occ)
    assert pairs > 10 and 0 < len(occluders) < len(covered)
    return pairs, 4 * len(covered) + 4 * 9 * len(occluders)


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("shape", SHAPES)
def test_k2_bound_counts_differing_pairs(shape, C):
    n, sph, H, pw, W, block = shape
    rows = n * sph
    idbuf, payload = _planes(0, rows, pw, block)
    pairs, geom = _geometry_brute(idbuf, payload, H, W, sph)
    nbytes = rows * pw * 4 * (1 + 2 * C) + geom
    want = cs._bound(nbytes, 60 * pairs + 2 * 2 * rows * pw)
    assert cs.k2_bound_ms(torch.as_tensor(idbuf), torch.as_tensor(payload),
                          C, H, W, sph) == want


@pytest.mark.parametrize("C", [1, 3])
@pytest.mark.parametrize("shape", SHAPES)
def test_k3_bound_counts_differing_pairs(shape, C):
    n, sph, H, pw, W, block = shape
    rows = n * sph
    idbuf, payload = _planes(3, rows, pw, block)
    pairs, geom = _geometry_brute(idbuf, payload, H, W, sph)
    nbytes = rows * pw * 4 * (1 + 3 * C + 6) + geom
    want = cs._bound(nbytes, 150 * pairs + 8 * rows * pw)
    assert cs.k3_bound_ms(torch.as_tensor(idbuf), torch.as_tensor(payload),
                          C, H, W, sph) == want


@pytest.mark.parametrize("shape", SHAPES)
def test_k2_design_bytes_counts_occluder_sectors(shape):
    n, sph, H, pw, W, block = shape
    rows, C = n * sph, 2
    idbuf, payload = _planes(1, rows, pw, block)
    need = set()
    for a, b in _pairs(rows, pw, H, W, sph):
        if idbuf[a] == idbuf[b]:
            continue
        za = payload[2][a] if idbuf[a] >= 0 else np.inf
        zb = payload[2][b] if idbuf[b] >= 0 else np.inf
        occ = a if za <= zb else b
        if idbuf[occ] >= 0:
            need.add(occ[0] * pw + occ[1])
    sectors = len({q // 8 for q in need})
    got = cs.k2_design_bytes(torch.as_tensor(idbuf),
                             torch.as_tensor(payload), C, H, W, sph)
    assert got == (rows * pw * 4 * (2 + 2 * C) + 9 * sectors * 32,
                   len(need), sectors)
    assert cs.k3_design_bytes(torch.as_tensor(idbuf), torch.as_tensor(
        payload), C, H, W, sph)[1:] == got[1:]


def _k4_brute(tex_shape, tu, tv, g):
    """K4's reductions, 32 neighbouring pixels at a time, pair by pair."""
    th, tw, C = tex_shape
    f32 = np.float32
    u, v = tu.reshape(-1), tv.reshape(-1)
    s0 = np.floor(u * f32(tw) - f32(0.5)).astype(np.int64)
    t0 = np.floor(v * f32(th) - f32(0.5)).astype(np.int64)
    n = u.size
    live = np.zeros(n + 1, bool)
    live[:n] = (g.reshape(C, -1) != 0).any(axis=0)
    total = groups = 0
    for i0 in range(0, n, 32):
        idx = [i for i in range(i0, min(i0 + 32, n)) if live[i]]
        if len({(t0[i], s0[i]) for i in idx}) == 1:
            total, groups = total + 4, groups + 1
            continue
        for e in range(i0, min(i0 + 32, n), 2):
            total += 4 * live[e]
            o = e + 1
            if not live[o]:
                continue
            if live[e] and t0[e] == t0[o] and s0[e] == s0[o]:
                pass
            elif live[e] and t0[e] == t0[o] and s0[o] == s0[e] + 1:
                total += 2
            else:
                total += 4
    return total * C, groups


def _k4_scene(rng, C, rows=22, pw=70):
    """Two stacked samples of 11 rows: smooth uv at about 1.3 pixels a
    texel of a 64 x 48 texture, one sample rotated; missed pixels at uv
    (0, 0), in a block of whole warps and scattered; a band minified to
    ~6 texels a pixel; cotangents 0 in some pixels and channels."""
    y, x = np.mgrid[0:rows, 0:pw].astype(np.float32)
    tu = x / (1.3 * 48) + 0.1
    tv = y / (1.3 * 64) + 0.2
    tu[11:], tv[11:] = 0.9 - y[11:] / (1.3 * 48), x[11:] / (1.3 * 64) - 0.05
    tu[3:6, 40:] = x[3:6, 40:] * 6 / 48
    missed = rng.uniform(size=(rows, pw)) < 0.15
    missed[14:, :] = True
    tu[missed] = tv[missed] = 0.0
    g = rng.normal(size=(C, rows, pw)).astype(np.float32)
    g[:, rng.uniform(size=(rows, pw)) < 0.2] = 0.0
    if C > 1:
        g[1, :, ::3] = 0.0
    return tu.astype(np.float32), tv.astype(np.float32), g


@pytest.mark.parametrize("C", [1, 3])
def test_k4_design_reductions_match_brute_force(C):
    rng = np.random.default_rng(2)
    tu, tv, g = _k4_scene(rng, C)
    tex_shape = (64, 48, C)
    want = _k4_brute(tex_shape, tu, tv, g)
    got = cs.k4_design_reductions(tex_shape, torch.as_tensor(tu),
                                  torch.as_tensor(tv), torch.as_tensor(g))
    assert got == want
    reductions, groups = got
    assert groups > 0
    # fewer than one thread a pixel's 4 C a live pixel
    assert reductions < 4 * C * int((g != 0).any(axis=0).sum())


def test_k4_design_reductions_of_one_uv_and_no_cotangent():
    """Every pixel at uv (0, 0): each 32 neighbouring pixels add 4 taps; no
    cotangent: no reduction."""
    tu = torch.zeros((16, 64))
    g = torch.ones((1, 16, 64))
    assert cs.k4_design_reductions((32, 32, 1), tu, tu, g) == (32 * 4, 32)
    assert cs.k4_design_reductions((32, 32, 1), tu, tu, g * 0) == (0, 0)


def test_kernel_pairs_time_one_set_of_inputs():
    """``kernel_pairs``, the kernels phase 6 and ``chip_turns.py`` both time,
    on a small workload on the CPU (each wrapper takes its plain version
    there): the single view's cotangents split its covered and missed
    pixels, K4 wrap takes K3's colour cotangent, and the library calls
    compute the clamp mode's functions."""
    from fpc_diffrend_tpu_torch.ops.cuda import antialias_cuda as ac
    from fpc_diffrend_tpu_torch.ops.cuda import rasterize_cuda as rc
    from fpc_diffrend_tpu_torch.workload import build_workload

    wl = build_workload(48, 128, grid=5, batch=2, tex_size=64, device="cpu")
    H, W, B = wl["H"], wl["W"], wl["B"]
    ph, pw = rc.pad_resolution(H, W)
    state = cs.step_inputs(wl)
    with torch.no_grad():
        tex = wl["params"]["tex"].detach()
        k1 = rc.fused_raster(state["bins"], tex, B * ph, pw)
        k1s = rc.fused_raster(cs.view_bins(wl), tex, ph, pw)
        pairs, cot = cs.kernel_pairs(tex, k1, state["g_aa"], k1s, H, W, ph)
        hit = k1s[0] >= 0
        assert 0 < int(hit.sum()) < hit.numel()
        assert bool(cot["g1"][:, hit].all()) and not bool(
            cot["g1"][:, ~hit].any())
        assert bool(cot["g_hot"][:, ~hit].all()) and not bool(
            cot["g_hot"][:, hit].any())
        assert torch.equal(cot["gcolour"], ac.antialias_planes_bwd_plain(
            k1[0], k1[2], k1[4], state["g_aa"], H, W, ph)[0])

        def outs(o):
            return (o,) if torch.is_tensor(o) else o

        for name, (fn, plain) in pairs.items():
            if plain is not None:
                for a, b in zip(outs(fn()), outs(plain()), strict=True):
                    assert torch.equal(a, b), name
        fwd = pairs["grid_sample"][0]()[0]
        np.testing.assert_allclose(fwd, pairs["texture_fwd_clamp"][0](),
                                   atol=1e-5)
        gtex = pairs["texture_bwd_clamp"][0]()[0]
        lib = pairs["grid_sampler_2d_backward"][0]()[0][0].permute(1, 2, 0)
        assert cs.max_err(lib, gtex) <= 1e-5 * float(gtex.abs().max())


MIP_SIZES = level_sizes(64, 48, 6)     # 64 x 48 .. 2 x 1, 6 levels


def _mip_scene(rng, C, rows=22, pw=70):
    """K4's scene (two stacked samples, missed pixels at uv (0, 0) in whole
    warps and scattered, a minified band, zero cotangents) with an LOD
    plane: magnified (lam < 0) where the uv is smooth, a band of rows
    minified over every level with fractions, a block past the last level,
    the missed pixels at the finite-difference LOD's -33, and a run at uv
    (0, 0) whose neighbours alternate between levels 0 and 1, where tap 00
    is texel (-1, -1) at both (no merge across levels)."""
    tu, tv, g = _k4_scene(rng, C, rows, pw)
    lam = np.full((rows, pw), -1.9, np.float32)
    lam[3:6, 40:] = rng.uniform(0.0, 5.5, size=(3, pw - 40))
    lam[7:9, :20] = rng.uniform(-0.5, 3.0, size=(2, 20))
    lam[12:14, 50:] = 7.25
    lam[(tu == 0) & (tv == 0)] = -33.2
    tu[10, :64] = tv[10, :64] = 0.0
    lam[10, :64] = np.tile([0.0, 1.0], 32)
    g[:, 10, :64] = 1.0
    return tu, tv, lam.astype(np.float32), g


def _mip_pick(lam, n_levels):
    lc = np.clip(lam, 0, n_levels - 1)
    lo = np.floor(lc).astype(np.int64)
    return lo, (lo + 1 < n_levels) & (lc != lo)


def _tap00(u, v, th, tw):
    f32 = np.float32
    s0 = int(np.floor(f32(u) * f32(tw) - f32(0.5)))
    t0 = int(np.floor(f32(v) * f32(th) - f32(0.5)))
    return t0, s0


@pytest.mark.parametrize("C", [1, 3])
def test_mip_level_counts_match_brute_force(C):
    rng = np.random.default_rng(4)
    tu, tv, lam, g = _mip_scene(rng, C)
    L = len(MIP_SIZES)
    u, v, lm = tu.reshape(-1), tv.reshape(-1), lam.reshape(-1)
    live = (g.reshape(C, -1) != 0).any(axis=0)
    lo, hi = _mip_pick(lm, L)
    texels = [set() for _ in range(L)]
    for i in np.nonzero(live)[0]:
        for lvl in [lo[i]] + ([lo[i] + 1] if hi[i] else []):
            th, tw = MIP_SIZES[lvl]
            t0, s0 = _tap00(u[i], v[i], th, tw)
            texels[lvl].update((t0 + dt) % th * tw + (s0 + ds) % tw
                               for dt in (0, 1) for ds in (0, 1))
    got = cs.mip_level_counts(MIP_SIZES, torch.as_tensor(tu),
                              torch.as_tensor(tv), torch.as_tensor(lam),
                              torch.as_tensor(g))
    assert got == {
        "px": u.size, "live_px": int(live.sum()),
        "live_px_at_uv_00": int((live & (u == 0) & (v == 0)).sum()),
        "lo_px": np.bincount(lo, minlength=L).tolist(),
        "lo_live_px": np.bincount(lo[live], minlength=L).tolist(),
        "blend_px": int(hi.sum()), "blend_live_px": int((hi & live).sum()),
        "texels_touched": [len(t) for t in texels],
        "texels": [th * tw for th, tw in MIP_SIZES]}
    # the scene reaches the coarse levels, past the last one and below 0
    assert got["lo_live_px"][-1] > 0 and got["lo_live_px"][3] > 0
    assert got["live_px_at_uv_00"] > 32 and 0 < got["blend_live_px"]


def _k9_brute(sizes, tu, tv, lam, g):
    """K9's reductions, slot by slot, 32 neighbouring pixels at a time,
    pair by pair."""
    C = g.shape[0]
    u, v, lm = tu.reshape(-1), tv.reshape(-1), lam.reshape(-1)
    n = u.size
    live0 = (g.reshape(C, -1) != 0).any(axis=0)
    lo, hi = _mip_pick(lm, len(sizes))
    total = groups = 0
    for k in (0, 1):
        live = np.zeros(n + 1, bool)
        live[:n] = live0 & (hi if k else True)
        key = [None] * (n + 1)
        for i in range(n):
            if live[i]:
                lvl = lo[i] + k
                key[i] = (lvl,) + _tap00(u[i], v[i], *sizes[lvl])
        for i0 in range(0, n, 32):
            idx = [i for i in range(i0, min(i0 + 32, n)) if live[i]]
            if len({key[i] for i in idx}) == 1:
                total, groups = total + 4, groups + 1
                continue
            for e in range(i0, min(i0 + 32, n), 2):
                total += 4 * live[e]
                o = e + 1
                if not live[o]:
                    continue
                if live[e] and key[e] == key[o]:
                    pass
                elif live[e] and key[e][:2] == key[o][:2] and (
                        key[o][2] == key[e][2] + 1):
                    total += 2
                else:
                    total += 4
    return total * C, groups


@pytest.mark.parametrize("C", [1, 3])
def test_k9_design_reductions_match_brute_force(C):
    rng = np.random.default_rng(5)
    tu, tv, lam, g = _mip_scene(rng, C)
    want = _k9_brute(MIP_SIZES, tu, tv, lam, g)
    got = cs.k9_design_reductions(MIP_SIZES, torch.as_tensor(tu),
                                  torch.as_tensor(tv), torch.as_tensor(lam),
                                  torch.as_tensor(g))
    assert got == want
    reductions, groups = got
    assert groups > 0
    # fewer than one thread a pixel's 4 C a live level of a live pixel
    live = (g != 0).any(axis=0)
    blend = _mip_pick(lam, len(MIP_SIZES))[1] & live
    assert reductions < 4 * C * int(live.sum() + blend.sum())


def test_k9_design_reductions_of_one_uv_and_no_cotangent():
    """Every pixel at uv (0, 0) and level 0: each 32 neighbouring pixels
    add 4 taps; blending level 1 too, 4 more; no cotangent: none."""
    tu = torch.zeros((16, 64))
    g = torch.ones((1, 16, 64))
    sizes = level_sizes(32, 32, 6)
    for lam, taps in ((-2.0, 4), (0.5, 8)):
        lp = torch.full((16, 64), lam)
        assert cs.k9_design_reductions(sizes, tu, tu, lp, g) == (
            32 * taps, 32 * taps // 4)
        assert cs.k9_design_reductions(sizes, tu, tu, lp, g * 0) == (0, 0)


def test_mip_kernel_pairs_time_one_set_of_inputs():
    """``mip_kernel_pairs`` on a small mip workload on the CPU: K8
    deriving the LOD from K1's uv and ids, and K9 on the step's pyramid and
    LOD (``mip_inputs``) and K3's colour cotangent, each equal to its plain
    version there; K8's LOD is the step's."""
    from fpc_diffrend_tpu_torch.ops import texture_mip as tm
    from fpc_diffrend_tpu_torch.ops.cuda import rasterize_cuda as rc
    from fpc_diffrend_tpu_torch.workload import build_workload

    wl = build_workload(48, 128, grid=5, batch=2, tex_size=64, mip=True,
                        device="cpu")
    H, W = wl["H"], wl["W"]
    ph, _ = rc.pad_resolution(H, W)
    state = cs.step_inputs(wl)
    with torch.no_grad():
        tex = wl["params"]["tex"].detach()
        pairs, (pyr, sizes, lam) = cs.mip_kernel_pairs(
            state["k1"], tex, state["k3"][0], H, W, ph)
        want_pyr, want_sizes = tm.mip_pyramid(tex, cs.MAX_MIP_LEVEL)
        assert torch.equal(pyr, want_pyr) and sizes == want_sizes
        assert len(sizes) == cs.MAX_MIP_LEVEL + 1
        idbuf, _, payload, _, _ = state["k1"]
        assert torch.equal(lam, tm.lod_from_texc(payload[3], payload[4],
                                                 idbuf, *sizes[0], H, W, ph))
        assert set(pairs) == {"mip_sample", "mip_sample_bwd"}
        for name in pairs:
            got, want = pairs[name][0](), pairs[name][1]()
            for a, b in zip(got, want, strict=True):
                assert torch.equal(a, b), name
        assert torch.equal(pairs["mip_sample"][0]()[1], lam)
        assert bool(want[0].any())


def _k11_inputs(case):
    """The synthetic K11 inputs of ``chip_smoke.check_place_synthetic``: a
    6,000-entry bin, and 70,000 tiles."""
    rng = np.random.default_rng(5)
    K = 8
    n_tiles, T, hot = {"hot bin": (600, 3000, True),
                       "70k tiles": (70000, 20000, False)}[case]
    base = rng.integers(8, n_tiles - K, size=(2, T, 1))
    tid = base + np.arange(K)
    n_live = rng.integers(0, K + 1, size=(2, T, 1))
    tid = np.where(np.arange(K) < n_live, tid, n_tiles)
    if hot:
        tid[:, :, 0] = 7
    return tid.astype(np.int32), n_tiles


@pytest.mark.parametrize("cut", ["uncapped", "half live", "inside a bin",
                                 "none"])
@pytest.mark.parametrize("case", ["hot bin", "70k tiles"])
def test_k11_model_places_as_the_plain_version(case, cut):
    """K11's design as plain PyTorch (``k11_model``: each live slot at its
    bin's offset + its block's prefix + its rank in its block) equals
    ``place_pairs_plain`` on the synthetic inputs, at every cut."""
    from fpc_diffrend_tpu_torch.ops.cuda import bin_place_cuda as bp

    tid, n_tiles = _k11_inputs(case)
    live = int((tid < n_tiles).sum())
    P = {"uncapped": tid.size, "half live": live // 2,
         "inside a bin": int(np.bincount(tid[tid < n_tiles])[7]) // 2 + 3,
         "none": 0}[cut]
    tile_ids = torch.as_tensor(tid)
    got = cs.k11_model(tile_ids, n_tiles, P)
    want = bp.place_pairs_plain(tile_ids, n_tiles, P)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _k11_brute(tid, n_tiles):
    """G, and each live slot's block prefix and in-block rank, slot by
    slot: blocks of whole triangles, at most 132 while each runs 8,192
    slots or more, more where a run would pass 16,384."""
    B, T, K = tid.shape
    n = tid.size
    G = max(min(132, -(-n // 8192)), -(-n // 16384), 1)
    per = -(-(B * T) // G)
    G = -(-(B * T) // per)
    flat = tid.reshape(-1)
    seen_before = {}                 # tile -> entries in earlier blocks
    prefix, rank = {}, {}
    for j in range(G):
        in_block = {}
        for i in range(j * per * K, min((j + 1) * per * K, n)):
            t = int(flat[i])
            if t >= n_tiles:
                continue
            prefix[i] = seen_before.get(t, 0)
            rank[i] = in_block.get(t, 0)
            in_block[t] = rank[i] + 1
        for t, c in in_block.items():
            seen_before[t] = seen_before.get(t, 0) + c
    return G, prefix, rank


def test_k11_blocks_and_design_bytes_match_brute_force():
    """``k11_blocks`` (the blocks, each slot's block prefix and in-block
    rank) against a slot-by-slot count, and ``k11_design_bytes`` from its
    parts: the slots twice, the (G, n_tiles) matrix six times, the totals
    written and read by every block, the outputs."""
    tid, n_tiles = _k11_inputs("hot bin")
    tile_ids = torch.as_tensor(tid)
    G, live, _, _, pre, rank, sizes = cs.k11_blocks(tile_ids, n_tiles)
    G_b, prefix_b, rank_b = _k11_brute(tid, n_tiles)
    assert G == G_b == sizes.shape[0]
    idx = torch.nonzero(live).reshape(-1).tolist()
    assert sorted(prefix_b) == idx
    assert [int(pre[i]) for i in idx] == [prefix_b[i] for i in idx]
    assert [int(rank[i]) for i in idx] == [rank_b[i] for i in idx]
    P = 5000
    n = tid.size
    want = (4 * 2 * n + 4 * G * n_tiles * 6 + 4 * (n_tiles + G * n_tiles)
            + 4 * (n_tiles + 1 + P))
    got = cs.k11_design_bytes(tile_ids, n_tiles, P)
    assert got == {"bytes": want, "launches": 3, "blocks": G,
                   "matrix_bytes": 4 * G * n_tiles * 6}


def test_k10_design_counts_match_brute_force():
    """``k10_design_bytes`` on a small view on the CPU: K1's planes
    written and its bins and texture read (counted from the tensors), K2's
    design traffic (``k2_design_bytes``), and K2's pair evaluations pair by
    pair: each differing pair once, and again where it crosses a 32 x 8
    tile's left column or top row into the halo of the next tile."""
    from fpc_diffrend_tpu_torch.ops.cuda import rasterize_cuda as rc
    from fpc_diffrend_tpu_torch.workload import build_workload

    wl = build_workload(48, 128, grid=5, batch=2, tex_size=64, device="cpu")
    H, W = wl["H"], wl["W"]
    ph, pw = rc.pad_resolution(H, W)
    tex = wl["params"]["tex"].detach()
    bins = cs.view_bins(wl)
    k1 = rc.fused_raster(bins, tex, ph, pw)
    C = tex.shape[2]
    live = int(bins.bin_start[-1])
    k1_bytes = (sum(o.numel() * o.element_size() for o in k1)
                + (live + int(bins.n_global[0])) * 32 * 4
                + bins.bin_start.numel() * 4 + tex.numel() * 4)
    idbuf = k1[0].numpy()
    pairs = evals = 0
    for a, b in _pairs(ph, pw, H, W, ph):
        if idbuf[a] == idbuf[b]:
            continue
        pairs += 1
        evals += 1
        horiz = a[0] == b[0]
        evals += (b[1] % 32 == 0) if horiz else (b[0] % 8 == 0)
    got = cs.k10_design_bytes(bins, ph, pw, C, tex, k1[0], k1[2], H, W, ph)
    k2_bytes = cs.k2_design_bytes(k1[0], k1[2], C, H, W, ph)[0]
    assert pairs > 10 and evals > pairs
    assert got == {"bytes": k1_bytes + k2_bytes, "k1_bytes": k1_bytes,
                   "k2_bytes": k2_bytes, "launches": 2,
                   "differing_pairs": pairs, "pair_evaluations": evals}


def test_view_place_pairs_time_one_set_of_inputs():
    """``view_place_pairs`` on a small workload on the CPU: K10 equals K1's
    planes and K2 on them (the "sepaa" pair), K1 at the view is those
    planes, and K11 at the step's batch and cap equals its plain version;
    ``bin_sizes`` counts the live slots of each tile."""
    from fpc_diffrend_tpu_torch.ops.cuda import rasterize_cuda as rc
    from fpc_diffrend_tpu_torch.workload import build_workload

    wl = build_workload(48, 128, grid=5, batch=2, tex_size=64, device="cpu")
    H, W, B = wl["H"], wl["W"], wl["B"]
    ph, _ = rc.pad_resolution(H, W)
    state = cs.step_inputs(wl)
    with torch.no_grad():
        tex = wl["params"]["tex"].detach()
        tile_ids, n_tiles = rc.pair_tile_ids(state["pc"].detach(),
                                             wl["scene"].faces, H, W)
        P = rc.entry_count(B, wl["faces"].shape[0], wl["config"].pair_cap)
        pairs = cs.view_place_pairs(tex, cs.view_bins(wl), H, W, ph,
                                    tile_ids, n_tiles, P)
        assert set(pairs) == {"fused_raster_aa", "sepaa",
                              "fused_raster_view", "bin_place"}
        k10 = pairs["fused_raster_aa"][0]()
        for a, b in zip(k10, pairs["sepaa"][0](), strict=True):
            assert torch.equal(a, b)
        for a, b in zip(k10, pairs["fused_raster_view"][0](), strict=False):
            assert torch.equal(a, b)
        got, want = pairs["bin_place"][0](), pairs["bin_place"][1]()
        assert all(torch.equal(a, b) for a, b in zip(got, want, strict=True))
        largest, mean, live = cs.bin_sizes(tile_ids, n_tiles)
        counts = np.bincount(tile_ids.numpy().reshape(-1),
                             minlength=n_tiles + 1)[:n_tiles]
        assert (largest, live) == (int(counts.max()), int(counts.sum()))
        assert mean == pytest.approx(counts.sum() / n_tiles)
