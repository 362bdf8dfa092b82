"""The counts behind ``chip_smoke.py``'s bounds and design numbers for K2
and K4, against brute-force numpy counts on small synthetic planes.

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
* ``kernel_pairs``: the one set of inputs on which phase 6 and
  ``chip_turns.py`` time K2, K3, K4 and K7 and their library calls.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs


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
    from fpc_diffrend_tpu_torch.profile_forward import step_stages
    from fpc_diffrend_tpu_torch.workload import build_workload

    wl = build_workload(48, 128, grid=5, batch=2, tex_size=64, device="cpu")
    H, W, B = wl["H"], wl["W"], wl["B"]
    ph, pw = rc.pad_resolution(H, W)
    state = {}
    for _, fn in step_stages(wl, state):
        fn()
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
