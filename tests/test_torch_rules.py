"""Rules the PyTorch port keeps, and its kernels on the card.

* The port's modules and chip_smoke.py import neither jax nor the JAX
  package (checked in a fresh interpreter; the name prefix
  ``fpc_diffrend_tpu_torch`` is not the JAX package).
* Entry points run on CUDA unless the caller asks for the CPU, and raise
  without a card: nothing falls back to the CPU on its own.
* On the card, each kernel equals its plain version on the same inputs,
  and a gradient through K1 and K2 runs (marked ``cuda``: skipped without
  a card; the chip runs them).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fpc_diffrend_tpu_torch import device as device_mod
from fpc_diffrend_tpu_torch.fit import state as state_mod
from fpc_diffrend_tpu_torch.fit.config import FitConfig
from fpc_diffrend_tpu_torch.workload import build_workload

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import fpc_diffrend_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "fpc_diffrend_tpu" or m.startswith("fpc_diffrend_tpu."))
print(len(names), bad)
sys.exit(1 if bad or len(names) < 15 else 0)
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device_mod.resolve_device()
    with pytest.raises(RuntimeError):
        device_mod.resolve_device("cuda")
    with pytest.raises(RuntimeError):
        build_workload(16, 16, grid=3, batch=1, tex_size=4)
    with pytest.raises(RuntimeError):
        state_mod.params_from_numpy({k: np.zeros(1, np.float32)
                                     for k in state_mod.PARAM_NAMES})
    assert device_mod.resolve_device("cpu") == torch.device("cpu")


def test_init_params_matches_jax():
    from fpc_diffrend_tpu.fit import state as jstate
    from fpc_diffrend_tpu.fit.config import FitConfig as JConfig

    tex = np.random.default_rng(0).uniform(size=(8, 8, 1)).astype(
        np.float32)
    got = state_mod.init_params(FitConfig(), 4, 30, 2, tex, 3, device="cpu")
    want = jstate.init_params(JConfig(), 4, 30, 2, tex, 3)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the GPU machine")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card(card):
    from fpc_diffrend_tpu_torch.ops.cuda import antialias_cuda as ac
    from fpc_diffrend_tpu_torch.ops.cuda import rasterize_cuda as rc
    from fpc_diffrend_tpu_torch.ops.rasterize import (
        RasterizeTexturedSepaaStacked, bin_stacked)
    from fpc_diffrend_tpu_torch.fit import loop

    for grid in (20, 4):     # binned triangles; the global list
        wl = build_workload(96, 200, grid=grid, batch=2, tex_size=64,
                            device=card)
        s, p, b = wl["scene"], wl["params"], wl["batch"]
        pc, _ = loop.sample_clip_positions(wl["config"], s, p, b.cam_idx,
                                           b.frame_idx)
        data_s, aux_s, bins = bin_stacked(pc, s.faces, s.uv, s.uv_idx,
                                          s.face_neighbors, (96, 200))
        ph, pw = rc.pad_resolution(96, 200)
        before = rc.fused_raster.launches
        k1 = rc.fused_raster(bins, p["tex"], 2 * ph, pw)
        assert rc.fused_raster.launches == before + 1
        p1 = rc.fused_raster_plain(bins, p["tex"], 2 * ph, pw)
        assert torch.equal(k1[0], p1[0]) and torch.equal(k1[1], p1[1])
        for a, q in zip(k1[2:], p1[2:]):
            torch.testing.assert_close(a, q, atol=1e-5, rtol=0)
        k2 = ac.antialias_planes(k1[0], k1[2], k1[4], 96, 200, ph)
        p2 = ac.antialias_planes_plain(k1[0], k1[2], k1[4], 96, 200, ph)
        torch.testing.assert_close(k2, p2, atol=1e-6, rtol=0)
    # a gradient through K1 and K2 runs K3-K6
    d, a, tex = (x.detach().clone().requires_grad_(True)
                 for x in (data_s, aux_s, p["tex"]))
    _, aa = RasterizeTexturedSepaaStacked.apply(d, a, tex, bins, ph, 96, 200)
    aa.sum().backward()
    for g in (d.grad, a.grad, tex.grad):
        assert bool(torch.isfinite(g).all()) and bool(g.any())


@pytest.mark.cuda
def test_backward_kernels_match_plain_versions_on_the_card(card):
    """K3-K6 against their plain versions with chip_smoke's tolerances:
    K3 and K4's gtu/gtv within 1e-6, the sums taken with atomics within
    1e-5 of the magnitudes they add up."""
    import chip_smoke
    from fpc_diffrend_tpu_torch.ops.cuda import rasterize_cuda as rc
    from fpc_diffrend_tpu_torch.ops.rasterize import bin_stacked
    from fpc_diffrend_tpu_torch.fit import loop

    gen = torch.Generator(device=card)
    gen.manual_seed(0)
    for grid in (20, 4):     # binned triangles; the global list
        wl = build_workload(96, 200, grid=grid, batch=2, tex_size=64,
                            device=card)
        s, p, b = wl["scene"], wl["params"], wl["batch"]
        pc, _ = loop.sample_clip_positions(wl["config"], s, p, b.cam_idx,
                                           b.frame_idx)
        _, _, bins = bin_stacked(pc, s.faces, s.uv, s.uv_idx,
                                 s.face_neighbors, (96, 200))
        ph, pw = rc.pad_resolution(96, 200)
        k1 = rc.fused_raster(bins, p["tex"], 2 * ph, pw)
        g_aa = torch.randn(k1[4].shape, device=card, generator=gen)
        gtuv = torch.randn((3, 2 * ph, pw), device=card, generator=gen)
        errs, _, _ = chip_smoke.check_backward(
            k1, bins, p["tex"], g_aa, gtuv, 96, 200, ph,
            2 * wl["faces"].shape[0], f"grid {grid}")
        assert errs["K3 gcolour"] <= chip_smoke.K3_ATOL
        if grid == 4:
            assert int(bins.n_global[0]) > 0


@pytest.mark.cuda
def test_bin_place_matches_plain_version_on_the_card(card):
    """K11 equals its plain version exactly (bin_start and sorted_tri),
    uncapped, at a cap that rounds up, and at one that drops entries, and
    launches once per binning."""
    from fpc_diffrend_tpu_torch.ops.cuda import bin_place_cuda as bp
    from fpc_diffrend_tpu_torch.ops.rasterize import bin_stacked
    from fpc_diffrend_tpu_torch.fit import loop

    rng = np.random.default_rng(3)
    T, K, n_tiles = 533, 8, 60
    tid = np.full((2, T, K), 2 * n_tiles, np.int32)
    for b in range(2):
        for t in range(T):
            n_live = rng.integers(0, K + 1)
            tid[b, t, :n_live] = (rng.choice(n_tiles, size=n_live,
                                             replace=False) + b * n_tiles)
    tile_ids = torch.as_tensor(tid, device=card)
    live = int((tid < 2 * n_tiles).sum())
    for P in (tid.size, 128, live // 2):
        before = bp.place_pairs.launches
        got = bp.place_pairs(tile_ids, 2 * n_tiles, P)
        assert bp.place_pairs.launches == before + 1
        want = bp.place_pairs_plain(tile_ids, 2 * n_tiles, P)
        for g, w in zip(got, want):
            assert torch.equal(g, w), P
    want = bp.count_pairs(tile_ids.cpu(), 2 * n_tiles)
    for in_device_memory in (False, True):
        got = bp.count_pairs(tile_ids, 2 * n_tiles, in_device_memory)
        assert torch.equal(got.cpu(), want), in_device_memory
    import chip_smoke

    chip_smoke.check_place_synthetic(card)   # a 6,000-entry bin; 70k tiles
    wl = build_workload(96, 200, grid=20, batch=2, tex_size=64, device=card)
    s, p, b = wl["scene"], wl["params"], wl["batch"]
    pc, _ = loop.sample_clip_positions(wl["config"], s, p, b.cam_idx,
                                       b.frame_idx)
    for cap in (0, wl["config"].pair_cap, 128):
        _, _, bins = bin_stacked(pc, s.faces, s.uv, s.uv_idx,
                                 s.face_neighbors, (96, 200), cap)
        _, _, ref = bin_stacked(pc.cpu(), s.faces.cpu(), s.uv.cpu(),
                                s.uv_idx.cpu(), s.face_neighbors.cpu(),
                                (96, 200), cap)
        assert torch.equal(bins.bin_start.cpu(), ref.bin_start)
        assert torch.equal(bins.sorted_tri.cpu(), ref.sorted_tri)


@pytest.mark.cuda
def test_mip_kernels_match_plain_versions_on_the_card(card):
    """K8 and K9 against their plain versions with chip_smoke's
    tolerances, with the real LOD and a random one past both clamps, and
    K1's texture-free mode equal to its textured mode."""
    import chip_smoke
    from fpc_diffrend_tpu_torch.ops.cuda import rasterize_cuda as rc
    from fpc_diffrend_tpu_torch.ops.rasterize import bin_stacked
    from fpc_diffrend_tpu_torch.fit import loop

    gen = torch.Generator(device=card)
    gen.manual_seed(0)
    wl = build_workload(96, 200, grid=20, batch=2, tex_size=256, device=card)
    s, p, b = wl["scene"], wl["params"], wl["batch"]
    pc, _ = loop.sample_clip_positions(wl["config"], s, p, b.cam_idx,
                                       b.frame_idx)
    _, _, bins = bin_stacked(pc, s.faces, s.uv, s.uv_idx, s.face_neighbors,
                             (96, 200))
    ph, pw = rc.pad_resolution(96, 200)
    k1 = rc.fused_raster(bins, p["tex"], 2 * ph, pw)
    k0 = rc.fused_raster(bins, None, 2 * ph, pw)
    assert all(torch.equal(x, y) for x, y in zip(k0[:4], k1[:4]))
    g = torch.randn(k1[4].shape, device=card, generator=gen)
    lam = torch.rand((2 * ph, pw), device=card, generator=gen) * 9.0 - 1.5
    errs, _, _ = chip_smoke.check_mip(k1, p["tex"].detach(), g, lam, 96, 200,
                                      ph, "mip")
    assert max(v for k, v in errs.items() if "K8" in k) <= chip_smoke.K8_ATOL
    assert max(v for k, v in errs.items()
               if "rel" in k) <= chip_smoke.ATOMIC_RTOL
