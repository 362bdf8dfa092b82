"""Rules the PyTorch port keeps, and its kernels on the card.

* The port's modules and chip_smoke.py import neither jax nor the JAX
  package (checked in a fresh interpreter; the name prefix
  ``fpc_diffrend_tpu_torch`` is not the JAX package).
* Entry points run on CUDA unless the caller asks for the CPU, and raise
  without a card: nothing falls back to the CPU on its own. The render
  and the result renderers are entry points too.
* No module of the port reads an ``FPC_*`` environment variable: the JAX
  package's tuning and route switches are explicit arguments there.
* One launch path: every kernel wrapper takes its entry point from
  ``kernels.build.entry``, which binds ``argtypes`` and ``restype`` once;
  no function in ``ops/cuda`` assigns them (read from the source).
* On the card, each kernel equals its plain version on the same inputs,
  and a gradient through K1 and K2 runs (marked ``cuda``: skipped without
  a card; the chip runs them).
"""

import os
import re
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


_FPC_ENV = re.compile(r"""(environ|getenv)\W[^\n]*['"]FPC_""")


def test_port_reads_no_fpc_environment_variable():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO,
                                               "fpc_diffrend_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 30
    readers = [f for f in files if _FPC_ENV.search(open(f).read())]
    assert not readers, readers
    assert _FPC_ENV.search('os.environ.get("FPC_AA_FUSE", "0")')


def _signature_assignments(path):
    """(function, line) of each assignment to ``.argtypes`` or ``.restype``
    inside a function of the module at ``path``, and the number of
    ``build.entry`` calls in it."""
    import ast

    tree = ast.parse(open(path).read())
    found, entries = [], 0
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for node in ast.walk(fn):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target] if isinstance(
                           node, (ast.AugAssign, ast.AnnAssign)) else [])
            for t in targets:
                for sub in ast.walk(t):
                    if (isinstance(sub, ast.Attribute)
                            and sub.attr in ("argtypes", "restype")):
                        found.append((fn.name, node.lineno))
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "entry"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "build"):
                entries += 1
    return found, entries


def test_kernel_wrappers_bind_signatures_once(tmp_path):
    cuda_dir = os.path.join(REPO, "fpc_diffrend_tpu_torch", "ops", "cuda")
    names = sorted(n for n in os.listdir(cuda_dir)
                   if n.endswith(".py") and n != "__init__.py")
    assert len(names) == 6, names
    total = 0
    for name in names:
        found, entries = _signature_assignments(os.path.join(cuda_dir, name))
        assert not found, (name, found)
        total += entries
    assert total == 12           # every launch of K1-K11's 12 entry points
    # the check sees an assignment in a launching function (the old form)
    bad = tmp_path / "wrapper.py"
    bad.write_text("def launch(lib):\n    fn = lib.k_launch\n"
                   "    fn.restype = ctypes.c_int\n"
                   "    fn.argtypes = [ctypes.c_void_p]\n    return fn()\n")
    assert _signature_assignments(str(bad)) == ([("launch", 3),
                                                 ("launch", 4)], 0)


def test_render_and_tools_raise_without_cuda(monkeypatch, tmp_path):
    from fpc_diffrend_tpu_torch.ops.pipeline import render
    from fpc_diffrend_tpu_torch.tools.render_result import render_result
    from fpc_diffrend_tpu_torch.tools.simple_render import simple_render

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pos = np.array([[-0.5, -0.5, 0.0], [0.5, -0.5, 0.0], [0.0, 0.5, 0.0]],
                   np.float32)
    faces = np.array([[0, 1, 2]], np.int32)
    args = (np.eye(4, dtype=np.float32), pos, faces, pos[:, :2] + 0.5,
            faces, np.full((4, 4, 1), 0.5, np.float32), (8, 8),
            np.full((1, 3), -1, np.int32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        render(*args)
    img = render(*args, device="cpu")
    assert img.shape == (8, 8, 1) and float(img.max()) == 0.5
    missing = str(tmp_path / "missing")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        simple_render(missing, "cam", missing)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        render_result(missing, missing, missing, ["cam"], 1)
    with pytest.raises(FileNotFoundError):              # past the device
        simple_render(missing, "cam", missing, device="cpu")


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


@pytest.mark.cuda
def test_k7_and_k10_match_plain_versions_on_the_card(card):
    """K7 (wrap and clamp) equals its plain version and K1's colour planes
    exactly, K4's clamp mode its plain version, and K10 equals K1 and K2,
    with chip_smoke's checks, on the binned dome and the global list."""
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
        tex = p["tex"].detach()
        k1 = rc.fused_raster(bins, tex, 2 * ph, pw)
        before = rc.fused_raster_aa.launches
        _, err = chip_smoke.check_aa_fused(bins, tex, 2 * ph, pw, 96, 200,
                                           ph, k1, f"grid {grid}")
        assert err <= chip_smoke.K1_ATOL
        assert rc.fused_raster_aa.launches == before + 1
        g = torch.randn(k1[4].shape, device=card, generator=gen)
        _, e7 = chip_smoke.check_texture(k1, tex, g, gen, f"grid {grid}")
        assert e7 == 0.0


@pytest.mark.cuda
def test_k2_edges_match_plain_version_on_the_card(card):
    """K2 against its plain version within 1e-6 where the bench's shapes do
    not take it: a width no multiple of 32, rows no multiple of 8, padding
    rows between samples (sample_ph > H), three channels."""
    import chip_smoke

    gen = torch.Generator(device=card)
    gen.manual_seed(1)
    assert chip_smoke.check_k2_edges(card, gen) <= chip_smoke.K2_ATOL


@pytest.mark.cuda
def test_k4_edges_match_plain_version_on_the_card(card):
    """K4 against its plain version (gtu/gtv within 1e-6, gtex within
    ATOMIC_RTOL of the summed magnitudes), wrap and clamp, one and three
    channels, with part warps: every pixel at one uv, uv across the wrap
    edge, random uv, minified uv; an all-zero cotangent gives zeros."""
    import chip_smoke

    gen = torch.Generator(device=card)
    gen.manual_seed(2)
    errs = chip_smoke.check_k4_edges(card, gen)
    assert len(errs) == 2 * 2 * 4 * 2 * 2
    for name, err in errs.items():
        limit = chip_smoke.ATOMIC_RTOL if "rel" in name else \
            chip_smoke.K4_ATOL
        assert err <= limit, name


@pytest.mark.cuda
def test_mip_edges_match_plain_versions_on_the_card(card):
    """K8 and K9 against their plain versions where the bench-mip batch
    does not take them (K8 and K9's gtu/gtv within 1e-6, the gradient
    pyramid within ATOMIC_RTOL of the summed magnitudes): three channels,
    a chain of no power-of-two sides, a one-level chain, planes of a pixel
    count no multiple of 4 and unaligned ones, every pixel at uv (0, 0),
    random and minified uv over a random LOD; an all-zero cotangent gives
    zeros."""
    import chip_smoke

    gen = torch.Generator(device=card)
    gen.manual_seed(3)
    errs = chip_smoke.check_mip_edges(card, gen)
    assert len(errs) == 2 * len(chip_smoke.MIP_EDGE_CHAINS) * 3 * 2 * 3
    for name, err in errs.items():
        limit = (chip_smoke.ATOMIC_RTOL if "rel" in name else
                 chip_smoke.K8_ATOL if name.startswith("K8") else
                 chip_smoke.K9_ATOL)
        assert err <= limit, name


@pytest.mark.cuda
def test_mip_kernels_on_rendered_uv_on_the_card(card):
    """K8 and K9 on K1's uv of a small render, with its LOD and with a
    random LOD past both clamps, each launched once a call."""
    import chip_smoke
    from fpc_diffrend_tpu_torch.ops.cuda import rasterize_cuda as rc
    from fpc_diffrend_tpu_torch.ops.cuda import texture_mip_cuda as tmc
    from fpc_diffrend_tpu_torch.profile_forward import forward_stages

    wl = build_workload(96, 200, grid=20, batch=2, tex_size=64, device=card)
    state = {}
    for _, fn in forward_stages(wl, state)[:2]:      # prologue, binning
        fn()
    ph, pw = rc.pad_resolution(96, 200)
    tex = wl["params"]["tex"].detach()
    k1 = rc.fused_raster(state["bins"], tex, 2 * ph, pw)
    gen = torch.Generator(device=card)
    gen.manual_seed(4)
    g = torch.randn(k1[4].shape, device=card, generator=gen)
    lam = (torch.rand((2 * ph, pw), device=card, generator=gen)
           * (chip_smoke.MAX_MIP_LEVEL + 3) - 1.5)
    before = (tmc.mip_sample.launches, tmc.mip_sample_bwd.launches)
    errs, _, _ = chip_smoke.check_mip(k1, tex, g, lam, 96, 200, ph,
                                      "cuda test")
    assert (tmc.mip_sample.launches - before[0],
            tmc.mip_sample_bwd.launches - before[1]) == (2, 2)
    assert len(errs) == 2 * 4
