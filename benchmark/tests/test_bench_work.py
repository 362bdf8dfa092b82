"""The work counts behind the rooflines, on tiny shapes counted by hand,
and the reference's own counts of covered pixels and pixel pairs."""

from __future__ import annotations

import torch

from benchmark import work
from benchmark.reference import render

SHAPE = {"vertices": 4, "triangles": 2, "uv": 4, "blendshapes": 1,
         "frames": 2, "cameras": 1, "height": 2, "width": 3, "channels": 1,
         "texels": 16, "mip": False, "mode": "prior"}
SEEN = {"covered": 5, "edge_pairs": 3}


def test_least_time_picks_the_larger_bound():
    t = work.least_time(67e12, 3.35e12)
    assert t["s"] == 1.0 and t["by"] == "flops"
    t = work.least_time(1.0, 3.35e12)
    assert t["s"] == 1.0 and t["by"] == "bytes"


def test_view_work_by_hand():
    v, t, nb, nf = 4, 2, 1, 2
    flops = (2 * nb * nf + 2 * 3 * v * nb + 3 * 128 + 39 * v + 45 * t
             + 44 * 5 + 5 * 6 + 43 * 3)
    geometry = 4 * (3 * v + 2 * 4 + 6 * t + 3 * v * nb + 32 * 1)
    params = 4 * (nf * (1 + nb) + 14 + 16)
    got = work.view_work(SHAPE, SEEN)
    assert got["flops"] == flops
    assert got["bytes"] == geometry + params + 4 * 6


def test_param_elements_count_what_the_mode_moves():
    """Prior mode: maps 2 x 2, maps_intermediate 1 x 2, a pose for the
    camera and for each frame (7 each), the 16 texels; free and combined
    mode add m1, m2 (2 x 2 each) and m3 (3 x 4 vertices x 2 frames)."""
    assert work.param_elements(SHAPE) == 4 + 2 + 7 + 14 + 16
    for mode in ("free", "combined"):
        assert (work.param_elements(dict(SHAPE, mode=mode))
                == 43 + 2 * 4 + 3 * 4 * 2)


def test_step_work_by_hand():
    per_sample = (2 * 1 * 2 + 2 * 3 * 4 + 3 * 128 + 39 * 4 + 45 * 2
                  + 44 * 5 + 5 * 6 + 43 * 3 + 30 * 4)
    got = work.step_work(SHAPE, SEEN, batch=3)
    assert got["flops"] == 3 * per_sample * 3.0 + 13 * 43
    assert got["bytes"] == 3 * 6 + 4 * (12 + 8 + 12 + 12 + 32) + 24 * 43
    mip = work.step_work(dict(SHAPE, mip=True), SEEN, batch=3)
    assert mip["flops"] == got["flops"] + (3 * 26 * 5 + 16 / 3) * 3.0


def test_reference_counts_one_triangle():
    """A right triangle over a 4 x 4 image covers the pixel centres under
    its hypotenuse, and its edge pairs are the covered pixels' borders
    with the uncovered ones."""
    clip = torch.tensor([[-1.0, -1.0, 0.0, 1.0], [1.0, -1.0, 0.0, 1.0],
                         [-1.0, 1.0, 0.0, 1.0]])
    faces = torch.tensor([[0, 1, 2]])
    planes = render.triangle_planes(clip, faces, 4, 4)
    ids = render.winners(planes, 4, 4)
    x = torch.arange(4) + 0.5
    want = (x[None, :] + x[:, None]) <= 4.0
    assert torch.equal(ids >= 0, want)
    stats = {}
    render.render_view(clip, faces, torch.zeros((3, 2)), faces,
                       torch.full((1, 3), -1), torch.ones((2, 2, 1)), 4, 4,
                       stats=stats)
    assert stats["covered"] == int(want.sum())
    pairs = int((want[:, 1:] != want[:, :-1]).sum()
                + (want[1:] != want[:-1]).sum())
    assert stats["edge_pairs"] == pairs and stats["views"] == 1
