"""The plain reference against the program's CPU path (its kernels' plain
versions) at a tiny size: one view's image, one step's loss and
gradients, and Adam's update."""

from __future__ import annotations

import dataclasses

import torch

from benchmark import check, harness, programs
from benchmark.inputs import make_inputs
from benchmark.reference import fit as ref_fit
from benchmark.reference import render
from fpc_diffrend_tpu_torch.fit import loop
from fpc_diffrend_tpu_torch.fit import state as state_mod

CPU = torch.device("cpu")


def fit_driver(root, seed=3):
    cell = harness.resolve(root, "tiny-fit")
    inputs = make_inputs(cell.config, "fit", seed, CPU)
    return cell, inputs, programs.FitDriver(cell.config, cell.traffic,
                                            inputs, seed, CPU)


def test_view_equals_the_program_at_rest(tiny_root):
    """With the rest pose every view's image is the program's, bit for
    bit: both render one view in the same arithmetic."""
    _, inputs, drv = fit_driver(tiny_root)
    rig = ref_fit.make_rig(inputs, CPU)
    params = {k: v.detach() for k, v in drv.state.params.items()}
    for cam in range(3):
        for frame in range(4):
            got, _ = loop.render_sample(drv.config, drv.scene, params, cam,
                                        frame)
            clip, _ = ref_fit.clip_positions(rig, params, cam, frame,
                                             ref_fit.Precision())
            want = render.render_view(clip, rig.faces, rig.uv, rig.uv_idx,
                                      rig.face_neighbors, params["tex"],
                                      48, 64)
            assert torch.equal(got, want)


def test_first_step_matches(tiny_root):
    """One step at one sample: the loss to rounding, each leaf's gradient
    within 1e-4 of its norm."""
    _, inputs, drv = fit_driver(tiny_root)
    drv.config = dataclasses.replace(drv.config, batch_size=1)
    got = drv.first_steps(1)
    want = check.reference_fit(drv.config, inputs, got, 1)
    assert abs(got["losses"][0] - want["losses"][0]) <= 1e-6 * abs(
        want["losses"][0])
    for k in check.live_leaves(want["grad1"]):
        g, w = got["grad1"][k], want["grad1"][k]
        assert float((g - w).norm()) <= 1e-4 * float(w.norm()), k


def test_adam_matches_the_optimizer():
    """The reference's Adam, ramp and renorm against torch.optim.Adam
    over the program's groups."""
    from fpc_diffrend_tpu_torch.fit.config import FitConfig

    config = FitConfig(lr_t=8e-3, max_iter=100)
    gen = torch.Generator().manual_seed(0)
    params = {k: torch.randn(3, 4, generator=gen) for k in ref_fit.PARAMS}
    grads = [{k: torch.randn(3, 4, generator=gen) for k in ref_fit.PARAMS}
             for _ in range(3)]
    mine = {k: v.clone() for k, v in params.items()}
    theirs = {k: v.clone() for k, v in params.items()}
    state = state_mod.init_state(config, theirs)
    m = {k: torch.zeros_like(v) for k, v in mine.items()}
    v = {k: torch.zeros_like(x) for k, x in mine.items()}
    settings = check.settings_of(config)
    for step, g in enumerate(grads):
        for k, p in theirs.items():
            p.grad = g[k].clone()
        state_mod.optimizer_step(config, state)
        ref_fit.adam_update(mine, g, m, v, step, settings)
    for k in ref_fit.PARAMS:
        assert torch.allclose(mine[k], theirs[k], rtol=1e-5, atol=1e-7), k
