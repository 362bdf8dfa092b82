"""A whole run of the harness on the CPU at a tiny size, past its look
for a card: the result line, the guard against JAX, and ``correct``
coming out false under each fault the cells can have and under the
control."""

from __future__ import annotations

import io
import json
import subprocess
import sys
import time
import types

import pytest
import torch

from benchmark import check, harness, programs
from benchmark.inputs import make_inputs
from benchmark.reference import fit as ref_fit
from benchmark.tests.conftest import ROOT, build_tiny_root
from fpc_diffrend_tpu_torch.fit import loop
from fpc_diffrend_tpu_torch.fit import state as state_mod

CPU = torch.device("cpu")
SEED = 2 ** 31 + 12345


def run(root, cell, trace=False, seed=SEED):
    return harness.run_cell(root, cell, seed, 0.3, trace, CPU,
                            time.perf_counter())


@pytest.fixture(scope="module")
def sound(tmp_path_factory):
    """Each tiny cell's sound numbers, and a root whose limits are three
    times them."""
    base = build_tiny_root(tmp_path_factory.mktemp("base"))
    numbers = {c: {k: v["value"] for k, v in run(base, c)[0]["checks"]
                   .items()} for c in ("tiny-fit", "tiny-view")}
    limits = {c: {k: 3 * v + 1e-9 for k, v in n.items()} for c, n in
              numbers.items()}
    limits["tiny-fit"]["nonfinite_losses"] = 0.0
    return numbers, build_tiny_root(tmp_path_factory.mktemp("lim"), limits)


def test_result_line(tiny_root):
    result, lines = run(tiny_root, "tiny-fit", trace=True)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert set(result["checks"]) == {"loss_gap", "grad_gap",
                                     "median_change_gap", "nonfinite_losses"}
    assert all(" limit " in line for line in lines)
    assert {"host_issue_ms.fit", "step_mfu_pct.fit"} <= set(
        result["metrics"])
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}
    dev = result["device"]
    assert dev["count"] == 1 and "busy_s" in dev and "window_s" in dev
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    out, err = io.StringIO(), io.StringIO()
    assert harness.report(result, lines, out, err) == 0
    assert json.loads(out.getvalue().splitlines()[-1])["correct"] in (
        True, False)
    assert err.getvalue().splitlines()[-1] == lines[-1]
    view, _ = run(tiny_root, "tiny-view")
    assert set(view["metrics"]) == {"render_views_s", "setup_s"}
    view, _ = run(tiny_root, "tiny-view", trace=True)
    assert set(view["metrics"]) == {"step_mfu_pct.render"}


def test_guard_names_whole_top_level_modules(monkeypatch):
    monkeypatch.setitem(sys.modules, "fpc_diffrend_tpu_torch_probe",
                        types.ModuleType("fpc_diffrend_tpu_torch_probe"))
    assert "fpc_diffrend_tpu_torch_probe" not in harness.forbidden_modules()
    assert not [m for m in harness.forbidden_modules()
                if m.startswith("fpc_diffrend_tpu_torch")]
    monkeypatch.setitem(sys.modules, "fpc_diffrend_tpu.ops",
                        types.ModuleType("fpc_diffrend_tpu.ops"))
    assert "fpc_diffrend_tpu.ops" in harness.forbidden_modules()
    out, err = io.StringIO(), io.StringIO()
    assert harness.report({"correct": True}, [], out, err) == 3
    assert out.getvalue() == "" and "fpc_diffrend_tpu.ops" in err.getvalue()


def test_sound_runs_are_correct(sound):
    _, root = sound
    for cell in ("tiny-fit", "tiny-view"):
        assert run(root, cell)[0]["correct"], cell


def test_state_left_unchanged_fails(sound, monkeypatch):
    """An unchanged state reads 1 on every leaf whose change is at least
    the median leaf's, which is half the leaves or more, so its median
    change gap is at least 0.5."""
    _, root = sound

    def frozen(config, state):
        state.step += 1

    monkeypatch.setattr(state_mod, "optimizer_step", frozen)
    result, _ = run(root, "tiny-fit")
    assert not result["correct"]
    assert result["checks"]["median_change_gap"]["value"] >= 0.5


def test_half_batch_fails(sound, monkeypatch):
    _, root = sound
    real = loop.loss_fn

    def half(params, config, scene, batch, step=0):
        n = max(batch.cam_idx.shape[0] // 2, 1)
        return real(params, config, scene,
                    loop.Batch(batch.cam_idx[:n], batch.frame_idx[:n],
                               batch.ref[:n]), step)

    monkeypatch.setattr(loop, "loss_fn", half)
    assert not run(root, "tiny-fit")[0]["correct"]


def test_altered_image_fails(sound, monkeypatch):
    _, root = sound
    real = loop.render_sample

    def altered(*args, **kwargs):
        img, verts = real(*args, **kwargs)
        img = img.clone()
        img[16:32, 24:40] += 0.1
        return img, verts

    monkeypatch.setattr(loop, "render_sample", altered)
    assert not run(root, "tiny-view")[0]["correct"]


def test_control_fails(sound):
    """The reference in TF32 in the program's place reads past the limits
    that sound runs keep."""
    _, root = sound
    cell = harness.resolve(root, "tiny-fit")
    inputs = make_inputs(cell.config, "fit", SEED, CPU)
    drv = programs.FitDriver(cell.config, cell.traffic, inputs, SEED, CPU)
    got = drv.first_steps(3)
    want = check.reference_fit(drv.config, inputs, got, 2)
    ctrl = check.reference_fit(drv.config, inputs, got, 2,
                               ref_fit.Precision(tf32=True))
    ctrl["params0"] = got["params0"]
    numbers = check.fit_numbers(ctrl, want)
    assert not check.verdict(numbers, cell.limits)[0]
    vcell = harness.resolve(root, "tiny-view")
    vin = make_inputs(vcell.config, "view", SEED, CPU)
    cfg = programs.fit_config(vcell.config, vcell.traffic, SEED)
    views = ((0, 1), (2, 3))
    pairs = zip(check.reference_views(cfg, vin, views,
                                      ref_fit.Precision(tf32=True)),
                check.reference_views(cfg, vin, views))
    assert not check.verdict(check.view_numbers(pairs), vcell.limits)[0]


@pytest.mark.cuda
def test_cell_on_card():
    """One short run of a cell on the card (run with ``-m cuda``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "face9-view", "--seed", "7", "--seconds", "2",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.splitlines()[-1])["correct"]
