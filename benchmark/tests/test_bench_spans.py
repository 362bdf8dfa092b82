"""``benchmark/spans.py``: the program's spans read from a hand-made
Chrome trace (idle gaps put down to the innermost open span, launches and
syncs counted per span by time on any thread), the readings of a run
without spans, and a whole run of the tiny cells on the CPU, with the
program's recording and without it."""

from __future__ import annotations

import gzip
import json
import time

import pytest
import torch

from benchmark import spans

CPU = torch.device("cpu")


def x(cat, name, ts, dur, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid}


def write(tmp_path, events):
    path = tmp_path / "t.trace.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    return str(path)


def test_read_program(tmp_path):
    events = [
        x("user_annotation", "fit.step", 0, 100),
        x("user_annotation", "fit.forward", 0, 40),
        x("user_annotation", "raster.bin", 10, 20),
        x("user_annotation", "fit.backward", 50, 45),
        x("user_annotation", "raster.bwd", 60, 20, tid=2),
        x("user_annotation", "Optimizer.step#Adam.step", 96, 3),
        x("cuda_runtime", "cudaLaunchKernel", 5, 1),
        x("cuda_runtime", "cudaLaunchKernel", 12, 1),
        x("cuda_runtime", "cudaLaunchKernel", 65, 1, tid=2),
        x("cuda_driver", "cuLaunchKernel", 90, 1, tid=2),
        x("cuda_runtime", "cudaStreamSynchronize", 15, 2),
        x("cuda_runtime", "cudaMemcpyAsync", 16, 1),
        x("cuda_runtime", "cudaDeviceSynchronize", 150, 1),
        # device: busy [0, 12], [20, 25], [61, 70], [120, 130]; gaps at 12
        # (in raster.bin, inside fit.forward), 25 (raster.bin), 70 (in
        # raster.bwd on another thread, inside fit.backward), 130
        # (outside the program; Adam's range is not the program's)
        x("kernel", "k", 0, 12), x("kernel", "k", 20, 5),
        x("gpu_memcpy", "m", 61, 9), x("kernel", "k", 120, 10),
    ]
    got = spans.read_program(write(tmp_path, events))
    assert got["spans"] == {
        "fit.step": {"count": 1, "launches": 4, "syncs": 1},
        "fit.forward": {"count": 1, "launches": 2, "syncs": 1},
        "raster.bin": {"count": 1, "launches": 1, "syncs": 1},
        "fit.backward": {"count": 1, "launches": 2, "syncs": 0},
        "raster.bwd": {"count": 1, "launches": 1, "syncs": 0}}
    assert dict((n, round(s * 1e6)) for n, s in got["idle_spans"]) == {
        "raster.bin": 8 + 36, "raster.bwd": 50}
    assert got["launches"] == 4 and got["syncs"] == 2
    assert got["idle_s"] == pytest.approx(94e-6)
    assert got["idle_in_program_s"] == pytest.approx(94e-6)
    # a gap after the last span's end is outside the program
    events.append(x("kernel", "k", 200, 5))
    got = spans.read_program(write(tmp_path, events))
    assert dict(got["idle_spans"])[spans.OUTSIDE] == pytest.approx(70e-6)


def test_without_spans(tmp_path):
    path = write(tmp_path, [x("kernel", "k", 0, 5), x("kernel", "k", 9, 5),
                            x("cpu_op", "aten::mul", 1, 3)])
    assert spans.read_program(path) is None
    for run in ({"kind": "fit", "slice_steps": 50, "program_timeline": None},
                {"kind": "view", "slice_steps": 60}):
        assert {k: f(run) for k, f in spans.READERS.items()} == dict.fromkeys(
            spans.READERS)


@pytest.mark.parametrize("cell", ["tiny-fit", "tiny-view"])
def test_run_cell(tiny_root, monkeypatch, cell):
    out = spans.run_cell(tiny_root, cell, 2 ** 31 + 7, 0.2, 1, CPU,
                         time.perf_counter())
    assert [w["recording"] for w in out["windows"]] == [False, True, True,
                                                        False]
    assert all(w["rate"] > 0 for w in out["windows"])
    got = {k: v for k, v in out["readings"].items() if v is not None}
    kind = "fit" if "fit" in cell else "render"
    assert {k for k in spans.READERS if k.endswith(kind)} == set(got)
    assert all(v >= 0 for v in got.values())
    assert 0 < got[f"bin_fill_pct.{kind}"] <= 100
    assert out["program_timeline"]["idle_s"] >= 0
    if kind == "fit":
        # no CUDA runtime on the CPU: nothing launched, nothing synced
        assert got["launches_per_step.fit"] == got["host_syncs.fit"] == 0
        assert got["step_host_ms.fit"] > got["backward_host_ms.fit"] > 0
    # a program without the recording: no readings, no failure
    monkeypatch.setattr(spans, "recording_of", lambda: None)
    out = spans.run_cell(tiny_root, cell, 2 ** 31 + 7, 0.2, 1, CPU,
                         time.perf_counter())
    assert [w["recording"] for w in out["windows"]] == [False, False]
    assert set(out["readings"].values()) == {None}
    assert out["program_timeline"] is None
