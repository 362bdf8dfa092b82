"""``BENCHMARK.json`` against the contract's shape, and every name in it
resolved to its files; a cell added as new files only is found."""

from __future__ import annotations

import json
import re

from benchmark import harness
from benchmark.tests.conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_shape(spec):
    assert set(spec) == KEYS
    assert spec["command"] == ["python3", "benchmark/run.py"]
    assert spec["paths"] == ["benchmark"]
    assert 1 <= spec["run_seconds"] <= 51
    names = [c["name"] for c in spec["configs"]]
    cells = [w["name"] for w in spec["workloads"]]
    metrics = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    for group in (names, cells, metrics):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and c["reduced"] == []
        assert any(w["config"] == c["name"] for w in spec["workloads"])
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                           "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                           "layer", "moves"}
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(spec)) < 64 * 1024


def test_every_cell_resolves(spec):
    for w in spec["workloads"]:
        cell = harness.resolve(ROOT, w["name"])
        assert cell.traffic["kind"] in ("fit", "view")
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert callable(harness.reader(ROOT, m["name"]))
        for m in cell.per_layer:
            assert m["moves"] in e2e
        assert set(cell.limits) >= {"loss_gap", "img_mad_u8"} & set(
            cell.limits)


def test_new_cell_from_new_files_only(tiny_root):
    """The tiny cells, metrics and limits exist only as files and entries
    added to a copy; the harness finds them by name."""
    cell = harness.resolve(tiny_root, "tiny-fit")
    assert cell.config["resolution"] == [48, 64]
    assert cell.traffic["fit"]["batch_size"] == 2
    names = {m["name"] for m in cell.end_to_end + cell.per_layer}
    assert {"fit_mpix_s", "setup_s", "host_issue_ms.fit"} <= names
    new = tiny_root / "benchmark" / "metrics" / "steps_done.py"
    new.write_text("def read(run):\n    return run['window']['steps']\n")
    assert harness.reader(tiny_root, "steps_done")(
        {"window": {"steps": 7}}) == 7
