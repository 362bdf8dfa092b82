"""Fixtures of the benchmark's CPU tests: the repository root on the
path, and a checkout-like root whose ``BENCHMARK.json`` adds tiny cells
(48 x 64 pixels, 3 cameras, 4 frames, a 240-triangle head) made only of
new files beside the benchmark's own."""

from __future__ import annotations

import copy
import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_CELLS = {"tiny-fit": ("tiny", "tiny-fit"),
              "tinymip-fit": ("tinymip", "tiny-fit"),
              "tiny-view": ("tiny", "tiny-view")}


def tiny_config(mip: bool) -> dict:
    with open(ROOT / "benchmark" / "configs" / "face9-linear.json") as f:
        c = json.load(f)
    c.update(name="tinymip" if mip else "tiny", resolution=[48, 64],
             n_cameras=3, n_frames=4, texshape=[32, 32, 1],
             n_blendshapes=5, enable_mip=mip, max_mip_level=3)
    c["mesh"] = dict(c["mesh"], n_ring=12, n_seg=10)
    c["calibration"] = dict(c["calibration"], focal_px=280.0,
                            sensor=[64, 48])
    return c


def build_tiny_root(dest: Path, limits: dict | None = None) -> Path:
    """A root with the benchmark's files and the tiny cells added as new
    files and new entries; ``limits``: cell -> its limits (default: the
    face9 cells' files)."""
    bench = dest / "benchmark"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(ROOT / "benchmark" / sub, bench / sub)
    with open(ROOT / "BENCHMARK.json") as f:
        spec = json.load(f)
    for mip in (False, True):
        c = tiny_config(mip)
        (bench / "configs" / f"{c['name']}.json").write_text(json.dumps(c))
        spec["configs"].append(dict(spec["configs"][0], name=c["name"],
                                    file=f"benchmark/configs/{c['name']}"
                                    ".json"))
    fit = json.loads((bench / "traffic" / "fit-b1.json").read_text())
    fit.update(fit={"batch_size": 2}, warmup_steps=1, trace_steps=2)
    (bench / "traffic" / "tiny-fit.json").write_text(json.dumps(fit))
    view = json.loads((bench / "traffic" / "view.json").read_text())
    view.update(check_views=2, warmup_views=1, trace_views=2)
    (bench / "traffic" / "tiny-view.json").write_text(json.dumps(view))
    for name, (conf, traffic) in TINY_CELLS.items():
        spec["workloads"].append(dict(name=name, config=conf,
                                      traffic=traffic, chips=1, why="tiny"))
        src = "face9-view" if "view" in name else "face9-fit-b1"
        lim = (limits or {}).get(name) or json.loads(
            (bench / "limits" / f"{src}.json").read_text())
        (bench / "limits" / f"{name}.json").write_text(json.dumps(lim))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            view = any("view" in w for w in m["workloads"])
            m["workloads"] += (["tiny-view"] if view
                               else ["tiny-fit", "tinymip-fit"])
    (dest / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return build_tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.fixture
def spec() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return copy.deepcopy(json.load(f))
