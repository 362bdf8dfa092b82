"""A cell on more than one card, run on the CPU: two gloo ranks of a tiny
frame-sharded fit, started and watched by ``benchmark/ranks.py`` as
``run.py`` starts four NCCL ranks on the cards. The result line comes from
rank 0; ``correct`` holds on a sound run and fails under each fault the
cell can have (the all-reduce skipped, the state left unchanged, half of
each rank's samples left out); a rank that fails or hangs, or that holds
a module of the JAX package, ends the run with no result."""

from __future__ import annotations

import io
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

from benchmark import ranks
from benchmark.tests.conftest import ROOT, build_tiny_root

SEED = 2 ** 31 + 4321
CELL = "tiny-fit-x2"
DEADLINE_S = 240

# a rank of run.py on the tiny root, with a fault planted first
RANK = '''import os, sys
from pathlib import Path
sys.path.insert(0, {repo!r})
from benchmark import run
{plant}
run.ROOT = Path({root!r})
code = run.main()
sys.stdout.flush()
sys.stderr.flush()
os._exit(code)
'''

PLANTS = {
    "sound": "",
    # the flat all-reduce over the world skipped: each rank steps on its
    # own part of the batch
    "no_allreduce": """
from fpc_diffrend_tpu_torch.parallel import train as ptrain
_real = ptrain._all_reduce_flat
ptrain._all_reduce_flat = (
    lambda tensors, group: None if group is None else _real(tensors, group))
""",
    # a step that returns its state unchanged
    "frozen": """
from fpc_diffrend_tpu_torch.fit import state as state_mod
def _frozen(config, state):
    state.step += 1
state_mod.optimizer_step = _frozen
""",
    # half of each rank's samples left out, the mean taken over the rest
    "half_batch": """
from fpc_diffrend_tpu_torch.fit.loop import Batch
from fpc_diffrend_tpu_torch.parallel import train as ptrain
_real = ptrain._local_loss
def _half(config, scene, params, batch, step, n_bands, batch_scale, *a):
    n = max(batch.cam_idx.shape[0] // 2, 1)
    return _real(config, scene, params, Batch(batch.cam_idx[:n],
                 batch.frame_idx[:n], batch.ref[:n]), step, n_bands,
                 batch_scale / 2, *a)
ptrain._local_loss = _half
""",
    # the JAX package loaded in rank 1's process (a stand-in module)
    "jax_package_on_rank_1": """
import types
if sys.argv[sys.argv.index("--rank") + 1] == "1":
    sys.modules["fpc_diffrend_tpu"] = types.ModuleType("fpc_diffrend_tpu")
""",
    # rank 1 fails once the window has opened on rank 0
    "rank_raises": """
from benchmark import programs
_real = programs.ShardedFitDriver.window
def _window(self, seconds, chunk):
    if self.rank == 1:
        raise RuntimeError("rank 1 fails in the window")
    return _real(self, seconds, chunk)
programs.ShardedFitDriver.window = _window
""",
}


@pytest.fixture(scope="module")
def sharded_root(tmp_path_factory) -> Path:
    """The tiny root with a two-rank cell: mesh (2, 1, 1), B = 4 (2 a
    rank), the per-frame parameters sharded, as new files and entries;
    chunks of 5 steps (the loss read every 5), so that the window's one
    chunk is short on the CPU."""
    root = build_tiny_root(tmp_path_factory.mktemp("x2"))
    bench = root / "benchmark"
    tr = json.loads((ROOT / "benchmark" / "traffic" / "fit-b36-x4.json")
                    .read_text())
    tr.update(mesh={"frame": 2, "view": 1, "tile": 1},
              fit={"batch_size": 4, "log_interval": 5}, warmup_steps=1,
              trace_steps=2)
    (bench / "traffic" / f"{CELL}.json").write_text(json.dumps(tr))
    (bench / "limits" / f"{CELL}.json").write_text(
        (bench / "limits" / "face9-fit-b36-x4.json").read_text())
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append(dict(name=CELL, config="tiny", traffic=CELL,
                                  chips=2, why="tiny"))
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "face9-fit-b36-x4" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


def launch(root: Path, tmp_path: Path, plant: str, trace: int = 0):
    script = tmp_path / f"rank_{plant}.py"
    script.write_text(RANK.format(repo=str(ROOT), root=str(root),
                                  plant=PLANTS[plant]))
    out, err = io.StringIO(), io.StringIO()
    t0 = time.time()
    code = ranks.launch(script, ["--workload", CELL, "--seed", str(SEED),
                                 "--seconds", "0.3", "--trace", str(trace)],
                        2, "cpu", t0, DEADLINE_S, out, err)
    return code, out.getvalue(), err.getvalue(), time.time() - t0


def test_sound_run_reports_from_rank_zero(sharded_root, tmp_path):
    code, out, err, _ = launch(sharded_root, tmp_path, "sound", trace=1)
    assert code == 0, err[-3000:]
    result = json.loads(out.splitlines()[-1])
    assert len([ln for ln in out.splitlines() if ln.startswith("{")]) == 1
    assert result["correct"], result["checks"]
    assert set(result["checks"]) == {"loss_gap", "grad_gap",
                                     "median_change_gap", "nonfinite_losses"}
    assert result["device"]["count"] == 2
    assert {"host_issue_ms.fit", "step_mfu_pct.fit"} <= set(result["metrics"])
    assert err.splitlines()[-1].startswith("nonfinite_losses ")


def test_end_to_end_line(sharded_root, tmp_path):
    code, out, err, _ = launch(sharded_root, tmp_path, "sound")
    assert code == 0, err[-3000:]
    result = json.loads(out.splitlines()[-1])
    assert set(result["metrics"]) == {"fit_mpix_s", "setup_s"}
    assert result["attempted"] > 0 and result["correct"]


@pytest.mark.parametrize("fault", ["no_allreduce", "frozen", "half_batch"])
def test_fault_fails(sharded_root, tmp_path, fault):
    code, out, err, _ = launch(sharded_root, tmp_path, fault)
    assert code == 0, err[-3000:]
    result = json.loads(out.splitlines()[-1])
    assert not result["correct"], result["checks"]
    if fault == "no_allreduce":   # rank 0's loss is its own share alone
        assert result["checks"]["loss_gap"]["value"] > 0.1
    if fault == "frozen":
        assert result["checks"]["median_change_gap"]["value"] >= 0.5


def test_failed_rank_ends_the_run(sharded_root, tmp_path):
    code, out, err, took = launch(sharded_root, tmp_path, "rank_raises")
    assert code != 0 and out == ""
    assert "rank 1 fails in the window" in err
    assert took < DEADLINE_S


def test_jax_package_on_another_rank_prints_nothing(sharded_root, tmp_path):
    code, out, err, _ = launch(sharded_root, tmp_path,
                               "jax_package_on_rank_1")
    assert code == 3 and out == ""
    assert "JAX or the JAX package was loaded: fpc_diffrend_tpu" in err


def test_hung_rank_is_killed_at_the_deadline(tmp_path):
    script = tmp_path / "hang.py"
    script.write_text("import sys, time\n"
                      "if sys.argv[sys.argv.index('--rank') + 1] == '1':\n"
                      "    time.sleep(600)\n"
                      "print('{}')\n")
    out, err = io.StringIO(), io.StringIO()
    t0 = time.time()
    code = ranks.launch(script, [], 2, "cpu", t0, 3.0, out, err)
    assert code != 0 and out.getvalue() == ""
    assert "outlived the deadline" in err.getvalue()
    assert time.time() - t0 < 30


def test_too_few_cards_prints_nothing():
    import torch

    if torch.cuda.is_available() and torch.cuda.device_count() >= 4:
        pytest.skip("this machine has the four cards the cell asks for")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "face9-fit-b36-x4", "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 1 and r.stdout == ""
