"""The port's bench entry point, its matrix and the precision study.

* ``workload.build_workload`` with ``weight_temporal`` and ``impl`` against
  ``bench.build_workload`` under the matching ``FPC_BENCH_*`` values, tiny:
  the scene, parameters, frames and batch array for array (exact; proj/mv
  1e-6); the config's temporal weight and rasterizer; one loss of each
  with a seeded pose per frame, so the temporal term is live: the loss
  within 1e-3 relative (the image allowance of ``test_torch_slice.py``),
  the temporal term within 1e-6 relative.
* ``python -m fpc_diffrend_tpu_torch.bench --cpu`` at 64x48 prints one
  JSON line with bench.py's keys and the port's.
* The matrix's rows are ``tools/bench_matrix.CONFIGS``'s, and the bench's
  defaults are ``bench.py``'s.
* ``precision_study --cpu`` at a few steps writes its table and curves;
  its verdict rule gives JAX's recorded verdicts on JAX's recorded runs.
"""

import dataclasses
import json
import os
import re
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fpc_diffrend_tpu.fit import loop as jloop
from fpc_diffrend_tpu.fit import losses as jlosses
from fpc_diffrend_tpu_torch import bench, bench_matrix
from fpc_diffrend_tpu_torch.examples import precision_study
from fpc_diffrend_tpu_torch.fit import loop as tloop
from fpc_diffrend_tpu_torch.fit import losses as tlosses
from fpc_diffrend_tpu_torch.workload import build_workload

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, GRID, BATCH, TEX, FRAMES, TEMPORAL = 48, 128, 5, 2, 64, 6, 10.0

# bench.py's knobs -> the port bench's arguments
KNOBS = {"RES_H": "res_h", "RES_W": "res_w", "GRID": "grid",
         "BATCH": "batch", "IMPL": "impl", "TEX": "tex", "CAMS": "cams",
         "FRAMES": "frames", "TEMPORAL": "temporal", "MIP": "mip",
         "ITERS": "iters", "DISPATCH": "dispatch"}


def _workloads(monkeypatch):
    import bench as jbench

    for k, v in dict(CPU="1", RES_H=H, RES_W=W, GRID=GRID, BATCH=BATCH,
                     TEX=TEX, FRAMES=FRAMES, TEMPORAL=TEMPORAL,
                     IMPL="scan").items():
        monkeypatch.setenv(f"FPC_BENCH_{k}", str(v))
    jw = jbench.build_workload()
    tw = build_workload(H, W, grid=GRID, batch=BATCH, tex_size=TEX,
                        n_frames=FRAMES, weight_temporal=TEMPORAL,
                        impl="scan", device="cpu")
    return jw, tw


def test_temporal_workload_matches_bench(monkeypatch, rng):
    jw, tw = _workloads(monkeypatch)
    jc, tc = jw["config"], tw["config"]
    assert jc.weight_temporal == tc.weight_temporal == TEMPORAL
    assert jc.raster_impl == tc.raster_impl == "scan"
    assert tw["n_frames"] == jw["n_frames"] == FRAMES
    for k in ("v_base", "faces", "uv", "uv_idx", "face_neighbors",
              "nbr_idx", "nbr_mask", "degree"):
        np.testing.assert_array_equal(getattr(tw["scene"], k).numpy(),
                                      np.asarray(getattr(jw["scene"], k)),
                                      err_msg=k)
    for k in ("proj", "mv"):
        np.testing.assert_allclose(getattr(tw["scene"], k).numpy(),
                                   np.asarray(getattr(jw["scene"], k)),
                                   atol=1e-6, err_msg=k)
    for k, v in jw["params"].items():
        np.testing.assert_array_equal(tw["params"][k].numpy(),
                                      np.asarray(v), err_msg=k)
    np.testing.assert_array_equal(tw["frames_u8"].numpy(),
                                  np.asarray(jw["frames_u8"]))
    for k in ("cam_idx", "frame_idx", "ref"):
        np.testing.assert_array_equal(getattr(tw["batch"], k).numpy(),
                                      np.asarray(getattr(jw["batch"], k)))

    # one loss of each, every frame's pose moved so the term is live
    shift = rng.normal(scale=0.05, size=(FRAMES, 3)).astype(np.float32)
    jp = dict(jw["params"], per_frame_t=jnp.asarray(shift))
    tp = dict(tw["params"], per_frame_t=torch.as_tensor(shift))
    frames = np.arange(FRAMES)
    jt = float(jlosses.temporal_smoothness(jc, jp, jnp.asarray(frames)))
    tt = float(tlosses.temporal_smoothness(tc, tp, torch.as_tensor(frames)))
    assert jt > 0
    np.testing.assert_allclose(tt, jt, rtol=1e-6)
    jc = dataclasses.replace(jc, aa_max_pairs=-1)
    _, jm = jloop.loss_fn(jp, jc, jw["scene"], jw["batch"], jnp.int32(0))
    with torch.no_grad():
        _, tm = tloop.loss_fn(tp, tc, tw["scene"], tw["batch"])
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-3)


def test_bench_cli_prints_one_json_line():
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run(
        [sys.executable, "-m", "fpc_diffrend_tpu_torch.bench", "--cpu",
         "--res-h", "64", "--res-w", "48", "--grid", "7", "--batch", "2",
         "--iters", "1", "--dispatch", "2", "--row", "tiny"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 1
    rec = json.loads(lines[0])
    for key in ("metric", "value", "unit", "vs_baseline", "row", "step_ms",
                "tris", "grad_prec", "tex_prec", "name", "power_limit"):
        assert key in rec, key
    assert rec["unit"] == "Mpix/s" and rec["row"] == "tiny"
    assert rec["tris"] == 2 * 6 * 6
    assert (rec["grad_prec"], rec["tex_prec"]) == ("exact", "exact")
    assert rec["name"] == "cpu" and rec["steps"] == 2
    assert np.isfinite(rec["value"]) and rec["step_ms"] > 0
    np.testing.assert_allclose(rec["value"],
                               2 * 64 * 48 / rec["step_ms"] / 1e3, atol=0.05)
    assert not any(rec["launches"].values())      # the plain versions
    assert "# step=" in r.stderr


def _jax_defaults():
    """bench.py's knob defaults, read from its source."""
    src = open(os.path.join(REPO, "bench.py")).read()
    found = dict(re.findall(
        r'environ\.get\("FPC_BENCH_(\w+)", "([^"]*)"\)', src))
    assert set(found) == set(KNOBS), found
    return found


def _as_args(env: dict) -> dict:
    """JAX knob values as the port bench's argument values."""
    defaults = vars(bench.parse_args([]))
    return {KNOBS[k]: type(defaults[KNOBS[k]])(
        float(v) if isinstance(defaults[KNOBS[k]], float) else v)
        for k, v in env.items()}


def test_bench_defaults_are_bench_py_s():
    want = _as_args(_jax_defaults())
    got = vars(bench.parse_args([]))
    assert {k: got[k] for k in want} == want
    assert (got["grad_prec"], got["tex_prec"], got["cpu"]) == (
        "exact", "exact", False)


def test_matrix_rows_are_bench_matrix_s():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import bench_matrix as jmatrix
    finally:
        sys.path.remove(os.path.join(REPO, "tools"))
    assert [c[0] for c in bench_matrix.CONFIGS] == [
        c[0] for c in jmatrix.CONFIGS]
    for (name, desc, params), (_, jdesc, env) in zip(bench_matrix.CONFIGS,
                                                      jmatrix.CONFIGS):
        assert desc == jdesc
        knobs = {k.replace("FPC_BENCH_", ""): v for k, v in env.items()}
        assert params == _as_args(knobs), name
        args = vars(bench_matrix.row_args(name, quick=True))
        want = dict(_as_args(_jax_defaults()), **_as_args(knobs), iters=3)
        assert {k: args[k] for k in want} == want, name
        assert args["row"] == name and args["batch"] == 8
    with pytest.raises(SystemExit):
        bench_matrix.main(["--only", "no-such-row"])


def test_matrix_writes_its_rows(tmp_path, monkeypatch, capsys):
    seen = []

    def fake_run(args):
        seen.append(args)
        return ({"value": 1.5, "step_ms": 2.0, "vs_baseline": 0.003,
                 "name": "cpu", "power_limit": None}, {"row": args.row})

    monkeypatch.setattr(bench, "run", fake_run)
    out = tmp_path / "m.json"
    assert bench_matrix.main(["--only", "512sq-9cam,1600x1200-mip",
                              "--quick", "--cpu", "--out", str(out)]) == 0
    rows = json.load(open(out))
    assert [r["config"] for r in rows] == ["512sq-9cam", "1600x1200-mip"]
    assert [a.mip for a in seen] == [0, 1] and all(a.cpu for a in seen)
    assert all(a.grad_prec == "exact" and a.iters == 3 for a in seen)
    fast = bench_matrix.row_args("1600x1200-headline", grad_prec="fast",
                                 tex_prec="fast2")
    assert (fast.grad_prec, fast.tex_prec, fast.iters) == ("fast", "fast2",
                                                           10)
    assert "| 1600x1200-mip | 1.5 | 2.000 |" in capsys.readouterr().out
    # a caller's check sees each row's own workload after its line
    checked = []
    bench_matrix.run(["256sq-1cam", "temporal-100f-2cam"], cpu=True,
                     check=lambda name, wl: checked.append((name, wl)))
    assert checked == [("256sq-1cam", {"row": "256sq-1cam"}),
                       ("temporal-100f-2cam",
                        {"row": "temporal-100f-2cam"})]


def test_precision_study_writes_table_and_curves(tmp_path):
    out = tmp_path / "prec"
    rc = precision_study.main(["--cpu", "--res", "32", "--steps", "4",
                               "--cams", "2", "--frames", "2", "--out",
                               str(out)])
    assert rc in (0, 1)
    table = open(out / "precision.md").read()
    for tag, (grad, tex) in precision_study.CONFIGS.items():
        rec = json.load(open(out / f"{tag}.json"))
        assert rec["prec"] == {"grad": grad, "tex": tex}
        assert rec["curve"] and np.isfinite(rec["final_loss"])
        assert rec["final_loss"] == rec["curve"][-1]["loss"]
        assert f"| {tag} | {rec['final_loss']:.3f} |" in table
    assert "| exact |" in table and "| fast2 |" in table


def test_precision_verdict_rule_gives_jax_s_recorded_verdicts():
    """JAX's recorded study (results/precision): both fast configs read
    "WORSE" by pose error (+6.74 %, +5.67 % against the 5 % budget)."""
    runs = {}
    for tag in ("exact", "fast", "fast2"):
        with open(os.path.join(REPO, "results", "precision",
                               f"{tag}.json")) as f:
            runs[tag] = json.load(f)
    judged = precision_study.verdicts(runs)
    table = open(os.path.join(REPO, "results", "precision",
                              "precision.md")).read()
    for tag, (ok, cell) in judged.items():
        assert ok == (tag == "exact")
        assert f"| {cell} |" in table, cell
