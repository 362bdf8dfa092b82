"""The harness: finds a cell's files by the names in ``BENCHMARK.json``,
runs the cell and assembles its result line.

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found by name:

* ``benchmark/configs/<config>.json`` (the ``file`` of its entry): sizes,
  rig, settings, what was assumed and reduced;
* ``benchmark/traffic/<traffic>.json``: the loop's kind ("fit", "view",
  or "fit_sharded": the fit over a cell's ranks, with its mesh) and its
  parameters (batch, chunk, checked steps or views, warm-up, traced
  slice) and FitConfig settings of its own;
* ``benchmark/limits/<workload>.json``: each compared number's limit;
* ``benchmark/metrics/<metric>.py``: ``read(run) -> float | None``, for
  end-to-end and per-layer metrics alike.

A cell added as new files and entries runs without an edit here.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path

import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "fpc_diffrend_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def load_spec(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def metrics_of(spec: dict, name: str) -> tuple:
    """(end-to-end, per-layer) metric entries the cell ``name`` reports: a
    metric with ``workloads`` in the cells it lists; a per-layer metric
    without them in every cell that reports the metric it moves."""
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    per = [m for m in spec["per_layer"]
           if name in m.get("workloads", [name] if m["moves"] in names
                            else [])]
    return e2e, per


def resolve(root: Path, name: str) -> Cell:
    """The cell ``name`` with its configuration, traffic, limits and
    metrics, read from the files its names point to.

    :raises KeyError: no such cell, or a name that points nowhere.
    """
    spec = load_spec(root)
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    e2e, per = metrics_of(spec, name)
    return Cell(name=name, config=_json(root / conf["file"]),
                traffic=_json(root / "benchmark" / "traffic"
                              / f"{w['traffic']}.json"),
                limits=_json(root / "benchmark" / "limits" / f"{name}.json"),
                end_to_end=e2e, per_layer=per)


def reader(root: Path, metric: str):
    """The ``read`` function of ``benchmark/metrics/<metric>.py``."""
    path = root / "benchmark" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    if spec is None:
        raise KeyError(f"no reader for metric {metric!r} at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def jax_loaded(err=None) -> bool:
    """Whether a module of JAX or of the JAX package is loaded (each named
    on ``err``, standard error by default)."""
    found = forbidden_modules()
    if found:
        print("JAX or the JAX package was loaded: " + ", ".join(found),
              file=err or sys.stderr, flush=True)
    return bool(found)


def shape_of(inputs, config: dict) -> dict:
    """The shapes the work counts read, from the inputs and the
    configuration (the mode as FitConfig's default where it names none),
    never from the program's buffers."""
    h, w = config["resolution"]
    th, tw, ch = config["texshape"]
    return {"vertices": inputs.vertices.shape[0] // 3,
            "triangles": inputs.faces.shape[0], "uv": inputs.uv.shape[0],
            "blendshapes": inputs.deltas.shape[1],
            "frames": config["n_frames"], "cameras": config["n_cameras"],
            "height": h, "width": w, "channels": ch, "texels": th * tw,
            "mip": bool(config["enable_mip"]),
            "mode": config.get("fit", {}).get("mode", "prior")}


def per_view(stats: dict) -> dict:
    n = max(stats.get("views", 0), 1)
    return {k: stats.get(k, 0) / n for k in ("covered", "edge_pairs")}


def run_fit(cell: Cell, inputs, seed, seconds, trace, device, t_start,
            trace_path):
    """A fit cell: set-up, the checked first steps, warm-up, the window,
    the traced slice, then the reference. A sharded fit runs on every rank
    of a ``torch.distributed`` world alike, in lock-step, the reference
    spread over the ranks; rank 0's run is the one reported: its window,
    its traced slice (the device's busy time averaged over the ranks) and
    the largest memory peak of the ranks."""
    from benchmark import check, programs, work

    tr = cell.traffic
    sharded = tr["kind"] == "fit_sharded"
    drv = (programs.ShardedFitDriver if sharded else programs.FitDriver)(
        cell.config, tr, inputs, seed, device)
    got = drv.first_steps(int(tr["check_steps"]))
    drv.steps(int(tr["warmup_steps"]))
    programs.sync(device)
    run = {"kind": "fit", "setup_s": time.perf_counter() - t_start,
           "pixels_per_step": tr["fit"]["batch_size"]
           * cell.config["resolution"][0] * cell.config["resolution"][1],
           "count": drv.world}
    run["window"] = drv.window(seconds, drv.log_every)
    if trace:
        from benchmark import trace as tracing
        n = int(tr["trace_steps"])
        run["slice_steps"] = n
        if drv.rank:
            trace_path = trace_path.replace(".trace.", f".rank{drv.rank}"
                                            ".trace.")
        # the barrier inside the profiled scope starts every rank's steps
        # together, whenever its profiler came up
        prof = tracing.profile(lambda: (drv.barrier(), drv.steps(n)),
                               device, trace_path)
        timeline = tracing.read(prof["path"], prof["window_s"])
        timeline["busy_s"] = drv.over_ranks(timeline["busy_s"],
                                            "sum") / drv.world
        run["timeline"] = timeline
    run["memory_peak_bytes"] = int(drv.over_ranks(
        torch.cuda.max_memory_allocated(device)
        if device.type == "cuda" else 0, "max"))
    config = drv.config
    window_losses = [v for _, v in drv.losses]
    rank, world = drv.rank, drv.world
    drv.free()
    del drv
    if device.type == "cuda":
        torch.cuda.empty_cache()
    stats = {}
    if sharded:
        want = check.reference_fit_ranks(config, inputs, got["batches"],
                                         rank, world, stats=stats)
    else:
        want = check.reference_fit(config, inputs, got,
                                   tr["fit"]["batch_size"], stats=stats)
    numbers = check.fit_numbers(got, want)
    numbers["nonfinite_losses"] = float(sum(
        not math.isfinite(v) for v in window_losses))
    run["least"] = work.step_work(shape_of(inputs, cell.config),
                                  per_view(stats),
                                  tr["fit"]["batch_size"] // world)
    run["attempted"] = run["window"]["steps"]
    run["failed"] = 0
    return run, numbers


def run_view(cell: Cell, inputs, seed, seconds, trace, device, t_start,
             trace_path):
    from benchmark import check, programs, work

    tr = cell.traffic
    drv = programs.ViewDriver(cell.config, tr, inputs, seed, device)
    n_warm = int(tr["warmup_views"])
    for i in range(n_warm):
        drv.render(i)
    programs.sync(device)
    run = {"kind": "view", "setup_s": time.perf_counter() - t_start}
    run["window"] = drv.window(seconds, start=n_warm)
    if trace:
        from benchmark import trace as tracing
        n = int(tr["trace_views"])
        start = n_warm + run["window"]["views"]
        run["slice_steps"] = n
        prof = tracing.profile(
            lambda: [drv.render(start + i) for i in range(n)], device,
            trace_path)
        run["timeline"] = tracing.read(prof["path"], prof["window_s"])
    run["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0)
    config = drv.config
    kept = {i: (drv.request(i), img) for i, img in
            run["window"].pop("kept").items()}
    drv.free()
    del drv
    if device.type == "cuda":
        torch.cuda.empty_cache()
    stats = {}
    views = sorted(kept.items())
    want = check.reference_views(config, inputs, [r for _, (r, _) in views],
                                 stats=stats)
    pairs = [(img, w) for (_, (_, img)), w in zip(views, want)]
    numbers = check.view_numbers(pairs)
    run["least"] = work.view_work(shape_of(inputs, cell.config),
                                  per_view(stats))
    run["attempted"] = run["window"]["views"]
    run["failed"] = 0
    return run, numbers


def device_record(device, run: dict, timeline) -> dict:
    if device.type == "cuda":
        from benchmark import card
        _, limit = card.card(device)
        rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": run.get("count", 1),
               "memory_peak_bytes": run["memory_peak_bytes"],
               "power_limit": limit}
    else:
        rec = {"platform": "cpu", "kind": "cpu",
               "count": run.get("count", 1), "memory_peak_bytes": 0}
    if timeline is not None:
        rec["busy_s"] = timeline["busy_s"]
        rec["window_s"] = timeline["window_s"]
    return rec


def build_kernels(device) -> dict:
    """Build every missing kernel library of the program at once (only the
    first run in a checkout finds any), so that set-up builds nothing
    later and the compiling run's build is recorded apart.

    :return: {"s": seconds, "built": the libraries compiled}."""
    if device.type != "cuda":
        return {"s": 0.0, "built": []}
    from fpc_diffrend_tpu_torch.kernels import build

    t0 = time.perf_counter()
    report = build.build()
    return {"s": time.perf_counter() - t0,
            "built": sorted(k for k, v in report.items() if v["seconds"])}


def run_cell(root: Path, name: str, seed: int, seconds: float, trace: bool,
             device, t_start: float) -> tuple:
    """Run one cell: inputs, set-up, the window, the traced slice (with
    ``trace``), the check.

    :return: (result dict for the last line, lines of compared numbers).
    """
    from benchmark import check
    from benchmark.inputs import make_inputs

    cell = resolve(root, name)
    kind = cell.traffic["kind"]
    build = build_kernels(device)
    inputs = make_inputs(cell.config, "view" if kind == "view" else "fit",
                         seed, device)
    trace_path = str(root / "benchmark" / "_traces"
                     / f"{name}.trace.json.gz")
    runner = {"fit": run_fit, "view": run_view, "fit_sharded": run_fit}[kind]
    run, numbers = runner(cell, inputs, seed, seconds, trace, device,
                          t_start, trace_path)
    correct, lines = check.verdict(numbers, cell.limits)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = reader(root, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    timeline = run.get("timeline")
    result = {"correct": correct, "attempted": run["attempted"],
              "failed": run["failed"], "metrics": metrics,
              "device": device_record(device, run, timeline if trace
                                      else None)}
    if trace and timeline is not None:
        result["breakdown"] = {"device_ops": timeline["device_ops"],
                               "idle_gaps": timeline["idle_gaps"]}
    result["least_time"] = run["least"]
    result["build"] = build
    result["checks"] = {n: {"value": numbers[n], "limit": cell.limits[n]}
                        for n in numbers}
    return result, lines


def set_cache_dirs(root: Path) -> None:
    """Point every build and kernel cache at a fixed directory inside the
    checkout (the program's own kernels build into its ``_build/``)."""
    base = root / "benchmark" / "_cache"
    for key, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[key] = str(base / sub)
        os.makedirs(base / sub, exist_ok=True)


def report(result: dict, lines: list, out=None, err=None) -> int:
    """Print the result line on ``out`` and the compared numbers last on
    ``err``; :return: 0, or 3 (and print no result) where a module of JAX
    or of the JAX package is loaded."""
    out = out or sys.stdout
    err = err or sys.stderr
    if jax_loaded(err):
        return 3
    print(json.dumps(result), file=out, flush=True)
    for line in lines:
        print(line, file=err)
    err.flush()
    return 0
