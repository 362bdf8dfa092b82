"""The program's own spans and counters in a cell's run: where a step's
host time goes, the launches and host syncs a step issues, the bins' fill,
and which layer the host was in when the device went idle.

The program records them only inside ``fpc_diffrend_tpu_torch.utils.
profiling.recording()``; a program without it (``recording_of()`` None)
gives none of this, and every reading here is then None. Two slices, each
after the unprofiled window:

* ``spans_slice``: steps or views under ``recording()`` alone, without
  the profiler (whose host cost about doubles a fit step's): each span's
  count, host seconds and self seconds (less what its children cover),
  and the counters;
* the traced slice under ``recording()`` too, so that each span is a
  ``user_annotation`` of its Chrome trace, on the clock of the kernels and
  of the CUDA runtime's calls: ``read_program`` counts each span's kernel
  launches and host syncs (by time, on any thread: on CUDA autograd's
  thread launches the backward while ``fit.backward`` waits on the main
  thread) and puts each idle gap of the device down to the program span
  that began last among those open at its start.

``READERS`` holds the per-layer readings of a run dict that carries them
(``spans``, ``counters``, ``spans_n``, ``program_timeline``,
``slice_steps``).

    python3 benchmark/spans.py --workload <cell> --seed <n> --seconds <s>
        [--turns 1]

runs a cell's set-up, ``--turns`` pairs of windows with recording off and
on in turns (off, on, on, off, ...), then both slices, and prints one JSON
line (also written to ``chiprun_out/spans/<cell>.<seed>.json``).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import collections  # noqa: E402
import contextlib  # noqa: E402
import gzip  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# the program's spans: its layers' names, and K11's range
PROGRAM_SPAN = re.compile(r"^(fit|model|raster|view)\.|^K11 ")
OUTSIDE = "(outside the program)"
HOST_CATS = ("cuda_runtime", "cuda_driver")
SYNCS = {"cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy", "cuStreamSynchronize",
         "cuCtxSynchronize", "cuEventSynchronize"}


def recording_of():
    """The program's ``recording`` context, or None where it has none."""
    mod = importlib.import_module("fpc_diffrend_tpu_torch.utils.profiling")
    return getattr(mod, "recording", None)


def summarize(spans) -> dict:
    """name -> {count, s, self_s} of recorded spans (name, start_ns,
    end_ns, thread, parent, request); a span's self time is its time less
    the union of its children's intervals. Summed here from the raw spans,
    not by the program's ``Recording.totals``, so that the readings do not
    move with the program."""
    kids = collections.defaultdict(list)
    for s in spans:
        if s[4] is not None and s[2] >= 0:
            kids[s[4]].append((s[1], s[2]))
    out = {}
    for i, s in enumerate(spans):
        if s[2] < 0:
            continue
        covered, last = 0, s[1]
        for a, b in sorted(kids[i]):
            a, b = max(a, last), min(b, s[2])
            if b > a:
                covered += b - a
                last = b
        row = out.setdefault(s[0], {"count": 0, "s": 0.0, "self_s": 0.0})
        row["count"] += 1
        row["s"] += (s[2] - s[1]) * 1e-9
        row["self_s"] += (s[2] - s[1] - covered) * 1e-9
    return out


def spans_slice(fn, n: int, device) -> dict:
    """``fn()`` (``n`` steps or views) under the program's recording, no
    profiler: {spans, counters, spans_n}; {} without ``recording``."""
    from benchmark import programs

    recording = recording_of()
    if recording is None:
        return {}
    with recording() as log:
        fn()
        programs.sync(device)
    return {"spans": summarize(log.spans), "counters": dict(log.counters),
            "spans_n": n}


def traced_slice(fn, device, trace_path: str) -> dict:
    """``benchmark.trace``'s traced slice of ``fn()``, under the program's
    recording where it has one: {timeline, program_timeline}."""
    from benchmark import trace as tracing

    recording = recording_of()
    with recording() if recording else contextlib.nullcontext():
        prof = tracing.profile(fn, device, trace_path)
    return {"timeline": tracing.read(prof["path"], prof["window_s"]),
            "program_timeline": read_program(prof["path"])}


def _inside(merged, ts) -> bool:
    i = bisect.bisect_right(merged, [ts, float("inf")]) - 1
    return i >= 0 and ts <= merged[i][1]


def read_program(path: str, top: int = 10):
    """The program's spans in a Chrome trace of the traced slice.

    :return: None where the trace holds no program span; else spans
        {name: {count, launches, syncs}} (kernel launches and host syncs
        of the CUDA runtime or driver that began inside one of the span's
        intervals, on any thread), idle_spans [[span, s]] (the largest
        sums of the device's idle gaps by the program span that began last
        among those open at the gap's start, any thread, or
        ``(outside the program)``), idle_s, idle_in_program_s, launches
        and syncs (the slice's totals).
    """
    from benchmark import trace as tracing

    with gzip.open(path, "rt") as f:
        events = json.load(f).get("traceEvents", [])
    spans, dev, calls = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat == "user_annotation" and PROGRAM_SPAN.match(name):
            spans.append((e["ts"], e["ts"] + e["dur"], name))
        elif cat in tracing.DEVICE_CATS:
            dev.append((e["ts"], e["ts"] + e["dur"]))
        elif cat in HOST_CATS and ("LaunchKernel" in name or name in SYNCS):
            calls.append((e["ts"], "LaunchKernel" in name))
    if not spans:
        return None
    by_name = collections.defaultdict(list)
    for s, e, name in spans:
        by_name[name].append((s, e))
    out = {}
    for name, ivs in by_name.items():
        merged = tracing._union(ivs)
        hits = [launch for ts, launch in calls if _inside(merged, ts)]
        out[name] = {"count": len(ivs), "launches": sum(hits),
                     "syncs": len(hits) - sum(hits)}
    spans.sort(key=lambda x: (x[0], -x[1]))     # of equal starts, outer first
    starts = [s for s, _, _ in spans]
    reach, far = [], float("-inf")        # the latest end among spans[:i+1]
    for _, e, _ in spans:
        far = max(far, e)
        reach.append(far)
    gaps = collections.Counter()
    busy = tracing._union(dev)
    for (_, g0), (g1, _) in zip(busy, busy[1:]):
        i = bisect.bisect_right(starts, g0) - 1
        owner = OUTSIDE
        while i >= 0 and reach[i] > g0:
            if spans[i][1] > g0:
                owner = spans[i][2]
                break
            i -= 1
        gaps[owner] += g1 - g0
    idle = sum(gaps.values())
    return {"spans": out,
            "idle_spans": [[n, t * 1e-6] for n, t in gaps.most_common(top)],
            "idle_s": idle * 1e-6,
            "idle_in_program_s": (idle - gaps[OUTSIDE]) * 1e-6,
            "launches": sum(launch for _, launch in calls),
            "syncs": sum(not launch for _, launch in calls)}


def _host_ms(kind: str, span: str):
    """ms a step (view) of ``span`` in the spans-only slice."""
    def read(run: dict):
        row = (run.get("spans") or {}).get(span)
        if run.get("kind") != kind or not row or not run.get("spans_n"):
            return None
        return 1e3 * row["s"] / run["spans_n"]
    return read


def _per_step(key: str):
    """``key`` (launches, syncs) inside ``fit.step`` a step of the traced
    slice."""
    def read(run: dict):
        pt = run.get("program_timeline")
        if (run.get("kind") != "fit" or not pt or "fit.step" not in
                pt["spans"] or not run.get("slice_steps")):
            return None
        return pt["spans"]["fit.step"][key] / run["slice_steps"]
    return read


def _fill(kind: str):
    """100 x the entries kept over the entries the bins hold."""
    def read(run: dict):
        c = run.get("counters") or {}
        if run.get("kind") != kind or not c.get("bin.capacity"):
            return None
        return 100.0 * c.get("bin.kept", 0) / c["bin.capacity"]
    return read


READERS = {
    "step_host_ms.fit": _host_ms("fit", "fit.step"),
    "bin_host_ms.fit": _host_ms("fit", "raster.bin"),
    "backward_host_ms.fit": _host_ms("fit", "fit.backward"),
    "optimizer_host_ms.fit": _host_ms("fit", "fit.optimizer"),
    "launches_per_step.fit": _per_step("launches"),
    "host_syncs.fit": _per_step("syncs"),
    "bin_fill_pct.fit": _fill("fit"),
    "bin_host_ms.render": _host_ms("view", "raster.bin"),
    "bin_fill_pct.render": _fill("view"),
}


def run_cell(root: Path, name: str, seed: int, seconds: float, turns: int,
             device, t_start: float) -> dict:
    """A cell's set-up and warm-up as ``benchmark.harness`` makes them,
    then windows with recording off and on in turns, the spans-only
    slice and the recorded traced slice.

    :return: {cell, seed, card, power_limit, setup_s, windows [{recording,
        rate, host_issue_ms}], readings (``READERS``), spans, counters,
        program_timeline, timeline}."""
    from benchmark import card, harness, programs
    from benchmark.inputs import make_inputs

    cell = harness.resolve(root, name)
    tr = cell.traffic
    kind = tr["kind"]
    harness.build_kernels(device)
    inputs = make_inputs(cell.config, kind, seed, device)
    if kind == "fit":
        drv = programs.FitDriver(cell.config, tr, inputs, seed, device)
        drv.steps(int(tr["warmup_steps"]))
        n = int(tr["trace_steps"])
        run = {"kind": "fit", "pixels_per_step": tr["fit"]["batch_size"]
               * cell.config["resolution"][0]
               * cell.config["resolution"][1]}
        rate = harness.reader(root, "fit_mpix_s")
        issue = harness.reader(root, "host_issue_ms.fit")

        def window():
            return drv.window(seconds, drv.log_every)

        def slice_():
            drv.steps(n)
    else:
        drv = programs.ViewDriver(cell.config, tr, inputs, seed, device)
        at = [int(tr["warmup_views"])]
        for i in range(at[0]):
            drv.render(i)
        n = int(tr["trace_views"])
        run = {"kind": "view"}
        rate = harness.reader(root, "render_views_s")

        def issue(_):
            return None

        def window():
            w = drv.window(seconds, start=at[0])
            at[0] += w["views"]
            return w

        def slice_():
            for i in range(n):
                drv.render(at[0] + i)
            at[0] += n
    programs.sync(device)
    run["setup_s"] = time.perf_counter() - t_start
    recording = recording_of()
    run["windows"] = []
    for on in [False, True, True, False] * turns:
        if on and recording is None:
            continue
        with recording() if on else contextlib.nullcontext():
            w = window()
        w.pop("kept", None)
        one = dict(run, window=w)
        run["windows"].append({"recording": on, "rate": rate(one),
                               "host_issue_ms": issue(one)})
    run.update(spans_slice(slice_, n, device))
    run["slice_steps"] = n
    run.update(traced_slice(slice_, device, str(
        root / "benchmark" / "_traces" / f"{name}.spans.trace.json.gz")))
    name_, limit = card.card(device)
    tl = run["timeline"]
    return {"cell": name, "seed": seed, "card": name_, "power_limit": limit,
            "setup_s": run["setup_s"], "windows": run["windows"],
            "readings": {k: f(run) for k, f in READERS.items()},
            "spans": run.get("spans"), "counters": run.get("counters"),
            "program_timeline": run["program_timeline"],
            "timeline": {k: tl[k] for k in ("busy_s", "window_s", "kernel_s",
                                             "n_kernels", "device_ops",
                                             "idle_gaps")}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--turns", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import harness

    harness.set_cache_dirs(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("spans.py needs a CUDA card", file=sys.stderr)
        return 1
    out = run_cell(ROOT, args.workload, args.seed, args.seconds, args.turns,
                   torch.device("cuda", 0), T_START)
    dest = ROOT / "chiprun_out" / "spans"
    dest.mkdir(parents=True, exist_ok=True)
    line = json.dumps(out)
    (dest / f"{args.workload}.{args.seed}.json").write_text(line)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
