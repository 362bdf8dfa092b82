"""The readings the limits of ``benchmark/limits/<cell>.json`` are set
from, on the card, at the cell's own size, in one process:

* the program's compared numbers on each seed of ``--seeds`` (its set-up
  and first steps, or its renders of the views a run keeps, against the
  reference);
* the control's on each of ``--control-seeds``: the reference computed
  with TF32's rounding of its matrix products, put in the program's place;
* the planted faults' on the same seeds: a fit step on half the batch,
  the mean taken over the rest (the reference put in the program's
  place); a view's image altered where it is produced (a 64 x 64 block of
  the program's image raised by 0.1).

A sharded fit cell (``benchmark/ranks.py`` starts its ranks, the
reference is spread over them) also reads the program with its flat
all-reduce over the world skipped, each rank stepping on its own part of
the batch (``no_allreduce``); its half batch is the first half of each
global batch.

A step that returns its state unchanged needs no run: its
``median_change_gap`` follows from the reference's change alone (the
median over the leaves of min(1, leaf norm / median leaf norm)), read on
every seed. Each fit reading also gives the worst leaf's change gap
(``worst_change_gap``), which is not compared.

    python3 benchmark/readings.py --workload face9-fit-b1 \
        --seeds 101 102 ... --control-seeds 201 202 203 --out FILE
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import ranks  # noqa: E402

# seconds the ranks of a sharded cell's readings may take in all
RANKS_DEADLINE_S = 3000


def fit_readings(cell, seeds, control_seeds, device):
    import torch

    from benchmark import check, programs
    from benchmark.inputs import make_inputs
    from benchmark.reference import fit as ref_fit

    batch = cell.traffic["fit"]["batch_size"]
    n = int(cell.traffic["check_steps"])
    out = {"program": {}, "control": {}, "half_batch": {}, "unchanged": {}}
    for seed in sorted(set(seeds) | set(control_seeds)):
        t0 = time.perf_counter()
        inputs = make_inputs(cell.config, "fit", seed, device)
        drv = programs.FitDriver(cell.config, cell.traffic, inputs, seed,
                                 device)
        got = drv.first_steps(n)
        config = drv.config
        drv.free()
        del drv
        torch.cuda.empty_cache()
        want = check.reference_fit(config, inputs, got, batch)
        out["unchanged"][seed] = check.fit_numbers(
            dict(got, params=got["params0"]), want)["median_change_gap"]
        if seed in seeds:
            out["program"][seed] = dict(
                check.fit_numbers(got, want), worst_change_gap=max(
                    check.change_gaps(got, want).values()))
        if seed in control_seeds:
            for name, prec, filt in (
                    ("control", ref_fit.Precision(tf32=True), None),
                    ("half_batch", None,
                     (lambda c, f: (c[:len(c) // 2], f[:len(f) // 2]))
                     if batch > 1 else None)):
                if name == "half_batch" and filt is None:
                    continue
                alt = check.reference_fit(config, inputs, got, batch, prec,
                                          batch_filter=filt)
                alt["params0"] = got["params0"]
                out[name][seed] = dict(
                    check.fit_numbers(alt, want), worst_change_gap=max(
                        check.change_gaps(alt, want).values()))
        print(seed, {k: v.get(seed) for k, v in out.items()},
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        del inputs
        torch.cuda.empty_cache()
    return out


def _sharded_first_steps(cell, inputs, seed, device, n):
    import torch

    from benchmark import programs

    drv = programs.ShardedFitDriver(cell.config, cell.traffic, inputs, seed,
                                    device)
    got = drv.first_steps(n)
    config = drv.config
    drv.free()
    del drv
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return got, config


def fit_sharded_readings(cell, seeds, control_seeds, device):
    import torch
    import torch.distributed as dist

    from benchmark import check
    from benchmark.inputs import make_inputs
    from benchmark.reference import fit as ref_fit
    from fpc_diffrend_tpu_torch.parallel import train as ptrain

    rank, world = dist.get_rank(), dist.get_world_size()
    n = int(cell.traffic["check_steps"])
    out = {"program": {}, "control": {}, "half_batch": {},
           "no_allreduce": {}, "unchanged": {}, "reference_s": {}}
    real = ptrain._all_reduce_flat

    def skipped(tensors, group):
        return None if group is None else real(tensors, group)

    for seed in sorted(set(seeds) | set(control_seeds)):
        t0 = time.perf_counter()
        inputs = make_inputs(cell.config, "fit", seed, device)
        got, config = _sharded_first_steps(cell, inputs, seed, device, n)
        t1 = time.perf_counter()
        want = check.reference_fit_ranks(config, inputs, got["batches"],
                                         rank, world)
        out["reference_s"][seed] = time.perf_counter() - t1
        out["unchanged"][seed] = check.fit_numbers(
            dict(got, params=got["params0"]), want)["median_change_gap"]
        if seed in seeds:
            out["program"][seed] = dict(
                check.fit_numbers(got, want), worst_change_gap=max(
                    check.change_gaps(got, want).values()))
        if seed in control_seeds:
            for name, prec, filt in (
                    ("control", ref_fit.Precision(tf32=True), None),
                    ("half_batch", None,
                     lambda c, f: (c[:len(c) // 2], f[:len(f) // 2]))):
                alt = check.reference_fit_ranks(config, inputs,
                                                got["batches"], rank, world,
                                                prec, batch_filter=filt)
                alt["params0"] = got["params0"]
                out[name][seed] = dict(
                    check.fit_numbers(alt, want), worst_change_gap=max(
                        check.change_gaps(alt, want).values()))
            ptrain._all_reduce_flat = skipped
            try:
                bad, _ = _sharded_first_steps(cell, inputs, seed, device, n)
            finally:
                ptrain._all_reduce_flat = real
            out["no_allreduce"][seed] = dict(
                check.fit_numbers(bad, want), worst_change_gap=max(
                    check.change_gaps(bad, want).values()))
        if rank == 0:
            print(seed, {k: v.get(seed) for k, v in out.items()},
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        del inputs
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out


def view_readings(cell, seeds, control_seeds, device):
    import torch

    from benchmark import check, programs
    from benchmark.inputs import make_inputs
    from benchmark.reference import fit as ref_fit

    k = int(cell.traffic["check_views"])
    out = {"program": {}, "control": {}, "altered": {}}
    for seed in sorted(set(seeds) | set(control_seeds)):
        t0 = time.perf_counter()
        inputs = make_inputs(cell.config, "view", seed, device)
        drv = programs.ViewDriver(cell.config, cell.traffic, inputs, seed,
                                  device)
        views = [(drv.request(i), drv.render(i)) for i in range(k)]
        config = drv.config
        drv.free()
        del drv
        want = check.reference_views(config, inputs, [r for r, _ in views])
        if seed in seeds:
            out["program"][seed] = check.view_numbers(
                [(img, w) for (_, img), w in zip(views, want)])
        if seed in control_seeds:
            ctrl = check.reference_views(config, inputs,
                                         [r for r, _ in views],
                                         ref_fit.Precision(tf32=True))
            out["control"][seed] = check.view_numbers(zip(ctrl, want))
            altered = []
            for (_, img), w in zip(views, want):
                bad = img.clone()
                h, wd = bad.shape[:2]
                bad[h // 2:h // 2 + 64, wd // 2:wd // 2 + 64] += 0.1
                altered.append((bad, w))
            out["altered"][seed] = check.view_numbers(altered)
        print(seed, {kk: v.get(seed) for kk, v in out.items()},
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        del inputs
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", required=True)
    ranks.add_args(ap)
    args = ap.parse_args(argv)
    from benchmark import card, harness

    harness.set_cache_dirs(ROOT)
    import torch

    cell = harness.resolve(ROOT, args.workload)
    kind = cell.traffic["kind"]
    if args.rank is not None:
        device = ranks.join(args)
    else:
        chips = {w["name"]: w["chips"] for w in
                 harness.load_spec(ROOT)["workloads"]}[args.workload]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"the cell needs {chips} CUDA card(s)", file=sys.stderr)
            return 1
        if kind == "fit_sharded":
            harness.build_kernels(torch.device("cuda", 0))
            return ranks.launch(__file__, sys.argv[1:] if argv is None
                                else argv, chips, "cuda", time.time(),
                                deadline_s=RANKS_DEADLINE_S)
        device = torch.device("cuda", 0)
    fn = {"fit": fit_readings, "view": view_readings,
          "fit_sharded": fit_sharded_readings}[kind]
    try:
        out = fn(cell, args.seeds, args.control_seeds, device)
    finally:
        if args.rank is not None:
            ranks.leave()
    if args.rank:
        return 0
    name, limit = card.card(device)
    record = {"workload": args.workload, "card": name, "power_limit": limit,
              "seconds": time.perf_counter() - T_START, **out}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    for kind, rows in out.items():
        if not rows:
            continue
        vals = list(rows.values())
        if isinstance(vals[0], dict):
            print(kind, {key: (min(r[key] for r in vals),
                               max(r[key] for r in vals))
                         for key in vals[0]})
        else:
            print(kind, (min(vals), max(vals)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
