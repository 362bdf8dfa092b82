"""The port's bench over the five rows of the JAX package's bench matrix.

Port of ``tools/bench_matrix.py``: the same rows (``CONFIGS``, their JAX
``FPC_BENCH_*`` knobs as ``bench`` arguments) with the same names, run one
after another in this process through ``bench.run``; each row's JSON line
is printed and the lines are written to ``--out`` (a path the JAX run does
not use), then a markdown table.

Usage: python -m fpc_diffrend_tpu_torch.bench_matrix [--quick]
       [--only NAME,...] [--out chiprun_out/bench_matrix.json] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os

from fpc_diffrend_tpu_torch import bench

# (name, description, bench arguments): tools/bench_matrix.py's CONFIGS
CONFIGS = [
    ("256sq-1cam", "single-frame single-camera 256^2 (BASELINE config 1)",
     {"res_h": 256, "res_w": 256, "cams": 1, "grid": 63, "tex": 256}),
    ("512sq-9cam", "single-frame 9-camera 512^2 shared texture (config 2)",
     {"res_h": 512, "res_w": 512, "cams": 9, "grid": 87, "tex": 512}),
    ("temporal-100f-2cam", "100-frame sequence, temporal smoothness, "
     "2 cameras (config 3)",
     {"res_h": 512, "res_w": 512, "cams": 2, "frames": 100,
      "temporal": 10.0, "grid": 87, "tex": 512}),
    ("1600x1200-headline", "full-resolution 9-view sequence fit "
     "(config 4; the headline bench.py config)", {}),
    ("1600x1200-mip", "full-resolution with trilinear mipmap sampling "
     "(reference main.py:27-28 max_mip_level=6)", {"mip": 1}),
]
QUICK_ITERS = 3


def row_args(name: str, quick: bool = False, cpu: bool = False,
             grad_prec: str = "exact", tex_prec: str = "exact"):
    """The ``bench`` arguments of row ``name``."""
    args = bench.parse_args(["--iters", str(QUICK_ITERS)] if quick else [])
    vars(args).update(next(c[2] for c in CONFIGS if c[0] == name), row=name,
                      cpu=cpu, grad_prec=grad_prec, tex_prec=tex_prec)
    return args


def run(only=(), quick: bool = False, cpu: bool = False,
        check=None) -> list[dict]:
    """Run the rows (those named in ``only``, else all) in order.

    :param check: None, or called as ``check(name, workload)`` after each
        row's line with the workload that row built and timed.
    :return: each row's record (``bench.run``'s, with ``config`` and
        ``desc``).
    """
    rows = []
    for name, desc, _ in CONFIGS:
        if only and name not in only:
            continue
        print(f"=== {name}: {desc}", flush=True)
        rec, wl = bench.run(row_args(name, quick, cpu))
        rec.update(config=name, desc=desc)
        print(json.dumps(rec), flush=True)
        rows.append(rec)
        if check is not None:
            check(name, wl)
        del wl                  # free it before the next row builds
    return rows


def table(rows) -> str:
    lines = ["| config | Mpix/s | step ms | vs baseline proxy | card |",
             "|---|---|---|---|---|"]
    lines += [f"| {r['config']} | {r['value']} | {r['step_ms']:.3f} | "
              f"{r['vs_baseline']} | {r['name']}, {r['power_limit']} |"
              for r in rows]
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help=f"{QUICK_ITERS} timing iters instead of 10")
    ap.add_argument("--only", default="",
                    help="comma-separated config name filter")
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "bench_matrix.json"))
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    only = [s for s in args.only.split(",") if s]
    unknown = set(only) - {c[0] for c in CONFIGS}
    if unknown:
        ap.error(f"unknown rows {sorted(unknown)}")
    rows = run(only, args.quick, args.cpu)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=1)
    print("\n" + table(rows))
    print("wrote", args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
