"""One run of one cell of the benchmark.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout that holds the program
(``fpc_diffrend_tpu_torch``). Builds the cell's inputs on the card from the
seed, sets the program up and warms it up on the cell's own shapes, runs
the cell's loop for ``--seconds``, then (with ``--trace 1``) a bounded
traced slice, checks what the timed path produced against the plain
reference, and prints one JSON line: with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics. Every
compared number is printed beside its limit, last on standard error and
last in the line. Exits 1 without a result where there is no CUDA card,
and 3 where a module of JAX or of the JAX package is loaded at the end.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import harness

    harness.set_cache_dirs(ROOT)
    import torch

    chips = {w["name"]: w["chips"] for w in
             harness.load_spec(ROOT)["workloads"]}.get(args.workload, 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    result, lines = harness.run_cell(ROOT, args.workload, args.seed,
                                     args.seconds, bool(args.trace), device,
                                     T_START)
    return harness.report(result, lines)


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
