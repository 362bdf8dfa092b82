"""The ranks of a cell that asks for more than one card.

``run.py`` (and ``readings.py``) become a launcher for such a cell: it
starts one process a card, each the same script with the hidden arguments
of :func:`add_args`, and waits for all of them. Rank r runs on ``cuda:r``
and joins the others through the program's own
``parallel/multihost.initialize`` over NCCL (gloo on the CPU, where the
tests run two ranks). Rank 0 prints the result; every other rank exits 3
where its process holds a module of JAX or of the JAX package. The
launcher passes rank 0's output on once every rank has ended well. A rank
that fails, or that
outlives the deadline, ends the run: every rank is killed, the launcher
prints what they said on standard error, prints no result and exits
non-zero.
"""

from __future__ import annotations

import argparse
import datetime
import signal
import socket
import subprocess
import sys
import tempfile
import time

# seconds a rank waits in a collective for the others (torch.distributed's
# default for every group of the rank's process)
COLLECTIVE_TIMEOUT_S = 300
# seconds from the ranks' start to the end of the last of them; a run has
# 360 s in all, and the launcher builds the kernels before it starts them
DEADLINE_S = 330
# how much of each rank's standard error a failed run shows
TAIL = 4000


def add_args(ap: argparse.ArgumentParser) -> None:
    """The arguments the launcher gives each rank (not for users)."""
    for flag, kind in (("--rank", int), ("--world", int), ("--coord", str),
                       ("--device-type", str), ("--t0", float)):
        ap.add_argument(flag, type=kind, default=None, help=argparse.SUPPRESS)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _die_with_parent() -> None:
    """In the child before it runs: be killed when the launcher dies."""
    import ctypes

    ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)  # SET_PDEATHSIG


def _terminated(signum, frame):
    raise SystemExit(128 + signum)


def _code(returncode: int) -> int:
    """A rank's exit code as a shell gives it (128 + n for signal n)."""
    return 128 - returncode if returncode < 0 else returncode


def launch(script, argv: list, world: int, device_type: str,
           t0_wall: float, deadline_s: float = DEADLINE_S, out=None,
           err=None) -> int:
    """Run ``world`` ranks of ``python3 script *argv`` and wait for them.

    :param t0_wall: the run's start (``time.time()``), from which each rank
        counts its set-up.
    :return: 0 where every rank ended with 0 (rank 0's standard output and
        error passed on, its error last), else the worst rank's code, or
        137 for ranks killed at the deadline.
    """
    out = out or sys.stdout
    err = err or sys.stderr
    coord = f"localhost:{free_port()}"
    logs = [(tempfile.TemporaryFile(), tempfile.TemporaryFile())
            for _ in range(world)]
    procs = []
    late = False
    old = signal.signal(signal.SIGTERM, _terminated)
    try:
        for r in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, str(script), *argv, "--rank", str(r),
                 "--world", str(world), "--coord", coord, "--device-type",
                 device_type, "--t0", repr(t0_wall)],
                stdin=subprocess.DEVNULL, stdout=logs[r][0],
                stderr=logs[r][1], preexec_fn=_die_with_parent))
        end = time.monotonic() + deadline_s
        while True:
            codes = [p.poll() for p in procs]
            if all(c == 0 for c in codes) or any(c for c in codes):
                break
            if time.monotonic() > end:
                late = True
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        signal.signal(signal.SIGTERM, old)
    texts = []
    for o, e in logs:
        o.seek(0)
        e.seek(0)
        texts.append((o.read().decode(errors="replace"),
                      e.read().decode(errors="replace")))
        o.close()
        e.close()
    codes = [_code(p.returncode) for p in procs]
    if late or any(codes):
        for r, (_, e) in enumerate(texts):
            print(f"--- rank {r} (exit {codes[r]}):\n{e[-TAIL:]}", file=err)
        why = (f"outlived the deadline of {deadline_s} s" if late
               else "failed")
        print(f"ranks {why}: exit codes {codes}; no result", file=err,
              flush=True)
        return max(codes) or 1
    for _, e in texts[1:]:
        err.write(e)
    out.write(texts[0][0])
    out.flush()
    err.write(texts[0][1])
    err.flush()
    return 0


def join(args):
    """Join this rank to the world (``args``: rank, world, coord,
    device_type) through the program's ``multihost.initialize``, every
    collective's timeout :data:`COLLECTIVE_TIMEOUT_S`.

    :return: the rank's device.
    """
    import torch
    from torch.distributed import distributed_c10d

    from fpc_diffrend_tpu_torch.parallel import multihost

    timeout = datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S)
    distributed_c10d.default_pg_timeout = timeout
    distributed_c10d.default_pg_nccl_timeout = timeout
    if args.device_type == "cuda":
        torch.cuda.set_device(args.rank)
        device = torch.device("cuda", args.rank)
    else:
        device = torch.device(args.device_type)
    multihost.initialize(args.coord, args.world, args.rank,
                         backend="nccl" if device.type == "cuda" else "gloo")
    return device


def start_of(t0_wall: float) -> float:
    """The run's start on this process's ``time.perf_counter``."""
    return time.perf_counter() - (time.time() - t0_wall)


def leave() -> None:
    """Leave the world (the process group ends with this rank)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()
