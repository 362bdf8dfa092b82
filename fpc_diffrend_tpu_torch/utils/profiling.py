"""Timing and tracing hooks (port of ``fpc_diffrend_tpu.utils.profiling``).

``time_fn`` waits for the devices the result lives on before it reads
the clock; ``trace`` records the host and, where there is one, the CUDA
device with ``torch.profiler`` and writes a Chrome trace.

The program's own spans and counters (port-only): ``span(name)`` marks a
layer of the fit step or the view (``fit.step``, ``raster.bin``, ...) and
``count(name, value)`` adds to a counter (``bin.kept``, ...). Both do
nothing until ``recording()`` turns them on for its scope (counters stay
off while a CUDA graph is captured); then each span
takes the host clock at entry and exit, with its thread, its parent span
and its request (the fit step's number or the view's), and enters
``annotate(name)``, so that a ``torch.profiler`` trace of the scope holds
it as a ``user_annotation`` on the clock of the kernels::

    with profiling.recording() as log:
        loop.run_fit(config, scene, frames, n_frames, n_steps=50)
    log.totals()["fit.backward"]      # (count, seconds, self seconds)

``fpc_diffrend_tpu_torch.profile_forward`` breaks a traced step down by
these spans.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import NamedTuple

import torch

from fpc_diffrend_tpu_torch.utils.debugging import tree_leaves_with_path


def sync(tree) -> float:
    """Wait for the devices of ``tree``'s tensors; :return: the sum of
    their absolute values in float32 (a checksum)."""
    leaves = [x for _, x in tree_leaves_with_path(tree)
              if isinstance(x, torch.Tensor)]
    if not leaves:
        return 0.0
    for dev in {x.device for x in leaves if x.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    total = sum(torch.sum(torch.abs(x.detach().to(torch.float32))).cpu()
                for x in leaves)
    return float(total)


def time_fn(fn, *args, iters: int = 10, warmup: int = 1):
    """(seconds_per_call, last_result) of ``fn(*args)`` over ``iters``
    calls after ``warmup``, the devices synchronized at both ends."""
    r = None
    for _ in range(warmup):
        r = fn(*args)
    sync(r)
    t0 = time.time()
    for _ in range(iters):
        r = fn(*args)
    sync(r)
    return (time.time() - t0) / iters, r


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the scope; writes ``log_dir/trace.json`` (Chrome trace
    format: chrome://tracing, Perfetto)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named region for profiler timelines."""
    return torch.profiler.record_function(name)


class Span(NamedTuple):
    """One recorded span: host clock (``time.perf_counter_ns``) at entry
    and exit, the thread it ran on, the index of its parent span in
    :attr:`Recording.spans` (None: none) and its request (the open fit
    step's number or the view's index; None: none)."""

    name: str
    start_ns: int
    end_ns: int
    thread: int
    parent: int | None
    request: int | None


class Recording:
    """What :func:`recording` gathered: :attr:`spans` (in the order they
    opened; a span still open at the scope's end has ``end_ns`` -1) and
    :attr:`counters` (name -> int). Device counters are read once, when
    the scope ends."""

    def __init__(self):
        self.spans = []
        self.counters = {}
        self._device = {}
        self._lock = threading.Lock()
        self._local = threading.local()
        self._home = self._stack()

    def _stack(self) -> list:
        """This thread's open spans (indices into ``spans``)."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _open(self, name: str, request) -> int:
        stack = self._stack()
        # a thread with no open span (autograd's device thread) works for
        # the innermost span of the recording's own thread (fit.backward)
        outer = stack or self._home
        parent = outer[-1] if outer else None
        if request is None and parent is not None:
            request = self.spans[parent][5]
        elif callable(request):
            request = request()
        with self._lock:
            index = len(self.spans)
            self.spans.append([name, time.perf_counter_ns(), -1,
                               threading.get_ident(), parent, request])
        stack.append(index)
        return index

    def _close(self, index: int) -> None:
        self.spans[index][2] = time.perf_counter_ns()
        self._stack().pop()

    def add(self, name: str, value) -> None:
        """Add ``value`` (an int, or a tensor summed on its device into an
        int64 slot, never read before the scope ends) to counter ``name``."""
        with self._lock:
            if isinstance(value, torch.Tensor):
                slot = self._device.get(name)
                if slot is None:
                    slot = self._device[name] = torch.zeros(
                        (), dtype=torch.int64, device=value.device)
                slot.add_(value if value.dim() == 0 else value.sum())
            else:
                self.counters[name] = self.counters.get(name, 0) + int(value)

    def _finish(self) -> None:
        self.spans = [Span(*s) for s in self.spans]
        by_device = {}
        for name, slot in self._device.items():
            by_device.setdefault(slot.device, []).append((name, slot))
        for items in by_device.values():          # one read a device
            values = torch.stack([slot for _, slot in items]).tolist()
            for (name, _), v in zip(items, values):
                self.counters[name] = self.counters.get(name, 0) + v
        self._device.clear()

    def totals(self) -> dict:
        """name -> (count, seconds, self seconds) of the closed spans; a
        span's self time is its time less what its children cover."""
        child = {}
        for s in self.spans:
            if s.parent is not None and s.end_ns >= 0:
                child.setdefault(s.parent, []).append((s.start_ns, s.end_ns))
        out = {}
        for i, s in enumerate(self.spans):
            if s.end_ns < 0:
                continue
            covered, last = 0, s.start_ns
            for a, b in sorted(child.get(i, ())):
                a, b = max(a, last), min(b, s.end_ns)
                if b > a:
                    covered += b - a
                    last = b
            n, total, own = out.get(s.name, (0, 0.0, 0.0))
            dur = s.end_ns - s.start_ns
            out[s.name] = (n + 1, total + dur * 1e-9,
                           own + (dur - covered) * 1e-9)
        return out


_ACTIVE = None            # the Recording in force, or None: recording off
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("log", "name", "request", "index", "region")

    def __init__(self, log: Recording, name: str, request):
        self.log, self.name, self.request = log, name, request

    def __enter__(self):
        self.index = self.log._open(self.name, self.request)
        self.region = annotate(self.name)
        self.region.__enter__()

    def __exit__(self, *exc):
        self.region.__exit__(*exc)
        self.log._close(self.index)
        return False


def span(name: str, request=None):
    """The program's span ``name`` at a layer boundary (a ``with``
    context). Off (no :func:`recording` in force) it is one shared no-op
    context: no clock read, no ``record_function``.

    :param request: the request the span serves (an int, or a callable
        that gives it, called only while recording); None: the parent's.
    """
    log = _ACTIVE
    if log is None:
        return _OFF
    return _Span(log, name, request)


def count(name: str, value) -> None:
    """Add ``value`` to the counter ``name`` while recording; off, or while
    a CUDA graph is being captured (its counter launches would be replayed
    with the graph), nothing.

    :param value: an int, a tensor (summed on its device), or a callable
        that gives one, called only while recording (so that a device
        counter launches nothing when off).
    """
    log = _ACTIVE
    if log is None or (torch.cuda.is_available()
                       and torch.cuda.is_current_stream_capturing()):
        return
    log.add(name, value() if callable(value) else value)


@contextlib.contextmanager
def recording():
    """Turn the spans and counters on for the scope; yields the
    :class:`Recording`, complete when the scope ends. Inside another
    recording's scope it yields that one."""
    global _ACTIVE
    if _ACTIVE is not None:
        yield _ACTIVE
        return
    log = Recording()
    _ACTIVE = log
    try:
        yield log
    finally:
        _ACTIVE = None
        log._finish()


def device_memory_stats() -> dict:
    """Memory stats of each CUDA device (``torch.cuda.memory_stats``);
    ``{"cpu": None}`` where there is none, as JAX gives a device without
    stats."""
    if not torch.cuda.is_available():
        return {"cpu": None}
    return {f"cuda:{i}": torch.cuda.memory_stats(i)
            for i in range(torch.cuda.device_count())}
