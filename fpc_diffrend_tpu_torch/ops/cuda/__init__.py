"""The CUDA kernels' wrappers (port of ``fpc_diffrend_tpu.ops.pallas``).

:data:`KERNELS` names every wrapper by its launch counter: each wrapper's
``.launches`` counts its calls that launched, a CUDA graph's capture once
and its replays never (``fit.loop.train_steps`` replays the fit step).
What ran on the device, replays included, is measured by
:func:`device_launches`: each kernel of :data:`DEVICE_KERNELS` counted
in a ``torch.profiler`` trace of the scope. :func:`device_events` is the
one reader of such a trace's device work.
"""

import contextlib
import re

from fpc_diffrend_tpu_torch.ops.cuda import antialias_cuda as _ac
from fpc_diffrend_tpu_torch.ops.cuda import bin_place_cuda as _bp
from fpc_diffrend_tpu_torch.ops.cuda import raster_grad_cuda as _gc
from fpc_diffrend_tpu_torch.ops.cuda import rasterize_cuda as _rc
from fpc_diffrend_tpu_torch.ops.cuda import texture_cuda as _tc
from fpc_diffrend_tpu_torch.ops.cuda import texture_mip_cuda as _tmc

KERNELS = {"bin_place": _bp.place_pairs, "fused_raster": _rc.fused_raster,
           "antialias": _ac.antialias_planes,
           "antialias_bwd": _ac.antialias_planes_bwd,
           "texture_bwd": _tc.texture_planes_bwd,
           "pixel_grad": _gc.pixel_grad, "fold_entries": _gc.fold_entries,
           "mip_sample": _tmc.mip_sample,
           "mip_sample_bwd": _tmc.mip_sample_bwd,
           "texture_fwd": _tc.texture_planes,
           "fused_raster_aa": _rc.fused_raster_aa}

# the device kernels (``csrc``) each wrapper launches once a call: K11's
# first of three (its place kernel has two variants; K4's ``to_float``
# runs in one precision mode only); K10 is K1's kernel, then K2's
DEVICE_KERNELS = {"bin_place": ("count_rows_kernel",),
                  "fused_raster": ("fused_raster_kernel",),
                  "antialias": ("antialias_kernel",),
                  "antialias_bwd": ("antialias_bwd_kernel",),
                  "texture_bwd": ("texture_bwd_kernel",),
                  "pixel_grad": ("pixel_grad_kernel",),
                  "fold_entries": ("fold_kernel",),
                  "mip_sample": ("mip_fwd_kernel",),
                  "mip_sample_bwd": ("mip_bwd_kernel",),
                  "texture_fwd": ("texture_fwd_kernel",),
                  "fused_raster_aa": ("fused_raster_kernel",
                                      "antialias_kernel")}
_NAMES = sorted({k for ks in DEVICE_KERNELS.values() for k in ks})


def device_want(calls: dict) -> dict:
    """The device kernels' launches that ``calls`` (wrapper name -> calls,
    as :data:`KERNELS` names them) run: device kernel -> launches."""
    out = dict.fromkeys(_NAMES, 0)
    for name, n in calls.items():
        for k in DEVICE_KERNELS[name]:
            out[k] += n
    return out


def device_events(prof) -> list:
    """(name, self device ms, count) of the device-side events of a
    ``torch.profiler`` profile, largest first; annotations
    (``record_function`` ranges mirrored on the device, such as
    ``Optimizer.step``) are spans over kernels, not work, and are left
    out."""
    from torch.autograd import DeviceType

    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    return sorted(rows, key=lambda r: -r[1])


def count_kernels(events) -> dict:
    """Device kernel -> launches among ``events``, (name, count) pairs of
    a trace's device events: a name counts where the kernel's own name
    stands in it, by itself or qualified (``(anonymous
    namespace)::fold_kernel(float const*, ...)``, ``void
    pixel_grad_kernel<true>(...)``)."""
    pats = {k: re.compile(rf"(?:^|[\s:]){k}(?:[<(]|$)") for k in _NAMES}
    out = dict.fromkeys(_NAMES, 0)
    for name, n in events:
        for k, pat in pats.items():
            if pat.search(name):
                out[k] += n
    return out


@contextlib.contextmanager
def device_launches():
    """Measure the scope's kernels on the device, a CUDA graph's replays
    included: yields a dict that is filled, when the scope ends and the
    device has finished it, with :func:`count_kernels` of a
    ``torch.profiler`` trace of the scope (without a CUDA device, every
    count 0)."""
    import torch

    got = {}
    cuda = torch.cuda.is_available()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield got
        if cuda:
            torch.cuda.synchronize()
    got.update(count_kernels((name, n) for name, _, n in device_events(prof)))
