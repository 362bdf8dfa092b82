"""Build the CUDA kernels of ``csrc/`` at first use, load them, and check
what their wrappers pass in.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared
library with a plain C interface, which is loaded with ``ctypes``: pointers
and the stream go in as ``c_void_p``, and every entry point returns
``cudaGetLastError()``. :func:`entry` binds an entry point's argument types
once and caches it, so a launch costs the host one dict lookup and one
foreign call. A source that includes no PyTorch header builds in seconds;
``torch.utils.cpp_extension.load`` takes minutes per file.

Libraries go to ``fpc_diffrend_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of the source, the headers of ``csrc/``
and the flags, so a changed source or header is rebuilt and an unchanged
one is reused. All sources that need a build are compiled by concurrent
``nvcc`` processes.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# name -> source file under csrc/
SOURCES = {
    "fused_raster": "fused_raster.cu",
    "antialias": "antialias.cu",
    "antialias_bwd": "antialias_bwd.cu",
    "texture_fwd": "texture_fwd.cu",
    "texture_bwd": "texture_bwd.cu",
    "raster_grad": "raster_grad.cu",
    "texture_mip": "texture_mip.cu",
    "bin_place": "bin_place.cu",
}

# -fmad=false: no multiply-add contraction, so each kernel rounds every
# product and sum exactly as its plain PyTorch version does and the two
# agree bit for bit on the id buffer, the antialias deltas and the
# antialias backward; only the sums taken with atomics differ in order.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
]

_loaded: dict[str, ctypes.CDLL] = {}
_entries: dict = {}

# the argument types of the entry points
PTR = ctypes.c_void_p
INT = ctypes.c_int
INT64 = ctypes.c_int64


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, /usr/local/cuda, or PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + headers
                          + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names=None) -> dict:
    """Compile every library in ``names`` (default: all) that is missing.

    :return: name -> {"seconds": wall time of its nvcc, 0 if reused,
        "log": nvcc's output (``-Xptxas -v`` register/spill report)}.
    :raises RuntimeError: an nvcc failed; its output is in the message.
    """
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    report = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            report[name] = {"seconds": 0.0, "log": "reused " + out.name}
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if it is missing."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib


def entry(name: str, symbol: str, argtypes):
    """The entry point ``symbol`` of library ``name``, loaded (and built)
    at first use with its ``argtypes`` and an int ``restype`` bound once;
    later calls return the same function object at the cost of a dict
    lookup, so a wrapper asks for it at every launch."""
    fn = _entries.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = list(argtypes)
        _entries[(name, symbol)] = fn
    return fn


def check(status: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")


def check_tensor(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` has the device, dtype and shape a kernel expects
    and is contiguous (the kernels index raw row-major memory). The usual
    case costs one test (a wrapper runs it at every launch)."""
    if (t.dtype == dtype and t.device == device and t.shape == shape
            and t.is_contiguous()):
        return
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def ptr(t: torch.Tensor) -> int:
    """A tensor's device address, as a ``PTR`` argument of an entry point
    takes it (ctypes converts the int through the bound ``argtypes``)."""
    return t.data_ptr()


def stream(device: torch.device) -> int:
    """The current CUDA stream of ``device``, as a kernel launch takes it:
    the handle ``torch.cuda.current_stream(device).cuda_stream`` gives,
    read without building a ``Stream`` object (as PyTorch's generated
    kernels read it), which would take most of a small kernel's host
    issue."""
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)
