"""ctypes bindings of the native runtime (``csrc/fpcruntime.cpp``).

The port's own copy of ``fpc_diffrend_tpu.runtime.native``: threaded TIFF
decode of a take, threaded OBJ vertex parsing, bulk .seq reads. The library
is compiled by ``g++`` at first use into ``fpc_diffrend_tpu_torch/_build/``
(listed in ``.gitignore``), named by a hash of the source and the flags as
``kernels.build`` names the CUDA libraries; nothing is built inside the
package's source tree. ``available()`` is False where it cannot be built
or loaded, and callers then take their Python path.

``load_tiffs.files`` and ``parse_obj_vertices.files`` count the files each
has read, so a run can show that its data went through the runtime.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from fpc_diffrend_tpu_torch.kernels.build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "csrc" / "fpcruntime.cpp"
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-pthread", "-shared"]

_state: dict = {}


def library_path() -> Path:
    digest = hashlib.sha1(SOURCE.read_bytes()
                          + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libfpcruntime-{digest[:12]}.so"


def build() -> Path:
    """Compile the library unless it exists; :return: its path.

    :raises RuntimeError: no C++ compiler, or it failed (output attached).
    """
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler: the native runtime cannot be "
                           "built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"native runtime build failed (exit "
                           f"{r.returncode}):\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    if "lib" in _state:
        return _state["lib"]
    try:
        lib = ctypes.CDLL(str(build()))
    except (RuntimeError, OSError, subprocess.TimeoutExpired) as e:
        _state["error"] = str(e)
        _state["lib"] = None
        return None
    lib.fpc_tiff_probe.argtypes = [ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_uint32),
                                   ctypes.POINTER(ctypes.c_uint32)]
    lib.fpc_tiff_probe.restype = ctypes.c_int
    lib.fpc_load_take.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.fpc_load_take.restype = ctypes.c_int
    lib.fpc_parse_obj_vertices.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int]
    lib.fpc_parse_obj_vertices.restype = ctypes.c_int
    lib.fpc_seq_read_frames.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint32, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_int]
    lib.fpc_seq_read_frames.restype = ctypes.c_int
    _state["lib"] = lib
    return lib


def available() -> bool:
    """True once the library is built and loaded."""
    return _load() is not None


def unavailable_reason() -> str:
    """Why :func:`available` is False ("" when it is True)."""
    _load()
    return _state.get("error", "")


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError("native runtime unavailable: "
                           + unavailable_reason())
    return lib


def _paths_array(paths: list[str]):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [os.fsencode(p) for p in paths]
    return arr


def _threads(n_threads: int) -> int:
    return n_threads or min(16, os.cpu_count() or 1)


def tiff_probe(path: str) -> tuple[int, int] | None:
    """(width, height) of an uncompressed grayscale TIFF the decoder takes,
    else None."""
    lib = _require()
    w, h = ctypes.c_uint32(), ctypes.c_uint32()
    if lib.fpc_tiff_probe(os.fsencode(path), ctypes.byref(w),
                          ctypes.byref(h)):
        return None
    return int(w.value), int(h.value)


def load_tiffs(paths: list[str], width: int, height: int,
               clip_max: int = 140, flip: bool = True,
               n_threads: int = 0) -> np.ndarray:
    """Decode grayscale TIFFs -> (N, H, W) uint8, clipped and flipped.

    :raises RuntimeError: the library is unavailable or a file failed.
    """
    lib = _require()
    out = np.empty((len(paths), height, width), np.uint8)
    failures = lib.fpc_load_take(
        _paths_array(paths), len(paths),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        width, height, clip_max, int(flip), _threads(n_threads))
    if failures:
        raise RuntimeError(f"{failures} TIFFs failed native decode")
    load_tiffs.files += len(paths)
    return out


def parse_obj_vertices(paths: list[str], n_floats: int,
                       n_threads: int = 0) -> np.ndarray:
    """Parse the vertex blocks of many OBJs -> (N, n_floats) float32."""
    lib = _require()
    out = np.empty((len(paths), n_floats), np.float32)
    failures = lib.fpc_parse_obj_vertices(
        _paths_array(paths), len(paths),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_floats, _threads(n_threads))
    if failures:
        raise RuntimeError(f"{failures} OBJs failed native parse")
    parse_obj_vertices.files += len(paths)
    return out


def seq_read_frames(path: str, first: int, count: int, width: int,
                    height: int, true_image_size: int,
                    n_threads: int = 0) -> np.ndarray:
    """Bulk-read uncompressed .seq frames -> (count, H, W) uint8."""
    lib = _require()
    out = np.empty((count, height, width), np.uint8)
    rc = lib.fpc_seq_read_frames(
        os.fsencode(path), first, count,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        width, height, true_image_size, _threads(n_threads))
    if rc:
        raise RuntimeError(f"{rc} seq frames failed to read")
    return out


load_tiffs.files = 0
parse_obj_vertices.files = 0
