"""The JAX package's public surface, mapped onto the port.

Walks every module of ``fpc_diffrend_tpu`` (``ops/pallas/`` included) and
holds each public callable it defines to the port: present under its own
name in a counterpart module, or named in :data:`SURFACE` as renamed,
absorbed into other port objects, or left out, with the reason. The
other way round, every port module with no JAX module at its path names
its JAX source in :data:`PORT_ONLY`.

When the JAX side gains a public name, the walk of its module fails here
until the port has the name or :data:`SURFACE` has a row for it. A
``renamed`` row's pair also reaches ``test_torch_models.
test_shared_signatures_follow_jax``, which checks its parameters against
JAX's under the differences named in that file's ``RENAMED``,
``DROPPED``, ``ADDED`` and ``DEFAULTS`` tables.

Everything here is exact: names, files and the version string.
"""

import importlib
import importlib.util
import os
import pkgutil
import types
from typing import NamedTuple

import pytest

import fpc_diffrend_tpu
import fpc_diffrend_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ``runtime/libfpcruntime`` is the native library's shared object, which
# the walk finds as a module but which is no Python module;
# ``runtime/native.py`` binds it, and the port's ``runtime/native.py`` is
# its counterpart.
NOT_MODULES = ("runtime.libfpcruntime",)

# JAX module -> the port modules that are its counterpart. Every module
# not named here maps to the port module at its own path.
COUNTERPARTS = {
    "version": ("",),                   # the port's __init__ holds it
    "ops.pallas": ("ops.cuda",),
    "ops.pallas.rasterize_tpu": ("ops.cuda.rasterize_cuda",
                                 "ops.cuda.bin_place_cuda"),
    "ops.pallas.texture_tpu": ("ops.cuda.texture_cuda",),
    "ops.pallas.texture_mip_tpu": ("ops.cuda.texture_mip_cuda",
                                   "ops.texture_mip"),
    "ops.pallas.antialias_tpu": ("ops.cuda.antialias_cuda",),
    "ops.pallas.raster_grad_tpu": ("ops.cuda.raster_grad_cuda",),
}


class Row(NamedTuple):
    """A JAX name the port does not have under that name.

    kind: "renamed" (the same function under the one port name of
    ``port``), "absorbed" (the port objects of ``port`` do its work under
    another interface) or "left_out" (nothing in the port does it).
    port: "module.name" paths in ``fpc_diffrend_tpu_torch``.
    """

    kind: str
    port: tuple = ()
    reason: str = ""


def renamed(port):
    return Row("renamed", (port,))


def absorbed(reason, *port):
    return Row("absorbed", port, reason)


def left_out(reason):
    return Row("left_out", (), reason)


_STACKED_ROUTES = ("ops.rasterize.RasterizeTextured",
                   "ops.rasterize.SAMPLERS")
_VMEM = ("the TPU kernel keeps the texture resident in VMEM and falls back "
         "to the XLA sampler past its limit; the CUDA sampler reads the "
         "texture from global memory at any size, so there is no limit")
_MIP_VMEM = ("the TPU kernel keeps the packed pyramid resident in VMEM; K8 "
             "and K9 read the flat pyramid from global memory at any size")

# JAX "module.name" -> Row, for every public callable a JAX module defines
# that no counterpart module has under the same name.
SURFACE = {
    # ---------------------------------------------------- ops.rasterize
    "ops.rasterize.rasterize_pallas_textured_sepaa_stacked": renamed(
        "ops.rasterize.rasterize_textured_sepaa_stacked"),
    "ops.rasterize.rasterize_fused": absorbed(
        "the primitive's kernel route: K1 without its texture tail under "
        "one Function, backward K5 (fed u, v, z too) -> K6",
        "ops.rasterize.RasterizeKernel"),
    "ops.rasterize.rasterize_texture_fused": absorbed(
        "K1 with its texture tail then K2, the single view's default "
        "\"sepaa\" route (the JAX stage's antialias follows it outside)",
        *_STACKED_ROUTES),
    "ops.rasterize.rasterize_texture_aa_fused": absorbed(
        "the \"aa_fused\" route: K10, K1 and K2 from one entry point",
        *_STACKED_ROUTES),
    "ops.rasterize.rasterize_texture_sepaa": absorbed(
        "the single view is the stacked Function at B = 1",
        *_STACKED_ROUTES),
    "ops.rasterize.rasterize_texture_sepaa_stacked": absorbed(
        "the stacked Function takes each sample's own records and bins, "
        "without "
        "JAX's interpret and pair_cap arguments; the mip path is its "
        "sampler \"mip\"", *_STACKED_ROUTES),
    # ----------------------------------------------------- ops.pipeline
    "ops.pipeline.stacked_batch_eligible": left_out(
        "the port renders every kernel-route batch stacked, the mip path "
        "and any texture size included; JAX asks whether its VMEM-resident "
        "texture and environment allow it"),
    # ----------------------------------------------------------- fit.api
    "fit.api.autotune_scene": left_out(
        "the face-order flip serves only the TPU's banded fold; K6 folds "
        "by gather in any face order"),
    # --------------------------------------------------- utils.debugging
    "utils.debugging.pallas_interpret_mode": left_out(
        "Pallas interpret mode; the port's plain PyTorch versions are what "
        "a CPU tensor runs"),
    # --------------------------------------------------- tools.undistort
    "tools.undistort.undistort_image_jax": renamed(
        "tools.undistort.undistort_image_torch"),
    # ------------------------------------------- ops.pallas.rasterize_tpu
    "ops.pallas.rasterize_tpu.corner_gather": absorbed(
        "x[idx] with a gather in place of XLA's scatter backward, a TPU "
        "answer to slow scatters; the port gathers by index_select, whose "
        "backward is index_add_", "ops.interpolate.gather_rows"),
    "ops.pallas.rasterize_tpu.uv_records": left_out(
        "the first layout of the uv rows, which JAX keeps for its tests; "
        "aux_records carries the uv corners"),
    "ops.pallas.rasterize_tpu.bin_triangles": absorbed(
        "the binning of set-up triangles is bin_scene_stacked, whose pairs "
        "K11 places", "ops.cuda.rasterize_cuda.bin_scene_stacked",
        "ops.cuda.bin_place_cuda.place_pairs"),
    "ops.pallas.rasterize_tpu.shift_records_stacked": left_out(
        "the port keeps each sample's records in its own frame and its "
        "kernels evaluate them at the sample's own rows (Bins.sample_ph): "
        "the f32 shift into the stacked frame broke every sample's "
        "gradients past the first at full size"),
    "ops.pallas.rasterize_tpu.tiles_per_program": left_out(
        "tiles per Pallas program, a TPU schedule; each CUDA kernel picks "
        "its own launch shape"),
    "ops.pallas.rasterize_tpu.chunk_schedule": left_out(
        "the TPU kernel's (tile, chunk) DMA prefetch schedule; K1 reads "
        "its bins from global memory"),
    "ops.pallas.rasterize_tpu.bin_scene": absorbed(
        "one view's binning is the stacked binning at B = 1",
        "ops.cuda.rasterize_cuda.bin_scene_stacked",
        "ops.rasterize.bin_stacked"),
    "ops.pallas.rasterize_tpu.fused_rasterize_from_bins": absorbed(
        "K1 on stacked bins, and K10 for its aa=True mode; the padded "
        "planes are the only layout", "ops.cuda.rasterize_cuda.fused_raster",
        "ops.cuda.rasterize_cuda.fused_raster_aa"),
    "ops.pallas.rasterize_tpu.visibility_from_bins": absorbed(
        "the id buffer is K1's first output",
        "ops.cuda.rasterize_cuda.fused_raster"),
    "ops.pallas.rasterize_tpu.visibility_pallas": absorbed(
        "the ids of the primitive's kernel route (K11, K1 at B = 1)",
        "ops.rasterize.rasterize", "ops.rasterize.RasterizeKernel"),
    # ------------------------------------------- ops.pallas.antialias_tpu
    "ops.pallas.antialias_tpu.pad_resolution": absorbed(
        "K2 reads the planes K1 writes, padded to the same 8x128 tiles by "
        "the rasterizer's pad_resolution",
        "ops.cuda.rasterize_cuda.pad_resolution"),
    "ops.pallas.antialias_tpu.aa_planes_bwd_core": absorbed(
        "K3 reads the id, payload and colour planes unpacked and returns "
        "the colour and corner cotangents",
        "ops.cuda.antialias_cuda.antialias_planes_bwd"),
    "ops.pallas.antialias_tpu.aa_planes_bwd_from_packed": absorbed(
        "the custom-VJP shape of the same backward; the textured pass of "
        "ops.rasterize routes K3's corner cotangents to K5 itself",
        "ops.cuda.antialias_cuda.antialias_planes_bwd"),
    "ops.pallas.antialias_tpu.antialias_planes_pallas": absorbed(
        "K2 on K1's planes, K3 in the textured pass's backward",
        "ops.cuda.antialias_cuda.antialias_planes",
        "ops.rasterize.RasterizeTextured"),
    "ops.pallas.antialias_tpu.antialias_payload_pallas": absorbed(
        "JAX's single-view mip path antialiases an image-layout colour; "
        "the port's mip path runs K2 on the planes inside the textured "
        "pass", "ops.cuda.antialias_cuda.antialias_planes",
        "ops.rasterize.RasterizeTextured"),
    # --------------------------------------------- ops.pallas.texture_tpu
    "ops.pallas.texture_tpu.extended_shape": left_out(_VMEM),
    "ops.pallas.texture_tpu.resident_bytes": left_out(_VMEM),
    "ops.pallas.texture_tpu.fits_resident": left_out(_VMEM),
    "ops.pallas.texture_tpu.texture_pallas": absorbed(
        "bilinear sampling of a (H, W, 2) uv image is ops.texture.texture's "
        "kernel route, K7 forward and K4 backward under one Function",
        "ops.texture.texture", "ops.cuda.texture_cuda.TextureBilinear"),
    "ops.pallas.texture_tpu.texture_planes_bwd_impl": absorbed(
        "K4 on uv planes of any shape, without the TPU padding arguments, "
        "with the texture precision",
        "ops.cuda.texture_cuda.texture_planes_bwd"),
    "ops.pallas.texture_tpu.texture_planes_pallas": absorbed(
        "K7 on uv planes of any shape, differentiable through the Function "
        "(the \"separate\" route's sampler)",
        "ops.cuda.texture_cuda.texture_planes",
        "ops.cuda.texture_cuda.TextureBilinear"),
    "ops.pallas.texture_tpu.texture_bilinear_pallas": absorbed(
        "JAX's first entry, one channel in clamp mode: the Function takes "
        "the boundary mode and any channel count",
        "ops.cuda.texture_cuda.TextureBilinear"),
    # ----------------------------------------- ops.pallas.texture_mip_tpu
    "ops.pallas.texture_mip_tpu.mip_resident_bytes": left_out(_MIP_VMEM),
    "ops.pallas.texture_mip_tpu.mip_fits_resident": left_out(_MIP_VMEM),
    "ops.pallas.texture_mip_tpu.mip_texture_pallas": absorbed(
        "the trilinear sample on the uv planes, K8 forward and K9 backward",
        "ops.texture_mip.mip_texture", "ops.texture_mip.MipSample"),
    # ----------------------------------------- ops.pallas.raster_grad_tpu
    "ops.pallas.raster_grad_tpu.pixel_grad_pallas": absorbed(
        "K5 on the payload cotangent planes, without the TPU cap, interpret "
        "and stacked arguments; K6 folds after it",
        "ops.cuda.raster_grad_cuda.pixel_grad"),
    "ops.pallas.raster_grad_tpu.banded_fold": absorbed(
        "K6 is the port of the banded fold's kernel, redesigned as a "
        "gather fold over every entry, in any face order",
        "ops.cuda.raster_grad_cuda.fold_entries"),
    "ops.pallas.raster_grad_tpu.fold_band_excess": left_out(
        "measures how far a face order lies from the banded fold's band; "
        "K6's gather fold has no band"),
}

KINDS = ("renamed", "absorbed", "left_out")

# Port module with no JAX module at its path -> (the JAX files it is
# ported from, relative to the repo; or none, with the reason).
PORT_ONLY = {
    "bench": (("bench.py",), ""),
    "bench_matrix": (("tools/bench_matrix.py",), ""),
    "workload": (("bench.py",), "bench.py's build_workload (:34-125)"),
    "profile_forward": (("tools/profile_stages.py", "tools/trace_step.py"),
                        ""),
    "examples": (("examples",), ""),
    "examples.convergence_study": (("examples/convergence_study.py",), ""),
    "examples.fit_cube": (("examples/fit_cube.py",), ""),
    "examples.fit_rig_synthetic": (("examples/fit_rig_synthetic.py",), ""),
    "examples.precision_study": (("examples/precision_study.py",), ""),
    "examples.rig": (("examples/fit_rig_synthetic.py",),
                     "the head mesh and camera rig the rig examples share"),
    "ops.precision": (("fpc_diffrend_tpu/ops/pallas/raster_grad_tpu.py",
                       "fpc_diffrend_tpu/ops/pallas/texture_tpu.py"),
                      "the FPC_GRAD_PREC and FPC_TEX_PREC reads"),
    "ops.texture_mip": (("fpc_diffrend_tpu/ops/pallas/texture_mip_tpu.py",
                         "fpc_diffrend_tpu/ops/texture.py"), ""),
    "ops.cuda": (("fpc_diffrend_tpu/ops/pallas/__init__.py",), ""),
    "ops.cuda.rasterize_cuda": (
        ("fpc_diffrend_tpu/ops/pallas/rasterize_tpu.py",), ""),
    "ops.cuda.bin_place_cuda": (
        ("fpc_diffrend_tpu/ops/pallas/rasterize_tpu.py",), ""),
    "ops.cuda.texture_cuda": (
        ("fpc_diffrend_tpu/ops/pallas/texture_tpu.py",), ""),
    "ops.cuda.texture_mip_cuda": (
        ("fpc_diffrend_tpu/ops/pallas/texture_mip_tpu.py",), ""),
    "ops.cuda.antialias_cuda": (
        ("fpc_diffrend_tpu/ops/pallas/antialias_tpu.py",), ""),
    "ops.cuda.raster_grad_cuda": (
        ("fpc_diffrend_tpu/ops/pallas/raster_grad_tpu.py",), ""),
    "kernels": ((), "port machinery: the CUDA kernels' build"),
    "kernels.build": ((), "port machinery: builds csrc/*.cu with nvcc and "
                          "binds the libraries with ctypes"),
    "device": ((), "port machinery: CUDA unless the caller asks for the "
                   "CPU; JAX picks its backend itself"),
}


def defined_names(module):
    """The public callables ``module`` defines: functions, classes,
    NamedTuples and ``jax.custom_vjp`` objects whose ``__module__`` is
    the module's own, so that re-exports drop out."""
    return sorted(
        name for name, obj in vars(module).items()
        if not name.startswith("_") and callable(obj)
        and getattr(obj, "__module__", None) == module.__name__)


def jax_modules():
    """Every module of the JAX package, as a path below the package
    ("" is the package itself)."""
    names = [""]
    for info in pkgutil.walk_packages(fpc_diffrend_tpu.__path__,
                                      "fpc_diffrend_tpu."):
        name = info.name.split(".", 1)[1]
        if name not in NOT_MODULES:
            names.append(name)
    return names


JAX_MODULES = jax_modules()


def port_modules():
    return [info.name.split(".", 1)[1] for info in pkgutil.walk_packages(
        fpc_diffrend_tpu_torch.__path__, "fpc_diffrend_tpu_torch.")]


def _jax_has(path):
    try:
        return importlib.util.find_spec("fpc_diffrend_tpu." + path) is not None
    except ModuleNotFoundError:         # a parent package is missing too
        return False


def _import(package, path):
    return importlib.import_module(package + ("." + path if path else ""))


def counterparts(jname):
    return [_import("fpc_diffrend_tpu_torch", p)
            for p in COUNTERPARTS.get(jname, (jname,))]


def _port_object(path):
    module, name = path.rsplit(".", 1)
    return getattr(_import("fpc_diffrend_tpu_torch", module), name, None)


def test_walker_reports_only_what_a_module_defines():
    """The walker's criterion on a module made here: a function and a
    callable with ``__module__`` set to the module (as ``jax.custom_vjp``
    objects have) count; a re-export and a private name do not."""
    mod = types.ModuleType("surface_probe")

    def fn():
        pass

    class Vjp:
        def __call__(self):
            pass

    def hidden():
        pass

    vjp = Vjp()
    for obj in (fn, vjp, hidden):
        obj.__module__ = mod.__name__
    mod.fn, mod.vjp_like, mod._hidden = fn, vjp, hidden
    mod.Path = os.PathLike                   # a re-export
    mod.CONSTANT = 3
    assert defined_names(mod) == ["fn", "vjp_like"]


def test_walk_covers_the_jax_package():
    """The walk reaches every module file of the JAX package, the Pallas
    modules included, and the JAX version is the port's."""
    names = set(JAX_MODULES)
    root = os.path.join(REPO, "fpc_diffrend_tpu")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), root)
                mod = rel[:-3].replace(os.sep, ".")
                mod = "" if mod == "__init__" else mod.removesuffix(
                    ".__init__")
                assert mod in names, mod
    for mod in COUNTERPARTS:
        assert mod in names, f"stale counterpart {mod}"
    assert "ops.pallas.rasterize_tpu" in names
    from fpc_diffrend_tpu.version import __version__
    assert fpc_diffrend_tpu_torch.__version__ == __version__


@pytest.mark.parametrize("jname", JAX_MODULES)
def test_every_jax_name_is_ported_or_mapped(jname):
    """(a) Each public callable of the JAX module is present under its
    name in a counterpart module, or has a SURFACE row."""
    jmod = _import("fpc_diffrend_tpu", jname)
    ports = counterparts(jname)
    missing = [name for name in defined_names(jmod)
               if not any(hasattr(p, name) for p in ports)
               and f"{jname}.{name}" not in SURFACE]
    assert not missing, (jname, missing)


def test_no_surface_row_is_stale():
    """(b) Every row names a public callable its JAX module defines."""
    for key in SURFACE:
        jname, name = key.rsplit(".", 1)
        assert jname in JAX_MODULES, key
        assert name in defined_names(_import("fpc_diffrend_tpu", jname)), key


def test_surface_port_objects_exist():
    """(c) Every port object a renamed or absorbed row names exists."""
    for key, row in SURFACE.items():
        for path in row.port:
            assert _port_object(path) is not None, (key, path)


def test_no_row_for_a_name_the_port_has():
    """(d) No row stands for a name a counterpart module already has."""
    for key in SURFACE:
        jname, name = key.rsplit(".", 1)
        have = [p.__name__ for p in counterparts(jname) if hasattr(p, name)]
        assert not have, (key, have)


def test_surface_rows_are_well_formed():
    """(e) Each row's kind is known; a renamed row names one port object
    and needs no reason; an absorbed row names port objects and a
    left_out row none, and both say why."""
    for key, row in SURFACE.items():
        assert row.kind in KINDS, key
        if row.kind == "renamed":
            assert len(row.port) == 1, key
        else:
            assert row.reason.strip(), key
            assert bool(row.port) == (row.kind == "absorbed"), key


def test_every_port_only_module_names_its_jax_source():
    """Every port module with no JAX module at its path is in PORT_ONLY,
    and every PORT_ONLY entry is such a module."""
    port_only = {name for name in port_modules() if not _jax_has(name)}
    assert port_only == set(PORT_ONLY)


@pytest.mark.parametrize("name", sorted(PORT_ONLY))
def test_port_only_sources_exist(name):
    """A PORT_ONLY entry's JAX sources are files (or the examples'
    directory) of the repo; an entry without one says why."""
    sources, reason = PORT_ONLY[name]
    assert sources or reason.strip(), name
    for src in sources:
        assert os.path.exists(os.path.join(REPO, src)), (name, src)
