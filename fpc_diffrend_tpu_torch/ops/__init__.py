"""Differentiable rendering ops: the nvdiffrast-style primitives and the
render pipeline on the H100.

Submodules keep their own namespaces (``ops.rasterize.rasterize`` etc.); the
re-exports are the JAX package's: the submodules as ``*_mod`` and the
pipeline entry point as ``ops.render``.
"""

from fpc_diffrend_tpu_torch.ops import antialias as antialias_mod
from fpc_diffrend_tpu_torch.ops import interpolate as interpolate_mod
from fpc_diffrend_tpu_torch.ops import mesh_ops
from fpc_diffrend_tpu_torch.ops import rasterize as rasterize_mod
from fpc_diffrend_tpu_torch.ops import texture as texture_mod
from fpc_diffrend_tpu_torch.ops.pipeline import BACKGROUND, render

__all__ = [
    "antialias_mod", "interpolate_mod", "mesh_ops", "rasterize_mod",
    "texture_mod", "render", "BACKGROUND",
]
