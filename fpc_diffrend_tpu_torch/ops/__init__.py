"""Differentiable rendering ops; the single-view pipeline entry point is
re-exported here as ``ops.render``, as the JAX package does."""

from fpc_diffrend_tpu_torch.ops.pipeline import BACKGROUND, render

__all__ = ["render", "BACKGROUND"]
