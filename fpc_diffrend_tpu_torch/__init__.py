"""fpc_diffrend_tpu_torch — the PyTorch/CUDA port of fpc_diffrend_tpu.

The JAX/Pallas package ``fpc_diffrend_tpu`` stays the reference. This
package computes the same functions with PyTorch tensor code, and every
Pallas kernel on its path is a CUDA C++ kernel written for Hopper
(``csrc/*.cu``, built at first use by ``kernels.build``).

Slice 1 covers the forward half of the default fit step:
blend -> pose -> clip -> stacked-batch binning -> fused raster+texture
kernel -> antialias kernel -> background composite -> photometric +
Laplacian loss (``fit.loop.evaluate``).

Rules the whole package keeps:

  * it imports neither ``jax`` nor ``fpc_diffrend_tpu``; what it needs of
    the JAX package's JAX-free modules it keeps as its own copy;
  * entry points take an explicit ``device`` and default to CUDA; without
    a card they raise unless the caller passes ``device="cpu"``;
  * a kernel wrapper runs its plain PyTorch version only for CPU tensors,
    and for CUDA tensors launches the kernel or raises;
  * float32 is exact: TF32 is switched off for matmuls and convolutions.
"""

import torch

# Exact f32 throughout: the blend is a matmul chain, and TF32 would keep
# only ~3 decimal digits of it.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

__all__ = ["__version__"]
