"""The gradient-precision modes of the backward's K4 and K5.

The counterpart of the JAX package's ``FPC_GRAD_PREC``
(``raster_grad_tpu.py:72-92``) and ``FPC_TEX_PREC``
(``texture_tpu.py:84-102``), which it reads from the environment at import.
The port reads no environment variable: the mode is a process-wide setting,
``exact`` for both unless a caller sets it.

* ``grad="fast"``: K5 rounds each pixel's gradient coefficients to bf16
  (round to nearest even) before it sums them onto the bin entries, as the
  TPU kernel contracts a single bf16 plane in place of its three-way split.
  K6 (the fold) stays f32 in every mode, as JAX's default ``segment_sum``
  fold does.
* ``tex="fast"``: K4's uv gradients take the four texels and the hat
  weights ``1 - fs`` and ``fs`` rounded to bf16 (the coordinate-gradient
  contractions ``sub @ wx`` and ``sub @ dwx`` at ``Precision.DEFAULT``);
  ``tex="fast2"`` also rounds ``g * wy`` and ``wx`` in the four texel
  shares (the texel-gradient contraction).

The forward has no mode: JAX's ``FPC_TEX_FWD_PREC=fast`` (the forward
sampler's contraction in bf16) and ``FPC_FWD_SPLITS=2`` (K1's gathered
record from two bf16 splits) are opt-in savings of MXU passes on the TPU
that make the render inexact, and the port computes their default, the
exact forward.

The port's ``exact`` is plain f32; JAX's is a three-way bf16 split of each
f32 operand, within a few ulp of it. JAX defaults to ``fast``/``fast2``.
The modes are kept to reproduce what the JAX package computes by default:
on the H100 they save no time, since the rounding sits on values the
kernels compute, not on what they read.

Autograd runs a CUDA backward on a device thread of its own, so the
setting is neither thread-local nor a context variable: each autograd
Function that launches K4 or K5 reads it in ``forward`` and keeps it in
``ctx``, and a backward run after :func:`precision` has exited still takes
the forward's mode. The scan route (its sampler ``ops.texture.texture``
too) and the mip sampler (K8, K9) have no precision mode, as in JAX.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

GRAD_MODES = ("exact", "fast")
TEX_MODES = ("exact", "fast", "fast2")


class Precision(NamedTuple):
    grad: str = "exact"
    tex: str = "exact"


_setting = [Precision()]


def _checked(grad: str, tex: str) -> Precision:
    if grad not in GRAD_MODES:
        raise ValueError(f"unknown gradient precision {grad!r}; one of "
                         f"{GRAD_MODES}")
    if tex not in TEX_MODES:
        raise ValueError(f"unknown texture precision {tex!r}; one of "
                         f"{TEX_MODES}")
    return Precision(grad, tex)


def get_precision() -> Precision:
    """The process-wide (grad, tex) modes."""
    return _setting[0]


def set_precision(grad: str | None = None,
                  tex: str | None = None) -> Precision:
    """Set the modes for every later forward; None keeps a mode as it is.

    :return: the modes before the call.
    :raises ValueError: an unknown mode.
    """
    prev = _setting[0]
    _setting[0] = _checked(prev.grad if grad is None else grad,
                           prev.tex if tex is None else tex)
    return prev


@contextlib.contextmanager
def precision(grad: str | None = None, tex: str | None = None):
    """:func:`set_precision` for the block, restored after it; yields the
    modes in force."""
    prev = set_precision(grad, tex)
    try:
        yield get_precision()
    finally:
        _setting[0] = prev
