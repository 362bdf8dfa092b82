"""Numerics checks (port of ``fpc_diffrend_tpu.utils.debugging``).

``nan_checks`` is autograd's anomaly mode with its NaN check: a backward
that makes a NaN raises at the operation that made it. The JAX package's
``pallas_interpret_mode`` has no counterpart: the port's plain versions of
its kernels are what the CPU path always runs.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch


@contextlib.contextmanager
def nan_checks():
    """Within the scope, a backward that produces NaN raises (autograd's
    anomaly mode with ``check_nan``)."""
    with torch.autograd.set_detect_anomaly(True, check_nan=True):
        yield


def tree_leaves_with_path(tree, path: str = ""):
    """(path, leaf) of every leaf of nested dicts (in sorted key order, as
    JAX flattens them), lists, tuples and dataclass instances; a path
    reads as ``jax.tree_util.keystr`` writes it (``['a'][0]``). None is
    no leaf."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tree_leaves_with_path(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in tree_leaves_with_path(v, f"{path}[{i}]")]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree)
                for x in tree_leaves_with_path(getattr(tree, f.name),
                                               f"{path}.{f.name}")]
    return [(path, tree)]


def assert_finite(tree, name: str = "tree") -> None:
    """Check every leaf of ``tree`` on the host.

    :raises FloatingPointError: names the first leaf with a non-finite
        value and counts them.
    """
    for path, leaf in tree_leaves_with_path(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        arr = np.asarray(leaf)
        if not np.isfinite(arr).all():
            bad = int((~np.isfinite(arr)).sum())
            raise FloatingPointError(
                f"{name}{path}: {bad} non-finite values")


def finite_or_zero(x):
    """Non-finite values replaced with zeros."""
    return torch.where(torch.isfinite(x), x, 0.0)
