"""K11: the stable bin placement of the stacked binning.

Port of ``fpc_diffrend_tpu.ops.pallas.rasterize_tpu``'s ``_place_pallas``
(its ``_count_kernel`` and ``_place_kernel``) as the CUDA kernels of
``csrc/bin_place.cu``: count the live (tile, triangle) pair slots per tile
and per block of slots, scan the counts, then place each slot's triangle
in its bin, ascending by triangle inside each bin, keeping the first P
entries. The result equals the kept prefix of one sort of the keys
``tile * B * T + b * T + t`` (``_place_sort``'s, for B = 1), which
:func:`place_pairs_plain` takes with ``torch.sort`` and
``torch.searchsorted``.

``place_pairs`` runs the kernels for CUDA tensors and the plain version for
CPU tensors, inside the span ``PROFILE_LABEL`` (``utils.profiling.span``),
so that a recorded profile of the binning shows K11 as its own stage.
"""

from __future__ import annotations

import torch

from fpc_diffrend_tpu_torch.kernels import build
from fpc_diffrend_tpu_torch.utils.profiling import span

Tensor = torch.Tensor

INT32_LIMIT = 1 << 31
PROFILE_LABEL = "K11 bin_place"
_PTR, _INT, _INT64 = build.PTR, build.INT, build.INT64
_COUNT_ARGS = [_PTR, _INT64, _INT, _PTR, _INT, _PTR]
_PLACE_ARGS = ([_PTR, _INT64, _INT, _INT, _INT, _INT64, _INT] + [_PTR] * 4
               + [_INT] * 2 + [_PTR] * 3)
# the placement's blocks: at most one a streaming multiprocessor of the
# H100 while each runs ~8 K slots or more (whole triangles), more where a
# run would pass 16 K slots (a block stages its run in shared memory)
PLACE_BLOCKS = 132
PLACE_MIN_SLOTS = 8192
PLACE_MAX_SLOTS = 16384
# tiles whose int array fits a block's shared memory on the H100 (232,448
# bytes opted in); past it the per-tile arrays live in device memory
SMEM_TILES = 56 * 1024


def place_blocks(n_tri: int, K: int):
    """(G blocks, run slots a block) of the placement of ``n_tri``
    triangles' K slots each: whole triangles a block, no block empty."""
    n = n_tri * K
    G = max(min(PLACE_BLOCKS, -(-n // PLACE_MIN_SLOTS)),
            -(-n // PLACE_MAX_SLOTS), 1)
    per_block = -(-n_tri // G)
    return (-(-n_tri // per_block), per_block * K) if n_tri else (1, 0)


def _check_args(tile_ids: Tensor, n_tiles: int, P: int) -> None:
    if tile_ids.ndim != 3:
        raise ValueError(f"tile_ids must be (B, T, K), got "
                         f"{tuple(tile_ids.shape)}")
    B, T, K = tile_ids.shape
    np_slots = B * T * K
    if np_slots >= INT32_LIMIT or B * T + 1 >= INT32_LIMIT:
        raise ValueError(f"{np_slots} pair slots exceed int32 positions")
    if not 0 <= P <= np_slots:
        raise ValueError(f"P = {P} is outside [0, {np_slots}]")
    build.check_tensor(tile_ids, "tile_ids", torch.int32, (B, T, K),
                       tile_ids.device)


def place_pairs_plain(tile_ids: Tensor, n_tiles: int, P: int):
    """Plain PyTorch version of K11 (same arguments and results as
    :func:`place_pairs`): one sort of int64 keys, cut at P, and the bin
    offsets by binary search."""
    _check_args(tile_ids, n_tiles, P)
    dev = tile_ids.device
    B, T, _ = tile_ids.shape
    n = B * T
    tri = torch.arange(n, device=dev).reshape(B, T, 1)
    keys, _ = torch.sort((tile_ids.long() * n + tri).reshape(-1))
    keys = keys[:P]
    sorted_tile = keys // n
    bin_start = torch.searchsorted(
        sorted_tile, torch.arange(n_tiles + 1, device=dev)).to(torch.int32)
    sorted_tri = torch.where(sorted_tile < n_tiles, keys % n,
                             n).to(torch.int32)
    return bin_start, sorted_tri


def count_pairs(tile_ids: Tensor, n_tiles: int,
                in_device_memory: bool = False) -> Tensor:
    """K11's count step: the live pair slots of each tile, (n_tiles,) int32.

    :param in_device_memory: count with one device-memory atomic a slot,
        the path of a histogram too large for shared memory, instead of the
        shared-memory histogram (``chip_smoke.py`` times the two).
    """
    _check_args(tile_ids, n_tiles, 0)
    dev = tile_ids.device
    if dev.type == "cpu":
        return torch.bincount(tile_ids.reshape(-1).long(),
                              minlength=n_tiles + 1)[:n_tiles].int()
    if dev.type != "cuda":
        raise ValueError(f"count_pairs: unsupported device {dev}")
    counts = torch.empty((n_tiles,), dtype=torch.int32, device=dev)
    count = build.entry("bin_place", "bin_count_launch", _COUNT_ARGS)
    build.check(count(build.ptr(tile_ids), tile_ids.numel(), n_tiles,
                      build.ptr(counts), int(in_device_memory),
                      build.stream(dev)), "bin_count")
    return counts


def place_pairs(tile_ids: Tensor, n_tiles: int, P: int):
    """K11: group the pair slots by tile.

    :param tile_ids: (B, T, K) int32 stacked tile of each of triangle b*T+t's
        K window slots; ``n_tiles`` marks a dead slot. Each triangle names a
        tile at most once.
    :param n_tiles: tiles of the stacked image.
    :param P: entries kept (the entry cap, at most B*T*K).
    :return: (bin_start (n_tiles + 1,) int32 bin offsets, clamped to P;
        sorted_tri (P,) int32 stacked triangle ids, grouped by tile and
        ascending inside each bin, B*T past the live prefix).
    """
    with span(PROFILE_LABEL):
        return _place_pairs(tile_ids, n_tiles, P)


def _place_pairs(tile_ids: Tensor, n_tiles: int, P: int):
    _check_args(tile_ids, n_tiles, P)
    dev = tile_ids.device
    if dev.type == "cpu":
        return place_pairs_plain(tile_ids, n_tiles, P)
    if dev.type != "cuda":
        raise ValueError(f"place_pairs: unsupported device {dev}")
    B, T, K = tile_ids.shape
    np_slots = B * T * K
    G, run = place_blocks(B * T, K)
    in_dev = n_tiles > SMEM_TILES
    # outputs and scratch in one allocation: bin_start, sorted_tri, then the
    # tiles' totals, the (G, n_tiles) prefixes, the cursors where they do
    # not fit shared memory and the staging of the device-memory path,
    # passed by address (no view of the scratch is made; it lives as long
    # as the outputs, which are views of the allocation)
    sizes = [n_tiles, G * n_tiles, G * n_tiles if in_dev else 0, np_slots]
    n_out = n_tiles + 1 + P
    place_pairs.launches += 1
    buf = torch.empty((n_out + sum(sizes),), dtype=torch.int32, device=dev)
    base = buf.data_ptr()
    tot, rows, cur, stage = (base + 4 * (n_out + sum(sizes[:i]))
                             for i in range(4))
    place = build.entry("bin_place", "bin_place_launch", _PLACE_ARGS)
    build.check(place(build.ptr(tile_ids), np_slots, K, n_tiles, G, run,
                      int(in_dev), rows, tot, cur, stage, P, B * T, base,
                      base + 4 * (n_tiles + 1), build.stream(dev)),
                "bin_place")
    return buf[:n_tiles + 1], buf[n_tiles + 1:n_out]


place_pairs.launches = 0
