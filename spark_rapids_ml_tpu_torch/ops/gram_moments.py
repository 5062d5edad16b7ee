"""Fused bf16 Gram + column moments: the Hopper kernels and their plain
versions.

Counterpart of ``spark_rapids_ml_tpu/ops/pallas_gram.py``, which holds both
TPU kernels. One read of a [rows, n] f32 matrix X gives, with ``products=3``
(the split, the ``"high"`` precision tier),

- ``gram`` = hiᵀhi + hiᵀlo + loᵀhi, accumulated in f32, where hi = bf16(X)
  and lo = bf16(X − hi), both rounded to nearest even; the loᵀlo term
  (~2⁻¹⁶ relative) is dropped;
- ``col_sum`` = Σ(hi + lo) and ``sum_sq`` = Σ(hi + lo)² over rows;

and with ``products=1`` (one bf16 pass with an f32 result: the ``"default"``
tier and the ``bf16_f32acc`` fold policy, which the JAX package leaves to
XLA and no Pallas kernel computes)

- ``gram`` = hiᵀhi, accumulated in f32;
- ``col_sum`` = Σx and ``sum_sq`` = Σx² over rows, in f32.

The split carries ~16 mantissa bits through bf16 tensor-core products, one
pass ~8. Two kernels in ``csrc/gram_moments.cu`` compute either, one
instance per count of products:

- ``fused_gram_moments`` multiplies every 128-column tile pair (the resident
  fit's Gram pass);
- ``symmetric_gram_moments`` multiplies the upper tile pairs only and mirrors
  the strict upper tiles into the lower half, so mirrored tiles are
  bit-equal (the streamed fold's Gram pass).

Each wrapper launches its kernel for a tensor on the card and runs its plain
version (``*_reference``) for a tensor on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.ops import _build

TILE = 128  # output tile edge of the kernel (csrc/gram_moments.cu kTile)
STEP = 32   # rows per ring stage of the kernel (kStep)
REFERENCE_BLOCK_ROWS = 1024  # the TPU kernel's default row block

PRODUCTS = (3, 1)  # the split's three products, or one bf16 pass

# Kernel launches since import (or since a caller reset them to 0), one
# count per instance: ``fused_gram_moments``'s and
# ``symmetric_gram_moments``'s with three products, and the ``_1pass``
# counts with one.
launches = 0
symmetric_launches = 0
launches_1pass = 0
symmetric_launches_1pass = 0
_launch_lock = threading.Lock()

# (symmetric, products) -> the instance's C entry point and launch counter
_INSTANCES = {
    (False, 3): ("gram_moments_launch", "launches"),
    (True, 3): ("symmetric_gram_moments_launch", "symmetric_launches"),
    (False, 1): ("gram_moments_1pass_launch", "launches_1pass"),
    (True, 1): ("symmetric_gram_moments_1pass_launch", "symmetric_launches_1pass"),
}


def fused_gram_moments_reference(
    x: torch.Tensor, *, products: int = 3
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the kernel, per block of
    ``REFERENCE_BLOCK_ROWS`` rows summed in f32 block after block as the TPU
    kernel's grid does: with three products the same RNE hi/lo split, three
    f32 matrix products of the bf16 values and moments from hi + lo; with
    one, hi = bf16(x), the f32 product hiᵀhi and moments from x itself.

    The blocks bound each f32 summation chain: one product over 10⁵ rows
    sums them in one chain, whose error (~√rows·2⁻²⁴ relative) would be
    as large as the tolerance the kernel is held to."""
    _check_products(products)
    n = x.shape[1]
    gram = torch.zeros((n, n), dtype=torch.float32, device=x.device)
    col_sum = torch.zeros((n,), dtype=torch.float32, device=x.device)
    sum_sq = torch.zeros((n,), dtype=torch.float32, device=x.device)
    for block in torch.split(x, REFERENCE_BLOCK_ROWS):
        hf = block.to(torch.bfloat16).float()
        if products == 3:
            lf = (block - hf).to(torch.bfloat16).float()
            gram += hf.T @ hf + hf.T @ lf + lf.T @ hf
            xb = hf + lf
        else:
            gram += hf.T @ hf
            xb = block
        col_sum += xb.sum(dim=0)
        sum_sq += (xb * xb).sum(dim=0)
    return gram, col_sum, sum_sq


def symmetric_gram_moments_reference(
    x: torch.Tensor, *, products: int = 3
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the symmetric kernel: the fused plain version,
    then every strict-lower ``TILE`` block replaced by the transpose of its
    upper mirror, as the kernel's reduce pass writes it. Diagonal blocks stay
    as computed (symmetric to rounding only)."""
    gram, col_sum, sum_sq = fused_gram_moments_reference(x, products=products)
    tile = torch.arange(gram.shape[0], device=x.device) // TILE
    lower = tile[:, None] > tile[None, :]
    return torch.where(lower, gram.T, gram), col_sum, sum_sq


def tile_pairs(n: int, symmetric: bool) -> list[tuple[int, int]]:
    """The output tiles a kernel multiplies, in its order: every (bi, bj)
    row by row, or only bi <= bj for the symmetric kernel."""
    nt = -(-n // TILE)
    return [(bi, bj) for bi in range(nt) for bj in range(bi if symmetric else 0, nt)]


class Schedule(NamedTuple):
    """The kernel's static work list (int32 tables).

    - ``items`` [num_items, 4]: (bi, bj, step_begin, step_end), one tile and
      a range of ``STEP``-row steps, sorted by tile and then by row;
    - ``tiles`` [num_tiles, 4]: (bi, bj, first item, end item), the items
      the reduce pass sums for each tile, in that order;
    - ``block_items`` [blocks + 1]: block b walks items
      ``block_items[b]:block_items[b + 1]``.
    """

    items: np.ndarray
    tiles: np.ndarray
    block_items: np.ndarray

    @property
    def blocks(self) -> int:
        return len(self.block_items) - 1

    def steps_per_block(self) -> list[int]:
        """Row steps each block walks, over all its items."""
        steps = self.items[:, 3] - self.items[:, 2]
        return [int(steps[a:b].sum()) for a, b in zip(self.block_items[:-1], self.block_items[1:])]


@functools.lru_cache(maxsize=64)
def schedule(rows: int, n: int, symmetric: bool, sm_count: int) -> Schedule:
    """Cut the tile-major line of (tile, row step) pairs into ``sm_count``
    equal shares, one per resident block, so every SM gets the same number
    of steps to within one and no wave runs part-empty. A share that crosses
    a tile's end becomes two items."""
    pairs = tile_pairs(n, symmetric)
    steps = -(-rows // STEP)
    total = len(pairs) * steps
    blocks = min(sm_count, total)
    items, block_items = [], [0]
    for b in range(blocks):
        pos, end = b * total // blocks, (b + 1) * total // blocks
        while pos < end:
            t, s0 = divmod(pos, steps)
            s1 = min(steps, s0 + end - pos)
            items.append((*pairs[t], s0, s1))
            pos += s1 - s0
        block_items.append(len(items))
    tiles, it = [], 0
    for bi, bj in pairs:
        begin = it
        while it < len(items) and items[it][:2] == (bi, bj):
            it += 1
        tiles.append((bi, bj, begin, it))
    tables = (np.asarray(items, np.int32).reshape(-1, 4),
              np.asarray(tiles, np.int32).reshape(-1, 4),
              np.asarray(block_items, np.int32))
    for table in tables:
        table.setflags(write=False)  # shared by every caller of the cache
    return Schedule(*tables)


def load_route(x: torch.Tensor) -> str:
    """How the kernel brings X's tiles in: ``"tma"`` where the tensor map
    allows it (row stride a multiple of 16 bytes, 16-byte-aligned base),
    else ``"plain"`` (masked loads into the same ring)."""
    return "tma" if x.shape[1] % 4 == 0 and x.data_ptr() % 16 == 0 else "plain"


def _check_products(products: int) -> None:
    if products not in PRODUCTS:
        raise ValueError(f"products must be one of {PRODUCTS}, got {products!r}")


def _check(x: torch.Tensor) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(x).__name__}")
    if x.dim() != 2:
        raise ValueError(f"expected a 2-D [rows, n] tensor, got shape {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"expected float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("expected a contiguous (row-major) tensor")
    if x.shape[1] == 0:
        raise ValueError("expected at least one column")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


_entries: dict[str, object] = {}  # C entry points, set up once at first use


def _entry(symbol: str):
    fn = _entries.get(symbol)
    if fn is None:
        fn = getattr(_build.load_library("gram_moments"), symbol)
        fn.argtypes = [
            ctypes.c_void_p,      # x
            ctypes.c_longlong,    # rows
            ctypes.c_int,         # n
            ctypes.c_int,         # use_tma
            ctypes.c_void_p,      # items
            ctypes.c_void_p,      # tiles
            ctypes.c_int,         # num_tiles
            ctypes.c_void_p,      # block_items
            ctypes.c_int,         # blocks
            ctypes.c_void_p,      # partial_gram
            ctypes.c_void_p,      # partial_moments
            ctypes.c_void_p,      # gram
            ctypes.c_void_p,      # col_sum
            ctypes.c_void_p,      # sum_sq
            ctypes.c_void_p,      # stream
        ]
        fn.restype = ctypes.c_int
        _entries[symbol] = fn
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=64)
def _device_tables(
    rows: int, n: int, symmetric: bool, sm_count: int, device: torch.device
) -> tuple[Schedule, torch.Tensor]:
    """The schedule and its three tables in one int32 tensor on the card,
    copied once per shape: the streamed fit's chunks reuse it without a
    host-to-device copy each."""
    plan = schedule(rows, n, symmetric, sm_count)
    flat = np.concatenate([plan.items.ravel(), plan.tiles.ravel(), plan.block_items])
    return plan, torch.from_numpy(flat).to(device)


def _launch(
    x: torch.Tensor, symmetric: bool, products: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run one instance's C entry point on the current stream over its
    schedule and count the launch. The library comes first: where it does
    not build or load, this raises before anything else is done."""
    symbol, counter = _INSTANCES[(symmetric, products)]
    launch = _entry(symbol)
    rows, n = x.shape
    plan, table = _device_tables(rows, n, symmetric, _sm_count(x.device), x.device)
    num_items, num_tiles = len(plan.items), len(plan.tiles)
    base = table.data_ptr()
    new = dict(dtype=torch.float32, device=x.device)
    partial_gram = torch.empty((max(num_items, 1), TILE, TILE), **new)
    partial_moments = torch.empty((max(num_items, 1), 2, TILE), **new)
    gram = torch.empty((n, n), **new)
    col_sum = torch.empty((n,), **new)
    sum_sq = torch.empty((n,), **new)
    with torch.cuda.device(x.device):
        err = launch(
            x.data_ptr(), rows, n, int(load_route(x) == "tma"),
            base, base + 16 * num_items, num_tiles,
            base + 16 * (num_items + num_tiles), plan.blocks,
            partial_gram.data_ptr(), partial_moments.data_ptr(),
            gram.data_ptr(), col_sum.data_ptr(), sum_sq.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"{symbol} failed with CUDA error {err} "
            f"(x {tuple(x.shape)}, {num_items} items on {plan.blocks} blocks)"
        )
    with _launch_lock:
        globals()[counter] += 1
    return gram, col_sum, sum_sq


def fused_gram_moments(
    x: torch.Tensor, *, products: int = 3
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(gram [n, n], col_sum [n], sum_sq [n]) of a contiguous [rows, n] f32 X,
    from the split's three products or from one bf16 pass (``products``).

    On the card this launches the instance on the current stream and returns
    without synchronising; on the CPU it runs the plain version.
    """
    _check_products(products)
    _check(x)
    if x.device.type == "cpu":
        return fused_gram_moments_reference(x, products=products)
    return _launch(x, symmetric=False, products=products)


def symmetric_gram_moments(
    x: torch.Tensor, *, products: int = 3
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``fused_gram_moments``'s triple from the upper tile pairs only, each
    strict upper tile mirrored bit-equal into the lower half.

    On the card this launches the symmetric instance on the current stream
    and returns without synchronising; on the CPU it runs the plain version.
    """
    _check_products(products)
    _check(x)
    if x.device.type == "cpu":
        return symmetric_gram_moments_reference(x, products=products)
    return _launch(x, symmetric=True, products=products)
