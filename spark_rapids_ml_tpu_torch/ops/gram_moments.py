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
pass ~8. ``csrc/gram_moments.cu`` computes either:

- with three products, ``fused_gram_moments`` multiplies every 128-column
  tile pair (the resident fit's Gram pass) and ``symmetric_gram_moments``
  the upper tile pairs only, mirroring the strict upper tiles into the
  lower half, so mirrored tiles are bit-equal (the streamed fold's Gram
  pass);
- with one product, both wrappers launch one kernel set: a pre-pass that
  writes hi into a bf16 scratch and takes the moments, then a TMA/wgmma
  Gram pass over the upper tile pairs at ``STEP_1PASS``-row steps
  (``schedule_1pass``), mirrored as the symmetric instance's.

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
STEP = 32   # rows per ring stage of the three-product kernel (kStep)
STEP_1PASS = 64  # rows per ring stage of the one-product Gram pass (k1Step)
# Steps whose products the one-product kernel's wgmma accumulator holds
# before they are added into the running f32 sum (promote_steps): 1,024
# rows. On an H100 (PERF.md, section 6) every 16 steps kept the Gram within
# 2.0e-6 of max|G| of the f64 sum at 131,072 rows (the gate is 1e-5); every
# 64 steps reached 1.06e-5.
PROMOTE_STEPS = 16
PREPASS_COLS = 512   # features per pre-pass block (kPrepassCols)
PREPASS_UNROLL = 8   # rows a pre-pass thread sums before its running sums (kPrepassUnroll)
PREPASS_BLOCKS_PER_SM = 4
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

# (symmetric, products) -> the instance's C entry point and launch counter;
# both one-product wrappers call the one entry point
_INSTANCES = {
    (False, 3): ("gram_moments_launch", "launches"),
    (True, 3): ("symmetric_gram_moments_launch", "symmetric_launches"),
    (False, 1): ("gram_moments_1pass_launch", "launches_1pass"),
    (True, 1): ("gram_moments_1pass_launch", "symmetric_launches_1pass"),
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


class Schedule1Pass(NamedTuple):
    """The one-product Gram pass's work list (int32 tables): ``items`` and
    ``block_items`` as in ``Schedule``, at ``STEP_1PASS``-row steps and in
    each block's walking order; ``tiles`` [num_tiles, 4] (bi, bj, first,
    end) with each tile's items ``tile_items[first:end]`` [num_items], in
    row order, the reduce pass's order."""

    items: np.ndarray
    tiles: np.ndarray
    block_items: np.ndarray
    tile_items: np.ndarray

    blocks = Schedule.blocks
    steps_per_block = Schedule.steps_per_block


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


# A partial tile's write and read, in one-product steps of card time: 128 KB
# at ~3 TB/s against a step's ~0.3 us (the cost model of row_parts).
PARTIAL_COST_STEPS = 0.15


def row_parts(tiles: int, steps: int, sm_count: int) -> int:
    """How many row parts the one-product work list cuts every tile into,
    at the same cuts: the q that minimises the longest block's steps
    (ceil(tiles * q / sm_count) units of ceil(steps / q) steps) plus the
    partial tiles' traffic (``PARTIAL_COST_STEPS`` a unit), for q up to
    ``steps`` (and 256)."""
    def cost(q: int) -> float:
        slots = -(-tiles * q // sm_count)
        return slots * -(-steps // q) + PARTIAL_COST_STEPS * tiles * q

    return min(range(1, min(steps, 256) + 1), key=cost)


@functools.lru_cache(maxsize=64)
def schedule_1pass(rows: int, n: int, sm_count: int) -> Schedule1Pass:
    """The one-product Gram pass's work list, which both one-product
    wrappers run: the upper tile pairs at ``STEP_1PASS``-row steps, every
    tile cut at the same ``row_parts`` row cuts into units (tile, part).
    The T tiles' units are dealt round-robin in part-major order: unit u =
    part * T + tile goes to block u % blocks as its (u // blocks)-th item.
    So the k-th items of all blocks are units of the same few parts, all as
    long to within a step, each walked from its part's first row: the
    blocks sweep the same rows at the same time, and each row of the bf16
    copy is read from device memory about once and from L2 by every tile
    that needs it. Each unit is an item with its own partial tile."""
    pairs = tile_pairs(n, True)
    num_tiles, steps = len(pairs), -(-rows // STEP_1PASS)
    q = row_parts(num_tiles, steps, sm_count) if steps else 0
    cuts = [j * steps // q for j in range(q + 1)] if q else []
    units = num_tiles * q
    blocks = min(sm_count, units)
    items, block_items, index = [], [0], {}
    for b in range(blocks):
        for u in range(b, units, blocks):
            j, t = divmod(u, num_tiles)
            index[u] = len(items)
            items.append((*pairs[t], cuts[j], cuts[j + 1]))
        block_items.append(len(items))
    tiles = [(*pair, t * q, (t + 1) * q) for t, pair in enumerate(pairs)]
    tile_items = [index[j * num_tiles + t] for t in range(num_tiles) for j in range(q)]
    tables = (np.asarray(items, np.int32).reshape(-1, 4),
              np.asarray(tiles, np.int32).reshape(-1, 4),
              np.asarray(block_items, np.int32),
              np.asarray(tile_items, np.int32))
    for table in tables:
        table.setflags(write=False)
    return Schedule1Pass(*tables)


def padded_cols(n: int) -> int:
    """The row stride, in features, of the one-product kernel's bf16 copy
    of X: n rounded up to a whole tile, so that every TMA box of the Gram
    pass lies inside it (features n and beyond are zeros)."""
    return -(-n // TILE) * TILE


def prepass_layout(rows: int, n: int, sm_count: int) -> tuple[int, int]:
    """(row_blocks, rows_per_block) of the one-product pre-pass: about
    ``PREPASS_BLOCKS_PER_SM`` blocks an SM over its (row block,
    ``PREPASS_COLS``-feature block) grid, each taking a whole number of
    ``PREPASS_UNROLL``-row groups. Each row block writes one partial of
    each moment, which the reduce pass sums in row-block order."""
    if rows == 0:
        return 0, 0
    col_blocks = -(-padded_cols(n) // PREPASS_COLS)
    target = max(1, PREPASS_BLOCKS_PER_SM * sm_count // col_blocks)
    per_block = -(-rows // target)
    per_block = max(4 * PREPASS_UNROLL, -(-per_block // PREPASS_UNROLL) * PREPASS_UNROLL)
    return -(-rows // per_block), per_block


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

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    # x, rows, n, use_tma, items, tiles, num_tiles, block_items, blocks,
    # partial_gram, partial_moments, gram, col_sum, sum_sq, stream
    "three": [_P, _LL, _I, _I, _P, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P],
    # x, rows, n, vec, row_blocks, rows_per_block, items, tiles, num_tiles,
    # block_items, blocks, tile_items, promote_steps, hi, partial_gram,
    # moment_parts, gram, col_sum, sum_sq, stream
    "one": [_P, _LL, _I, _I, _I, _I, _P, _P, _I, _P, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P],
}


def _entry(symbol: str):
    fn = _entries.get(symbol)
    if fn is None:
        fn = getattr(_build.load_library("gram_moments"), symbol)
        fn.argtypes = _ARGTYPES["one" if symbol == "gram_moments_1pass_launch" else "three"]
        fn.restype = ctypes.c_int
        _entries[symbol] = fn
    return fn


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


@functools.lru_cache(maxsize=64)
def _device_tables(
    rows: int, n: int, symmetric: bool, sm_count: int, device: torch.device,
    one_product: bool = False,
) -> tuple[Schedule | Schedule1Pass, torch.Tensor]:
    """The schedule and its tables in one int32 tensor on the card, copied
    once per shape: the streamed fit's chunks reuse it without a
    host-to-device copy each."""
    plan = schedule_1pass(rows, n, sm_count) if one_product else schedule(
        rows, n, symmetric, sm_count)
    flat = np.concatenate([table.ravel() for table in plan])
    return plan, torch.from_numpy(flat).to(device)


def _launch(
    x: torch.Tensor, symmetric: bool, products: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run one instance's C entry point on the current stream over its
    schedule and count the launch. The library comes first: where it does
    not build or load, this raises before anything else is done."""
    symbol, counter = _INSTANCES[(symmetric, products)]
    launch = _entry(symbol)
    if products == 1:
        out = _launch_1pass(launch, symbol, x)
    else:
        out = _launch_3(launch, symbol, x, symmetric)
    with _launch_lock:
        globals()[counter] += 1
    return out


def _launch_3(launch, symbol: str, x: torch.Tensor, symmetric: bool):
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
    return gram, col_sum, sum_sq


def _launch_1pass(launch, symbol: str, x: torch.Tensor):
    """The one-product kernels on one scratch allocation: hi [rows,
    padded_cols(n)] bf16, then the partial tiles, then the pre-pass's moment
    partials, each 256-byte aligned."""
    rows, n = x.shape
    sm_count = _sm_count(x.device)
    plan, table = _device_tables(rows, n, True, sm_count, x.device, one_product=True)
    row_blocks, rows_per_block = prepass_layout(rows, n, sm_count)
    num_items, num_tiles = len(plan.items), len(plan.tiles)
    items = table.data_ptr()
    tiles = items + 16 * num_items
    block_items = tiles + 16 * num_tiles
    tile_items = block_items + 4 * (plan.blocks + 1)

    def aligned(nbytes: int) -> int:
        return -(-nbytes // 256) * 256

    hi_bytes = aligned(rows * padded_cols(n) * 2)
    partial_bytes = aligned(num_items * TILE * TILE * 4)
    scratch = torch.empty(hi_bytes + partial_bytes + aligned(row_blocks * 2 * n * 4),
                          dtype=torch.uint8, device=x.device)
    hi = scratch.data_ptr()
    new = dict(dtype=torch.float32, device=x.device)
    gram = torch.empty((n, n), **new)
    col_sum = torch.empty((n,), **new)
    sum_sq = torch.empty((n,), **new)
    with torch.cuda.device(x.device):
        err = launch(
            x.data_ptr(), rows, n, int(load_route(x) == "tma"), row_blocks, rows_per_block,
            items, tiles, num_tiles, block_items, plan.blocks, tile_items, PROMOTE_STEPS,
            hi, hi + hi_bytes, hi + hi_bytes + partial_bytes,
            gram.data_ptr(), col_sum.data_ptr(), sum_sq.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"{symbol} failed with CUDA error {err} (x {tuple(x.shape)}, "
            f"{num_items} items on {plan.blocks} blocks, {row_blocks} pre-pass row blocks)"
        )
    return gram, col_sum, sum_sq


def fused_gram_moments(
    x: torch.Tensor, *, products: int = 3
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(gram [n, n], col_sum [n], sum_sq [n]) of a contiguous [rows, n] f32 X,
    from the split's three products or from one bf16 pass (``products``).

    On the card this launches the instance on the current stream and returns
    without synchronising; on the CPU it runs the plain version. With one
    product the card multiplies the upper tile pairs and mirrors them, as
    ``symmetric_gram_moments`` does: the Gram is symmetric, so that is the
    same function for half the work.
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
