"""Fused split-bf16 Gram + column moments: the Hopper kernels and their
plain versions.

Counterpart of ``spark_rapids_ml_tpu/ops/pallas_gram.py``, which holds both
TPU kernels. One read of a [rows, n] f32 matrix X gives

- ``gram`` = hiᵀhi + hiᵀlo + loᵀhi, accumulated in f32, where hi = bf16(X)
  and lo = bf16(X − hi), both rounded to nearest even; the loᵀlo term
  (~2⁻¹⁶ relative) is dropped;
- ``col_sum`` = Σ(hi + lo) and ``sum_sq`` = Σ(hi + lo)² over rows.

The split carries ~16 mantissa bits through bf16 tensor-core products, the
arithmetic of the ``"high"`` precision tier. Two kernels in
``csrc/gram_moments.cu`` compute it:

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
import threading

import torch

from spark_rapids_ml_tpu_torch.ops import _build

TILE = 128  # output tile edge of the kernel (csrc/gram_moments.cu kTile)
STEP = 32   # rows per k-step of the kernel (kStep)
BLOCKS_PER_SM = 2  # split the rows until the grid has this many blocks per SM
REFERENCE_BLOCK_ROWS = 1024  # the TPU kernel's default row block

# Kernel launches since import (or since a caller reset them to 0):
# ``fused_gram_moments``'s and ``symmetric_gram_moments``'s.
launches = 0
symmetric_launches = 0
_launch_lock = threading.Lock()


def fused_gram_moments_reference(
    x: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of the kernel: the same RNE hi/lo split,
    three f32 matrix products of the bf16 values per block of
    ``REFERENCE_BLOCK_ROWS`` rows, summed in f32 block after block as the TPU
    kernel's grid does, and moments from hi + lo.

    The blocks bound each f32 summation chain: one product over 10⁵ rows
    sums them in one chain, whose error (~√rows·2⁻²⁴ relative) would be
    as large as the tolerance the kernel is held to."""
    n = x.shape[1]
    gram = torch.zeros((n, n), dtype=torch.float32, device=x.device)
    col_sum = torch.zeros((n,), dtype=torch.float32, device=x.device)
    sum_sq = torch.zeros((n,), dtype=torch.float32, device=x.device)
    for block in torch.split(x, REFERENCE_BLOCK_ROWS):
        hi = block.to(torch.bfloat16)
        lo = (block - hi.float()).to(torch.bfloat16)
        hf, lf = hi.float(), lo.float()
        gram += hf.T @ hf + hf.T @ lf + lf.T @ hf
        xb = hf + lf
        col_sum += xb.sum(dim=0)
        sum_sq += (xb * xb).sum(dim=0)
    return gram, col_sum, sum_sq


def symmetric_gram_moments_reference(
    x: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plain version of the symmetric kernel: the fused plain version,
    then every strict-lower ``TILE`` block replaced by the transpose of its
    upper mirror, as the kernel's reduce pass writes it. Diagonal blocks stay
    as computed (symmetric to rounding only)."""
    gram, col_sum, sum_sq = fused_gram_moments_reference(x)
    tile = torch.arange(gram.shape[0], device=x.device) // TILE
    lower = tile[:, None] > tile[None, :]
    return torch.where(lower, gram.T, gram), col_sum, sum_sq


def upper_tiles(n: int) -> int:
    """Tile pairs bi <= bj the symmetric kernel multiplies for n columns."""
    nt = -(-n // TILE)
    return nt * (nt + 1) // 2


def _split_rows(rows: int, tiles: int, sm_count: int) -> tuple[int, int]:
    """(splits, rows_per_split) so the grid has about BLOCKS_PER_SM blocks on
    each SM; rows_per_split is a multiple of STEP."""
    splits = max(1, -(-BLOCKS_PER_SM * sm_count // tiles))
    per_split = -(-max(rows, 1) // splits)
    per_split = -(-per_split // STEP) * STEP
    return max(1, -(-rows // per_split)), per_split


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
            ctypes.c_int,         # n_pad
            ctypes.c_int,         # splits
            ctypes.c_longlong,    # rows_per_split
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


def _launch(
    x: torch.Tensor, symbol: str, tiles: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run one C entry point on the current stream; ``tiles``, the output
    tiles its grid multiplies, sizes the row splits."""
    rows, n = x.shape
    n_pad = -(-n // TILE) * TILE
    sm_count = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits, per_split = _split_rows(rows, tiles, sm_count)
    new = dict(dtype=torch.float32, device=x.device)
    partial_gram = torch.empty((splits, n_pad, n_pad), **new)
    partial_moments = torch.empty((splits, 2, n_pad), **new)
    gram = torch.empty((n, n), **new)
    col_sum = torch.empty((n,), **new)
    sum_sq = torch.empty((n,), **new)
    launch = _entry(symbol)
    with torch.cuda.device(x.device):
        err = launch(
            x.data_ptr(), rows, n, n_pad, splits, per_split,
            partial_gram.data_ptr(), partial_moments.data_ptr(),
            gram.data_ptr(), col_sum.data_ptr(), sum_sq.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"{symbol} failed with CUDA error {err} "
            f"(x {tuple(x.shape)}, splits {splits})"
        )
    return gram, col_sum, sum_sq


def fused_gram_moments(
    x: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(gram [n, n], col_sum [n], sum_sq [n]) of a contiguous [rows, n] f32 X.

    On the card this launches the kernel on the current stream and returns
    without synchronising; on the CPU it runs the plain version.
    """
    global launches
    _check(x)
    if x.device.type == "cpu":
        return fused_gram_moments_reference(x)
    out = _launch(x, "gram_moments_launch", (-(-x.shape[1] // TILE)) ** 2)
    with _launch_lock:
        launches += 1
    return out


def symmetric_gram_moments(
    x: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``fused_gram_moments``'s triple from the upper tile pairs only, each
    strict upper tile mirrored bit-equal into the lower half.

    On the card this launches the symmetric kernel on the current stream and
    returns without synchronising; on the CPU it runs the plain version.
    """
    global symmetric_launches
    _check(x)
    if x.device.type == "cpu":
        return symmetric_gram_moments_reference(x)
    out = _launch(x, "symmetric_gram_moments_launch", upper_tiles(x.shape[1]))
    with _launch_lock:
        symmetric_launches += 1
    return out
