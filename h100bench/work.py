"""The yardstick: the chip's published peaks, and the operations and bytes
that a piece of work needs, from its shapes alone.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W
power limit): a card set below it runs slower, so every share is stated
beside the card's power limit. A bound is the least time the chip could
take: the larger of operations over the peak rate and bytes over the
memory bandwidth, each input byte read once and each output byte written
once.
"""

from __future__ import annotations

PEAK_FLOPS = {
    "bf16": 989e12,
    "f32": 67e12,   # outside the tensor cores: f32 products with TF32 off
}
PEAK_HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float, peak: str) -> float:
    """Least seconds for ``flops`` operations at ``PEAK_FLOPS[peak]`` and
    ``nbytes`` of memory traffic, whichever takes longer."""
    return max(flops / PEAK_FLOPS[peak], nbytes / PEAK_HBM_BYTES_PER_S)


def lloyd_flops(rows: int, n: int, k: int) -> float:
    """One Lloyd iteration's two products: the cross term x·cᵀ and the
    centroid sums onehotᵀ·x, 2·rows·n·k operations each."""
    return 4.0 * rows * n * k


def lloyd_bytes(rows: int, n: int, k: int) -> float:
    """X and the centres read once, the sums and counts written once."""
    return 4.0 * (rows * n + 2 * k * n + k)


def lloyd_bound_s(rows: int, n: int, k: int, iterations: int) -> float:
    """Least seconds of ``iterations`` Lloyd iterations in f32."""
    return iterations * bound_s(lloyd_flops(rows, n, k), lloyd_bytes(rows, n, k), "f32")
