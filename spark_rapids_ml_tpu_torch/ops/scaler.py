"""Feature moments for StandardScaler.

Counterpart of ``MomentStats`` and ``finalize_moments`` in
``spark_rapids_ml_tpu/ops/scaler.py``: what the fused standardize of the PCA
fit needs (``linalg.standardized_cov_from_stats``). The rest of the scaler
family is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class MomentStats(NamedTuple):
    """Per-feature first and second moments, summed across partitions."""

    count: torch.Tensor     # []
    total: torch.Tensor     # [n] per-feature sums
    total_sq: torch.Tensor  # [n] per-feature sums of squares


def finalize_moments(stats: MomentStats) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, sample std) from summed moments: the (m−1) variance of Spark
    MLlib's StandardScaler, clipped at zero against cancellation on constant
    features."""
    count = torch.clamp(stats.count, min=1.0)
    mean = stats.total / count
    denom = torch.clamp(count - 1, min=1.0)
    var = torch.clamp((stats.total_sq - count * mean * mean) / denom, min=0.0)
    return mean, torch.sqrt(var)
