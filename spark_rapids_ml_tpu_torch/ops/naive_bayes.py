"""Naive Bayes sufficient statistics on torch tensors: one-hot products.

Counterpart of ``spark_rapids_ml_tpu/ops/naive_bayes.py``. The statistics
are weighted class counts and per-class feature sums (``nb_stats``), and
for the gaussian type a second, centred pass of squared deviations from
the class means (``nb_centered_sq``). Each is the scatter by label recast
as the product onehotᵀ·X, in f32 with TF32 off, as ``ops/kmeans.py`` sums
its centroids; the statistics are a commutative monoid
(``combine_nb_stats``).

Rows go through in blocks of ``block_rows`` and the block partials are
summed by a balanced tree (``parallel.tree_aggregate.tree_reduce``): one
product over millions of rows would add every row's term into one f32
chain, while a block's chain is ``block_rows`` long and the tree adds
log₂(blocks) roundings. The blocks change only the order of the f32 sums.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from spark_rapids_ml_tpu_torch.ops.linalg import _require_f32_matmul
from spark_rapids_ml_tpu_torch.parallel.tree_aggregate import tree_reduce

#: rows per block of the one-hot products
DEFAULT_BLOCK_ROWS = 8192


class NBStats(NamedTuple):
    counts: torch.Tensor    # [C] weighted class counts
    feat_sum: torch.Tensor  # [C, F] weighted per-class feature sums


def combine_nb_stats(a: NBStats, b: NBStats) -> NBStats:
    return NBStats(*(av + bv for av, bv in zip(a, b)))


def _onehot_w(y: torch.Tensor, w: torch.Tensor, n_classes: int, dtype) -> torch.Tensor:
    """[rows, C] one-hot of the class labels scaled by the row weights."""
    classes = torch.arange(n_classes, dtype=torch.int64, device=y.device)
    return (y.to(torch.int64)[:, None] == classes[None, :]).to(dtype) * w[:, None]


def nb_stats(
    x: torch.Tensor,  # [rows, F]
    y: torch.Tensor,  # [rows] class indices (float or int)
    w: torch.Tensor,  # [rows] instance weights (0 = pad/excluded)
    n_classes: int,
    *,
    block_rows: int = DEFAULT_BLOCK_ROWS,
) -> NBStats:
    """Weighted class counts and per-class feature sums of a row shard."""
    _require_f32_matmul()
    parts = []
    for lo in range(0, x.shape[0], block_rows):
        onehot_w = _onehot_w(y[lo:lo + block_rows], w[lo:lo + block_rows], n_classes, x.dtype)
        parts.append(NBStats(onehot_w.sum(dim=0), onehot_w.T @ x[lo:lo + block_rows]))
    return tree_reduce(parts, combine_nb_stats)


def nb_centered_sq(
    x: torch.Tensor,   # [rows, F]
    y: torch.Tensor,   # [rows] class indices
    w: torch.Tensor,   # [rows] weights (0 = pad)
    mu: torch.Tensor,  # [C, F] per-class means
    n_classes: int,
    *,
    block_rows: int = DEFAULT_BLOCK_ROWS,
) -> torch.Tensor:
    """[C, F] Σ w·(x − μ_class)², the second gaussian pass: variance from
    squared deviations against the reduced class means is stable where the
    one-pass Σx²/N − μ² cancels on offset-heavy features."""
    _require_f32_matmul()
    mu = mu.to(x.dtype)
    parts = []
    for lo in range(0, x.shape[0], block_rows):
        yi = y[lo:lo + block_rows].to(torch.int64)
        d = x[lo:lo + block_rows] - mu[torch.clamp(yi, 0, n_classes - 1)]
        onehot_w = _onehot_w(yi, w[lo:lo + block_rows], n_classes, x.dtype)
        parts.append(onehot_w.T @ (d * d))
    return tree_reduce(parts, lambda a, b: a + b)
