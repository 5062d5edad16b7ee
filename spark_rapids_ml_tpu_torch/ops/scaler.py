"""Feature scaling math of the scaler family, in PyTorch ops.

Port of ``spark_rapids_ml_tpu/ops/scaler.py``: the same functions, the same
arguments and the same edge rules, on tensors of any device. The JAX
package has no Pallas code here (reductions, elementwise passes,
``bincount``, ``searchsorted`` and one matmul for DCT), so neither has the
port: these are PyTorch ops, which run on the card's library kernels.

The statistics are commutative monoids like PCA's ``GramStats``: one per
partition (or per streamed chunk), combined across partitions.

- Moments (``MomentStats``) for StandardScaler and the variance selector,
  and the streamed fold over them (``moment_fold_step``, driven by
  ``spark/ingest.py::stream_fold``). The port's carry is f32 on the
  device, as the staged chunks are; its count is exact below 2²⁴ rows.
- Range statistics (min / max / max |x|) for MinMaxScaler, MaxAbsScaler
  and the histogram passes.
- A per-feature fixed-bin histogram and quantiles from it, for
  RobustScaler, the Imputer's median and QuantileDiscretizer. A value
  lands in bin ``trunc(clamp((x − min)/w, 0, bins − 1))`` with
  w = (max − min)/bins (1 where the range is 0); pad rows and invalid
  entries go to an overflow bin that is dropped. ``torch.histc`` is not
  used: its edge rule is not this one.
- NaN-aware moments and ranges for the Imputer; ``bucketize``
  (``searchsorted`` on the right, minus one, clipped); the DCT-II basis.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class MomentStats(NamedTuple):
    """Per-feature first and second moments, summed across partitions."""

    count: torch.Tensor     # []
    total: torch.Tensor     # [n] per-feature sums
    total_sq: torch.Tensor  # [n] per-feature sums of squares


def moment_stats(x: torch.Tensor) -> MomentStats:
    """Moments of a block; the count is its row count, pads included (the
    caller fixes it to the true rows)."""
    return MomentStats(
        count=torch.tensor(float(x.shape[0]), dtype=x.dtype, device=x.device),
        total=x.sum(dim=0),
        total_sq=(x * x).sum(dim=0),
    )


def combine_moment_stats(a: MomentStats, b: MomentStats) -> MomentStats:
    return MomentStats(a.count + b.count, a.total + b.total, a.total_sq + b.total_sq)


def moment_stats_weighted(x: torch.Tensor, w: torch.Tensor) -> MomentStats:
    """Moments under the masking convention: ``w`` holds instance weights on
    true rows and 0.0 on pads, and the count is their sum. ``w`` may lie on
    the host (the streamed fold keeps it there); it is copied to ``x``'s
    device."""
    w = w.to(device=x.device, dtype=x.dtype, non_blocking=True)
    xw = x * w[:, None]
    return MomentStats(count=w.sum(), total=xw.sum(dim=0), total_sq=(xw * x).sum(dim=0))


def moment_fold_step():
    """The streamed fit's fold step ``step(carry, x, w) -> carry``: adds the
    chunk's weighted moments into ``carry`` in place (the counterpart of the
    JAX step's donated carry) and returns it; nothing synchronizes."""

    def step(carry: MomentStats, x: torch.Tensor, w: torch.Tensor) -> MomentStats:
        stats = moment_stats_weighted(x, w)
        carry.count.add_(stats.count)
        carry.total.add_(stats.total)
        carry.total_sq.add_(stats.total_sq)
        return carry

    return step


def init_moment_carry(n: int, device: torch.device | str) -> MomentStats:
    """The zero f32 carry of ``moment_fold_step`` on ``device``."""
    new = dict(dtype=torch.float32, device=device)
    return MomentStats(torch.zeros((), **new), torch.zeros((n,), **new), torch.zeros((n,), **new))


def finalize_moments(stats: MomentStats) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, sample std) from summed moments: the (m−1) variance of Spark
    MLlib's StandardScaler, clipped at zero against cancellation on constant
    features."""
    count = torch.clamp(stats.count, min=1.0)
    mean = stats.total / count
    denom = torch.clamp(count - 1, min=1.0)
    var = torch.clamp((stats.total_sq - count * mean * mean) / denom, min=0.0)
    return mean, torch.sqrt(var)


def standardize(
    x: torch.Tensor,
    mean: torch.Tensor,
    std: torch.Tensor,
    *,
    with_mean: bool = False,
    with_std: bool = True,
) -> torch.Tensor:
    """(x − μ)/σ with Spark's flags (withMean defaults to false there);
    zero-variance features pass through unscaled."""
    if with_mean:
        x = x - mean[None, :]
    if with_std:
        safe = torch.where(std > 0, std, torch.ones_like(std))
        x = x / safe[None, :]
    return x


def normalize(x: torch.Tensor, p: float = 2.0) -> torch.Tensor:
    """Row-wise p-normalization (Spark Normalizer, p ≥ 1, inf allowed); a
    row of norm 0 is left as it is."""
    if p == float("inf"):
        norms = x.abs().amax(dim=1)
    else:
        norms = (x.abs() ** p).sum(dim=1) ** (1.0 / p)
    safe = torch.where(norms > 0, norms, torch.ones_like(norms))
    return x / safe[:, None]


class RangeStats(NamedTuple):
    """Per-feature min / max / max |x|: the monoid of MinMaxScaler and
    MaxAbsScaler."""

    count: torch.Tensor    # []
    min: torch.Tensor      # [n]
    max: torch.Tensor      # [n]
    max_abs: torch.Tensor  # [n]


def _row_mask(x: torch.Tensor, true_rows: int) -> torch.Tensor:
    """[rows, 1] bool: the row is one of the first ``true_rows``."""
    return (torch.arange(x.shape[0], device=x.device) < true_rows)[:, None]


def range_stats(
    x: torch.Tensor, true_rows: int | None = None, *, valid: torch.Tensor | None = None
) -> RangeStats:
    """Masked per-feature min / max / max |x|, under a row-prefix count
    (``true_rows``) or an explicit [rows, 1] / [rows, n] / [rows] ``valid``
    mask. Masked entries become ±inf (0 for max |x|), so they never clamp
    the fold."""
    if valid is None:
        valid = _row_mask(x, true_rows)
        count = torch.tensor(float(true_rows), dtype=x.dtype, device=x.device)
    else:
        if valid.ndim == 1:
            valid = valid[:, None]
        count = valid.any(dim=1).sum().to(x.dtype)
    inf = torch.tensor(math.inf, dtype=x.dtype, device=x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return RangeStats(
        count=count,
        min=torch.where(valid, x, inf).amin(dim=0),
        max=torch.where(valid, x, -inf).amax(dim=0),
        max_abs=torch.where(valid, x.abs(), zero).amax(dim=0),
    )


def combine_range_stats(a: RangeStats, b: RangeStats) -> RangeStats:
    return RangeStats(
        a.count + b.count,
        torch.minimum(a.min, b.min),
        torch.maximum(a.max, b.max),
        torch.maximum(a.max_abs, b.max_abs),
    )


def minmax_scale(
    x: torch.Tensor, original_min: torch.Tensor, original_max: torch.Tensor, lo: float, hi: float
) -> torch.Tensor:
    """Spark MinMaxScalerModel: each feature's [E_min, E_max] onto [lo, hi];
    a constant feature maps to 0.5·(lo + hi)."""
    span = original_max - original_min
    safe = torch.where(span != 0, span, torch.ones_like(span))
    raw = torch.where(span != 0, (x - original_min) / safe, torch.full_like(x, 0.5))
    return raw * (hi - lo) + lo


def maxabs_scale(x: torch.Tensor, max_abs: torch.Tensor) -> torch.Tensor:
    """Spark MaxAbsScalerModel: x / max |x| per feature (an all-zero feature
    passes through)."""
    return x / torch.where(max_abs != 0, max_abs, torch.ones_like(max_abs))


def binarize(x: torch.Tensor, *, threshold: float = 0.0) -> torch.Tensor:
    """1.0 where x > threshold, else 0.0 (Spark Binarizer's strict >)."""
    return (x > threshold).to(x.dtype)


def histogram_stats(
    x: torch.Tensor,
    true_rows: int,
    mins: torch.Tensor,
    maxs: torch.Tensor,
    *,
    bins: int,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-feature fixed-bin histogram over [mins, maxs] as [n, bins] int64
    counts: bin ``trunc(clamp((x − min)/w, 0, bins − 1))``, pad rows and
    invalid entries to the dropped overflow bin. One ``bincount`` over all
    columns at once (each column's bins offset by ``col·(bins + 1)``).
    Quantile resolution is the bin width: range/bins."""
    rows, n = x.shape
    width = (maxs - mins) / bins
    safe_w = torch.where(width > 0, width, torch.ones_like(width))
    idx = torch.clamp((x - mins[None, :]) / safe_w[None, :], 0, bins - 1).to(torch.int64)
    keep = _row_mask(x, true_rows)
    if valid is not None:
        keep = keep & valid
    routed = torch.where(keep, idx, torch.full_like(idx, bins))
    offsets = torch.arange(n, device=x.device, dtype=torch.int64) * (bins + 1)
    flat = (routed + offsets[None, :]).reshape(-1)
    counts = torch.bincount(flat, minlength=n * (bins + 1)).reshape(n, bins + 1)
    return counts[:, :bins]


def quantile_from_histogram(
    hist: torch.Tensor, mins: torch.Tensor, maxs: torch.Tensor, q: float
) -> torch.Tensor:
    """Per-feature q-quantile of [n, bins] histograms, interpolated linearly
    inside the bin it falls in; a zero-range feature gives its min."""
    counts = hist.to(mins.dtype)
    bins = hist.shape[1]
    total = counts.sum(dim=1)
    cum = torch.cumsum(counts, dim=1)
    target = q * total
    ge = cum >= (target[:, None] - 1e-9)
    bin_idx = ge.to(torch.int8).argmax(dim=1)  # the first bin reaching it

    def take(a, i):
        return torch.gather(a, 1, i[:, None])[:, 0]

    cum_before = torch.where(
        bin_idx > 0, take(cum, torch.clamp(bin_idx - 1, min=0)), torch.zeros_like(total)
    )
    in_bin = take(counts, bin_idx)
    frac = torch.clamp((target - cum_before) / torch.clamp(in_bin, min=1.0), 0.0, 1.0)
    width = (maxs - mins) / bins
    return mins + (bin_idx.to(mins.dtype) + frac) * width


def robust_scale(
    x: torch.Tensor,
    median: torch.Tensor,
    qrange: torch.Tensor,
    *,
    with_centering: bool,
    with_scaling: bool,
) -> torch.Tensor:
    """(x − median?) / range?; a zero quantile range divides by 1."""
    out = x
    if with_centering:
        out = out - median[None, :]
    if with_scaling:
        out = out / torch.where(qrange > 0, qrange, torch.ones_like(qrange))[None, :]
    return out


class NanMomentStats(NamedTuple):
    """The Imputer's mean-strategy monoid: missing entries add to neither
    the sum nor the count."""

    count: torch.Tensor  # [n] valid entries per feature
    total: torch.Tensor  # [n] sum over valid entries


def _is_missing(x: torch.Tensor, missing: float) -> torch.Tensor:
    """Elementwise missing-sentinel test (NaN by ``isnan``, else ==)."""
    return torch.isnan(x) if missing != missing else x == missing


def valid_mask(x: torch.Tensor, true_rows: int, missing: float) -> torch.Tensor:
    """[rows, n] bool: a true row and not the missing sentinel."""
    return _row_mask(x, true_rows) & ~_is_missing(x, missing)


def nan_moment_stats(x: torch.Tensor, true_rows: int, missing: float) -> NanMomentStats:
    valid = valid_mask(x, true_rows, missing)
    xz = torch.where(valid, x, torch.zeros_like(x))
    return NanMomentStats(count=valid.sum(dim=0).to(x.dtype), total=xz.sum(dim=0))


def combine_nan_moment_stats(a: NanMomentStats, b: NanMomentStats) -> NanMomentStats:
    return NanMomentStats(a.count + b.count, a.total + b.total)


def impute(x: torch.Tensor, fill: torch.Tensor, missing: float) -> torch.Tensor:
    """Missing entries replaced by the per-feature fill value."""
    return torch.where(_is_missing(x, missing), fill[None, :].expand_as(x), x)


class NanRangeStats(NamedTuple):
    """NaN-aware min / max and valid counts (the Imputer's median pass)."""

    count: torch.Tensor  # [n]
    min: torch.Tensor    # [n]
    max: torch.Tensor    # [n]


def nan_range_stats(x: torch.Tensor, true_rows: int, missing: float) -> NanRangeStats:
    valid = valid_mask(x, true_rows, missing)
    inf = torch.tensor(math.inf, dtype=x.dtype, device=x.device)
    return NanRangeStats(
        count=valid.sum(dim=0).to(x.dtype),
        min=torch.where(valid, x, inf).amin(dim=0),
        max=torch.where(valid, x, -inf).amax(dim=0),
    )


def combine_nan_range_stats(a: NanRangeStats, b: NanRangeStats) -> NanRangeStats:
    return NanRangeStats(a.count + b.count, torch.minimum(a.min, b.min), torch.maximum(a.max, b.max))


def bucketize(x: torch.Tensor, splits: torch.Tensor) -> torch.Tensor:
    """Per-feature bucket ids from sorted split points ``splits`` [n, b+1]:
    bucket i is [splits[i], splits[i+1]), the top edge inclusive (Spark
    Bucketizer); duplicate splits leave empty buckets. The ids come in
    ``x``'s dtype. Values are compared in ``splits``' dtype."""
    values = x.to(splits.dtype).T.contiguous()  # [n, rows]
    idx = torch.searchsorted(splits.contiguous(), values, right=True) - 1
    return torch.clamp(idx, 0, splits.shape[1] - 2).T.to(x.dtype)


def dct2_matrix(n: int, dtype=torch.float64, device: torch.device | str = "cpu") -> torch.Tensor:
    """The unitary DCT-II basis [n, n] (Spark DCT: scipy's ``norm='ortho'``);
    row k is cos(π(2j + 1)k / 2n) scaled by √(1/n) for k = 0, √(2/n) else."""
    k = torch.arange(n, dtype=dtype, device=device)
    basis = torch.cos(math.pi * (2.0 * k[None, :] + 1.0) * k[:, None] / (2.0 * n))
    scale = torch.full((n,), math.sqrt(2.0 / n), dtype=dtype, device=device)
    scale[0] = math.sqrt(1.0 / n)
    return basis * scale[:, None]


def dct2(x: torch.Tensor, basis: torch.Tensor, *, inverse: bool = False) -> torch.Tensor:
    """Row-wise unitary DCT-II (or its inverse, DCT-III) as one matmul."""
    return x @ (basis if inverse else basis.T)
