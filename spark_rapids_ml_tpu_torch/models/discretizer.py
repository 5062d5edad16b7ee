"""QuantileDiscretizer and Bucketizer: binning on the histogram sketch.

Port of ``spark_rapids_ml_tpu/models/discretizer.py``. Spark's pair works
on one Double column; here the unit is the features vector column, as in
the JAX package: ``Bucketizer`` applies one splits array to every feature,
and ``QuantileDiscretizer`` learns per-feature splits, a [n, buckets+1]
matrix, from RobustScaler's fixed-bin histogram (two passes on the device,
``models/scaler.py``). Collapsed quantiles on skewed data give duplicate
splits and so empty buckets; ids stay in [0, numBuckets).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.models.base import Estimator, Model, Transformer
from spark_rapids_ml_tpu_torch.models.params import HasDevice, HasInputCol, HasOutputCol, Param
from spark_rapids_ml_tpu_torch.models.scaler import _fit_histogram, _fit_range_stats, _quantiles
from spark_rapids_ml_tpu_torch.ops import scaler as S
from spark_rapids_ml_tpu_torch.telemetry import trace_range
from spark_rapids_ml_tpu_torch.utils import columnar


def check_finite_range(mins: np.ndarray, maxs: np.ndarray) -> None:
    """Refuse NaN/Inf-poisoned feature ranges."""
    mins, maxs = np.asarray(mins), np.asarray(maxs)
    if np.isfinite(mins).all() and np.isfinite(maxs).all():
        return
    bad = np.flatnonzero(~np.isfinite(mins) | ~np.isfinite(maxs))
    raise ValueError(
        f"feature(s) {bad.tolist()} contain NaN/Inf values; "
        "QuantileDiscretizer needs finite data — impute first "
        "(spark_rapids_ml_tpu_torch.models.scaler.Imputer)"
    )


def splits_from_histogram(hist: torch.Tensor, mins: torch.Tensor, maxs: torch.Tensor,
                          num_buckets: int) -> np.ndarray:
    """[n, num_buckets+1] f64 per-feature quantile grid with ±inf outer
    edges; the interior splits are the histogram's quantiles at 1/b … (b−1)/b."""
    b = num_buckets
    splits = np.empty((hist.shape[0], b + 1))
    splits[:, 0] = -np.inf
    splits[:, b] = np.inf
    splits[:, 1:b] = _quantiles(hist, mins, maxs, np.arange(1, b) / b).T
    return splits


def _bucketize(mat: np.ndarray, splits: np.ndarray, device: torch.device) -> np.ndarray:
    """Bucket ids of host rows against per-feature ``splits`` [n, b+1], on
    ``device`` (f64 splits, values compared in f64), in the rows' dtype."""
    x = torch.from_numpy(np.ascontiguousarray(mat)).to(device)
    sp = torch.from_numpy(np.ascontiguousarray(splits, dtype=np.float64)).to(device)
    return S.bucketize(x, sp).cpu().numpy()


class Bucketizer(HasDevice, HasInputCol, HasOutputCol, Transformer):
    """Stateless binning of every feature against one sorted splits array.
    ``handleInvalid``: ``'error'`` (default) raises on a value outside
    [splits[0], splits[-1]] or NaN; ``'keep'`` gives it the extra id
    ``len(splits) − 1``. ±inf endpoints make every value in range."""

    splits = Param("splits", "sorted bucket boundaries (len >= 3)", None)
    handleInvalid = Param("handleInvalid", "out-of-range policy: error | keep", str)

    def __init__(self, uid: str | None = None, device: str | torch.device = "cuda", **kwargs):
        super().__init__(uid, device=device, **kwargs)
        self._setDefault(handleInvalid="error", outputCol="bucketed_features")

    def setSplits(self, value) -> "Bucketizer":
        sp = np.asarray(value, dtype=np.float64)
        if sp.ndim != 1 or len(sp) < 3:
            raise ValueError("splits must be a 1-D sequence of at least 3 boundaries")
        if not np.all(np.diff(sp) > 0):
            raise ValueError(f"splits must be strictly increasing, got {sp}")
        return self._set(splits=sp)

    def getSplits(self) -> np.ndarray:
        return np.asarray(self.getOrDefault("splits"))

    def setHandleInvalid(self, value: str) -> "Bucketizer":
        if value not in ("error", "keep"):
            raise ValueError(
                "handleInvalid must be 'error' or 'keep' ('skip' would "
                "drop rows, which a columnar map cannot do)"
            )
        return self._set(handleInvalid=value)

    def _bucket(self, mat: np.ndarray) -> np.ndarray:
        sp = self.getSplits()
        lo, hi = sp[0], sp[-1]
        invalid = np.isnan(mat) | (mat < lo) | (mat > hi)
        if invalid.any() and self.getOrDefault("handleInvalid") == "error":
            bad = np.argwhere(invalid)[0]
            raise ValueError(
                f"value {mat[tuple(bad)]} at row {bad[0]} feature "
                f"{bad[1]} is outside [{lo}, {hi}] (or NaN); widen "
                "splits (±inf endpoints) or setHandleInvalid('keep')"
            )
        ids = _bucketize(mat, np.broadcast_to(sp, (mat.shape[1], len(sp))), self.device)
        if invalid.any():  # handleInvalid == "keep"
            ids = np.where(invalid, float(len(sp) - 1), ids)
        return ids

    def transform(self, dataset: Any) -> Any:
        if not self.isSet("splits"):
            raise ValueError("splits must be set before transform")
        with trace_range("bucketize", self.device):
            return columnar.apply_column_transform(
                dataset, self._paramMap.get("inputCol"), self.getOutputCol(), self._bucket
            )


class _DiscretizerParams(HasDevice, HasInputCol, HasOutputCol):
    numBuckets = Param("numBuckets", "number of quantile buckets (>= 2)", int)
    numBins = Param("numBins", "histogram resolution of the quantile sketch (see RobustScaler)",
                    int)

    def __init__(self, uid: str | None = None, device: str | torch.device = "cuda", **kwargs):
        super().__init__(uid, device=device, **kwargs)
        self._setDefault(numBuckets=2, numBins=4096, outputCol="bucketed_features")

    def getNumBuckets(self) -> int:
        return self.getOrDefault("numBuckets")

    def getNumBins(self) -> int:
        return self.getOrDefault("numBins")


class QuantileDiscretizer(_DiscretizerParams, Estimator):
    """Per-feature quantile splits (numBuckets equal-frequency bins) from
    the histogram sketch, with ±inf outer edges."""

    def setNumBuckets(self, value: int) -> "QuantileDiscretizer":
        if value < 2:
            raise ValueError(f"numBuckets must be >= 2, got {value}")
        return self._set(numBuckets=int(value))

    def setNumBins(self, value: int) -> "QuantileDiscretizer":
        if value < 2:
            raise ValueError(f"numBins must be >= 2, got {value}")
        return self._set(numBins=int(value))

    def fit(self, dataset: Any, num_partitions: int | None = None) -> "QuantileDiscretizerModel":
        rstats = _fit_range_stats(self, dataset, num_partitions)
        check_finite_range(rstats.min.cpu().numpy(), rstats.max.cpu().numpy())
        with trace_range("quantile discretizer histogram", self.device):
            hist = _fit_histogram(self, dataset, num_partitions, rstats.min, rstats.max,
                                  self.getNumBins())
        splits = splits_from_histogram(hist, rstats.min, rstats.max, self.getNumBuckets())
        model = QuantileDiscretizerModel(uid=self.uid, splits=splits, device=self.device)
        return self._copyValues(model)


class QuantileDiscretizerModel(_DiscretizerParams, Model):
    """Per-feature splits [n, numBuckets+1] with ±inf outer edges."""

    def __init__(self, uid: str | None = None, splits: np.ndarray | None = None,
                 device: str | torch.device = "cuda"):
        super().__init__(uid, device=device)
        self.splits = None if splits is None else np.asarray(splits)

    def _bucket(self, mat: np.ndarray) -> np.ndarray:
        if mat.shape[1] != self.splits.shape[0]:
            raise ValueError(
                f"model learned {self.splits.shape[0]} features, input has {mat.shape[1]}"
            )
        if np.isnan(mat).any():
            bad = np.argwhere(np.isnan(mat))[0]
            raise ValueError(
                f"NaN at row {bad[0]} feature {bad[1]}; "
                "QuantileDiscretizer bins finite data — impute first "
                "(spark_rapids_ml_tpu_torch.models.scaler.Imputer)"
            )
        return _bucketize(mat, self.splits, self.device)

    def transform(self, dataset: Any) -> Any:
        with trace_range("quantile bucketize", self.device):
            return columnar.apply_column_transform(
                dataset, self._paramMap.get("inputCol"), self.getOutputCol(), self._bucket
            )

    def _saveData(self) -> dict[str, np.ndarray]:
        return {"splits": self.splits}

    @classmethod
    def _fromSaved(cls, uid, data, device):
        return cls(uid=uid, splits=data["splits"], device=device)

    def _checkSparkML(self) -> None:
        raise NotImplementedError(
            "stock Spark ML's QuantileDiscretizer fits a single-column "
            "Bucketizer; the per-feature splits matrix has no stock "
            "layout — use the native layout"
        )
