"""The scaler family of the port: BASELINE config 4's preprocessing
("StandardScaler / Normalizer fused into the PCA input pipeline") and the
rest of Spark ML's feature scalers, on the card by default.

Counterpart of ``spark_rapids_ml_tpu/models/scaler.py``: the same classes,
params, defaults, setters and messages, plus a ``device`` argument
(default ``"cuda"``):

- StandardScaler (withMean=False, withStd=True) and its model: moments per
  partition and a tree reduction, or, above the streamed-fit cutover, the
  moments fold of ``spark/ingest.py::stream_fold``;
- MinMaxScaler, MaxAbsScaler (range statistics), RobustScaler (range,
  then a fixed-bin histogram, then quantiles), Imputer (mean, or the
  histogram median), and their models;
- the stateless Normalizer, Binarizer, ElementwiseProduct, VectorSlicer,
  DCT and PolynomialExpansion.

The device math is ``ops/scaler.py``. Rows go to the device as f32
(``utils.device.to_device``), so a transform returns f32 where the JAX
package keeps its input's dtype. ElementwiseProduct, VectorSlicer and
PolynomialExpansion are host numpy in the JAX package and stay so here.
Models save and load in the JAX package's layouts: native, and Spark ML's
for StandardScaler, MinMaxScaler, MaxAbsScaler and RobustScaler.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import math
import warnings
from typing import Any

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.models.base import Estimator, Model, Transformer, spark_set_params
from spark_rapids_ml_tpu_torch.models.params import HasDevice, HasInputCol, HasOutputCol, Param
from spark_rapids_ml_tpu_torch.ops import scaler as S
from spark_rapids_ml_tpu_torch.parallel.executor import run_partition_tasks
from spark_rapids_ml_tpu_torch.parallel.tree_aggregate import tree_reduce
from spark_rapids_ml_tpu_torch.spark import ingest
from spark_rapids_ml_tpu_torch.telemetry import trace_range
from spark_rapids_ml_tpu_torch.utils import columnar
from spark_rapids_ml_tpu_torch.utils import persistence as P
from spark_rapids_ml_tpu_torch.utils.device import to_device


def _params_on(device: torch.device, *arrays) -> list[torch.Tensor]:
    """A fitted model's host vectors as f32 tensors on ``device``."""
    return [to_device(np.asarray(a), device) for a in arrays]


def _partition_reduce(ds: columnar.PartitionedDataset, device: torch.device, fn, combine):
    """``fn(padded rows on device, true_rows)`` per partition, on the
    partition thread pool, tree-reduced with ``combine``."""

    def run(mat):
        padded, true_rows = columnar.pad_rows(mat)
        return fn(to_device(padded, device), true_rows)

    return tree_reduce(run_partition_tasks(run, list(ds.matrices())), combine)


def _reduce_partitions(self, dataset, num_partitions, fn, combine):
    """The shared resident fit: ``_partition_reduce`` of ``dataset``'s
    partitions on the estimator's device."""
    ds = columnar.PartitionedDataset.from_any(
        dataset, self._paramMap.get("inputCol"), num_partitions
    )
    return _partition_reduce(ds, self.device, fn, combine)


def _save_spark_ml_vectors(model, path: str, vectors: dict) -> None:
    """The scaler family's stock-layout writer: the params Spark knows and
    the ordered dense-vector data row."""
    P.save_spark_ml_vector_model(
        path,
        class_name=model._SPARK_ML_CLASS,
        uid=model.uid,
        params={k: v for k, v in spark_set_params(model).items() if k in model._SPARK_ML_PARAMS},
        vectors=vectors,
    )


def _vector(table, name: str) -> np.ndarray:
    return P.struct_to_vector(table.column(name)[0].as_py())


class _Stage(HasDevice, HasInputCol, HasOutputCol):
    """A stage over ``inputCol`` that writes ``outputCol``, on ``device``."""

    def _apply(self, dataset: Any, fn) -> Any:
        return columnar.apply_column_transform(
            dataset, self._paramMap.get("inputCol"), self.getOutputCol(), fn
        )

    def _on_device(self, mat: np.ndarray, fn) -> np.ndarray:
        """``fn`` of the rows as f32 on the stage's device, back on the host."""
        return fn(to_device(mat, self.device)).cpu().numpy()


# -- StandardScaler -------------------------------------------------------------


class _ScalerParams(_Stage):
    withMean = Param("withMean", "center features before scaling", bool)
    withStd = Param("withStd", "scale features to unit sample std", bool)

    def __init__(self, uid: str | None = None, device: str | torch.device = "cuda", **kwargs):
        super().__init__(uid, device=device, **kwargs)
        self._setDefault(withMean=False, withStd=True, outputCol="scaled_features")

    def getWithMean(self) -> bool:
        return self.getOrDefault("withMean")

    def getWithStd(self) -> bool:
        return self.getOrDefault("withStd")


def _moments_with_true_count(x: torch.Tensor, true_rows: int) -> S.MomentStats:
    """A padded partition's moments, the count fixed to its true rows (pad
    rows are zero and add nothing else)."""
    st = S.moment_stats(x)
    return S.MomentStats(torch.full_like(st.count, true_rows), st.total, st.total_sq)


class StandardScaler(_ScalerParams, Estimator):
    def setWithMean(self, value: bool) -> "StandardScaler":
        return self._set(withMean=value)

    def setWithStd(self, value: bool) -> "StandardScaler":
        return self._set(withStd=value)

    def fit(self, dataset: Any, num_partitions: int | None = None) -> "StandardScalerModel":
        """Moments on the device, resident, or folded chunk by chunk through
        ``spark.ingest.stream_fold`` above the
        ``TPU_ML_STREAM_FIT_MAX_RESIDENT_BYTES`` cutover (O(chunk + n)
        device memory; the model keeps the fold's record as
        ``stream_report``); then the mean and the sample std."""
        ds = columnar.PartitionedDataset.from_any(
            dataset, self._paramMap.get("inputCol"), num_partitions
        )
        report = None
        with trace_range("scaler moments", self.device):
            if columnar.use_streamed_fit(ds):
                it = ds.matrices()
                first = next(it)
                n = first.shape[1]
                report = ingest.stream_fold(
                    itertools.chain([first], it),
                    S.moment_fold_step(),
                    n=n,
                    init=S.init_moment_carry(n, self.device),
                    device=self.device,
                )
                stats = report.carry
            else:
                stats = _partition_reduce(
                    ds, self.device, _moments_with_true_count, S.combine_moment_stats
                )
            mean, std = S.finalize_moments(stats)
        model = StandardScalerModel(
            uid=self.uid, mean=mean.cpu().numpy(), std=std.cpu().numpy(), device=self.device
        )
        if report is not None:
            model.stream_report = dataclasses.replace(report, carry=None)
        return self._copyValues(model)


class StandardScalerModel(_ScalerParams, Model):
    """``mean``/``std`` [n] host vectors; ``stream_report`` is the streamed
    fold's record for a streamed fit, else None."""

    def __init__(
        self,
        uid: str | None = None,
        mean: np.ndarray | None = None,
        std: np.ndarray | None = None,
        device: str | torch.device = "cuda",
    ):
        super().__init__(uid, device=device)
        self.mean = None if mean is None else np.asarray(mean)
        self.std = None if std is None else np.asarray(std)
        self.stream_report: ingest.StreamFold | None = None

    def _scale(self, mat: np.ndarray) -> np.ndarray:
        mean, std = _params_on(self.device, self.mean, self.std)
        return self._on_device(mat, functools.partial(
            S.standardize, mean=mean, std=std,
            with_mean=self.getWithMean(), with_std=self.getWithStd(),
        ))

    def transform(self, dataset: Any) -> Any:
        with trace_range("scaler transform", self.device):
            return self._apply(dataset, self._scale)

    def _saveData(self) -> dict[str, np.ndarray]:
        return {"mean": self.mean, "std": self.std}

    @classmethod
    def _fromSaved(cls, uid, data, device):
        return cls(uid=uid, mean=data["mean"], std=data["std"], device=device)

    # stock Spark persists Row(std: Vector, mean: Vector), in that order
    _SPARK_ML_CLASS = "org.apache.spark.ml.feature.StandardScalerModel"
    _SPARK_ML_PARAMS = ("withMean", "withStd", "inputCol", "outputCol")

    def _saveSparkML(self, path: str) -> None:
        _save_spark_ml_vectors(self, path, {"std": self.std, "mean": self.mean})

    @classmethod
    def _fromSparkML(cls, meta: dict, table, device) -> "StandardScalerModel":
        return cls(uid=meta["uid"], mean=_vector(table, "mean"), std=_vector(table, "std"),
                   device=device)


# -- MinMaxScaler, MaxAbsScaler -----------------------------------------------------


def _fit_range_stats(self, dataset: Any, num_partitions: int | None) -> S.RangeStats:
    """The range scalers' fit: one masked reduction per partition and an
    elementwise min/max tree reduction."""
    with trace_range("scaler range stats", self.device):
        return _reduce_partitions(
            self, dataset, num_partitions, S.range_stats, S.combine_range_stats
        )


class _MinMaxParams(_Stage):
    min = Param("min", "lower bound of the output range", float)
    max = Param("max", "upper bound of the output range", float)

    def __init__(self, uid: str | None = None, device: str | torch.device = "cuda", **kwargs):
        super().__init__(uid, device=device, **kwargs)
        self._setDefault(min=0.0, max=1.0, outputCol="scaled_features")

    def getMin(self) -> float:
        return self.getOrDefault("min")

    def getMax(self) -> float:
        return self.getOrDefault("max")

    def _check_range(self) -> None:
        if not self.getMin() < self.getMax():
            raise ValueError(f"min={self.getMin()} must be < max={self.getMax()}")


class MinMaxScaler(_MinMaxParams, Estimator):
    """Rescale each feature to [min, max] (Spark ``MinMaxScaler``); a
    constant feature maps to the output midpoint."""

    def setMin(self, value: float) -> "MinMaxScaler":
        return self._set(min=float(value))

    def setMax(self, value: float) -> "MinMaxScaler":
        return self._set(max=float(value))

    def fit(self, dataset: Any, num_partitions: int | None = None) -> "MinMaxScalerModel":
        self._check_range()
        stats = _fit_range_stats(self, dataset, num_partitions)
        model = MinMaxScalerModel(
            uid=self.uid, originalMin=stats.min.cpu().numpy(),
            originalMax=stats.max.cpu().numpy(), device=self.device,
        )
        return self._copyValues(model)


class MinMaxScalerModel(_MinMaxParams, Model):
    def __init__(
        self,
        uid: str | None = None,
        originalMin: np.ndarray | None = None,
        originalMax: np.ndarray | None = None,
        device: str | torch.device = "cuda",
    ):
        super().__init__(uid, device=device)
        self.originalMin = None if originalMin is None else np.asarray(originalMin)
        self.originalMax = None if originalMax is None else np.asarray(originalMax)

    def _scale(self, mat: np.ndarray) -> np.ndarray:
        lo, hi = _params_on(self.device, self.originalMin, self.originalMax)
        return self._on_device(mat, lambda x: S.minmax_scale(x, lo, hi, self.getMin(),
                                                             self.getMax()))

    def transform(self, dataset: Any) -> Any:
        with trace_range("minmax transform", self.device):
            return self._apply(dataset, self._scale)

    def _saveData(self) -> dict[str, np.ndarray]:
        return {"originalMin": self.originalMin, "originalMax": self.originalMax}

    @classmethod
    def _fromSaved(cls, uid, data, device):
        return cls(uid=uid, originalMin=data["originalMin"], originalMax=data["originalMax"],
                   device=device)

    _SPARK_ML_CLASS = "org.apache.spark.ml.feature.MinMaxScalerModel"
    _SPARK_ML_PARAMS = ("min", "max", "inputCol", "outputCol")

    def _saveSparkML(self, path: str) -> None:
        _save_spark_ml_vectors(
            self, path, {"originalMin": self.originalMin, "originalMax": self.originalMax}
        )

    @classmethod
    def _fromSparkML(cls, meta: dict, table, device) -> "MinMaxScalerModel":
        return cls(uid=meta["uid"], originalMin=_vector(table, "originalMin"),
                   originalMax=_vector(table, "originalMax"), device=device)


class _MaxAbsParams(_Stage):
    def __init__(self, uid: str | None = None, device: str | torch.device = "cuda", **kwargs):
        super().__init__(uid, device=device, **kwargs)
        self._setDefault(outputCol="scaled_features")


class MaxAbsScaler(_MaxAbsParams, Estimator):
    """Scale each feature to [-1, 1] by its max |x| (Spark
    ``MaxAbsScaler``): no centering, zeros stay zero."""

    def fit(self, dataset: Any, num_partitions: int | None = None) -> "MaxAbsScalerModel":
        stats = _fit_range_stats(self, dataset, num_partitions)
        model = MaxAbsScalerModel(uid=self.uid, maxAbs=stats.max_abs.cpu().numpy(),
                                  device=self.device)
        return self._copyValues(model)


class MaxAbsScalerModel(_MaxAbsParams, Model):
    def __init__(self, uid: str | None = None, maxAbs: np.ndarray | None = None,
                 device: str | torch.device = "cuda"):
        super().__init__(uid, device=device)
        self.maxAbs = None if maxAbs is None else np.asarray(maxAbs)

    def _scale(self, mat: np.ndarray) -> np.ndarray:
        (max_abs,) = _params_on(self.device, self.maxAbs)
        return self._on_device(mat, lambda x: S.maxabs_scale(x, max_abs))

    def transform(self, dataset: Any) -> Any:
        with trace_range("maxabs transform", self.device):
            return self._apply(dataset, self._scale)

    def _saveData(self) -> dict[str, np.ndarray]:
        return {"maxAbs": self.maxAbs}

    @classmethod
    def _fromSaved(cls, uid, data, device):
        return cls(uid=uid, maxAbs=data["maxAbs"], device=device)

    _SPARK_ML_CLASS = "org.apache.spark.ml.feature.MaxAbsScalerModel"
    _SPARK_ML_PARAMS = ("inputCol", "outputCol")

    def _saveSparkML(self, path: str) -> None:
        _save_spark_ml_vectors(self, path, {"maxAbs": self.maxAbs})

    @classmethod
    def _fromSparkML(cls, meta: dict, table, device) -> "MaxAbsScalerModel":
        return cls(uid=meta["uid"], maxAbs=_vector(table, "maxAbs"), device=device)


# -- stateless transformers -----------------------------------------------------------


class Normalizer(_Stage, Transformer):
    """Stateless row p-normalization (Spark ``Normalizer``)."""

    p = Param("p", "norm order (p >= 1; inf supported)", float)

    def __init__(self, uid: str | None = None, device: str | torch.device = "cuda", **kwargs):
        super().__init__(uid, device=device, **kwargs)
        self._setDefault(p=2.0, outputCol="normalized_features")

    def setP(self, value: float) -> "Normalizer":
        return self._set(p=value)

    def getP(self) -> float:
        return self.getOrDefault("p")

    def _normalize_matrix(self, mat: np.ndarray) -> np.ndarray:
        return self._on_device(mat, lambda x: S.normalize(x, self.getP()))

    def transform(self, dataset: Any) -> Any:
        with trace_range("normalize", self.device):
            return self._apply(dataset, self._normalize_matrix)


class Binarizer(_Stage, Transformer):
    """Stateless thresholding (Spark ``Binarizer``): 1.0 where x >
    threshold, else 0.0."""

    threshold = Param("threshold", "binarization threshold (strict >)", float)

    def __init__(self, uid: str | None = None, device: str | torch.device = "cuda", **kwargs):
        super().__init__(uid, device=device, **kwargs)
        self._setDefault(threshold=0.0, outputCol="binarized_features")

    def setThreshold(self, value: float) -> "Binarizer":
        return self._set(threshold=float(value))

    def getThreshold(self) -> float:
        return self.getOrDefault("threshold")

    def _binarize(self, mat: np.ndarray) -> np.ndarray:
        return self._on_device(mat, lambda x: S.binarize(x, threshold=self.getThreshold()))

    def transform(self, dataset: Any) -> Any:
        with trace_range("binarize", self.device):
            return self._apply(dataset, self._binarize)


# -- RobustScaler, Imputer ---------------------------------------------------------------


def _fit_histogram(self, dataset, num_partitions, mins: torch.Tensor, maxs: torch.Tensor,
                   bins: int, missing: float | None = None) -> torch.Tensor:
    """The partitioned histogram pass (RobustScaler, QuantileDiscretizer,
    the Imputer's median), additive across partitions; with ``missing``,
    missing entries go to the dropped bin too."""

    def task(x, true_rows):
        valid = None if missing is None else S.valid_mask(x, true_rows, missing)
        return S.histogram_stats(x, true_rows, mins, maxs, bins=bins, valid=valid)

    return _reduce_partitions(self, dataset, num_partitions, task, lambda a, b: a + b)


def _quantiles(hist, mins, maxs, qs) -> np.ndarray:
    """[len(qs), n] quantiles of one histogram."""
    return np.stack([S.quantile_from_histogram(hist, mins, maxs, q).cpu().numpy() for q in qs])


class _RobustParams(_Stage):
    lower = Param("lower", "lower quantile of the scaling range", float)
    upper = Param("upper", "upper quantile of the scaling range", float)
    withCentering = Param("withCentering", "subtract the median", bool)
    withScaling = Param("withScaling", "divide by the quantile range", bool)
    numBins = Param(
        "numBins",
        "histogram resolution of the distributed quantile sketch "
        "(value-resolution error = feature range / numBins)",
        int,
    )

    def __init__(self, uid: str | None = None, device: str | torch.device = "cuda", **kwargs):
        super().__init__(uid, device=device, **kwargs)
        self._setDefault(lower=0.25, upper=0.75, withCentering=False, withScaling=True,
                         numBins=4096, outputCol="scaled_features")

    def getLower(self) -> float:
        return self.getOrDefault("lower")

    def getUpper(self) -> float:
        return self.getOrDefault("upper")

    def getWithCentering(self) -> bool:
        return self.getOrDefault("withCentering")

    def getWithScaling(self) -> bool:
        return self.getOrDefault("withScaling")

    def getNumBins(self) -> int:
        return self.getOrDefault("numBins")

    def _check_quantile_bounds(self) -> None:
        if not 0.0 <= self.getLower() < self.getUpper() <= 1.0:
            raise ValueError(
                f"need 0 <= lower < upper <= 1, got [{self.getLower()}, {self.getUpper()}]"
            )


class RobustScaler(_RobustParams, Estimator):
    """Quantile-based scaling (Spark ``RobustScaler``'s surface): the range
    pass, then a per-feature fixed-bin histogram, from which the median and
    the quantile range interpolate. The quantiles' value error is at most
    range/numBins (Spark bounds the rank error instead)."""

    def setLower(self, value: float) -> "RobustScaler":
        return self._set(lower=float(value))

    def setUpper(self, value: float) -> "RobustScaler":
        return self._set(upper=float(value))

    def setWithCentering(self, value: bool) -> "RobustScaler":
        return self._set(withCentering=bool(value))

    def setWithScaling(self, value: bool) -> "RobustScaler":
        return self._set(withScaling=bool(value))

    def setNumBins(self, value: int) -> "RobustScaler":
        if value < 2:
            raise ValueError(f"numBins must be >= 2, got {value}")
        return self._set(numBins=int(value))

    def fit(self, dataset: Any, num_partitions: int | None = None) -> "RobustScalerModel":
        self._check_quantile_bounds()
        rstats = _fit_range_stats(self, dataset, num_partitions)
        with trace_range("robust scaler histogram", self.device):
            hist = _fit_histogram(self, dataset, num_partitions, rstats.min, rstats.max,
                                  self.getNumBins())
        median, lo, hi = _quantiles(hist, rstats.min, rstats.max,
                                    (0.5, self.getLower(), self.getUpper()))
        model = RobustScalerModel(uid=self.uid, median=median, range=hi - lo,
                                  device=self.device)
        return self._copyValues(model)


class RobustScalerModel(_RobustParams, Model):
    def __init__(
        self,
        uid: str | None = None,
        median: np.ndarray | None = None,
        range: np.ndarray | None = None,
        device: str | torch.device = "cuda",
    ):
        super().__init__(uid, device=device)
        self.median = None if median is None else np.asarray(median)
        self.range = None if range is None else np.asarray(range)

    def _scale(self, mat: np.ndarray) -> np.ndarray:
        median, qrange = _params_on(self.device, self.median, self.range)
        return self._on_device(mat, lambda x: S.robust_scale(
            x, median, qrange, with_centering=self.getWithCentering(),
            with_scaling=self.getWithScaling(),
        ))

    def transform(self, dataset: Any) -> Any:
        with trace_range("robust transform", self.device):
            return self._apply(dataset, self._scale)

    def _saveData(self) -> dict[str, np.ndarray]:
        return {"median": self.median, "range": self.range}

    @classmethod
    def _fromSaved(cls, uid, data, device):
        return cls(uid=uid, median=data["median"], range=data["range"], device=device)

    # stock Spark persists Row(range, median)
    _SPARK_ML_CLASS = "org.apache.spark.ml.feature.RobustScalerModel"
    _SPARK_ML_PARAMS = ("lower", "upper", "withCentering", "withScaling", "inputCol",
                        "outputCol")

    def _saveSparkML(self, path: str) -> None:
        _save_spark_ml_vectors(self, path, {"range": self.range, "median": self.median})

    @classmethod
    def _fromSparkML(cls, meta: dict, table, device) -> "RobustScalerModel":
        return cls(uid=meta["uid"], median=_vector(table, "median"),
                   range=_vector(table, "range"), device=device)


def _apply_empty_surrogate(count: np.ndarray, surrogate: np.ndarray) -> np.ndarray:
    """An all-missing feature's surrogate is 0.0 (Spark ML's empty-stat
    convention), with a warning naming it."""
    empty = count == 0
    if empty.any():
        warnings.warn(
            f"imputer: feature(s) {np.flatnonzero(empty).tolist()} "
            "have no valid entries; their surrogate is 0.0",
            UserWarning,
            stacklevel=3,
        )
        return np.where(empty, 0.0, surrogate)
    return surrogate


class _ImputerParams(_Stage):
    strategy = Param("strategy", "imputation strategy: mean | median", str)
    missingValue = Param("missingValue", "the placeholder for missing entries (default NaN)",
                         float)
    numBins = Param("numBins", "histogram resolution of the median sketch (see RobustScaler)",
                    int)

    def __init__(self, uid: str | None = None, device: str | torch.device = "cuda", **kwargs):
        super().__init__(uid, device=device, **kwargs)
        self._setDefault(strategy="mean", missingValue=float("nan"), numBins=4096,
                         outputCol="imputed_features")

    def getStrategy(self) -> str:
        return self.getOrDefault("strategy")

    def getMissingValue(self) -> float:
        return self.getOrDefault("missingValue")

    def getNumBins(self) -> int:
        return self.getOrDefault("numBins")


class Imputer(_ImputerParams, Estimator):
    """Per-feature missing-value imputation over the features vector
    column (Spark ``Imputer``'s ``mean``/``median``, missingValue NaN by
    default): ``mean`` is one NaN-aware moments pass, ``median`` the
    RobustScaler histogram with missing entries dropped. A feature with no
    valid entry gets 0.0, with a warning."""

    def setStrategy(self, value: str) -> "Imputer":
        if value not in ("mean", "median"):
            raise ValueError(
                f"strategy must be 'mean' or 'median', got {value!r} "
                "('mode' needs exact value counts, which the histogram "
                "sketch deliberately does not keep)"
            )
        return self._set(strategy=value)

    def setMissingValue(self, value: float) -> "Imputer":
        return self._set(missingValue=float(value))

    def setNumBins(self, value: int) -> "Imputer":
        if value < 2:
            raise ValueError(f"numBins must be >= 2, got {value}")
        return self._set(numBins=int(value))

    def fit(self, dataset: Any, num_partitions: int | None = None) -> "ImputerModel":
        missing = self.getMissingValue()
        with trace_range("imputer fit", self.device):
            if self.getStrategy() == "mean":
                stats = _reduce_partitions(
                    self, dataset, num_partitions,
                    lambda x, true_rows: S.nan_moment_stats(x, true_rows, missing),
                    S.combine_nan_moment_stats,
                )
                count = stats.count.cpu().numpy()
                surrogate = stats.total.cpu().numpy() / np.maximum(count, 1.0)
            else:
                rstats = _reduce_partitions(
                    self, dataset, num_partitions,
                    lambda x, true_rows: S.nan_range_stats(x, true_rows, missing),
                    S.combine_nan_range_stats,
                )
                count = rstats.count.cpu().numpy()
                # an all-missing feature has ±inf bounds: keep the histogram
                # finite (its quantile is replaced by the empty surrogate)
                mins = torch.where(torch.isfinite(rstats.min), rstats.min,
                                   torch.zeros_like(rstats.min))
                maxs = torch.where(torch.isfinite(rstats.max), rstats.max,
                                   torch.zeros_like(rstats.max))
                hist = _fit_histogram(self, dataset, num_partitions, mins, maxs,
                                      self.getNumBins(), missing=missing)
                (surrogate,) = _quantiles(hist, mins, maxs, (0.5,))
            surrogate = _apply_empty_surrogate(count, surrogate)
        return self._copyValues(ImputerModel(uid=self.uid, surrogate=surrogate,
                                             device=self.device))


class ImputerModel(_ImputerParams, Model):
    def __init__(self, uid: str | None = None, surrogate: np.ndarray | None = None,
                 device: str | torch.device = "cuda"):
        super().__init__(uid, device=device)
        self.surrogate = None if surrogate is None else np.asarray(surrogate)

    def _fill(self, mat: np.ndarray) -> np.ndarray:
        (fill,) = _params_on(self.device, self.surrogate)
        return self._on_device(mat, lambda x: S.impute(x, fill, self.getMissingValue()))

    def transform(self, dataset: Any) -> Any:
        with trace_range("impute", self.device):
            return self._apply(dataset, self._fill)

    def _saveData(self) -> dict[str, np.ndarray]:
        return {"surrogate": self.surrogate}

    @classmethod
    def _fromSaved(cls, uid, data, device):
        return cls(uid=uid, surrogate=data["surrogate"], device=device)

    def _checkSparkML(self) -> None:
        raise NotImplementedError(
            "stock Spark ML's Imputer operates on separate numeric input "
            "columns (surrogateDF layout), which cannot represent this "
            "vector-column model; use the native layout"
        )


# -- ElementwiseProduct, VectorSlicer, DCT, PolynomialExpansion ----------------


class ElementwiseProduct(_Stage, Transformer):
    """Stateless per-feature rescaling by a fixed weight vector (Spark
    ``ElementwiseProduct``: x ∘ scalingVec), in f64 on the host as in the
    JAX package."""

    scalingVec = Param("scalingVec", "the componentwise multiplier", None)

    def __init__(self, uid: str | None = None, device: str | torch.device = "cuda", **kwargs):
        super().__init__(uid, device=device, **kwargs)
        self._setDefault(outputCol="scaled_features")

    def setScalingVec(self, value) -> "ElementwiseProduct":
        return self._set(scalingVec=np.asarray(value, dtype=np.float64))

    def getScalingVec(self) -> np.ndarray:
        return np.asarray(self.getOrDefault("scalingVec"))

    def _product(self, mat: np.ndarray) -> np.ndarray:
        w = self.getScalingVec()
        if mat.shape[1] != len(w):
            raise ValueError(f"scalingVec has {len(w)} entries, features have {mat.shape[1]}")
        return mat * w[None, :]

    def transform(self, dataset: Any) -> Any:
        if not self.isSet("scalingVec"):
            raise ValueError("scalingVec must be set before transform")
        with trace_range("elementwise product", self.device):
            return self._apply(dataset, self._product)


class VectorSlicer(_Stage, Transformer):
    """Stateless feature subsetting by indices (Spark ``VectorSlicer``'s
    ``indices``), on the host as in the JAX package."""

    indices = Param("indices", "feature indices to keep, in output order", None)

    def __init__(self, uid: str | None = None, device: str | torch.device = "cuda", **kwargs):
        super().__init__(uid, device=device, **kwargs)
        self._setDefault(outputCol="sliced_features")

    def setIndices(self, value) -> "VectorSlicer":
        idx = np.asarray(value, dtype=np.int32)
        if idx.ndim != 1 or len(idx) == 0:
            raise ValueError("indices must be a non-empty 1-D sequence")
        if len(np.unique(idx)) != len(idx):
            raise ValueError(f"indices must be unique, got {idx.tolist()}")
        if (idx < 0).any():
            raise ValueError(f"indices must be non-negative, got {idx.tolist()}")
        return self._set(indices=idx)

    def getIndices(self) -> np.ndarray:
        return np.asarray(self.getOrDefault("indices"))

    def _slice(self, mat: np.ndarray) -> np.ndarray:
        idx = self.getIndices()
        if idx.max() >= mat.shape[1]:
            raise ValueError(f"index {int(idx.max())} out of bounds for {mat.shape[1]} features")
        return np.ascontiguousarray(mat[:, idx])

    def transform(self, dataset: Any) -> Any:
        if not self.isSet("indices"):
            raise ValueError("indices must be set before transform")
        with trace_range("vector slicer", self.device):
            return self._apply(dataset, self._slice)


@functools.lru_cache(maxsize=32)
def _dct_basis(n: int) -> torch.Tensor:
    """The f64 DCT-II basis of width ``n``, on the host (cast and moved per
    transform)."""
    return S.dct2_matrix(n)


class DCT(_Stage, Transformer):
    """Row-wise unitary Discrete Cosine Transform (Spark ``DCT``: DCT-II
    scaled to an orthonormal matrix; ``inverse=True`` applies DCT-III): one
    [n, n] basis matmul per batch on the device."""

    inverse = Param("inverse", "apply the inverse transform (DCT-III)", bool)

    def __init__(self, uid: str | None = None, device: str | torch.device = "cuda", **kwargs):
        super().__init__(uid, device=device, **kwargs)
        self._setDefault(inverse=False, outputCol="dct_features")

    def setInverse(self, value: bool) -> "DCT":
        return self._set(inverse=bool(value))

    def getInverse(self) -> bool:
        return self.getOrDefault("inverse")

    def _apply_dct(self, mat: np.ndarray) -> np.ndarray:
        basis = _dct_basis(mat.shape[1]).to(device=self.device, dtype=torch.float32)
        return self._on_device(mat, lambda x: S.dct2(x, basis, inverse=self.getInverse()))

    def transform(self, dataset: Any) -> Any:
        with trace_range("dct", self.device):
            return self._apply(dataset, self._apply_dct)


@functools.lru_cache(maxsize=64)
def _poly_plan(n: int, degree: int):
    """The monomial plan of PolynomialExpansion in Spark's exact output
    order, a copy of the JAX package's. Spark expands recursively, E(k, d)
    = E(k−1, d) ++ x_k·([1] ++ E(k, d−1)), giving (x, x·x, y, x·y, y·y) for
    (x, y) at degree 2; built iteratively here. Each term records its parent
    and the feature it multiplies in, so evaluation is one multiply per
    monomial, by degree wave. Returns (parents, features, degrees), int32
    [m], in the final order."""
    new_parts = [None] * (degree + 1)
    for d in range(1, degree + 1):
        parts_d = []
        running_prev = []  # E(k, d-1), extended as k advances
        for k in range(1, n + 1):
            feat = k - 1
            if d > 1:
                running_prev.extend(new_parts[d - 1][k - 1])
            part = [(frozenset([(feat, 1)]), feat)]
            for key, _ in running_prev:
                dd = dict(key)
                dd[feat] = dd.get(feat, 0) + 1
                part.append((frozenset(dd.items()), feat))
            parts_d.append(part)
        new_parts[d] = parts_d

    order = [t for part in new_parts[degree] for t in part]
    index = {key: i for i, (key, _) in enumerate(order)}
    m = len(order)
    parents = np.empty(m, dtype=np.int32)
    features = np.empty(m, dtype=np.int32)
    degrees = np.empty(m, dtype=np.int32)
    for i, (key, feat) in enumerate(order):
        dd = dict(key)
        degrees[i] = sum(dd.values())
        dd[feat] -= 1
        if dd[feat] == 0:
            del dd[feat]
        parents[i] = index[frozenset(dd.items())] if dd else -1
        features[i] = feat
    return parents, features, degrees


class PolynomialExpansion(_Stage, Transformer):
    """Polynomial feature expansion in Spark MLlib's output order (all
    monomials of degree 1..degree, no bias term), on the host as in the JAX
    package. Width C(n+d, d) − 1, capped at 100,000 terms."""

    degree = Param("degree", "maximum monomial degree (>= 1)", int)

    def __init__(self, uid: str | None = None, device: str | torch.device = "cuda", **kwargs):
        super().__init__(uid, device=device, **kwargs)
        self._setDefault(degree=2, outputCol="poly_features")

    def setDegree(self, value: int) -> "PolynomialExpansion":
        if value < 1:
            raise ValueError(f"degree must be >= 1, got {value}")
        return self._set(degree=int(value))

    def getDegree(self) -> int:
        return self.getOrDefault("degree")

    def _expand(self, mat: np.ndarray) -> np.ndarray:
        n = mat.shape[1]
        d = self.getDegree()
        m = math.comb(n + d, d) - 1
        if m > 100_000:
            raise ValueError(
                f"degree={d} on {n} features expands to {m} terms; "
                "cap is 100000 — lower the degree or select features first"
            )
        parents, features, degrees = _poly_plan(n, d)
        if not np.issubdtype(mat.dtype, np.floating):
            mat = mat.astype(np.float64)
        out = np.empty((mat.shape[0], len(parents)), dtype=mat.dtype)
        # a degree-t term's parent has degree t−1: d waves, not m steps
        for t in range(1, d + 1):
            idx = np.flatnonzero(degrees == t)
            if t == 1:
                out[:, idx] = mat[:, features[idx]]
            else:
                out[:, idx] = out[:, parents[idx]] * mat[:, features[idx]]
        return out

    def transform(self, dataset: Any) -> Any:
        with trace_range("polynomial expansion", self.device):
            return self._apply(dataset, self._expand)
