"""IsotonicRegression of the port: pyspark.ml's monotone 1-D regression.

Counterpart of ``spark_rapids_ml_tpu/models/isotonic.py``, with the same
params, defaults, setters and persistence: ``isotonic`` (True =
non-decreasing, False = antitonic), ``featureIndex`` and ``weightCol``;
the model holds Spark's stepwise (boundaries, predictions) pair and
predicts by linear interpolation between boundaries, clamped outside.

This estimator is host work by design, in the JAX package and here: the
fit is pool-adjacent-violators (PAV) on three 1-D numpy arrays after a
sort, whose data-dependent pool merging has no device form worth its
launches, and prediction is ``np.interp``. It takes no ``device`` and never
touches the card; it is not a CPU fallback of a device path.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from spark_rapids_ml_tpu_torch.models.base import Estimator, Model
from spark_rapids_ml_tpu_torch.models.params import (
    HasFeaturesCol,
    HasLabelCol,
    HasPredictionCol,
    Param,
)
from spark_rapids_ml_tpu_torch.telemetry import trace_range
from spark_rapids_ml_tpu_torch.utils import columnar


def _pav(y: np.ndarray, w: np.ndarray) -> np.ndarray:
    """Weighted L2 pool-adjacent-violators: the non-decreasing fit of y (a
    stack of merged blocks; a new point merges backward while it violates
    monotonicity). O(n) after the caller's sort."""
    means: list[float] = []
    weights: list[float] = []
    counts: list[int] = []
    for yi, wi in zip(y, w):
        m, ww, c = float(yi), float(wi), 1
        while means and means[-1] > m:
            pm, pw, pc = means.pop(), weights.pop(), counts.pop()
            total = pw + ww
            m = (pm * pw + m * ww) / total if total > 0 else m
            ww = total
            c += pc
        means.append(m)
        weights.append(ww)
        counts.append(c)
    return np.repeat(means, counts)


class _IsotonicParams(HasFeaturesCol, HasLabelCol, HasPredictionCol):
    isotonic = Param("isotonic", "True = non-decreasing (default), False = antitonic", bool)
    featureIndex = Param("featureIndex", "feature column index used as the predictor", int)
    weightCol = Param("weightCol", "optional instance-weight column", str)

    def __init__(self, uid: str | None = None, **kwargs):
        super().__init__(uid, **kwargs)
        self._setDefault(
            featuresCol="features", labelCol="label",
            predictionCol="prediction", isotonic=True, featureIndex=0,
        )

    def getIsotonic(self) -> bool:
        return self.getOrDefault("isotonic")

    def getFeatureIndex(self) -> int:
        return self.getOrDefault("featureIndex")


class IsotonicRegression(_IsotonicParams, Estimator):
    def setIsotonic(self, value: bool) -> "IsotonicRegression":
        return self._set(isotonic=bool(value))

    def setFeatureIndex(self, value: int) -> "IsotonicRegression":
        if value < 0:
            raise ValueError(f"featureIndex must be >= 0, got {value}")
        return self._set(featureIndex=value)

    def setWeightCol(self, value: str) -> "IsotonicRegression":
        return self._set(weightCol=value)

    def fit(self, dataset: Any, num_partitions: int | None = None):
        # num_partitions is accepted for Estimator-signature uniformity; PAV
        # is one host-side 1-D solve
        parts = columnar.labeled_partitions(
            dataset,
            self.getOrDefault("featuresCol"),
            self.getOrDefault("labelCol"),
            None,
            weight_col=self._paramMap.get("weightCol"),
        )
        fi = self.getFeatureIndex()
        xs = np.concatenate([p[0] for p in parts])
        if not 0 <= fi < xs.shape[1]:
            raise ValueError(f"featureIndex={fi} out of range for {xs.shape[1]} features")
        x = xs[:, fi].astype(np.float64)
        y = np.concatenate([p[1] for p in parts]).astype(np.float64)
        w = (
            np.concatenate([p[2] for p in parts]).astype(np.float64)
            if parts[0][2] is not None
            else np.ones(len(x))
        )
        with trace_range("isotonic pav"):
            # zero-weight points carry no information (sklearn drops them)
            live = w > 0
            x, y, w = x[live], y[live], w[live]
            order = np.argsort(x, kind="stable")
            xs_sorted, ys_sorted, ws_sorted = x[order], y[order], w[order]
            # pool duplicate x into one weighted point BEFORE PAV (the
            # isotonic optimum: sklearn's make_unique, SPARK-28727)
            uniq_x, first_idx = np.unique(xs_sorted, return_index=True)
            w_pool = np.add.reduceat(ws_sorted, first_idx)
            y_pool = np.add.reduceat(ws_sorted * ys_sorted, first_idx) / w_pool
            sign = 1.0 if self.getIsotonic() else -1.0
            preds = sign * _pav(sign * y_pool, w_pool)
        model = IsotonicRegressionModel(uid=self.uid, boundaries=uniq_x, predictions=preds)
        return self._copyValues(model)

    @classmethod
    def _fromSaved(cls, uid, data, device=None):
        return cls(uid=uid)


class IsotonicRegressionModel(_IsotonicParams, Model):
    def __init__(
        self,
        uid: str | None = None,
        boundaries: np.ndarray | None = None,
        predictions: np.ndarray | None = None,
    ):
        super().__init__(uid)
        self.boundaries = None if boundaries is None else np.asarray(boundaries)
        self.predictions = None if predictions is None else np.asarray(predictions)

    def _predict_values(self, v: np.ndarray) -> np.ndarray:
        """Spark's rule: linear interpolation between boundaries, clamped
        to the edge predictions outside the range."""
        return np.interp(v, self.boundaries, self.predictions)

    def _predict_matrix(self, mat: np.ndarray) -> np.ndarray:
        fi = self.getFeatureIndex()
        if not 0 <= fi < mat.shape[1]:
            raise ValueError(f"featureIndex={fi} out of range for {mat.shape[1]} features")
        return self._predict_values(mat[:, fi].astype(np.float64))

    def transform(self, dataset: Any) -> Any:
        return columnar.apply_column_transform(
            dataset,
            self.getOrDefault("featuresCol"),
            self.getOrDefault("predictionCol"),
            self._predict_matrix,
        )

    def predict(self, value: float) -> float:
        return float(self._predict_values(np.asarray([value]))[0])

    def _saveData(self) -> dict[str, np.ndarray]:
        return {"boundaries": self.boundaries, "predictions": self.predictions}

    @classmethod
    def _fromSaved(cls, uid, data, device=None):
        return cls(uid=uid, boundaries=data["boundaries"], predictions=data["predictions"])
