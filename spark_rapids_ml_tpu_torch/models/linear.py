"""LinearRegression, LogisticRegression and LinearSVC of the port, on the
card by default.

Counterpart of ``spark_rapids_ml_tpu/models/linear.py``: the same params,
defaults, setters and messages, plus a ``device`` argument (default
``"cuda"``). Each fit sums per-partition statistics (``ops/linear.py``)
and runs a small solve:

- ``LinearRegression``: one pass (normal equations; FISTA for
  ``elasticNetParam`` > 0). Resident, each partition's statistics come from
  ``run_partition_tasks`` and a ``tree_reduce``; above the streamed-fit
  cutover the labeled partitions drain through ``spark.ingest.stream_fold``
  into one f64 carry on the card (``linear.linear_fold_step``), with labels
  and weights staged beside the rows.
- ``LogisticRegression`` (binary, or multinomial softmax for more than two
  classes) and ``LinearSVC`` (squared hinge): Newton, one pass of
  statistics an iteration over partitions that stay on the card, with the
  JAX package's ``checkpoint_dir``/``checkpoint_every`` checkpoint and
  resume (``utils/checkpoint.py``: a checkpoint of either package resumes
  in the other).

Rows go to the card once as f32 (``utils.device``), the intercept column
made there. The JAX package pads each partition to a power-of-two row
bucket (one compiled program per bucket) and masks the pads with weight 0;
cuBLAS takes any row count and a weight-0 row adds nothing to a statistic,
so the port sends the true rows alone. The normal equations' summed
statistics and their solve, and the Newton parameters and solves, are f64
on the card; the products over the rows are f32 (see ``ops/linear.py``).
Models save and load in the JAX package's native layout
(``models/base.py``; host-side, needs pyarrow).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.models.base import Estimator, Model
from spark_rapids_ml_tpu_torch.models.params import (
    HasDevice,
    HasFeaturesCol,
    HasLabelCol,
    HasPredictionCol,
    Param,
)
from spark_rapids_ml_tpu_torch.ops import linear as LIN
from spark_rapids_ml_tpu_torch.parallel.executor import run_partition_tasks
from spark_rapids_ml_tpu_torch.parallel.tree_aggregate import tree_reduce
from spark_rapids_ml_tpu_torch.spark import ingest
from spark_rapids_ml_tpu_torch.telemetry import trace_range
from spark_rapids_ml_tpu_torch.utils import columnar
from spark_rapids_ml_tpu_torch.utils.device import to_device, to_device_augmented

# Full-Newton multinomial cap: the Hessian is [C·d, C·d] and its assembly
# takes C(C+1)/2 products.
_MAX_CLASSES = 64


class _SupervisedParams(HasDevice, HasFeaturesCol, HasLabelCol, HasPredictionCol):
    regParam = Param("regParam", "L2 regularization strength λ", float)
    fitIntercept = Param("fitIntercept", "whether to fit an intercept term", bool)
    weightCol = Param(
        "weightCol",
        "optional instance-weight column (Spark ML weightCol contract); "
        "weights ride the same per-row vector that masks shape-bucketing "
        "padding, so weighted fits cost nothing extra",
        str,
    )

    def __init__(self, uid: str | None = None, device: str | torch.device = "cuda",
                 **kwargs):
        super().__init__(uid, device=device, **kwargs)
        self._setDefault(
            featuresCol="features",
            labelCol="label",
            predictionCol="prediction",
            regParam=0.0,
            fitIntercept=True,
        )

    def setRegParam(self, value: float):
        return self._set(regParam=value)

    def setWeightCol(self, value: str):
        return self._set(weightCol=value)

    def setFitIntercept(self, value: bool):
        return self._set(fitIntercept=value)

    def getRegParam(self) -> float:
        return self.getOrDefault("regParam")

    def getFitIntercept(self) -> bool:
        return self.getOrDefault("fitIntercept")

    def _labeled(self, dataset: Any, num_partitions: int | None):
        return columnar.labeled_partitions(
            dataset,
            self.getOrDefault("featuresCol"),
            self.getOrDefault("labelCol"),
            num_partitions,
            weight_col=self._paramMap.get("weightCol"),
        )


class _GLMModel(_SupervisedParams, Model):
    """Shared fitted-model surface: ``coefficients`` [n] and ``intercept``
    on the host."""

    def __init__(
        self,
        uid: str | None = None,
        coefficients: np.ndarray | None = None,
        intercept: float = 0.0,
        device: str | torch.device = "cuda",
    ):
        super().__init__(uid, device=device)
        self.coefficients = None if coefficients is None else np.asarray(coefficients)
        self.intercept = float(intercept)

    def _predict_matrix(self, mat: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def _margins(self, mat: np.ndarray) -> torch.Tensor:
        """x·coefficients + intercept of host rows, on ``device``."""
        x = to_device(mat, self.device)
        coef = torch.as_tensor(self.coefficients, dtype=x.dtype, device=self.device)
        intercept = torch.tensor(self.intercept, dtype=x.dtype, device=self.device)
        return LIN.predict_linear(x, coef, intercept)

    def transform(self, dataset: Any) -> Any:
        return columnar.apply_column_transform(
            dataset,
            self.getOrDefault("featuresCol"),
            self.getOrDefault("predictionCol"),
            self._predict_matrix,
        )

    def _saveData(self) -> dict[str, np.ndarray]:
        return {
            "coefficients": self.coefficients,
            "intercept": np.asarray([self.intercept]),
        }

    @classmethod
    def _fromSaved(cls, uid, data, device: str | torch.device = "cuda"):
        return cls(
            uid=uid,
            coefficients=data["coefficients"],
            intercept=float(data["intercept"][0]),
            device=device,
        )


# ---------------------------------------------------------------------------
# Linear regression
# ---------------------------------------------------------------------------


class _ElasticNetParams:
    """elasticNetParam/maxIter/tol, shared by LinearRegression and its model
    (a fitted model carries and persists the solver params)."""

    elasticNetParam = Param(
        "elasticNetParam",
        "elastic-net mixing α in [0, 1]: 0 = pure L2 (closed form), "
        "1 = lasso; the L1 solve is FISTA over the reduced statistics",
        float,
    )
    maxIter = Param("maxIter", "maximum FISTA iterations (α > 0 only)", int)
    tol = Param(
        "tol",
        "FISTA convergence tolerance on the relative coefficient change",
        float,
    )

    def __init__(self, uid: str | None = None, **kwargs):
        super().__init__(uid, **kwargs)
        self._setDefault(elasticNetParam=0.0, maxIter=500, tol=1e-8)

    def setElasticNetParam(self, value: float):
        if not 0.0 <= value <= 1.0:
            raise ValueError(f"elasticNetParam must be in [0, 1], got {value}")
        return self._set(elasticNetParam=float(value))

    def getElasticNetParam(self) -> float:
        return self.getOrDefault("elasticNetParam")

    def setMaxIter(self, value: int):
        return self._set(maxIter=value)

    def getMaxIter(self) -> int:
        return self.getOrDefault("maxIter")

    def setTol(self, value: float):
        return self._set(tol=value)

    def getTol(self) -> float:
        return self.getOrDefault("tol")


def _labeled_on_device(part, device: torch.device):
    """(x, y, w or None) of one host partition on ``device``, f32."""
    x, y, sw = part
    return (
        to_device(x, device),
        to_device(np.asarray(y), device),
        None if sw is None else to_device(sw, device),
    )


class LinearRegression(_ElasticNetParams, _SupervisedParams, Estimator):
    """Least squares with optional L2 / L1 / elastic-net regularization.

    One pass builds the (XᵀX, Xᵀy, …) monoid; the [n, n] solve runs once on
    the reduced statistics. ``elasticNetParam=0`` (default) is the closed
    form, λ scaled by the row count (``sklearn.linear_model.Ridge(
    alpha=regParam·rows)``); ``elasticNetParam=α>0`` is FISTA on the same
    statistics (``sklearn.linear_model.ElasticNet(alpha=regParam,
    l1_ratio=α)``). A streamed fit's model keeps the fold's ``StreamFold``
    record (without the carry) as ``stream_report``.
    """

    def _solve_args(self) -> dict:
        return dict(
            reg_param=self.getRegParam(),
            elastic_net_param=self.getElasticNetParam(),
            fit_intercept=self.getFitIntercept(),
            max_iter=self.getMaxIter(),
            tol=self.getTol(),
        )

    def fit(self, dataset: Any, num_partitions: int | None = None) -> "LinearRegressionModel":
        parts = self._labeled(dataset, num_partitions)
        device = self.device
        report = None
        with trace_range("linreg stats", device):
            rows = sum(len(p[0]) for p in parts)
            n = parts[0][0].shape[1] if parts else 0
            if parts and ingest.use_streamed_fit(rows, n):
                # out of core: the labeled partitions drain through the
                # in-place f64 carry at O(chunk + n²) device memory
                report = ingest.stream_fold(
                    iter(parts),
                    LIN.linear_fold_step(),
                    n=n,
                    label_col="y",
                    init=LIN.init_linear_carry(n, device),
                    device=device,
                )
                stats = report.carry
            else:
                def task(part):
                    return LIN.as_f64(LIN.linear_stats(*_labeled_on_device(part, device)))

                stats = tree_reduce(run_partition_tasks(task, parts), LIN.combine_linear_stats)
        with trace_range("linreg solve", device):
            coef, intercept = LIN.solve_from_stats(stats, **self._solve_args())
        model = LinearRegressionModel(
            uid=self.uid,
            coefficients=coef.cpu().numpy(),
            intercept=float(intercept),
            device=device,
        )
        if report is not None:
            model.stream_report = dataclasses.replace(report, carry=None)
        return self._copyValues(model)


class LinearRegressionModel(_ElasticNetParams, _GLMModel):
    stream_report: ingest.StreamFold | None = None

    def _predict_matrix(self, mat: np.ndarray) -> np.ndarray:
        return self._margins(mat).cpu().numpy()

    def predict(self, row) -> float:
        return float(np.dot(self.coefficients, np.asarray(row)) + self.intercept)


# ---------------------------------------------------------------------------
# Newton fits
# ---------------------------------------------------------------------------


def _device_parts(parts, fit_intercept: bool, device: torch.device, label_dtype=None):
    """Each labeled partition on ``device`` once, for every Newton
    iteration: (rows with the intercept column made on the card, labels,
    weights or None). Counterpart of the JAX package's ``_pad_parts``,
    without the padding (see the module note)."""
    out = []
    for x, y, sw in parts:
        xd = to_device_augmented(x, device) if fit_intercept else to_device(x, device)
        yd = to_device(np.asarray(y), device)
        if label_dtype is not None:
            yd = yd.to(label_dtype)
        out.append((xd, yd, None if sw is None else to_device(sw, device)))
    return out


def _resume_newton_checkpoint(checkpoint_dir: str | None, n_params: int):
    """(initial w, start iteration, checkpointer or None) of a Newton loop,
    resumed from the newest durable checkpoint when there is one."""
    w = np.zeros(n_params)
    if checkpoint_dir is None:
        return w, 0, None
    from spark_rapids_ml_tpu_torch.utils.checkpoint import TrainingCheckpointer

    ckpt = TrainingCheckpointer(checkpoint_dir)
    resumed = ckpt.latest()
    if resumed is None:
        return w, 0, ckpt
    step, arrays, _ = resumed
    if arrays["w"].shape[0] != n_params:
        raise ValueError(
            f"checkpoint at {checkpoint_dir} holds {arrays['w'].shape[0]} "
            f"parameters but this fit has {n_params}; is checkpoint_dir stale?"
        )
    return arrays["w"], step + 1, ckpt


def _newton_loop(est, parts, stats_fn, combine, update_fn, n_params: int, *,
                 trace_label: str, checkpoint_dir: str | None,
                 checkpoint_every: int) -> np.ndarray:
    """The Newton loop of the binary and softmax fits, merged on the host: each
    iteration every partition's f32 statistics at the current f64
    parameters, tree-reduced, then ``update_fn(w, stats) -> (w, step)``,
    which solves in f64. Returns the final parameters on the host (f64)."""
    device = est.device
    w_host, start_iter, ckpt = _resume_newton_checkpoint(checkpoint_dir, n_params)
    w = torch.as_tensor(np.asarray(w_host, dtype=np.float64), device=device)
    with trace_range(trace_label, device):
        for it in range(start_iter, est.getMaxIter()):
            partials = [stats_fn(x, y, w, sw) for x, y, sw in parts]
            stats = tree_reduce(partials, combine)
            w, step_norm = update_fn(w, stats)
            if _newton_step_bookkeeping(
                w, step_norm, tol=est.getTol(), ckpt=ckpt, it=it,
                checkpoint_every=checkpoint_every, loss=float(stats.loss),
            ):
                break
    return w.cpu().numpy()


def _binary_newton_fit(
    est,
    parts,
    stats_fn,
    *,
    elastic_net_param: float,
    trace_label: str,
    checkpoint_dir: str | None,
    checkpoint_every: int,
) -> tuple[np.ndarray, float]:
    """The binary Newton fit shared by the logistic and squared-hinge
    (LinearSVC) losses, which differ only in ``stats_fn``. Returns
    (coefficients, intercept) split by the estimator's fitIntercept."""
    fit_intercept = est.getFitIntercept()

    def update(w, stats):
        return LIN.newton_update(
            w, stats, reg_param=est.getRegParam(),
            elastic_net_param=elastic_net_param, fit_intercept=fit_intercept,
        )

    w_full = _newton_loop(
        est, parts, stats_fn, LIN.combine_newton_stats, update, parts[0][0].shape[1],
        trace_label=trace_label, checkpoint_dir=checkpoint_dir,
        checkpoint_every=checkpoint_every,
    )
    if fit_intercept:
        return w_full[:-1], float(w_full[-1])
    return w_full, 0.0


def _newton_step_bookkeeping(w, step_norm, *, tol, ckpt, it, checkpoint_every, loss) -> bool:
    """The tail of a Newton iteration: the stop test, the non-finite-data
    raise before any save (a junk checkpoint must not outlive the raise),
    then the checkpoint every ``checkpoint_every`` iterations. True when
    the loop should stop."""
    step = float(step_norm)
    stop = not step > tol
    if stop:
        LIN.check_newton_outcome(step, w)
    if ckpt is not None and (it + 1) % checkpoint_every == 0:
        ckpt.save(it, {"w": w.cpu().numpy()}, {"loss": loss})
    return stop


def _check_checkpoint_every(checkpoint_every: int) -> None:
    if checkpoint_every < 1:
        raise ValueError(f"checkpoint_every must be >= 1, got {checkpoint_every}")


class _HasProbabilityCol:
    """probabilityCol, shared by LogisticRegression and its model. Default
    '' = don't emit; setProbabilityCol('probability') gives pyspark.ml's
    surface."""

    probabilityCol = Param(
        "probabilityCol",
        "optional output column for the per-class probability vector "
        "([1-p, p] for binary, the softmax row for multinomial); '' = "
        "don't emit",
        str,
    )

    def __init__(self, uid: str | None = None, **kwargs):
        super().__init__(uid, **kwargs)
        self._setDefault(probabilityCol="")

    def setProbabilityCol(self, value: str):
        return self._set(probabilityCol=value)

    def getProbabilityCol(self) -> str:
        return self.getOrDefault("probabilityCol")


class LogisticRegression(_HasProbabilityCol, _SupervisedParams, Estimator):
    """Logistic regression by IRLS/Newton, binary or multinomial (softmax,
    full Newton, for labels 0..C−1 with C > 2), optionally elastic-net
    (proximal Newton: FISTA on the local quadratic model). Each iteration is
    one pass of statistics and an f64 solve on the card; convergence on the
    Newton step norm. ``checkpoint_dir``/``checkpoint_every`` as KMeans.
    """

    maxIter = Param("maxIter", "maximum Newton iterations", int)
    tol = Param("tol", "convergence tolerance on the Newton step norm", float)
    elasticNetParam = Param(
        "elasticNetParam",
        "elastic-net mixing α in [0, 1]: 0 = pure L2 IRLS (closed-form "
        "step), >0 = proximal-Newton with L1 soft-thresholding",
        float,
    )

    def __init__(self, uid: str | None = None, **kwargs):
        super().__init__(uid, **kwargs)
        self._setDefault(maxIter=25, tol=1e-6, elasticNetParam=0.0)

    def setMaxIter(self, value: int):
        return self._set(maxIter=value)

    def setTol(self, value: float):
        return self._set(tol=value)

    def getMaxIter(self) -> int:
        return self.getOrDefault("maxIter")

    def getTol(self) -> float:
        return self.getOrDefault("tol")

    def setElasticNetParam(self, value: float):
        if not 0.0 <= value <= 1.0:
            raise ValueError(f"elasticNetParam must be in [0, 1], got {value}")
        return self._set(elasticNetParam=float(value))

    def getElasticNetParam(self) -> float:
        return self.getOrDefault("elasticNetParam")

    def fit(
        self,
        dataset: Any,
        num_partitions: int | None = None,
        *,
        checkpoint_dir: str | None = None,
        checkpoint_every: int = 5,
    ) -> "LogisticRegressionModel":
        _check_checkpoint_every(checkpoint_every)
        parts = self._labeled(dataset, num_partitions)
        fit_intercept = self.getFitIntercept()

        all_labels = np.unique(np.concatenate([np.unique(y) for _, y, _ in parts]))
        if not np.all(all_labels == np.round(all_labels)) or all_labels.min() < 0:
            raise ValueError(
                "logistic regression requires integer class labels "
                f"0..C-1, got {all_labels[:8]}"
            )
        n_classes = int(all_labels.max()) + 1
        if n_classes > _MAX_CLASSES:
            raise ValueError(
                f"labels imply {n_classes} classes (max label "
                f"{int(all_labels.max())}), over the supported cap of "
                f"{_MAX_CLASSES} — the full-Newton Hessian is [C·d, C·d]. "
                "Check for mislabeled/ID-like rows, or re-encode labels "
                "densely as 0..C-1"
            )
        if n_classes > 2:
            return self._fit_multinomial(
                parts, n_classes, fit_intercept,
                checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
            )
        coef, intercept = _binary_newton_fit(
            self,
            _device_parts(parts, fit_intercept, self.device),
            LIN.logistic_newton_stats,
            elastic_net_param=self.getElasticNetParam(),
            trace_label="logreg newton",
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every,
        )
        model = LogisticRegressionModel(
            uid=self.uid, coefficients=coef, intercept=intercept, device=self.device
        )
        return self._copyValues(model)

    def _fit_multinomial(
        self, parts, n_classes: int, fit_intercept: bool, *,
        checkpoint_dir: str | None, checkpoint_every: int,
    ) -> "LogisticRegressionModel":
        """Softmax IRLS: full Newton on the flattened [C·d] parameter, one
        pass of ``SoftmaxStats`` (C(C+1)/2 block products) an iteration and
        an f64 [C·d, C·d] solve on the card."""
        device_parts = _device_parts(parts, fit_intercept, self.device, label_dtype=torch.int64)
        d = device_parts[0][0].shape[1]

        def stats_fn(x, y, w, sw):
            return LIN.softmax_newton_stats(x, y, w, n_classes, sw)

        def update(w, stats):
            return LIN.softmax_newton_update(
                w, stats, n_classes, reg_param=self.getRegParam(),
                elastic_net_param=self.getElasticNetParam(), fit_intercept=fit_intercept,
            )

        w_flat = _newton_loop(
            self, device_parts, stats_fn, LIN.combine_softmax_stats, update, n_classes * d,
            trace_label="softmax newton", checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every,
        )
        w_mat = w_flat.reshape(n_classes, d)
        if fit_intercept:
            coef_matrix, intercepts = w_mat[:, :-1], w_mat[:, -1]
        else:
            coef_matrix, intercepts = w_mat, np.zeros(n_classes)
        model = LogisticRegressionModel(
            uid=self.uid, coefficientMatrix=coef_matrix, interceptVector=intercepts,
            device=self.device,
        )
        return self._copyValues(model)


class LogisticRegressionModel(_HasProbabilityCol, _GLMModel):
    """Binary or multinomial fitted model. Binary: ``coefficients`` [n] and
    ``intercept`` (``predict_proba_matrix`` gives [rows] P(y=1)).
    Multinomial: ``coefficientMatrix`` [C, n] and ``interceptVector`` [C]
    (``predict_proba_matrix`` gives [rows, C]); transform emits the argmax
    class."""

    def __init__(
        self,
        uid: str | None = None,
        coefficients: np.ndarray | None = None,
        intercept: float = 0.0,
        coefficientMatrix: np.ndarray | None = None,
        interceptVector: np.ndarray | None = None,
        device: str | torch.device = "cuda",
    ):
        super().__init__(uid, coefficients=coefficients, intercept=intercept, device=device)
        self.coefficientMatrix = (
            None if coefficientMatrix is None else np.asarray(coefficientMatrix)
        )
        self.interceptVector = None if interceptVector is None else np.asarray(interceptVector)

    @property
    def numClasses(self) -> int:
        if self.coefficientMatrix is not None:
            return self.coefficientMatrix.shape[0]
        return 2

    def transform(self, dataset: Any) -> Any:
        proba_col = self.getProbabilityCol()
        if proba_col and columnar.has_named_columns(dataset):
            # both output columns from one forward pass on containers with
            # named columns; matrices keep the prediction-only contract
            mat = columnar.extract_matrix(dataset, self.getOrDefault("featuresCol"))
            vecs, preds = self.proba_and_predictions(mat)
            return columnar.append_columns(
                dataset, [(proba_col, vecs), (self.getOrDefault("predictionCol"), preds)]
            )
        return super().transform(dataset)

    def proba_and_predictions(self, mat: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """One forward pass → ([rows, C] probability vectors, [rows]
        predictions): binary stacks [1−p, p] and thresholds at 0.5
        inclusive; multinomial takes the argmax of the softmax row."""
        proba = self.predict_proba_matrix(mat)
        if proba.ndim == 1:
            preds = (proba >= 0.5).astype(np.float64)
            return np.stack([1.0 - proba, proba], axis=1), preds
        return proba, np.argmax(proba, axis=1).astype(np.float64)

    def predict_proba_matrix(self, mat: np.ndarray) -> np.ndarray:
        if self.coefficientMatrix is not None:
            x = to_device(mat, self.device)
            out = LIN.predict_softmax_proba(
                x,
                torch.as_tensor(self.coefficientMatrix, dtype=x.dtype, device=self.device),
                torch.as_tensor(self.interceptVector, dtype=x.dtype, device=self.device),
            )
            return out.cpu().numpy()
        return torch.sigmoid(self._margins(mat)).cpu().numpy()

    def _predict_matrix(self, mat: np.ndarray) -> np.ndarray:
        proba = self.predict_proba_matrix(mat)
        if proba.ndim == 2:
            return np.argmax(proba, axis=1).astype(np.float64)
        return (proba >= 0.5).astype(np.float64)

    def predict(self, row) -> float:
        if self.coefficientMatrix is not None:
            z = self.coefficientMatrix @ np.asarray(row) + self.interceptVector
            return float(np.argmax(z))
        z = float(np.dot(self.coefficients, np.asarray(row)) + self.intercept)
        return 1.0 if z >= 0.0 else 0.0

    def _saveData(self) -> dict[str, np.ndarray]:
        if self.coefficientMatrix is not None:
            return {
                "coefficientMatrix": self.coefficientMatrix,
                "interceptVector": self.interceptVector,
            }
        return super()._saveData()

    @classmethod
    def _fromSaved(cls, uid, data, device: str | torch.device = "cuda"):
        if "coefficientMatrix" in data:
            return cls(
                uid=uid,
                coefficientMatrix=data["coefficientMatrix"],
                interceptVector=data["interceptVector"],
                device=device,
            )
        return super()._fromSaved(uid, data, device)


# ---------------------------------------------------------------------------
# Linear SVC (squared-hinge L2 SVM)
# ---------------------------------------------------------------------------


class LinearSVC(_SupervisedParams, Estimator):
    """Linear support-vector classifier on the squared-hinge loss (cuML's
    and sklearn's default; smooth, so the logistic Newton machinery fits it
    in a handful of passes). L2 only, like Spark's LinearSVC."""

    maxIter = Param("maxIter", "maximum Newton iterations", int)
    tol = Param("tol", "convergence tolerance on the Newton step norm", float)
    threshold = Param(
        "threshold",
        "decision threshold on the rawPrediction margin (Spark LinearSVC "
        "contract: predict 1.0 when wᵀx + b > threshold)",
        float,
    )
    rawPredictionCol = Param(
        "rawPredictionCol", "margin output column ([−m, m], Spark shape)", str
    )

    def __init__(self, uid: str | None = None, **kwargs):
        super().__init__(uid, **kwargs)
        self._setDefault(
            maxIter=100, tol=1e-6, threshold=0.0,
            rawPredictionCol="rawPrediction", regParam=0.0,
        )

    def setMaxIter(self, value: int):
        return self._set(maxIter=value)

    def setTol(self, value: float):
        return self._set(tol=value)

    def setThreshold(self, value: float):
        return self._set(threshold=float(value))

    def setRawPredictionCol(self, value: str):
        return self._set(rawPredictionCol=value)

    def getMaxIter(self) -> int:
        return self.getOrDefault("maxIter")

    def getTol(self) -> float:
        return self.getOrDefault("tol")

    def getThreshold(self) -> float:
        return self.getOrDefault("threshold")

    def fit(
        self,
        dataset: Any,
        num_partitions: int | None = None,
        *,
        checkpoint_dir: str | None = None,
        checkpoint_every: int = 5,
    ) -> "LinearSVCModel":
        _check_checkpoint_every(checkpoint_every)
        parts = self._labeled(dataset, num_partitions)
        fit_intercept = self.getFitIntercept()
        labels = np.unique(np.concatenate([np.unique(y) for _, y, _ in parts]))
        if not np.all(np.isin(labels, (0.0, 1.0))):
            raise ValueError(f"LinearSVC requires binary 0/1 labels, got {labels[:8]}")
        coef, intercept = _binary_newton_fit(
            self,
            _device_parts(parts, fit_intercept, self.device),
            LIN.svc_newton_stats,
            elastic_net_param=0.0,  # Spark LinearSVC: L2 only
            trace_label="svc newton",
            checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every,
        )
        model = LinearSVCModel(
            uid=self.uid, coefficients=coef, intercept=intercept, device=self.device
        )
        return self._copyValues(model)


class LinearSVCModel(_GLMModel):
    """Fitted linear SVC: margin m = wᵀx + b; rawPrediction [−m, m];
    prediction 1.0 when m > threshold (Spark LinearSVCModel's shape)."""

    threshold = LinearSVC.threshold
    rawPredictionCol = LinearSVC.rawPredictionCol

    def __init__(self, uid=None, coefficients=None, intercept: float = 0.0,
                 device: str | torch.device = "cuda"):
        super().__init__(uid, coefficients=coefficients, intercept=intercept, device=device)
        self._setDefault(threshold=0.0, rawPredictionCol="rawPrediction")

    def getThreshold(self) -> float:
        return self.getOrDefault("threshold")

    def setThreshold(self, value: float):
        return self._set(threshold=float(value))

    def margins(self, mat: np.ndarray) -> np.ndarray:
        return self._margins(mat).cpu().numpy()

    def _predict_matrix(self, mat: np.ndarray) -> np.ndarray:
        return (self.margins(mat) > self.getThreshold()).astype(np.float64)

    def transform(self, dataset: Any) -> Any:
        raw_col = self.getOrDefault("rawPredictionCol")
        if raw_col and columnar.has_named_columns(dataset):
            mat = columnar.extract_matrix(dataset, self.getOrDefault("featuresCol"))
            m = self.margins(mat)
            preds = (m > self.getThreshold()).astype(np.float64)
            return columnar.append_columns(
                dataset,
                [(raw_col, np.stack([-m, m], axis=1)),
                 (self.getOrDefault("predictionCol"), preds)],
            )
        return super().transform(dataset)
