"""Model selection of the port: param grids, evaluators, cross-validation.

Counterpart of ``spark_rapids_ml_tpu/models/tuning.py`` (``pyspark.ml``'s
``tuning`` and ``evaluation``): ``ParamGridBuilder``; the Regression,
BinaryClassification (the weighted Mann–Whitney AUC over tied-score
groups, and the PR curve), MulticlassClassification and Clustering
(silhouette, subsampled above ``maxRows``) evaluators, numpy on the host
as in the JAX package; ``CrossValidator`` (folds from
``np.random.default_rng(seed).permutation``) and ``TrainValidationSplit``,
whose models hand ``transform`` to the best model. AUC, the PR area and
logLoss rank the model's probability surface where it has one
(``predict_proba_matrix``), as Spark's evaluator reads rawPrediction.

The candidate fits are the port's estimators, so they run where those run:
on the card by default. The datasets are those the estimators take: an
``(X, y)``/``(X, y, w)`` tuple, a matrix, an Arrow table, a
``PartitionedDataset`` (collected once per fit), or a container of the
column protocol (``utils/columnar.py``), or a Spark DataFrame: pyspark's or
the port's ``localspark`` one. Over a DataFrame the folds are one
``randomSplit`` (each fold's train set the union of the others, cached),
the candidates are the estimator's own DataFrame fits (the ``Spark*``
estimators of ``spark/estimators.py``), and every evaluator reads its
columns in one job (``_df_columns``), so labels, scores and weights come
from the same plan execution. A DataFrame of the JAX package's
``localspark`` is refused: its workers would run the JAX package.
"""

from __future__ import annotations

import functools
import warnings
from typing import Any

import numpy as np

from spark_rapids_ml_tpu_torch.models.base import Estimator, Model
from spark_rapids_ml_tpu_torch.models.params import (
    HasLabelCol,
    HasPredictionCol,
    Param,
    Params,
)
from spark_rapids_ml_tpu_torch.utils import columnar

pa = columnar.pa


def _is_spark_df(dataset: Any) -> bool:
    """True for a pyspark DataFrame or one of the port's ``localspark``;
    raises for one of the JAX package's ``localspark``."""
    mod = type(dataset).__module__ or ""
    if mod.startswith("spark_rapids_ml_tpu.localspark"):
        raise TypeError(
            f"a DataFrame of the JAX package's localspark ({type(dataset).__name__}) "
            "would run the JAX package in its workers: build it with "
            "spark_rapids_ml_tpu_torch.localspark, or collect the rows into an (X, y) "
            "tuple, a matrix, an Arrow table or a frame of named columns"
        )
    return columnar.is_spark_dataframe(dataset)


def _df_columns(df, *cols: str) -> list[np.ndarray]:
    """The named DataFrame columns collected in one job (one collect per
    column would run the plan again each time and rely on the row order
    holding across jobs): scalar columns as [rows] f64 vectors, array
    columns as [rows, n] matrices."""
    selected = df.select(*cols)
    if hasattr(selected, "toArrow"):
        table = selected.toArrow()
        out = []
        for c in cols:
            col = table.column(c)
            if pa.types.is_floating(col.type) or pa.types.is_integer(col.type):
                out.append(np.asarray(col.to_numpy(zero_copy_only=False), dtype=np.float64))
            else:
                out.append(columnar.extract_matrix(table, c))
        return out
    rows = selected.collect()
    out = []
    for i, _ in enumerate(cols):
        vals = [r[i] for r in rows]
        if vals and (np.isscalar(vals[0]) or isinstance(vals[0], (int, float))):
            out.append(np.asarray(vals, dtype=np.float64))
        else:
            out.append(np.stack([columnar.row_vector_to_ndarray(v) for v in vals]))
    return out


def _column_names(dataset) -> list[str]:
    """Column names of any supported container ([] when nameless)."""
    schema = getattr(dataset, "schema", None)
    if schema is not None and hasattr(schema, "names"):
        return list(schema.names)  # arrow tables and batches
    cols = getattr(dataset, "columns", None)  # the column protocol
    return list(cols) if cols is not None else []


def n_rows(dataset: Any) -> int:
    if _is_spark_df(dataset):
        return dataset.count()
    if isinstance(dataset, tuple) and len(dataset) in (2, 3):
        return len(np.asarray(dataset[0]))
    if pa is not None and isinstance(dataset, (pa.Table, pa.RecordBatch)):
        return dataset.num_rows
    if isinstance(dataset, columnar.PartitionedDataset):
        return sum(m.shape[0] for m in dataset.matrices())
    if hasattr(dataset, "iloc"):
        return len(dataset)
    arr = np.asarray(dataset)
    if arr.ndim == 0:
        raise TypeError(
            f"unsupported dataset container for row splitting: {type(dataset).__name__}"
        )
    return len(arr)


def row_slice(dataset: Any, idx: np.ndarray) -> Any:
    """Take rows by integer index, keeping the container type.
    ``PartitionedDataset`` callers collect once (``_collect_for_split``)
    before slicing again and again."""
    idx = np.asarray(idx)
    if isinstance(dataset, tuple) and len(dataset) in (2, 3):
        # (X, y), weighted (X, y, w), or unweighted (X, y, None)
        return tuple(None if part is None else np.asarray(part)[idx] for part in dataset)
    if pa is not None and isinstance(dataset, (pa.Table, pa.RecordBatch)):
        return dataset.take(pa.array(idx))
    if isinstance(dataset, columnar.PartitionedDataset):
        return columnar.PartitionedDataset([dataset.collect_matrix()[idx]], dataset.input_col)
    if hasattr(dataset, "iloc"):
        return dataset.iloc[idx]
    arr = np.asarray(dataset)
    if arr.ndim == 0:
        raise TypeError(
            f"unsupported dataset container for row splitting: {type(dataset).__name__}"
        )
    return arr[idx]


def _collect_for_split(dataset: Any) -> Any:
    """A ``PartitionedDataset`` collected to one matrix, once per fit (k-fold
    CV slices it 2k times); the candidates split it again through
    ``num_partitions`` if they want."""
    if isinstance(dataset, columnar.PartitionedDataset):
        return dataset.collect_matrix()
    return dataset


def _labels_of(dataset: Any, label_col: str) -> np.ndarray:
    if isinstance(dataset, tuple) and len(dataset) in (2, 3):
        return np.asarray(dataset[1], dtype=np.float64)
    if _is_spark_df(dataset):
        return _df_columns(dataset, label_col)[0]
    return columnar.extract_vector(dataset, label_col)


# ---------------------------------------------------------------------------
# Param grid
# ---------------------------------------------------------------------------


class ParamGridBuilder:
    """Cartesian-product grids of param settings.

    >>> grid = (ParamGridBuilder()
    ...         .addGrid("regParam", [0.0, 0.1])
    ...         .addGrid("fitIntercept", [True, False])
    ...         .build())
    """

    def __init__(self):
        self._grid: dict[str, list] = {}
        self._base: dict[str, Any] = {}

    def addGrid(self, param: "Param | str", values) -> "ParamGridBuilder":
        name = param.name if isinstance(param, Param) else param
        self._grid[name] = list(values)
        return self

    def baseOn(self, **kwargs) -> "ParamGridBuilder":
        self._base.update(kwargs)
        return self

    def build(self) -> list[dict[str, Any]]:
        maps = [dict(self._base)]
        for name, values in self._grid.items():
            maps = [{**m, name: v} for m in maps for v in values]
        return maps


# ---------------------------------------------------------------------------
# Evaluators
# ---------------------------------------------------------------------------


class Evaluator(Params):
    """Base evaluator. ``weightCol`` (Spark 3.0+ evaluator surface) weights
    every metric by per-instance weights when set: ``(X, y, w)`` tuples use
    their third slot, other containers extract the column by name. Empty
    (default) = unweighted."""

    weightCol = Param(
        "weightCol", "instance-weight column ('' = unweighted)", str
    )

    def __init__(self, uid: str | None = None, **kwargs):
        super().__init__(uid, **kwargs)
        self._setDefault(weightCol="")

    def setWeightCol(self, value: str):
        return self._set(weightCol=value)

    def evaluate(self, dataset: Any, predictions: np.ndarray | None = None) -> float:
        raise NotImplementedError

    def isLargerBetter(self) -> bool:
        return True

    def _labeled_pair(self, dataset, predictions):
        """(labels, predictions, weights-or-None) host vectors."""
        label_col = self.getOrDefault("labelCol")
        pred_col = self.getOrDefault("predictionCol")
        weight_col = self.getOrDefault("weightCol")
        if predictions is not None:
            y = _labels_of(dataset, label_col)
            p = np.asarray(predictions, dtype=np.float64).reshape(-1)
            return y, p, self._weights_of(dataset, len(y))
        if _is_spark_df(dataset):
            cols = [label_col, pred_col] + ([weight_col] if weight_col else [])
            got = _df_columns(dataset, *cols)  # one job, weights included
            w = columnar.validate_weights(got[2], len(got[0])) if weight_col else None
            return got[0], got[1], w
        y = _labels_of(dataset, label_col)
        return (
            y,
            columnar.extract_vector(dataset, pred_col),
            self._weights_of(dataset, len(y)),
        )

    def _weights_of(self, dataset, n: int) -> np.ndarray | None:
        """[n] validated instance weights when ``weightCol`` is set, else
        None. Tuple containers use their third slot (the framework's
        ``(X, y, w)`` convention) regardless of the column name."""
        weight_col = self.getOrDefault("weightCol")
        if not weight_col:
            return None
        if isinstance(dataset, tuple):
            if len(dataset) < 3 or dataset[2] is None:
                raise ValueError(
                    f"weightCol={weight_col!r} is set but the (X, y) tuple "
                    "carries no weight slot; pass (X, y, w)"
                )
            w = np.asarray(dataset[2], dtype=np.float64)
        elif _is_spark_df(dataset):
            w = _df_columns(dataset, weight_col)[0]
        else:
            w = columnar.extract_vector(dataset, weight_col)
        return columnar.validate_weights(w, n)


class RegressionEvaluator(Evaluator, HasLabelCol, HasPredictionCol):
    """rmse (default) / mse / mae / r2 on (labelCol, predictionCol)."""

    metricName = Param("metricName", "rmse|mse|mae|r2|var", str)

    def __init__(self, uid: str | None = None, **kwargs):
        super().__init__(uid, **kwargs)
        self._setDefault(metricName="rmse", labelCol="label", predictionCol="prediction")

    def setMetricName(self, value: str) -> "RegressionEvaluator":
        if value not in ("rmse", "mse", "mae", "r2", "var"):
            raise ValueError("metricName must be rmse, mse, mae, r2, or var")
        return self._set(metricName=value)

    def isLargerBetter(self) -> bool:
        return self.getOrDefault("metricName") in ("r2", "var")

    def evaluate(self, dataset, predictions=None) -> float:
        y, p, w = self._labeled_pair(dataset, predictions)
        if w is None:
            w = np.ones_like(y)
        wsum = w.sum()
        err = y - p
        metric = self.getOrDefault("metricName")
        if metric == "mse":
            return float(np.sum(w * err**2) / wsum)
        if metric == "rmse":
            return float(np.sqrt(np.sum(w * err**2) / wsum))
        if metric == "mae":
            return float(np.sum(w * np.abs(err)) / wsum)
        ybar = float(np.sum(w * y) / wsum)
        if metric == "var":
            # Spark's explainedVariance: mean (pred - label-mean)^2
            return float(np.sum(w * (p - ybar) ** 2) / wsum)
        ss_tot = float(np.sum(w * (y - ybar) ** 2))
        return 1.0 - float(np.sum(w * err**2)) / (ss_tot if ss_tot > 0 else 1.0)


def _tied_group_weights(
    p: np.ndarray, w: np.ndarray, pos_mask: np.ndarray, *, descending: bool
) -> tuple[np.ndarray, np.ndarray]:
    """Per-tied-score-group (positive-weight, negative-weight) sums in
    score order — the ONE sort/group/accumulate kernel both binary curve
    metrics (ROC's Mann–Whitney, PR's threshold sweep) share, so tie and
    weight handling can never diverge between them."""
    key = -p if descending else p
    order = np.argsort(key, kind="mergesort")
    ks, ws, pm = key[order], w[order], pos_mask[order]
    _, group = np.unique(ks, return_inverse=True)
    n_groups = group.max() + 1
    g_pos = np.zeros(n_groups)
    g_neg = np.zeros(n_groups)
    np.add.at(g_pos, group, np.where(pm, ws, 0.0))
    np.add.at(g_neg, group, np.where(~pm, ws, 0.0))
    return g_pos, g_neg


class BinaryClassificationEvaluator(Evaluator, HasLabelCol, HasPredictionCol):
    """areaUnderROC (default, rank statistic over scores), areaUnderPR
    (trapezoid over the per-threshold precision/recall curve), or accuracy.

    For areaUnderROC, scores come from ``rawPredictionCol`` when the
    dataset carries it — a probability or raw-margin VECTOR column (the
    pyspark.ml convention; the last element is the positive-class score —
    so a LogisticRegression ``probabilityCol`` output plugs in directly)
    or a scalar score column. AUC is a rank statistic, invariant to any
    monotone transform, so margins and probabilities score identically.
    Falls back to ``predictionCol`` when absent (hard labels give the
    degenerate two-level AUC). ``accuracy`` always uses ``predictionCol``.
    """

    metricName = Param(
        "metricName", "areaUnderROC|areaUnderPR|accuracy", str
    )
    rawPredictionCol = Param(
        "rawPredictionCol",
        "score column for areaUnderROC: vector (last element used) or "
        "scalar; falls back to predictionCol when the column is absent",
        str,
    )

    def __init__(self, uid: str | None = None, **kwargs):
        super().__init__(uid, **kwargs)
        self._setDefault(
            metricName="areaUnderROC", labelCol="label",
            predictionCol="prediction", rawPredictionCol="rawPrediction",
        )

    def setMetricName(self, value: str) -> "BinaryClassificationEvaluator":
        if value not in ("areaUnderROC", "areaUnderPR", "accuracy"):
            raise ValueError(
                "metricName must be areaUnderROC, areaUnderPR, or accuracy"
            )
        return self._set(metricName=value)

    def setRawPredictionCol(self, value: str) -> "BinaryClassificationEvaluator":
        return self._set(rawPredictionCol=value)

    def _score_pair(self, dataset):
        """(labels, scores) with a score column preferred for ranking.

        Column choice: ``rawPredictionCol`` if present, else a
        ``probability`` column (this framework's classifiers emit
        probabilityCol, conventionally named 'probability', and never a
        'rawPrediction' column — without this fallback the out-of-the-box
        evaluator would silently rank on hard labels), else degrade to
        ``predictionCol`` with a warning (hard labels give the degenerate
        two-level AUC)."""
        label_col = self.getOrDefault("labelCol")
        columns = _column_names(dataset)
        score_col = None
        for candidate in (self.getOrDefault("rawPredictionCol"), "probability"):
            if candidate and candidate in columns:
                score_col = candidate
                break
        if score_col is not None:
            if _is_spark_df(dataset):
                weight_col = self.getOrDefault("weightCol")
                cols = [label_col, score_col] + ([weight_col] if weight_col else [])
                got = _df_columns(dataset, *cols)  # one job, weights included
                y, s = got[0], got[1]
                w = columnar.validate_weights(got[2], len(y)) if weight_col else None
            else:
                y = _labels_of(dataset, label_col)
                try:  # vector column ([rows, C] probability/margins)...
                    s = columnar.extract_matrix(dataset, score_col)
                except (TypeError, ValueError):  # ...or a scalar score
                    s = columnar.extract_vector(dataset, score_col)
                w = self._weights_of(dataset, len(y))
            s = np.asarray(s, dtype=np.float64)
            if s.ndim == 2:
                s = s[:, -1]  # positive-class score, pyspark.ml convention
            return y, s, w
        warnings.warn(
            "BinaryClassificationEvaluator: no score column found (looked "
            f"for {self.getOrDefault('rawPredictionCol')!r} and "
            "'probability'); areaUnderROC/areaUnderPR degrade to the "
            "two-level curve of "
            "hard labels. Point rawPredictionCol at your model's "
            "probability output (e.g. setRawPredictionCol('probability') "
            "with LogisticRegression().setProbabilityCol('probability')).",
            stacklevel=3,
        )
        return self._labeled_pair(dataset, None)

    def evaluate(self, dataset, predictions=None) -> float:
        if self.getOrDefault("metricName") == "accuracy":
            y, p, w = self._labeled_pair(dataset, predictions)
            hits = ((p >= 0.5) == (y >= 0.5)).astype(np.float64)
            if w is None:
                return float(np.mean(hits))
            return float(np.sum(w * hits) / w.sum())
        if predictions is not None:
            y, p, w = self._labeled_pair(dataset, predictions)
        else:
            y, p, w = self._score_pair(dataset)
        if w is None:
            w = np.ones_like(p)
        if self.getOrDefault("metricName") == "areaUnderPR":
            return self._area_under_pr(y, p, w)
        pos_mask = y >= 0.5
        w_pos_total = float(w[pos_mask].sum())
        w_neg_total = float(w[~pos_mask].sum())
        if w_pos_total == 0.0 or w_neg_total == 0.0:
            return 0.5
        # Weighted Mann–Whitney with tie correction:
        # AUC = Σ_{i∈pos} w_i·(W_neg(score<s_i) + ½·W_neg(score=s_i)) / (W⁺·W⁻)
        # computed by one sort over tied-score groups.
        gw_pos, gw_neg = _tied_group_weights(p, w, pos_mask, descending=False)
        cum_neg_before = np.concatenate([[0.0], np.cumsum(gw_neg)[:-1]])
        auc_num = float(np.sum(gw_pos * (cum_neg_before + 0.5 * gw_neg)))
        return auc_num / (w_pos_total * w_neg_total)

    @staticmethod
    def _area_under_pr(y, p, w) -> float:
        """Weighted PR AUC by trapezoid over the per-threshold
        (recall, precision) points, descending thresholds, with the curve
        anchored at (0, precision-of-first-group) — Spark's linear
        interpolation convention (BinaryClassificationMetrics.pr), vs the
        step interpolation some libraries use; differences show up only in
        the last decimals on tied-score data. A positive-free dataset
        scores 0.0."""
        pos = y >= 0.5
        w_pos_total = float(w[pos].sum())
        if w_pos_total == 0.0:
            return 0.0
        g_tp, g_neg = _tied_group_weights(p, w, pos, descending=True)
        tp = np.cumsum(g_tp)
        retrieved = np.cumsum(g_tp + g_neg)
        # leading groups made ENTIRELY of zero-weight rows carry no mass:
        # keeping them would anchor the curve at 0/0 = NaN and poison the
        # trapezoid (validate_weights allows individual zero weights)
        nz = retrieved > 0
        tp, retrieved = tp[nz], retrieved[nz]
        recall = tp / w_pos_total
        precision = tp / retrieved
        r = np.concatenate([[0.0], recall])
        pr = np.concatenate([[precision[0]], precision])
        return float(np.sum(np.diff(r) * 0.5 * (pr[1:] + pr[:-1])))


class MulticlassClassificationEvaluator(Evaluator, HasLabelCol, HasPredictionCol):
    """Spark's ``pyspark.ml.evaluation.MulticlassClassificationEvaluator``
    surface: f1 (default, class-frequency-weighted), accuracy,
    weightedPrecision, weightedRecall on (labelCol, predictionCol), and
    logLoss on (labelCol, probabilityCol) — the metric set that makes the
    multinomial softmax estimator tunable by CV/TVS.

    Weighted metrics follow Spark's definition: per-class scores averaged
    with TRUE-label frequencies as weights (a class predicted but never
    present contributes 0 weight). ``logLoss`` clips probabilities to
    ``eps`` like Spark (MulticlassMetrics logLoss eps=1e-15).
    """

    metricName = Param(
        "metricName",
        "f1|accuracy|weightedPrecision|weightedRecall|logLoss",
        str,
    )
    probabilityCol = Param(
        "probabilityCol",
        "[rows, C] class-probability vector column (logLoss only)",
        str,
    )
    eps = Param("eps", "probability clip floor for logLoss", float)

    _METRICS = ("f1", "accuracy", "weightedPrecision", "weightedRecall", "logLoss")

    def __init__(self, uid: str | None = None, **kwargs):
        super().__init__(uid, **kwargs)
        self._setDefault(
            metricName="f1", labelCol="label", predictionCol="prediction",
            probabilityCol="probability", eps=1e-15,
        )

    def setMetricName(self, value: str) -> "MulticlassClassificationEvaluator":
        if value not in self._METRICS:
            raise ValueError(f"metricName must be one of {self._METRICS}")
        return self._set(metricName=value)

    def setProbabilityCol(self, value: str) -> "MulticlassClassificationEvaluator":
        return self._set(probabilityCol=value)

    def isLargerBetter(self) -> bool:
        return self.getOrDefault("metricName") != "logLoss"

    def _prob_pair(self, dataset, predictions):
        """(labels, [rows, C] probabilities) for logLoss."""
        label_col = self.getOrDefault("labelCol")
        prob_col = self.getOrDefault("probabilityCol")
        if predictions is not None:
            probs = np.asarray(predictions, dtype=np.float64)
            if probs.ndim == 1 and probs.size and 0.0 <= probs.min() and probs.max() <= 1.0:
                # binary models surface P(class 1) as a [rows] vector
                # (LogisticRegressionModel.predict_proba_matrix's 2-class
                # contract) — promote to the [rows, 2] layout Spark's
                # probability column uses so logLoss works on binary data
                probs = np.stack([1.0 - probs, probs], axis=1)
            if probs.ndim != 2:
                raise ValueError(
                    "logLoss needs a [rows, C] probability matrix (or a "
                    "[rows] binary P(class 1) vector); got shape "
                    f"{probs.shape}. Pass the model's probability output, "
                    "or evaluate the transformed dataset carrying "
                    f"{prob_col!r}"
                )
            y = _labels_of(dataset, label_col)
            return y, probs, self._weights_of(dataset, len(y))
        if prob_col not in _column_names(dataset):
            raise ValueError(
                f"logLoss needs probability column {prob_col!r}; set the "
                "model's probabilityCol (e.g. "
                "LogisticRegression().setProbabilityCol('probability')) or "
                "this evaluator's setProbabilityCol"
            )
        if _is_spark_df(dataset):
            weight_col = self.getOrDefault("weightCol")
            cols = [label_col, prob_col] + ([weight_col] if weight_col else [])
            got = _df_columns(dataset, *cols)  # one job, weights included
            y, probs = got[0], got[1]
            w = columnar.validate_weights(got[2], len(y)) if weight_col else None
        else:
            y = _labels_of(dataset, label_col)
            probs = columnar.extract_matrix(dataset, prob_col)
            w = self._weights_of(dataset, len(y))
        return y, np.asarray(probs, dtype=np.float64), w

    def evaluate(self, dataset, predictions=None) -> float:
        metric = self.getOrDefault("metricName")
        if metric == "logLoss":
            y, probs, iw = self._prob_pair(dataset, predictions)
            cls = np.asarray(y, dtype=np.int64)
            if cls.min() < 0 or cls.max() >= probs.shape[1]:
                raise ValueError(
                    f"labels span {cls.min()}..{cls.max()} but the "
                    f"probability column has {probs.shape[1]} classes"
                )
            eps = self.getOrDefault("eps")
            picked = np.clip(probs[np.arange(len(cls)), cls], eps, 1.0)
            if iw is None:
                return float(-np.mean(np.log(picked)))
            return float(-np.sum(iw * np.log(picked)) / iw.sum())
        y, p, iw = self._labeled_pair(dataset, predictions)
        if iw is None:
            iw = np.ones_like(y, dtype=np.float64)
        if metric == "accuracy":
            return float(np.sum(iw * (y == p)) / iw.sum())
        classes = np.unique(y)
        true_w = np.array([float(iw[y == c].sum()) for c in classes])
        weights = true_w / true_w.sum()  # class frequency, instance-weighted
        prec = np.zeros(len(classes))
        rec = np.zeros(len(classes))
        for i, c in enumerate(classes):
            tp = float(iw[(p == c) & (y == c)].sum())
            pred_c = float(iw[p == c].sum())
            prec[i] = tp / pred_c if pred_c > 0 else 0.0
            rec[i] = tp / true_w[i] if true_w[i] > 0 else 0.0
        if metric == "weightedPrecision":
            return float(np.sum(weights * prec))
        if metric == "weightedRecall":
            return float(np.sum(weights * rec))
        denom = prec + rec
        f1 = np.where(denom > 0, 2.0 * prec * rec / np.maximum(denom, 1e-300), 0.0)
        return float(np.sum(weights * f1))


class ClusteringEvaluator(Evaluator):
    """Mean silhouette (squared-Euclidean) on (featuresCol, predictionCol).

    Row pairs are O(rows²); rows are subsampled to ``maxRows`` (deterministic)
    above that — the Spark evaluator makes the same tradeoff via its
    squared-Euclidean variant. With ``weightCol`` the per-row a/b means and
    the final silhouette mean are instance-weighted (Spark 3.1 surface);
    the subsample itself stays uniform, so a cap-exceeding weighted
    evaluation is an estimate of the weighted metric.
    """

    featuresCol = Param("featuresCol", "features column", str)
    predictionCol = Param("predictionCol", "cluster assignment column", str)
    maxRows = Param("maxRows", "subsample cap for the pairwise pass", int)

    def __init__(self, uid: str | None = None, **kwargs):
        super().__init__(uid, **kwargs)
        self._setDefault(featuresCol="features", predictionCol="prediction", maxRows=2048)

    def evaluate(self, dataset, predictions=None) -> float:
        feats = self.getOrDefault("featuresCol")
        pred_col = self.getOrDefault("predictionCol")
        cap = self.getOrDefault("maxRows")
        if predictions is None and _is_spark_df(dataset):
            # the subsample goes into the plan: never more than ~2·cap rows
            # on the driver for a cap-bounded metric
            weight_col = self.getOrDefault("weightCol")
            total = dataset.count()
            if total > cap:
                dataset = dataset.sample(fraction=min(1.0, 2.0 * cap / total), seed=0)
            cols = [feats, pred_col] + ([weight_col] if weight_col else [])
            got = _df_columns(dataset, *cols)  # one job, weights included
            x, p = got[0], got[1].astype(np.int64)
            w = columnar.validate_weights(got[2], len(x)) if weight_col else None
        else:
            if isinstance(dataset, tuple):  # (X, _, w?) container
                x = np.asarray(dataset[0], dtype=np.float64)
            elif _is_spark_df(dataset):
                x = _df_columns(dataset, feats)[0]
            else:
                x = columnar.extract_matrix(dataset, feats)
            if predictions is not None:
                p = np.asarray(predictions, dtype=np.float64).reshape(-1).astype(np.int64)
            else:
                p = columnar.extract_vector(dataset, pred_col).astype(np.int64)
            w = self._weights_of(dataset, len(x))
        if w is None:
            w = np.ones(len(x))
        if len(x) > cap:
            sel = np.random.default_rng(0).choice(len(x), cap, replace=False)
            x, p, w = x[sel], p[sel], w[sel]
        # Gram identity keeps the pairwise pass at one [rows, rows] matrix
        # (the [rows, rows, dims] broadcast would be GBs at default maxRows).
        sq = (x * x).sum(-1)
        d2 = np.maximum(sq[:, None] + sq[None, :] - 2.0 * (x @ x.T), 0.0)
        labels = np.unique(p)
        if len(labels) < 2:
            return 0.0
        sil = np.zeros(len(x))
        for i in range(len(x)):
            same = p == p[i]
            same[i] = False
            w_same = float(w[same].sum())
            if w_same <= 0:
                continue  # (weighted-)singleton cluster: silhouette is 0
            a = float(np.dot(w[same], d2[i, same])) / w_same
            others = [
                float(np.dot(w[p == c], d2[i, p == c])) / float(w[p == c].sum())
                for c in labels
                if c != p[i] and w[p == c].sum() > 0
            ]
            if not others:
                continue  # every other cluster is weight-empty
            b = min(others)
            sil[i] = 0.0 if max(a, b) == 0 else (b - a) / max(a, b)
        return float(np.dot(w, sil) / w.sum())


# ---------------------------------------------------------------------------
# Validators
# ---------------------------------------------------------------------------


def _fit_and_eval(estimator, params, evaluator, train, val):
    est = estimator.copy()
    if params:
        est._set(**params)
    model = est.fit(train)
    # AUC ranks SCORES; a thresholded 0/1 prediction column collapses it to
    # balanced accuracy. When the model exposes a probability surface
    # (LogisticRegression), rank that instead — the Spark evaluator makes
    # the same choice by reading rawPrediction rather than prediction.
    wants_probability_surface = (
        (
            isinstance(evaluator, BinaryClassificationEvaluator)
            and evaluator.getOrDefault("metricName")
            in ("areaUnderROC", "areaUnderPR")
        )
        or (
            isinstance(evaluator, MulticlassClassificationEvaluator)
            and evaluator.getOrDefault("metricName") == "logLoss"
        )
    )
    if wants_probability_surface and hasattr(model, "predict_proba_matrix"):
        fcol = model.getOrDefault("featuresCol")
        if isinstance(val, tuple):
            feats = np.asarray(val[0])
            scores = model.predict_proba_matrix(feats)
            return model, evaluator.evaluate(val, predictions=scores)
        if _is_spark_df(val):
            # one job for every column, weightCol included, so weighted CV
            # ranks the same probability surface (through the (X, y, w)
            # tuple container)
            wcol = evaluator.getOrDefault("weightCol")
            got = _df_columns(val, fcol, evaluator.getOrDefault("labelCol"),
                              *([wcol] if wcol else []))
            scores = model.predict_proba_matrix(got[0])
            return model, evaluator.evaluate(tuple(got), predictions=scores)
        feats = columnar.extract_matrix(val, fcol)
        scores = model.predict_proba_matrix(feats)
        return model, evaluator.evaluate(val, predictions=scores)
    if isinstance(val, tuple):
        pred = model.transform(val[0])
        return model, evaluator.evaluate(val, predictions=np.asarray(pred))
    out = model.transform(val)
    if isinstance(out, np.ndarray):  # bare-matrix containers: predictions only
        return model, evaluator.evaluate(val, predictions=out)
    return model, evaluator.evaluate(out)


class _ValidatorParams(Params):
    seed = Param("seed", "fold shuffle seed", int)

    def _candidates(self):
        maps = self._maps
        return maps if maps else [{}]


class CrossValidator(_ValidatorParams, Estimator):
    """k-fold cross-validation over a param grid.

    >>> cv = CrossValidator(estimator=LinearRegression(),
    ...                     estimatorParamMaps=grid,
    ...                     evaluator=RegressionEvaluator(),
    ...                     numFolds=3)
    >>> best = cv.fit((x, y)).bestModel
    """

    numFolds = Param("numFolds", "number of folds", int)

    def __init__(
        self,
        uid: str | None = None,
        estimator: Estimator | None = None,
        estimatorParamMaps: list[dict] | None = None,
        evaluator: Evaluator | None = None,
        numFolds: int = 3,
        seed: int = 0,
        collectSubModels: bool = False,
    ):
        super().__init__(uid)
        self._estimator = estimator
        self._maps = estimatorParamMaps or []
        self._evaluator = evaluator
        self._collect = collectSubModels
        self._setDefault(numFolds=3, seed=0)
        self._set(numFolds=numFolds, seed=seed)

    def fit(self, dataset: Any) -> "CrossValidatorModel":
        k = self.getOrDefault("numFolds")
        if k < 2:
            raise ValueError("numFolds must be >= 2")
        splits = None
        if _is_spark_df(dataset):
            # Spark's fold assignment: one randomSplit plans k disjoint row
            # subsets, each fold's train set the union of the others
            splits = dataset.randomSplit([1.0 / k] * k, seed=self.getOrDefault("seed"))
            if any(sp.first() is None for sp in splits):
                raise ValueError(
                    f"randomSplit produced an empty fold (numFolds={k}); "
                    "the dataset is too small for this many folds"
                )
        else:
            dataset = _collect_for_split(dataset)
            rng = np.random.default_rng(self.getOrDefault("seed"))
            folds = np.array_split(rng.permutation(n_rows(dataset)), k)
        candidates = self._candidates()
        metrics = np.zeros((len(candidates), k))
        sub_models = [] if self._collect else None
        for f in range(k):
            if splits is not None:
                # cached: the Newton and Lloyd candidates run many jobs over
                # a fold, each of which would replay the split's filters
                train = functools.reduce(
                    lambda a, b: a.union(b), [splits[i] for i in range(k) if i != f]
                ).cache()
                val = splits[f].cache()
            else:
                train_idx = np.concatenate([folds[i] for i in range(k) if i != f])
                train = row_slice(dataset, train_idx)
                val = row_slice(dataset, folds[f])
            try:
                fold_models = []
                for c, params in enumerate(candidates):
                    model, metric = _fit_and_eval(
                        self._estimator, params, self._evaluator, train, val)
                    metrics[c, f] = metric
                    fold_models.append(model)
                if sub_models is not None:
                    sub_models.append(fold_models)
            finally:
                if splits is not None:
                    train.unpersist()
                    val.unpersist()
        avg = metrics.mean(axis=1)
        best_idx = int(np.argmax(avg) if self._evaluator.isLargerBetter() else np.argmin(avg))
        best_est = self._estimator.copy()
        if candidates[best_idx]:
            best_est._set(**candidates[best_idx])
        best_model = best_est.fit(dataset)
        return CrossValidatorModel(
            uid=self.uid,
            bestModel=best_model,
            avgMetrics=list(avg),
            bestIndex=best_idx,
            subModels=sub_models,
        )


class CrossValidatorModel(Model):
    def __init__(
        self,
        uid: str | None = None,
        bestModel: Model | None = None,
        avgMetrics: list[float] | None = None,
        bestIndex: int = 0,
        subModels=None,
    ):
        super().__init__(uid)
        self.bestModel = bestModel
        self.avgMetrics = avgMetrics or []
        self.bestIndex = bestIndex
        self.subModels = subModels

    def transform(self, dataset: Any) -> Any:
        return self.bestModel.transform(dataset)


class TrainValidationSplit(_ValidatorParams, Estimator):
    """Single train/validation split over a param grid (cheaper than CV)."""

    trainRatio = Param("trainRatio", "fraction of rows used for training", float)

    def __init__(
        self,
        uid: str | None = None,
        estimator: Estimator | None = None,
        estimatorParamMaps: list[dict] | None = None,
        evaluator: Evaluator | None = None,
        trainRatio: float = 0.75,
        seed: int = 0,
    ):
        super().__init__(uid)
        self._estimator = estimator
        self._maps = estimatorParamMaps or []
        self._evaluator = evaluator
        self._setDefault(trainRatio=0.75, seed=0)
        self._set(trainRatio=trainRatio, seed=seed)

    def fit(self, dataset: Any) -> "TrainValidationSplitModel":
        ratio = self.getOrDefault("trainRatio")
        if not 0.0 < ratio < 1.0:
            raise ValueError("trainRatio must be in (0, 1)")
        if _is_spark_df(dataset):
            train, val = dataset.randomSplit([ratio, 1.0 - ratio],
                                             seed=self.getOrDefault("seed"))
            if train.first() is None or val.first() is None:
                raise ValueError("split produced an empty train or validation set")
            train, val = train.cache(), val.cache()
        else:
            dataset = _collect_for_split(dataset)
            rng = np.random.default_rng(self.getOrDefault("seed"))
            idx = rng.permutation(n_rows(dataset))
            cut = int(len(idx) * ratio)
            if cut == 0 or cut == len(idx):
                raise ValueError("split produced an empty train or validation set")
            train = row_slice(dataset, idx[:cut])
            val = row_slice(dataset, idx[cut:])
        candidates = self._candidates()
        metrics = []
        for params in candidates:
            _, metric = _fit_and_eval(
                self._estimator, params, self._evaluator, train, val
            )
            metrics.append(metric)
        arr = np.asarray(metrics)
        best_idx = int(np.argmax(arr) if self._evaluator.isLargerBetter() else np.argmin(arr))
        best_est = self._estimator.copy()
        if candidates[best_idx]:
            best_est._set(**candidates[best_idx])
        best_model = best_est.fit(dataset)
        return TrainValidationSplitModel(
            uid=self.uid,
            bestModel=best_model,
            validationMetrics=metrics,
            bestIndex=best_idx,
        )


class TrainValidationSplitModel(Model):
    def __init__(
        self,
        uid: str | None = None,
        bestModel: Model | None = None,
        validationMetrics: list[float] | None = None,
        bestIndex: int = 0,
    ):
        super().__init__(uid)
        self.bestModel = bestModel
        self.validationMetrics = validationMetrics or []
        self.bestIndex = bestIndex

    def transform(self, dataset: Any) -> Any:
        return self.bestModel.transform(dataset)
