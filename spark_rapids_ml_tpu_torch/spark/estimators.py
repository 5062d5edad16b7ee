"""Spark DataFrame-facing estimators of the port.

Port of ``spark_rapids_ml_tpu/spark/estimators.py``. The reference's user
story (README.md:24-37): change one import and a Spark ML pipeline runs
accelerated. Every ``Spark*`` class here subclasses the port's core
estimator or model and takes a Spark DataFrame, pyspark's or one of the
port's local engine (``localspark``), through the Arrow plan functions of
``spark/arrow_fns.py``; any other input falls through to the core fit.

- **Statistics over jobs** (the driver-merge distribution): each
  partition's statistics one row, merged on the driver in f64, then the
  estimator's own driver half on its device (``solve_merged``,
  ``newton_step``, ``lloyd_step``, ``reduce_candidates``,
  ``moments_merged``, ``robust_merged``, the Imputer's ``surrogate_*``,
  ``decompose_merged``): SparkPCA, SparkTruncatedSVD,
  SparkLinearRegression, SparkLogisticRegression (one job per Newton
  iteration, binary or multinomial), SparkKMeans (k-means‖ as cost,
  sampling and weighting jobs; Lloyd as one job per iteration;
  ``checkpoint_dir`` resumes between jobs), the scalers, SparkImputer,
  SparkVarianceThresholdSelector and SparkQuantileDiscretizer (range and
  histogram jobs).
- **Collect and fit**: the rows collected on the driver by the bounded
  chunker (``ingest._iter_chunks``), then the core fit: SparkLinearSVC,
  the forests, GBT, OneVsRest, NaiveBayes, the MLP, FM, isotonic, UMAP and
  the k-NN item sets; SparkDBSCAN labels its collected rows on one device.
- **Transforms**: one lazy mapInArrow pass of the model's own matrix
  method in the workers (``_spark_transform``, and the multi-column
  bodies for classifiers and k-NN), whose ``TransformReport`` closes when
  the plan first materializes; the stateless stages likewise.

The plan functions compute on the estimator's device type (``"cuda"`` by
default) inside the worker. Only ``"driver-merge"`` runs: ``"mesh-local"``
and ``"mesh-barrier"`` are accepted as params, as in the JAX package, and
``fit`` refuses them before any job runs (they wait for ROADMAP Queue A
item 6). pyspark is optional and imported only for a pyspark DataFrame.
There is no compilation cache to enable (``_sql_mods``): a CUDA graph
cannot outlive its process.
"""

from __future__ import annotations

import logging
from typing import Any

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.models import scaler as scaler_mod
from spark_rapids_ml_tpu_torch.models import truncated_svd as tsvd_mod
from spark_rapids_ml_tpu_torch.models.dbscan import DBSCAN, DBSCANModel
from spark_rapids_ml_tpu_torch.models.discretizer import (
    Bucketizer,
    QuantileDiscretizer,
    QuantileDiscretizerModel,
    check_finite_range,
    splits_from_histogram,
)
from spark_rapids_ml_tpu_torch.models.fm import (
    FMClassificationModel,
    FMClassifier,
    FMRegressionModel,
    FMRegressor,
)
from spark_rapids_ml_tpu_torch.models.forest import (
    RandomForestClassificationModel,
    RandomForestClassifier,
    RandomForestRegressionModel,
    RandomForestRegressor,
)
from spark_rapids_ml_tpu_torch.models.gbt import (
    GBTClassificationModel,
    GBTClassifier,
    GBTRegressionModel,
    GBTRegressor,
)
from spark_rapids_ml_tpu_torch.models.isotonic import IsotonicRegression, IsotonicRegressionModel
from spark_rapids_ml_tpu_torch.models.kmeans import KMeans, KMeansModel, _resume_kmeans_checkpoint
from spark_rapids_ml_tpu_torch.models.linear import (
    _MAX_CLASSES,
    LinearRegression,
    LinearRegressionModel,
    LinearSVC,
    LinearSVCModel,
    LogisticRegression,
    LogisticRegressionModel,
    _newton_step_bookkeeping,
    _resume_newton_checkpoint,
)
from spark_rapids_ml_tpu_torch.models.mlp import (
    MultilayerPerceptronClassificationModel,
    MultilayerPerceptronClassifier,
)
from spark_rapids_ml_tpu_torch.models.naive_bayes import NaiveBayes, NaiveBayesModel
from spark_rapids_ml_tpu_torch.models.neighbors import (
    ApproximateNearestNeighbors,
    ApproximateNearestNeighborsModel,
    NearestNeighbors,
    NearestNeighborsModel,
)
from spark_rapids_ml_tpu_torch.models.ovr import OneVsRest, OneVsRestModel
from spark_rapids_ml_tpu_torch.models.params import Param
from spark_rapids_ml_tpu_torch.models.pca import PCA, PCAModel
from spark_rapids_ml_tpu_torch.models.scaler import (
    DCT,
    Binarizer,
    ElementwiseProduct,
    Imputer,
    ImputerModel,
    MaxAbsScaler,
    MaxAbsScalerModel,
    MinMaxScaler,
    MinMaxScalerModel,
    Normalizer,
    PolynomialExpansion,
    RobustScaler,
    RobustScalerModel,
    StandardScaler,
    StandardScalerModel,
    VectorSlicer,
)
from spark_rapids_ml_tpu_torch.models.selector import (
    VarianceThresholdSelector,
    VarianceThresholdSelectorModel,
    select_by_variance,
)
from spark_rapids_ml_tpu_torch.models.truncated_svd import TruncatedSVD, TruncatedSVDModel
from spark_rapids_ml_tpu_torch.models.umap import UMAP, UMAPModel
from spark_rapids_ml_tpu_torch.ops import kmeans as KM
from spark_rapids_ml_tpu_torch.ops import linalg as L
from spark_rapids_ml_tpu_torch.ops import linear as LIN
from spark_rapids_ml_tpu_torch.ops import scaler as S
from spark_rapids_ml_tpu_torch.spark import arrow_fns, ingest
from spark_rapids_ml_tpu_torch.telemetry import trace_range
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY
from spark_rapids_ml_tpu_torch.utils import columnar
from spark_rapids_ml_tpu_torch.utils.config import get_config
from spark_rapids_ml_tpu_torch.utils.device import to_device

logger = logging.getLogger("spark_rapids_ml_tpu_torch")

_MESH_DISTRIBUTIONS = ("mesh-local", "mesh-barrier")


def _require_pyspark():
    try:
        import pyspark  # noqa: F401
        from pyspark.sql import DataFrame  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "spark_rapids_ml_tpu_torch.spark.estimators requires pyspark "
            "(pip install pyspark>=3.4) for pyspark DataFrames; the core "
            "estimators work without it on pandas/Arrow/ndarray input, and "
            "spark_rapids_ml_tpu_torch.localspark offers the DataFrame API "
            "without a JVM"
        ) from e


def _sql_mods(dataset):
    """(types, functions) of the dataset's SQL engine: pyspark's for a
    pyspark DataFrame, the port's local engine's otherwise, so both run the
    same estimator code."""
    mod = type(dataset).__module__ or ""
    if mod.startswith("pyspark."):
        _require_pyspark()
        from pyspark.sql import functions, types

        return types, functions
    from spark_rapids_ml_tpu_torch.localspark import functions, types

    return types, functions


def _is_spark_df(dataset: Any) -> bool:
    return columnar.is_spark_dataframe(dataset)


def _spark_arrays_type(T, fields: list[str]):
    return T.StructType([T.StructField(f, T.ArrayType(T.DoubleType())) for f in fields])


def _run_pass(df, fn, schema, decode_batches, decode_rows):
    """One mapInArrow job decoded on the driver: ``toArrow`` where the
    DataFrame has it (pyspark >= 4.0, localspark), else ``collect()``."""
    out_df = df.mapInArrow(fn, schema=schema)
    if hasattr(out_df, "toArrow"):
        return decode_batches(out_df.toArrow().to_batches())
    return decode_rows(out_df.collect())


def _collect_stats(df, partition_fn, fields: list[str], shapes: dict[str, tuple],
                   combine=None) -> dict[str, np.ndarray]:
    """One stats ``mapInArrow`` pass folded on the driver."""
    T, _ = _sql_mods(df)
    out = _run_pass(df, partition_fn, _spark_arrays_type(T, fields),
                    lambda b: arrow_fns.arrays_from_batches(b, shapes, combine),
                    lambda r: arrow_fns.arrays_from_rows(r, shapes, combine))
    # the merged payload: a lower bound of what the executors shipped
    REGISTRY.counter_inc("drivermerge.bytes", sum(v.nbytes for v in out.values()))
    REGISTRY.counter_inc("drivermerge.passes")
    return out


def _parse_checkpoint_kwargs(kwargs: dict, default_every: int) -> tuple:
    """(checkpoint_dir, checkpoint_every), validated as the core estimators
    validate them, so a typo does not train differently per container."""
    kwargs = dict(kwargs)
    checkpoint_dir = kwargs.pop("checkpoint_dir", None)
    checkpoint_every = kwargs.pop("checkpoint_every", None)
    if kwargs:
        raise TypeError(f"unexpected fit() kwargs: {sorted(kwargs)}")
    if checkpoint_every is None:
        checkpoint_every = default_every
    if checkpoint_every < 1:
        raise ValueError(f"checkpoint_every must be >= 1, got {checkpoint_every}")
    return checkpoint_dir, checkpoint_every


def _host_stats_on(stats: L.GramStats, device: torch.device) -> L.GramStats:
    """The driver's merged f64 host statistics as f32 tensors on
    ``device``, the dtype every fit of the port decomposes in."""
    return L.GramStats(*(torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)
                         for a in stats))


class _HasDistribution:
    """Mixin: the DataFrame fit's cross-partition reduction, one definition
    for every estimator that offers it."""

    _ALLOWED_DISTRIBUTIONS: tuple = ("driver-merge", "mesh-barrier")

    distribution = Param(
        "distribution",
        "cross-partition reduction strategy for DataFrame fits: "
        "'driver-merge' (per-partition stats rows merged on the driver, the "
        "portable path: architecture parity with the reference's JVM reduce, "
        "RapidsRowMatrix.scala:139), or 'mesh-barrier' / 'mesh-local' (a "
        "collective over the partitions' process group, or over the driver's "
        "own devices), which the port accepts and refuses at fit until ROADMAP "
        "Queue A item 6",
        str,
    )

    def __init__(self, uid: str | None = None, **kwargs):
        super().__init__(uid, **kwargs)
        self._setDefault(distribution="driver-merge")

    def setDistribution(self, value: str):
        if value not in self._ALLOWED_DISTRIBUTIONS:
            raise ValueError(f"distribution must be one of {self._ALLOWED_DISTRIBUTIONS}")
        return self._set(distribution=value)

    def _check_distribution(self) -> None:
        """Refuse a mesh distribution before any job of a DataFrame fit."""
        distribution = self.getOrDefault("distribution")
        if distribution in _MESH_DISTRIBUTIONS:
            raise NotImplementedError(
                f"distribution={distribution!r} needs the port's device mesh "
                "(parallel/mesh.py, gram.py, tsqr.py, spark/spmd.py), which waits for "
                "ROADMAP Queue A item 6; use 'driver-merge'"
            )


class SparkPCA(_HasDistribution, PCA):
    """PCA whose ``fit``/``transform`` take a Spark DataFrame (pyspark's or
    ``localspark``'s). Every param of the core ``PCA`` and its persistence
    carry over; other inputs fall through to the core fit."""

    _ALLOWED_DISTRIBUTIONS = ("driver-merge", "mesh-barrier", "mesh-local")

    def fit(self, dataset: Any, num_partitions: int | None = None, **kwargs) -> "SparkPCAModel":
        checkpoint_dir, _ = _parse_checkpoint_kwargs(
            kwargs, get_config().stream_checkpoint_every_chunks
        )
        if not _is_spark_df(dataset):
            if checkpoint_dir is not None:
                raise NotImplementedError(
                    "checkpoint_dir applies to the mesh-local streamed DataFrame fit; "
                    "local containers fit in one resident pass"
                )
            core = super().fit(dataset, num_partitions)
            model = SparkPCAModel(uid=core.uid, pc=core.pc,
                                  explainedVariance=core.explainedVariance,
                                  mean=core.mean, std=core.std, device=self.device)
            model.stream_report = core.stream_report
            return self._copyValues(model)
        self._check_distribution()
        if checkpoint_dir is not None:
            raise NotImplementedError(
                "checkpoint_dir requires distribution='mesh-local' with a covariance "
                "solver: only the streamed chunk fold has a resumable cursor"
            )
        T, _ = _sql_mods(dataset)
        input_col = self.getInputCol()
        solver = self.getOrDefault("solver")
        with trace_range("compute cov", self.device):
            selected = dataset.select(input_col)
            n = _infer_n(selected, input_col)
            k = self.getK()
            if k > n:  # before the cluster-wide Gram pass
                raise ValueError(f"k={k} must be <= number of features {n}")
            if solver == "svd":
                if self.getOrDefault("standardize"):
                    raise ValueError(
                        "standardize=True derives the scaled covariance from GramStats "
                        "and so requires a covariance solver ('full'/'randomized'/"
                        "'auto'); solver='svd' decomposes R factors of the raw rows"
                    )
                return self._fit_svd(selected, input_col, n, k)
            fit_fn = arrow_fns.make_fit_partition_fn(
                input_col, precision=self.getOrDefault("precision"), device=self.device.type
            )
            stats = _run_pass(selected, fit_fn,
                              _spark_arrays_type(T, ["xtx", "col_sum", "count"]),
                              arrow_fns.stats_from_batches, arrow_fns.stats_from_rows)
        mean = std = None
        with trace_range("eigh", self.device):
            stats = _host_stats_on(stats, self.device)
            if self.getOrDefault("standardize"):
                cov, mean, std = L.standardized_cov_from_stats(stats)
            else:
                cov = L.covariance_from_stats(stats, mean_centering=self.getMeanCentering())
            pc, ev = L.pca_fit_from_cov(cov, k, solver=solver)
        model = SparkPCAModel(
            uid=self.uid,
            pc=pc.cpu().numpy(),
            explainedVariance=ev.cpu().numpy(),
            mean=None if mean is None else mean.cpu().numpy(),
            std=None if std is None else std.cpu().numpy(),
            device=self.device,
        )
        return self._copyValues(model)

    def _fit_svd(self, selected, input_col: str, n: int, k: int) -> "SparkPCAModel":
        """Solver ``"svd"`` over driver-merge: each partition's R factor
        (``QRPartitionFn``), merged by a ``combine_r`` tree on the driver's
        device, then the SVD of R. ``meanCentering`` costs one moments pass
        for the global mean, applied in the workers before padding."""
        T, _ = _sql_mods(selected)
        mean = None
        if self.getMeanCentering():
            shapes = {"count": (), "total": (n,), "total_sq": (n,)}
            arrays = _collect_stats(
                selected,
                arrow_fns.make_moments_partition_fn(input_col, device=self.device.type),
                list(shapes), shapes,
            )
            mean = arrays["total"] / max(float(arrays["count"]), 1.0)
        r = _run_pass(selected, arrow_fns.QRPartitionFn(input_col, mean, device=self.device.type),
                      _spark_arrays_type(T, ["r"]),
                      lambda b: arrow_fns.r_from_batches(b, n, self.device),
                      lambda r: arrow_fns.r_from_rows(r, n, self.device))
        with trace_range("svd from r", self.device):
            pc, ev = L.svd_from_r(r, k)
        model = SparkPCAModel(uid=self.uid, pc=pc.cpu().numpy(),
                              explainedVariance=ev.cpu().numpy(), device=self.device)
        return self._copyValues(model)


class SparkPCAModel(PCAModel):
    """Fitted model whose ``transform`` streams a Spark DataFrame through
    ``mapInArrow``, projecting in the workers on the model's device type.
    Other inputs take the core transform."""

    def transform(self, dataset: Any) -> Any:
        if not _is_spark_df(dataset):
            return super().transform(dataset)
        T, _ = _sql_mods(dataset)
        output_col = self.getOutputCol()
        fn = arrow_fns.make_transform_partition_fn(
            self.getInputCol(), output_col, self.pc, self.mean, self.std,
            device=self.device.type,
        )
        out_schema = T.StructType(
            list(dataset.schema.fields) + [T.StructField(output_col, T.ArrayType(T.DoubleType()))]
        )
        with trace_range("pca transform", self.device):
            return dataset.mapInArrow(fn, schema=out_schema)


# -- shared plan helpers ---------------------------------------------------------


def _resolve_col(obj, *names) -> str | None:
    """The first set-or-defaulted column param among ``names``
    (``_paramMap.get`` alone would miss a default like
    featuresCol='features')."""
    for n in names:
        if obj.isSet(n) or obj.hasDefault(n):
            return obj.getOrDefault(n)
    return None


def _resolve_input_col(model) -> str:
    # Spark ML reads the "features" column when the param is unset
    return _resolve_col(model, "inputCol", "featuresCol") or "features"


def _infer_n(df, col: str) -> int:
    """The feature count from the first row, as RapidsPCA.scala:73-74
    infers it."""
    first = df.select(col).first()
    if first is None:
        raise ValueError("empty dataset")
    if first[0] is None:
        raise ValueError(
            f"input column {col!r} contains null feature vectors; "
            "drop or impute nulls before fit"
        )
    return columnar.feature_dim(first[0])


def _device_str(model) -> str:
    """The device type a model's transform computes on: its own, its first
    sub-model's (OneVsRest), or the host for a model with neither
    (isotonic's interpolation)."""
    device = getattr(model, "device", None)
    if device is None and getattr(model, "models", None):
        device = model.models[0].device
    return "cpu" if device is None else device.type


def _spark_append(dataset, fn, fields):
    """``mapInArrow`` with the input schema plus ``fields`` appended: the
    one dispatch of every model transform. The ``transform.dispatch`` span
    times the plan only (mapInArrow is lazy); the partitions book their own
    ``transform.partition_seconds``."""
    T, _ = _sql_mods(dataset)
    with trace_range("transform.dispatch"):
        schema = T.StructType(
            list(dataset.schema.fields) + [T.StructField(name, typ) for name, typ in fields]
        )
        return dataset.mapInArrow(fn, schema=schema)


def _spark_transform(model, dataset, matrix_fn, output_col: str, scalar: bool):
    """A model's one-output transform: ``matrix_fn`` (a bound method of the
    model) appended as a double or ArrayType(double) column."""
    T, _ = _sql_mods(dataset)
    with trace_range("transform.plan"):
        fn = arrow_fns.make_matrix_map_partition_fn(
            _resolve_input_col(model), output_col, matrix_fn, device=_device_str(model)
        )
        out_type = T.DoubleType() if scalar else T.ArrayType(T.DoubleType())
    return _spark_append(dataset, fn, [(output_col, out_type)])


def _classifier_columns_transform(model, dataset, matrix_fn, trace_label: str):
    """rawPrediction, probability and prediction in one pass: the
    classifier transform of the collect-and-fit families; ``matrix_fn``
    returns the three arrays in that order."""
    T, _ = _sql_mods(dataset)
    raw, proba, pred = (model.getOrDefault(c) for c in
                        ("rawPredictionCol", "probabilityCol", "predictionCol"))
    fn = arrow_fns.MultiOutputPartitionFn(
        model.getOrDefault("featuresCol"),
        [(raw, np.float64), (proba, np.float64), (pred, np.float64)],
        matrix_fn, device=_device_str(model),
    )
    with trace_range(trace_label):
        return _spark_append(dataset, fn, [
            (raw, T.ArrayType(T.DoubleType())),
            (proba, T.ArrayType(T.DoubleType())),
            (pred, T.DoubleType()),
        ])


def _collect_xyw(dataset, feats: str, label_col: str | None = None,
                 weight_col: str | None = None):
    """A DataFrame's (features, label, weight) columns concatenated on the
    driver through the bounded chunker (``ingest._iter_chunks``), the
    driver-merge collection of the collect-and-fit families. On pyspark one
    count job sizes the collect, so a large one streams. The features come
    back f32, the dtype every port fit computes in, so the fits' host steps
    (the trees' bin edges) see the values the card sees; labels and
    weights stay f64."""
    cols = [feats] + ([label_col] if label_col else []) + ([weight_col] if weight_col else [])
    selected = dataset.select(*cols)
    if hasattr(selected, "_parts"):  # localspark streams natively
        est_bytes = 0
    else:
        est_bytes = dataset.count() * (_infer_n(dataset, feats) + len(cols) - 1) * 8
    xs, ys, ws = [], [], []
    for x, y, w in ingest._iter_chunks(selected, feats, label_col, weight_col,
                                       est_bytes=est_bytes):
        xs.append(np.asarray(x, dtype=np.float32))
        if y is not None:
            ys.append(y)
        if w is not None:
            ws.append(w)
    if not xs:
        raise ValueError("dataset has no rows")
    return (np.concatenate(xs), np.concatenate(ys) if ys else None,
            np.concatenate(ws) if ws else None)


def _collect_fit_wrap(est, dataset, wrap, core_fit, *, weighted: bool = True):
    """The collect-and-fit families' DataFrame fit: (features, label[,
    weight]) collected, the core fit on the arrays, the model re-wrapped as
    the Spark class."""
    x, y, w = _collect_xyw(
        dataset, est.getOrDefault("featuresCol"), label_col=est.getOrDefault("labelCol"),
        weight_col=est._paramMap.get("weightCol") if weighted else None,
    )
    return wrap(core_fit((x, y) if w is None else (x, y, w)))


def _as_spark(model, cls):
    """A core model as its Spark subclass, which adds only the DataFrame
    transform: every fitted field (and the fit report) carries over."""
    model.__class__ = cls
    return model


def _on_device(arrays: dict, fields, device: torch.device) -> list[torch.Tensor]:
    """Merged f64 host statistics as f32 tensors on ``device``: the dtype
    the core fits reduce and solve in."""
    return [torch.as_tensor(np.asarray(arrays[f]), dtype=torch.float32, device=device)
            for f in fields]


def _check_weights(arrays: dict, weight_col, field: str = "count") -> None:
    if weight_col and float(np.sum(arrays[field])) == 0.0:
        raise ValueError("all instance weights are zero")


# -- GLMs ----------------------------------------------------------------------


class SparkLinearRegression(_HasDistribution, LinearRegression):
    """LinearRegression over a DataFrame: one ``LinRegPartitionFn`` stats
    job, the partitions' f64 statistics merged on the driver, and
    ``solve_from_stats`` (the closed form, or FISTA for an elastic net) on
    the estimator's device. Other inputs fall through to the core fit."""

    _ALLOWED_DISTRIBUTIONS = ("driver-merge", "mesh-barrier", "mesh-local")

    def fit(self, dataset: Any, num_partitions: int | None = None, **kwargs):
        checkpoint_dir, _ = _parse_checkpoint_kwargs(
            kwargs, get_config().stream_checkpoint_every_chunks)
        if checkpoint_dir is not None:
            raise NotImplementedError(
                "LinearRegression trains in one closed-form pass; checkpoint/resume "
                "applies only to the mesh-local streamed DataFrame fit's chunk cursor"
            )
        if not _is_spark_df(dataset):
            return _as_spark(super().fit(dataset, num_partitions), SparkLinearRegressionModel)
        self._check_distribution()
        feats = self.getOrDefault("featuresCol")
        label = self.getOrDefault("labelCol")
        weight_col = self._paramMap.get("weightCol")
        n = _infer_n(dataset, feats)
        shapes = {"xtx": (n, n), "xty": (n,), "x_sum": (n,), "y_sum": (), "y_sq": (),
                  "count": ()}
        with trace_range("linreg stats", self.device):
            fn = arrow_fns.make_linreg_partition_fn(feats, label, weight_col,
                                                    device=self.device.type)
            cols = [feats, label] + ([weight_col] if weight_col else [])
            arrays = _collect_stats(dataset.select(*cols), fn, list(shapes), shapes)
            _check_weights(arrays, weight_col)
        coef, intercept = self.solve_merged(arrays)
        model = SparkLinearRegressionModel(uid=self.uid, coefficients=coef,
                                           intercept=intercept, device=self.device)
        return self._copyValues(model)

    def solve_merged(self, arrays: dict) -> tuple[np.ndarray, float]:
        """The driver half: the merged f64 ``LinearStats`` solved on the
        estimator's device (f64, as the core fit solves its f64 partials)."""
        with trace_range("linreg solve", self.device):
            stats = LIN.LinearStats(*(
                torch.as_tensor(np.asarray(arrays[f]), dtype=torch.float64, device=self.device)
                for f in LIN.LinearStats._fields))
            coef, intercept = LIN.solve_from_stats(stats, **self._solve_args())
        return coef.cpu().numpy(), float(intercept)


class SparkLinearRegressionModel(LinearRegressionModel):
    def transform(self, dataset: Any) -> Any:
        if not _is_spark_df(dataset):
            return super().transform(dataset)
        return _spark_transform(self, dataset, self._predict_matrix,
                                self.getOrDefault("predictionCol"), scalar=True)


class SparkLogisticRegression(_HasDistribution, LogisticRegression):
    """Distributed IRLS over a DataFrame on driver-merge: a label-scan job
    (the class count), then one job per Newton iteration with the current
    parameters in the task state and the f64 solve on the estimator's
    device between jobs (binary ``LogRegNewtonPartitionFn``, or
    ``SoftmaxNewtonPartitionFn`` for three classes or more);
    ``checkpoint_dir`` saves between jobs and a killed fit resumes."""

    _ALLOWED_DISTRIBUTIONS = ("driver-merge", "mesh-barrier", "mesh-local")

    def fit(self, dataset: Any, num_partitions: int | None = None, **kwargs):
        if not _is_spark_df(dataset):
            return _as_spark(super().fit(dataset, num_partitions, **kwargs),
                             SparkLogisticRegressionModel)
        checkpoint_dir, checkpoint_every = _parse_checkpoint_kwargs(kwargs, 5)
        self._check_distribution()
        feats = self.getOrDefault("featuresCol")
        label = self.getOrDefault("labelCol")
        weight_col = self._paramMap.get("weightCol")
        selected = dataset.select(*([feats, label] + ([weight_col] if weight_col else [])))
        fit_intercept = self.getFitIntercept()
        n = _infer_n(dataset, feats)
        with trace_range("label scan", self.device):
            all_labels = self._scan_labels(dataset.select(label), label)
        if not np.all(all_labels == np.round(all_labels)) or all_labels.min() < 0:
            raise ValueError(
                f"logistic regression requires integer class labels 0..C-1, got {all_labels[:8]}"
            )
        n_classes = int(all_labels.max()) + 1
        if n_classes > _MAX_CLASSES:
            raise ValueError(
                f"labels imply {n_classes} classes (max label {int(all_labels.max())}), "
                f"over the supported cap of {_MAX_CLASSES} — the full-Newton Hessian is "
                "[C·d, C·d]. Check for mislabeled/ID-like rows, or re-encode labels "
                "densely as 0..C-1"
            )
        d = n + 1 if fit_intercept else n
        n_params = d if n_classes <= 2 else n_classes * d
        shapes = {"hess": (n_params, n_params), "grad": (n_params,), "loss": (), "count": ()}
        w, start_iter, ckpt = _resume_newton_checkpoint(checkpoint_dir, n_params)
        label_trace = "logreg newton" if n_classes <= 2 else "softmax newton"
        with trace_range(label_trace, self.device):
            for it in range(start_iter, self.getMaxIter()):
                if n_classes <= 2:
                    fn = arrow_fns.make_logreg_newton_partition_fn(
                        feats, label, w, fit_intercept=fit_intercept, weight_col=weight_col,
                        device=self.device.type)
                else:
                    fn = arrow_fns.SoftmaxNewtonPartitionFn(
                        feats, label, w, n_classes, fit_intercept=fit_intercept,
                        weight_col=weight_col, device=self.device.type)
                arrays = _collect_stats(selected, fn, list(shapes), shapes)
                _check_weights(arrays, weight_col)
                w_dev, step_norm = self.newton_step(w, arrays, n_classes)
                w = w_dev.cpu().numpy()
                if _newton_step_bookkeeping(
                    w_dev, step_norm, tol=self.getTol(), ckpt=ckpt, it=it,
                    checkpoint_every=checkpoint_every, loss=float(arrays["loss"]),
                ):
                    break
        return self._model_from_params(w, n_classes, fit_intercept)

    def newton_step(self, w: np.ndarray, arrays: dict, n_classes: int):
        """The driver half of one iteration: the merged statistics (f32 on
        the device, as the core fit reduces them) and the f64 parameters
        through ``newton_update`` (binary) or ``softmax_newton_update``;
        returns (new parameters on the device, step norm)."""
        wd = torch.as_tensor(np.asarray(w, dtype=np.float64), device=self.device)
        reg = dict(reg_param=self.getRegParam(), elastic_net_param=self.getElasticNetParam(),
                   fit_intercept=self.getFitIntercept())
        if n_classes <= 2:
            stats = LIN.NewtonStats(*_on_device(arrays, LIN.NewtonStats._fields, self.device))
            return LIN.newton_update(wd, stats, **reg)
        stats = LIN.SoftmaxStats(*_on_device(arrays, LIN.SoftmaxStats._fields, self.device))
        return LIN.softmax_newton_update(wd, stats, n_classes, **reg)

    def _model_from_params(self, w: np.ndarray, n_classes: int, fit_intercept: bool):
        """The fitted parameters as a model: [d] binary, flattened [C·d]
        multinomial."""
        if n_classes <= 2:
            coef, intercept = (w[:-1], float(w[-1])) if fit_intercept else (w, 0.0)
            model = SparkLogisticRegressionModel(uid=self.uid, coefficients=coef,
                                                 intercept=intercept, device=self.device)
        else:
            w_mat = np.asarray(w).reshape(n_classes, -1)
            coef_matrix, intercepts = ((w_mat[:, :-1], w_mat[:, -1]) if fit_intercept
                                       else (w_mat, np.zeros(n_classes)))
            model = SparkLogisticRegressionModel(
                uid=self.uid, coefficientMatrix=coef_matrix, interceptVector=intercepts,
                device=self.device)
        return self._copyValues(model)

    @staticmethod
    def _scan_labels(label_df, label: str) -> np.ndarray:
        T, _ = _sql_mods(label_df)
        return _run_pass(label_df, arrow_fns.LabelScanPartitionFn(label),
                         _spark_arrays_type(T, ["labels"]),
                         arrow_fns.labels_from_batches, arrow_fns.labels_from_rows)


class SparkLogisticRegressionModel(LogisticRegressionModel):
    def transform(self, dataset: Any) -> Any:
        if not _is_spark_df(dataset):
            return super().transform(dataset)
        proba_col = self.getProbabilityCol()
        pred_col = self.getOrDefault("predictionCol")
        if not proba_col:
            return _spark_transform(self, dataset, self._predict_matrix, pred_col, scalar=True)
        T, _ = _sql_mods(dataset)
        fn = arrow_fns.ProbaPredictionPartitionFn(
            _resolve_input_col(self), proba_col, pred_col, self.proba_and_predictions,
            device=_device_str(self))
        with trace_range("logreg transform"):
            return _spark_append(dataset, fn, [(proba_col, T.ArrayType(T.DoubleType())),
                                               (pred_col, T.DoubleType())])


class SparkLinearSVC(_HasDistribution, LinearSVC):
    """LinearSVC over a DataFrame on driver-merge: (features, label,
    weight) collected through the bounded chunker, then the core
    squared-hinge Newton loop."""

    _ALLOWED_DISTRIBUTIONS = ("driver-merge", "mesh-local")

    def fit(self, dataset: Any, num_partitions: int | None = None, **kwargs):
        checkpoint_dir, checkpoint_every = _parse_checkpoint_kwargs(kwargs, 5)
        if not _is_spark_df(dataset):
            core = super().fit(dataset, num_partitions, checkpoint_dir=checkpoint_dir,
                               checkpoint_every=checkpoint_every)
            return _as_spark(core, SparkLinearSVCModel)
        self._check_distribution()
        x, y, w = _collect_xyw(dataset, self.getOrDefault("featuresCol"),
                               label_col=self.getOrDefault("labelCol"),
                               weight_col=self._paramMap.get("weightCol"))
        core = LinearSVC.fit(self, (x, y) if w is None else (x, y, w),
                             checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every)
        return _as_spark(core, SparkLinearSVCModel)


class SparkLinearSVCModel(LinearSVCModel):
    def transform(self, dataset: Any) -> Any:
        if not _is_spark_df(dataset):
            return super().transform(dataset)
        T, _ = _sql_mods(dataset)
        raw, pred = self.getOrDefault("rawPredictionCol"), self.getOrDefault("predictionCol")

        def matrix_fn(mat, _m=self):
            m = _m.margins(mat)
            return np.stack([-m, m], axis=1), (m > _m.getThreshold()).astype(np.float64)

        fn = arrow_fns.MultiOutputPartitionFn(
            self.getOrDefault("featuresCol"), [(raw, np.float64), (pred, np.float64)],
            matrix_fn, device=_device_str(self))
        with trace_range("svc transform"):
            return _spark_append(dataset, fn, [(raw, T.ArrayType(T.DoubleType())),
                                               (pred, T.DoubleType())])


# -- KMeans ----------------------------------------------------------------------


class SparkKMeans(_HasDistribution, KMeans):
    """KMeans over a DataFrame on driver-merge. Seeding: k-means‖ as jobs
    (per round a cost job and a Bernoulli sampling job, then a weighting
    job and a weighted k-means++ on the driver's device), or k-means++ /
    random on a bounded random sample. Then Lloyd as one
    ``KMeansPartitionFn`` job per iteration, the centres in the task state;
    ``checkpoint_dir`` saves between jobs and a killed fit resumes."""

    _ALLOWED_DISTRIBUTIONS = ("driver-merge", "mesh-barrier", "mesh-local")

    _INIT_SAMPLE = 4096

    def fit(self, dataset: Any, num_partitions: int | None = None, **kwargs):
        if not _is_spark_df(dataset):
            return _as_spark(super().fit(dataset, num_partitions, **kwargs), SparkKMeansModel)
        checkpoint_dir, checkpoint_every = _parse_checkpoint_kwargs(kwargs, 1)
        self._check_distribution()
        _, F = _sql_mods(dataset)
        input_col = _resolve_col(self, "inputCol") or "features"
        weight_col = self._paramMap.get("weightCol")
        selected = dataset.select(*([input_col] + ([weight_col] if weight_col else [])))
        k = self.getK()
        # resume before seeding: a killed fit pointed at the same directory
        # continues mid-Lloyd (the core fit's layout and helper)
        centers, start_iter, cost0, ckpt = _resume_kmeans_checkpoint(checkpoint_dir, k)
        if centers is not None:
            n_data = _infer_n(dataset, input_col)
            if centers.shape[1] != n_data:
                raise ValueError(
                    f"checkpoint centers have {centers.shape[1]} features but the dataset "
                    f"has {n_data}; is checkpoint_dir stale?"
                )
        else:
            with trace_range("kmeans init", self.device):
                if self.getInitMode() == "k-means||":
                    centers = self._kmeans_parallel_init_df(selected, input_col, weight_col, k)
                else:
                    centers = self._sample_init(selected, F, weight_col, k)
        return self._lloyd_df(selected, input_col, weight_col, centers, ckpt=ckpt,
                              checkpoint_every=checkpoint_every, start_iter=start_iter,
                              cost0=cost0)

    def _sample_init(self, selected, F, weight_col, k: int) -> np.ndarray:
        """k-means++ or random seeds from a random sample of at most
        ``_INIT_SAMPLE`` positive-weight rows (``df.sample``, not ``limit``,
        which would take the first rows in plan order)."""
        seed_df = selected.where(F.col(weight_col) > 0) if weight_col else selected
        total = seed_df.count()
        if total > self._INIT_SAMPLE:
            fraction = min(1.0, 2.0 * self._INIT_SAMPLE / total)
            sample_rows = seed_df.sample(fraction=fraction, seed=self.getSeed()).collect()
            if len(sample_rows) > self._INIT_SAMPLE:
                rng = np.random.default_rng(self.getSeed())
                keep = rng.choice(len(sample_rows), self._INIT_SAMPLE, replace=False)
                sample_rows = [sample_rows[i] for i in keep]
            elif len(sample_rows) < k:
                sample_rows = seed_df.limit(self._INIT_SAMPLE).collect()
        else:
            sample_rows = seed_df.collect()
        if len(sample_rows) < k:
            raise ValueError(
                f"k={k} but only {len(sample_rows)} rows with positive weight were found "
                "to seed centers from"
            )
        sample = np.stack([columnar.row_vector_to_ndarray(r[0]) for r in sample_rows])
        if self.getInitMode() == "random":
            rng = np.random.default_rng(self.getSeed())
            return sample[rng.choice(len(sample), k, replace=False)]
        return KM.kmeans_plus_plus_init(
            self._generator(), to_device(sample, self.device), k).cpu().numpy()

    def _lloyd_df(self, selected, input_col: str, weight_col: str | None, centers: np.ndarray,
                  *, ckpt=None, checkpoint_every: int = 1, start_iter: int = 0,
                  cost0: float = np.inf) -> "SparkKMeansModel":
        """Lloyd over jobs: one ``KMeansPartitionFn`` stats job an
        iteration, the merged statistics through ``lloyd_step``; with
        ``ckpt``, a durable checkpoint between jobs. ``cost0`` is the
        checkpointed cost, so a resume at maxIter still reports it."""
        k, n = centers.shape
        shapes = {"sums": (k, n), "counts": (k,), "cost": ()}
        tol_sq = self.getTol() ** 2
        cost = cost0
        with trace_range("kmeans lloyd", self.device):
            for it in range(start_iter, self.getMaxIter()):
                fn = arrow_fns.make_kmeans_partition_fn(input_col, centers, weight_col,
                                                        device=self.device.type)
                arrays = _collect_stats(selected, fn, list(shapes), shapes)
                _check_weights(arrays, weight_col, "counts")
                centers, cost, shift = self.lloyd_step(centers, arrays)
                if ckpt is not None and (it + 1) % checkpoint_every == 0:
                    ckpt.save(it, {"centers": centers}, {"cost": cost})
                if shift <= tol_sq:
                    break
        model = SparkKMeansModel(uid=self.uid, clusterCenters=centers, trainingCost=cost,
                                 device=self.device)
        return self._copyValues(model)

    def lloyd_step(self, centers: np.ndarray, arrays: dict) -> tuple[np.ndarray, float, float]:
        """The driver half of one Lloyd iteration: the merged f64
        ``KMeansStats`` (f32 on the device, as the core fit reduces them)
        to (new centres on the host, cost, largest squared centre shift)."""
        stats = KM.KMeansStats(*_on_device(arrays, KM.KMeansStats._fields, self.device))
        old = to_device(centers, self.device)
        new = KM.update_centers(stats, old)
        return new.cpu().numpy(), float(stats.cost), float(KM.center_shift_sq(old, new))

    def reduce_candidates(self, candidates: np.ndarray, counts: np.ndarray, k: int) -> np.ndarray:
        """The driver half of k-means‖'s end: weighted k-means++ over the
        candidates (weights: the rows each owns) on the estimator's
        device."""
        return KM.weighted_kmeans_plus_plus_init(
            self._generator(), to_device(candidates, self.device),
            torch.as_tensor(counts, dtype=torch.float32, device=self.device), k,
        ).cpu().numpy()

    def _kmeans_parallel_init_df(self, selected, input_col: str, weight_col: str | None,
                                 k: int) -> np.ndarray:
        """k-means‖ over jobs (Bahmani et al.): per round a cost job (φ,
        ``KMeansAssignStatsFn``) and an oversampling job (ℓ = 2k expected
        candidates, ``KMeansParallelSampleFn``), the candidates collected
        on the driver; then a weighting job and ``reduce_candidates``."""
        T, F = _sql_mods(selected)
        ell = 2.0 * k
        seed = self.getSeed()
        # zero-weight rows are excluded instances and never become candidates
        seedable = selected.where(F.col(weight_col) > 0) if weight_col else selected
        # the first candidate from a small random sample (.first() alone would
        # take plan order)
        probe = seedable.sample(fraction=0.05, seed=seed).first() or seedable.first()
        if probe is None:
            raise ValueError("no rows with positive weight to seed from")
        candidates = columnar.row_vector_to_ndarray(probe[0])[None, :].astype(np.float64)
        assign_schema = _spark_arrays_type(T, ["counts", "cost"])

        def assign(cands):
            shapes = {"counts": (len(cands),), "cost": ()}
            return _run_pass(
                selected,
                arrow_fns.KMeansAssignStatsFn(input_col, cands, weight_col,
                                              device=self.device.type),
                assign_schema,
                lambda b: arrow_fns.arrays_from_batches(b, shapes),
                lambda r: arrow_fns.arrays_from_rows(r, shapes),
            )

        cand_schema = T.StructType([T.StructField("candidate", T.ArrayType(T.DoubleType()))])
        for step in range(self.getInitSteps()):
            phi = float(assign(candidates)["cost"])
            if phi <= 0.0:  # every (weighted) row coincides with a candidate
                break
            new = _run_pass(
                selected,
                arrow_fns.KMeansParallelSampleFn(input_col, candidates, ell / phi,
                                                 seed + step + 1, weight_col,
                                                 device=self.device.type),
                cand_schema, arrow_fns.candidates_from_batches, arrow_fns.candidates_from_rows,
            )
            if new.size:
                candidates = np.concatenate([candidates, new], axis=0)

        if len(candidates) <= k:
            # degenerate oversampling: top up from a bounded uniform sample
            extra = seedable.sample(fraction=min(1.0, (4.0 * k) / max(seedable.count(), 1)),
                                    seed=seed).collect()
            pool = (np.stack([columnar.row_vector_to_ndarray(r[0]) for r in extra]) if extra
                    else np.zeros((0, candidates.shape[1])))
            need = k - len(candidates)
            if need > 0:
                if len(pool) < need:
                    raise ValueError(
                        f"k={k} but only {len(candidates) + len(pool)} candidate rows "
                        "could be drawn"
                    )
                rng = np.random.default_rng(seed)
                candidates = np.concatenate(
                    [candidates, pool[rng.choice(len(pool), need, replace=False)]])
            return candidates[:k]
        return self.reduce_candidates(candidates, assign(candidates)["counts"], k)


class SparkKMeansModel(KMeansModel):
    def transform(self, dataset: Any) -> Any:
        if not _is_spark_df(dataset):
            return super().transform(dataset)
        return _spark_transform(self, dataset, self._predict_matrix, self.getOutputCol(),
                                scalar=True)

    def computeCost(self, dataset: Any) -> float:
        """Σ squared distance to the nearest centre; over a DataFrame one
        ``KMeansAssignStatsFn`` job, only a scalar row reaching the
        driver."""
        if not _is_spark_df(dataset):
            return super().computeCost(dataset)
        input_col = _resolve_col(self, "inputCol") or "features"
        shapes = {"counts": (len(self.clusterCenters),), "cost": ()}
        fn = arrow_fns.KMeansAssignStatsFn(input_col, self.clusterCenters,
                                           device=self.device.type)
        try:
            arrays = _collect_stats(dataset.select(input_col), fn, list(shapes), shapes)
        except ValueError as e:
            if "no partition statistics" in str(e):
                return 0.0  # every partition empty: the core path's answer
            raise
        return float(arrays["cost"])


# -- the scalers and selectors -------------------------------------------------


def _collect_range_stats(est, dataset) -> dict:
    """The range pass of MinMax / MaxAbs / Robust / QuantileDiscretizer:
    one ``RangeStatsPartitionFn`` job, merged by min / max on the driver
    (f64 host arrays)."""
    input_col = _resolve_col(est, "inputCol") or "features"
    n = _infer_n(dataset, input_col)
    with trace_range("scaler range stats", est.device):
        return _collect_stats(
            dataset.select(input_col),
            arrow_fns.make_range_stats_partition_fn(input_col, device=est.device.type),
            arrow_fns.RANGE_STATS_FIELDS, arrow_fns.range_stats_shapes(n),
            combine=arrow_fns.RANGE_COMBINE,
        )


def _collect_histogram(est, dataset, mins, maxs, bins: int, missing=None) -> np.ndarray:
    """The quantile sketch's second pass: one ``HistogramPartitionFn`` job
    over the driver's [mins, maxs], summed on the driver."""
    input_col = _resolve_col(est, "inputCol") or "features"
    n = len(mins)
    with trace_range("quantile sketch histogram", est.device):
        return _collect_stats(
            dataset.select(input_col),
            arrow_fns.HistogramPartitionFn(input_col, mins, maxs, bins, missing=missing,
                                           device=est.device.type),
            ["hist"], {"hist": (n, bins)},
        )["hist"]


def _quantiles_on(device, hist: np.ndarray, mins, maxs, qs) -> np.ndarray:
    """[len(qs), n] quantiles of a merged histogram on ``device``, the
    bounds in f32 as the partitions binned with them."""
    return scaler_mod._quantiles(
        torch.as_tensor(hist, device=device),
        *(torch.as_tensor(np.asarray(v), dtype=torch.float32, device=device)
          for v in (mins, maxs)),
        qs,
    )


class SparkStandardScaler(_HasDistribution, StandardScaler):
    """StandardScaler over a DataFrame: one ``MomentsPartitionFn`` job, the
    moments merged on the driver and finished on the estimator's device."""

    _ALLOWED_DISTRIBUTIONS = ("driver-merge", "mesh-barrier", "mesh-local")

    def fit(self, dataset: Any, num_partitions: int | None = None):
        if not _is_spark_df(dataset):
            return _as_spark(super().fit(dataset, num_partitions), SparkStandardScalerModel)
        self._check_distribution()
        input_col = _resolve_col(self, "inputCol") or "features"
        n = _infer_n(dataset, input_col)
        shapes = {"count": (), "total": (n,), "total_sq": (n,)}
        with trace_range("scaler moments", self.device):
            arrays = _collect_stats(
                dataset.select(input_col),
                arrow_fns.make_moments_partition_fn(input_col, device=self.device.type),
                list(shapes), shapes,
            )
        mean, std = self.moments_merged(arrays)
        model = SparkStandardScalerModel(uid=self.uid, mean=mean, std=std, device=self.device)
        return self._copyValues(model)

    def moments_merged(self, arrays: dict) -> tuple[np.ndarray, np.ndarray]:
        """The driver half: (mean, sample std) of the merged moments."""
        stats = S.MomentStats(*_on_device(arrays, S.MomentStats._fields, self.device))
        mean, std = S.finalize_moments(stats)
        return mean.cpu().numpy(), std.cpu().numpy()


class SparkStandardScalerModel(StandardScalerModel):
    def transform(self, dataset: Any) -> Any:
        if not _is_spark_df(dataset):
            return super().transform(dataset)
        return _spark_transform(self, dataset, self._scale, self.getOutputCol(), scalar=False)


class SparkMinMaxScaler(_HasDistribution, MinMaxScaler):
    """MinMaxScaler over a DataFrame: one range job."""

    _ALLOWED_DISTRIBUTIONS = ("driver-merge", "mesh-local")

    def fit(self, dataset: Any, num_partitions: int | None = None):
        if not _is_spark_df(dataset):
            return _as_spark(super().fit(dataset, num_partitions), SparkMinMaxScalerModel)
        self._check_distribution()
        self._check_range()
        arrays = _collect_range_stats(self, dataset)
        model = SparkMinMaxScalerModel(uid=self.uid, originalMin=arrays["min"],
                                       originalMax=arrays["max"], device=self.device)
        return self._copyValues(model)


class SparkMinMaxScalerModel(MinMaxScalerModel):
    def transform(self, dataset: Any) -> Any:
        if not _is_spark_df(dataset):
            return super().transform(dataset)
        return _spark_transform(self, dataset, self._scale, self.getOutputCol(), scalar=False)


class SparkMaxAbsScaler(_HasDistribution, MaxAbsScaler):
    """MaxAbsScaler over a DataFrame: one range job."""

    _ALLOWED_DISTRIBUTIONS = ("driver-merge", "mesh-local")

    def fit(self, dataset: Any, num_partitions: int | None = None):
        if not _is_spark_df(dataset):
            return _as_spark(super().fit(dataset, num_partitions), SparkMaxAbsScalerModel)
        self._check_distribution()
        arrays = _collect_range_stats(self, dataset)
        model = SparkMaxAbsScalerModel(uid=self.uid, maxAbs=arrays["max_abs"],
                                       device=self.device)
        return self._copyValues(model)


class SparkMaxAbsScalerModel(MaxAbsScalerModel):
    def transform(self, dataset: Any) -> Any:
        if not _is_spark_df(dataset):
            return super().transform(dataset)
        return _spark_transform(self, dataset, self._scale, self.getOutputCol(), scalar=False)


class SparkRobustScaler(_HasDistribution, RobustScaler):
    """RobustScaler over a DataFrame: the range job, then the histogram job
    over its bounds; the median and the quantile range interpolate from the
    merged histogram (``robust_merged``)."""

    _ALLOWED_DISTRIBUTIONS = ("driver-merge", "mesh-local")

    def fit(self, dataset: Any, num_partitions: int | None = None):
        if not _is_spark_df(dataset):
            return _as_spark(super().fit(dataset, num_partitions), SparkRobustScalerModel)
        self._check_distribution()
        self._check_quantile_bounds()
        rstats = _collect_range_stats(self, dataset)
        hist = _collect_histogram(self, dataset, rstats["min"], rstats["max"],
                                  self.getNumBins())
        median, rng = self.robust_merged(rstats, hist)
        model = SparkRobustScalerModel(uid=self.uid, median=median, range=rng,
                                       device=self.device)
        return self._copyValues(model)

    def robust_merged(self, rstats: dict, hist: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """The driver half: (median, upper − lower quantile) of the merged
        histogram over the merged range."""
        median, lo, hi = _quantiles_on(self.device, hist, rstats["min"], rstats["max"],
                                       (0.5, self.getLower(), self.getUpper()))
        return median, hi - lo


class SparkRobustScalerModel(RobustScalerModel):
    def transform(self, dataset: Any) -> Any:
        if not _is_spark_df(dataset):
            return super().transform(dataset)
        return _spark_transform(self, dataset, self._scale, self.getOutputCol(), scalar=False)


class SparkImputer(_HasDistribution, Imputer):
    """Imputer over a DataFrame: ``mean`` is one NaN-aware moments job;
    ``median`` the NaN-aware range job and the histogram job with missing
    entries dropped."""

    _ALLOWED_DISTRIBUTIONS = ("driver-merge",)

    def fit(self, dataset: Any, num_partitions: int | None = None):
        if not _is_spark_df(dataset):
            return _as_spark(super().fit(dataset, num_partitions), SparkImputerModel)
        self._check_distribution()
        input_col = _resolve_col(self, "inputCol") or "features"
        n = _infer_n(dataset, input_col)
        missing = self.getMissingValue()
        selected = dataset.select(input_col)
        with trace_range("imputer fit", self.device):
            if self.getStrategy() == "mean":
                arrays = _collect_stats(
                    selected,
                    arrow_fns.NanMomentsPartitionFn(input_col, missing, device=self.device.type),
                    ["count", "total"], {"count": (n,), "total": (n,)},
                )
                surrogate = self.surrogate_from_moments(arrays)
            else:
                rstats = _collect_stats(
                    selected,
                    arrow_fns.NanRangePartitionFn(input_col, missing, device=self.device.type),
                    list(S.NanRangeStats._fields), {f: (n,) for f in S.NanRangeStats._fields},
                    combine=arrow_fns.RANGE_COMBINE,
                )
                mins, maxs = self.finite_bounds(rstats)
                hist = _collect_histogram(self, dataset, mins, maxs, self.getNumBins(),
                                          missing=missing)
                surrogate = self.surrogate_from_histogram(rstats, hist)
        model = SparkImputerModel(uid=self.uid, surrogate=surrogate, device=self.device)
        return self._copyValues(model)

    @staticmethod
    def surrogate_from_moments(arrays: dict) -> np.ndarray:
        """The driver half of ``mean``: Σ valid / count, 0 for an empty
        feature."""
        count = arrays["count"]
        return scaler_mod._apply_empty_surrogate(count, arrays["total"] / np.maximum(count, 1.0))

    @staticmethod
    def finite_bounds(rstats: dict) -> tuple[np.ndarray, np.ndarray]:
        """The histogram's bounds: an all-missing feature's ±inf become 0."""
        return tuple(np.where(np.isfinite(rstats[f]), rstats[f], 0.0) for f in ("min", "max"))

    def surrogate_from_histogram(self, rstats: dict, hist: np.ndarray) -> np.ndarray:
        """The driver half of ``median``: the merged histogram's median."""
        mins, maxs = self.finite_bounds(rstats)
        (median,) = _quantiles_on(self.device, hist, mins, maxs, (0.5,))
        return scaler_mod._apply_empty_surrogate(rstats["count"], median)


class SparkImputerModel(ImputerModel):
    def transform(self, dataset: Any) -> Any:
        if not _is_spark_df(dataset):
            return super().transform(dataset)
        return _spark_transform(self, dataset, self._fill, self.getOutputCol(), scalar=False)


class SparkVarianceThresholdSelector(_HasDistribution, VarianceThresholdSelector):
    """VarianceThresholdSelector over a DataFrame: one moments job (the
    statistic SparkStandardScaler reduces)."""

    _ALLOWED_DISTRIBUTIONS = ("driver-merge",)

    def fit(self, dataset: Any, num_partitions: int | None = None):
        if not _is_spark_df(dataset):
            return _as_spark(super().fit(dataset, num_partitions),
                             SparkVarianceThresholdSelectorModel)
        self._check_distribution()
        features_col = _resolve_col(self, "featuresCol") or "features"
        n = _infer_n(dataset, features_col)
        shapes = {"count": (), "total": (n,), "total_sq": (n,)}
        with trace_range("variance selector fit", self.device):
            arrays = _collect_stats(
                dataset.select(features_col),
                arrow_fns.make_moments_partition_fn(features_col, device=self.device.type),
                list(shapes), shapes,
            )
            stats = S.MomentStats(*_on_device(arrays, S.MomentStats._fields, self.device))
            _, std = S.finalize_moments(stats)
        selected = select_by_variance(std.cpu().numpy() ** 2, self.getVarianceThreshold())
        model = SparkVarianceThresholdSelectorModel(uid=self.uid, selectedFeatures=selected,
                                                    device=self.device)
        return self._copyValues(model)


class SparkVarianceThresholdSelectorModel(VarianceThresholdSelectorModel):
    def transform(self, dataset: Any) -> Any:
        if not _is_spark_df(dataset):
            return super().transform(dataset)
        return _spark_transform(self, dataset, self._select, self.getOutputCol(), scalar=False)


class SparkQuantileDiscretizer(_HasDistribution, QuantileDiscretizer):
    """QuantileDiscretizer over a DataFrame: the range job, then the
    histogram job; the split grid resolves on the driver."""

    _ALLOWED_DISTRIBUTIONS = ("driver-merge", "mesh-local")

    def fit(self, dataset: Any, num_partitions: int | None = None):
        if not _is_spark_df(dataset):
            return _as_spark(super().fit(dataset, num_partitions),
                             SparkQuantileDiscretizerModel)
        self._check_distribution()
        rstats = _collect_range_stats(self, dataset)
        check_finite_range(rstats["min"], rstats["max"])
        hist = _collect_histogram(self, dataset, rstats["min"], rstats["max"],
                                  self.getNumBins())
        bounds = (torch.as_tensor(rstats[f], dtype=torch.float32, device=self.device)
                  for f in ("min", "max"))
        splits = splits_from_histogram(torch.as_tensor(hist, device=self.device), *bounds,
                                       self.getNumBuckets())
        model = SparkQuantileDiscretizerModel(uid=self.uid, splits=splits, device=self.device)
        return self._copyValues(model)


class SparkQuantileDiscretizerModel(QuantileDiscretizerModel):
    def transform(self, dataset: Any) -> Any:
        if not _is_spark_df(dataset):
            return super().transform(dataset)
        return _spark_transform(self, dataset, self._bucket, self.getOutputCol(), scalar=False)


# -- TruncatedSVD ------------------------------------------------------------------


class SparkTruncatedSVD(_HasDistribution, TruncatedSVD):
    """TruncatedSVD over a DataFrame on driver-merge: solver ``"svd"`` is
    one R-factor job (``QRPartitionFn``, merged by a ``combine_r`` tree);
    the others one Gram job (``FitPartitionFn``: ``fused_gram_moments`` per
    batch at ``"high"``), decomposed on the estimator's device."""

    _ALLOWED_DISTRIBUTIONS = ("driver-merge", "mesh-barrier", "mesh-local")

    def fit(self, dataset: Any, num_partitions: int | None = None):
        if not _is_spark_df(dataset):
            return _as_spark(super().fit(dataset, num_partitions), SparkTruncatedSVDModel)
        self._check_distribution()
        T, _ = _sql_mods(dataset)
        input_col = _resolve_col(self, "inputCol") or "features"
        selected = dataset.select(input_col)
        n = _infer_n(dataset, input_col)
        k = self.getK()
        if k > n:
            raise ValueError(f"k={k} must be <= number of features {n}")
        solver = self.getOrDefault("solver")
        with trace_range("tsvd reduce", self.device):
            if solver == "svd":
                reduced = _run_pass(
                    selected, arrow_fns.QRPartitionFn(input_col, device=self.device.type),
                    _spark_arrays_type(T, ["r"]),
                    lambda b: arrow_fns.r_from_batches(b, n, self.device),
                    lambda r: arrow_fns.r_from_rows(r, n, self.device),
                )
            else:
                fn = arrow_fns.make_fit_partition_fn(
                    input_col, precision=self.getOrDefault("precision"),
                    device=self.device.type)
                reduced = _collect_stats(selected, fn, ["xtx", "col_sum", "count"],
                                         {"xtx": (n, n), "col_sum": (n,), "count": ()})["xtx"]
        components, sv = self.decompose_merged(reduced, k, solver)
        model = SparkTruncatedSVDModel(uid=self.uid, components=components,
                                       singularValues=sv, device=self.device)
        return self._copyValues(model)

    def decompose_merged(self, reduced, k: int, solver: str) -> tuple[np.ndarray, np.ndarray]:
        """The driver half: the merged R factor (solver ``"svd"``, on the
        device) or the merged f64 Gram (f32 on the device, as the core fit
        sums it) decomposed into (components [n, k], σ [k])."""
        with trace_range("tsvd decompose", self.device):
            if solver == "svd":
                components, s = L.svd_components_from_r(reduced, k)
            else:
                gram = torch.as_tensor(np.asarray(reduced), dtype=torch.float32,
                                       device=self.device)
                components, s = tsvd_mod._decompose_gram(gram, k, solver)
        return components.cpu().numpy(), s[:k].cpu().numpy()


class SparkTruncatedSVDModel(TruncatedSVDModel):
    def transform(self, dataset: Any) -> Any:
        if not _is_spark_df(dataset):
            return super().transform(dataset)
        return _spark_transform(self, dataset, self._project_matrix, self.getOutputCol(),
                                scalar=False)


# -- the stateless transformers ------------------------------------------------------


def _stateless(core, matrix_method: str, required: str | None = None):
    """A stateless stage's Spark subclass: over a DataFrame its transform is
    one mapInArrow pass of the local path's matrix function."""

    def transform(self, dataset: Any) -> Any:
        if not _is_spark_df(dataset):
            return core.transform(self, dataset)
        if required is not None and not self.isSet(required):
            raise ValueError(f"{required} must be set before transform")
        return _spark_transform(self, dataset, getattr(self, matrix_method),
                                self.getOutputCol(), scalar=False)

    doc = f"{core.__name__} over a DataFrame as well: one mapInArrow pass of ``{matrix_method}``."
    return type(f"Spark{core.__name__}", (core,),
                {"transform": transform, "__doc__": doc, "__module__": __name__})


SparkBinarizer = _stateless(Binarizer, "_binarize")
SparkDCT = _stateless(DCT, "_apply_dct")
SparkElementwiseProduct = _stateless(ElementwiseProduct, "_product", "scalingVec")
SparkPolynomialExpansion = _stateless(PolynomialExpansion, "_expand")
SparkVectorSlicer = _stateless(VectorSlicer, "_slice", "indices")
SparkBucketizer = _stateless(Bucketizer, "_bucket", "splits")
SparkNormalizer = _stateless(Normalizer, "_normalize_matrix")


# -- neighbours and DBSCAN ---------------------------------------------------------


def _knn_collect_items(est, dataset):
    """(items, ids) of a DataFrame: the fit-side collection of both k-NN
    estimators (k bounded by the item count, positional default ids,
    integral ids as int64)."""
    feats = _resolve_col(est, "inputCol") or "features"
    items, ids, _ = _collect_xyw(dataset, feats, label_col=est._paramMap.get("idCol"))
    if items.shape[0] < est.getK():
        raise ValueError(f"k={est.getK()} exceeds the fitted item count {items.shape[0]}")
    if ids is None:
        ids = np.arange(items.shape[0], dtype=np.int64)
    elif np.all(ids == np.round(ids)):
        ids = ids.astype(np.int64)
    return items, ids


def _knn_spark_kneighbors(model, dataset, kk: int, trace_label: str):
    """The query side of both k-NN models: ``indices`` and ``distances``
    appended per batch, the indices' type following the fitted ids'
    (the declared schema and the worker's cast must agree)."""
    T, _ = _sql_mods(dataset)
    int_ids = np.issubdtype(model.itemIds.dtype, np.integer)

    def matrix_fn(mat, _m=model, _k=kk):
        d, i = _m._kneighbors_matrix(mat, _k)
        return i, d

    fn = arrow_fns.MultiOutputPartitionFn(
        _resolve_col(model, "inputCol") or "features",
        [("indices", np.int64 if int_ids else np.float64), ("distances", np.float64)],
        matrix_fn, device=_device_str(model),
    )
    with trace_range(trace_label):
        return _spark_append(dataset, fn, [
            ("indices", T.ArrayType(T.LongType() if int_ids else T.DoubleType())),
            ("distances", T.ArrayType(T.DoubleType())),
        ])


class SparkNearestNeighbors(NearestNeighbors):
    """Exact k-NN over a DataFrame: ``fit`` collects the item set into the
    model; the query side is an embarrassingly parallel mapInArrow pass
    with the items shipped in the plan function."""

    def fit(self, dataset: Any, num_partitions: int | None = None):
        if not _is_spark_df(dataset):
            return _as_spark(super().fit(dataset, num_partitions), SparkNearestNeighborsModel)
        items, ids = _knn_collect_items(self, dataset)
        model = SparkNearestNeighborsModel(uid=self.uid, items=items, itemIds=ids,
                                           device=self.device)
        return self._copyValues(model)


class SparkNearestNeighborsModel(NearestNeighborsModel):
    def kneighbors(self, dataset: Any, k: int | None = None):
        """A DataFrame gets ``indices`` (item ids) and ``distances``
        appended; other inputs keep the core (distances, ids) contract."""
        if not _is_spark_df(dataset):
            return super().kneighbors(dataset, k)
        return _knn_spark_kneighbors(self, dataset, self.getK() if k is None else k,
                                     "knn spark transform")

    def transform(self, dataset: Any) -> Any:
        if not _is_spark_df(dataset):
            return super().transform(dataset)
        return self.kneighbors(dataset)


class SparkApproximateNearestNeighbors(ApproximateNearestNeighbors):
    """IVF-Flat ANN over a DataFrame: ``fit`` collects the items and builds
    the index on the driver's device; queries as SparkNearestNeighbors'."""

    def fit(self, dataset: Any, num_partitions: int | None = None):
        if not _is_spark_df(dataset):
            core = super().fit(dataset, num_partitions)
        else:
            core = self._fit_items(*_knn_collect_items(self, dataset))
        return _as_spark(core, SparkApproximateNearestNeighborsModel)


class SparkApproximateNearestNeighborsModel(ApproximateNearestNeighborsModel):
    def kneighbors(self, dataset: Any, k: int | None = None):
        if not _is_spark_df(dataset):
            return super().kneighbors(dataset, k)
        return _knn_spark_kneighbors(self, dataset, self.getK() if k is None else k,
                                     "ann spark transform")

    def transform(self, dataset: Any) -> Any:
        if not _is_spark_df(dataset):
            return super().transform(dataset)
        return self.kneighbors(dataset)


class SparkDBSCAN(DBSCAN):
    """DBSCAN over a DataFrame: see ``SparkDBSCANModel``."""

    def fit(self, dataset: Any = None) -> "SparkDBSCANModel":
        return self._copyValues(SparkDBSCANModel(uid=self.uid, device=self.device))


class SparkDBSCANModel(DBSCANModel):
    """Density clustering needs every pairwise relation, so over a
    DataFrame it collects the rows to the driver once and labels them on
    the model's device (the core kernel); the prediction column comes back
    appended in row order."""

    def clusterLabels(self, dataset: Any) -> np.ndarray:
        if not _is_spark_df(dataset):
            return super().clusterLabels(dataset)
        return self._collect_and_cluster(dataset)[1]

    def _collect_and_cluster(self, dataset):
        """One collect feeds the clustering and the output table (a second
        one could return the rows in another order)."""
        feats = _resolve_col(self, "inputCol") or "features"
        weight_col = self._paramMap.get("weightCol")
        table = dataset.toArrow() if hasattr(dataset, "_parts") else dataset.toPandas()
        x = columnar.extract_matrix(table, feats)
        w = None
        if weight_col is not None:
            w = columnar.validate_weights(columnar.extract_vector(table, weight_col), x.shape[0])
        with trace_range("dbscan spark cluster", self.device):
            return table, self._cluster_matrix(x, w)

    def transform(self, dataset: Any) -> Any:
        if not _is_spark_df(dataset):
            return super().transform(dataset)
        table, labels = self._collect_and_cluster(dataset)
        session = getattr(dataset, "sparkSession", None) or dataset._session
        if hasattr(dataset, "_parts"):
            import pyarrow as pa

            table = table.append_column(self.getPredictionCol(),
                                        pa.array(labels, type=pa.int32()))
        else:
            table[self.getPredictionCol()] = labels
        return session.createDataFrame(table)


# -- the collect-and-fit families ------------------------------------------------------


class _CollectFit:
    """A supervised family whose DataFrame fit collects (features, label[,
    weight]) on the driver and runs the core fit: boosting, the fleets, the
    optimizers and the layouts are global or sequential. ``_spark_model``
    is the Spark model class; ``_weighted`` whether weightCol travels."""

    _spark_model: type
    _weighted = True

    def fit(self, dataset: Any, num_partitions: int | None = None):
        if hasattr(self, "_check_distribution") and _is_spark_df(dataset):
            self._check_distribution()
        if not _is_spark_df(dataset):
            core = super().fit(dataset, num_partitions)
        else:
            core = _collect_fit_wrap(self, dataset, lambda m: m,
                                     lambda data: super(_CollectFit, self).fit(data),
                                     weighted=self._weighted)
        return _as_spark(core, self._spark_model)


class SparkRandomForestClassificationModel(RandomForestClassificationModel):
    def transform(self, dataset: Any) -> Any:
        if not _is_spark_df(dataset):
            return super().transform(dataset)

        def matrix_fn(mat, _m=self, _t=len(self.trees.feature)):
            proba, pred = _m.proba_and_predictions(mat)
            return proba * _t, proba, pred

        return _classifier_columns_transform(self, dataset, matrix_fn, "rf transform")


class SparkRandomForestClassifier(_CollectFit, _HasDistribution, RandomForestClassifier):
    """RandomForestClassifier over a DataFrame: collected, then the core
    build on the driver's device."""

    _ALLOWED_DISTRIBUTIONS = ("driver-merge", "mesh-local")
    _spark_model = SparkRandomForestClassificationModel


class SparkRandomForestRegressionModel(RandomForestRegressionModel):
    def transform(self, dataset: Any) -> Any:
        if not _is_spark_df(dataset):
            return super().transform(dataset)
        return _spark_transform(self, dataset, self._predict_matrix,
                                self.getOrDefault("predictionCol"), scalar=True)


class SparkRandomForestRegressor(_CollectFit, _HasDistribution, RandomForestRegressor):
    """RandomForestRegressor over a DataFrame, as the classifier."""

    _ALLOWED_DISTRIBUTIONS = ("driver-merge", "mesh-local")
    _spark_model = SparkRandomForestRegressionModel


class SparkGBTClassificationModel(GBTClassificationModel):
    def transform(self, dataset: Any) -> Any:
        if not _is_spark_df(dataset):
            return super().transform(dataset)

        def matrix_fn(mat, _m=self):
            return _m._outputs(_m._margins(mat))

        return _classifier_columns_transform(self, dataset, matrix_fn, "gbt transform")


class SparkGBTClassifier(_CollectFit, GBTClassifier):
    """GBTClassifier over a DataFrame: boosting is sequential, so the rows
    are collected and boosted on the driver's device; the transform is a
    mapInArrow pass."""

    _spark_model = SparkGBTClassificationModel


class SparkGBTRegressionModel(GBTRegressionModel):
    def transform(self, dataset: Any) -> Any:
        if not _is_spark_df(dataset):
            return super().transform(dataset)
        return _spark_transform(self, dataset, self._predict_matrix,
                                self.getOrDefault("predictionCol"), scalar=True)


class SparkGBTRegressor(_CollectFit, GBTRegressor):
    """GBTRegressor over a DataFrame, as SparkGBTClassifier."""

    _spark_model = SparkGBTRegressionModel


class SparkOneVsRestModel(OneVsRestModel):
    def transform(self, dataset: Any) -> Any:
        if not _is_spark_df(dataset):
            return super().transform(dataset)
        return _spark_transform(self, dataset, self._predict_matrix,
                                self.getOrDefault("predictionCol"), scalar=True)


class SparkOneVsRest(OneVsRest):
    """OneVsRest over a DataFrame: (features, label) collected, the
    per-class fleet trained on the driver by the wrapped classifier's core
    fit."""

    def fit(self, dataset: Any, num_partitions: int | None = None):
        if self.classifier is None:  # before any cluster work
            raise ValueError("setClassifier(...) before fit")
        if not _is_spark_df(dataset):
            return _as_spark(super().fit(dataset, num_partitions), SparkOneVsRestModel)
        x, y, _ = _collect_xyw(dataset, self.getOrDefault("featuresCol"),
                               label_col=self.getOrDefault("labelCol"))
        return _as_spark(self._fit_xy(x, y, num_partitions), SparkOneVsRestModel)


class SparkNaiveBayesModel(NaiveBayesModel):
    def transform(self, dataset: Any) -> Any:
        if not _is_spark_df(dataset):
            return super().transform(dataset)

        def matrix_fn(mat, _m=self):
            raw = _m._raw_scores(mat)
            return (raw, *_m._from_raw(raw))

        return _classifier_columns_transform(self, dataset, matrix_fn, "naive bayes transform")


class SparkNaiveBayes(_CollectFit, NaiveBayes):
    """NaiveBayes over a DataFrame: collected, then the core monoid fit."""

    _spark_model = SparkNaiveBayesModel


class SparkMultilayerPerceptronClassificationModel(MultilayerPerceptronClassificationModel):
    def transform(self, dataset: Any) -> Any:
        if not _is_spark_df(dataset):
            return super().transform(dataset)

        def matrix_fn(mat, _m=self):
            logits = _m._logits(mat)
            return (logits, *_m._from_logits(logits))

        return _classifier_columns_transform(self, dataset, matrix_fn, "mlp transform")


class SparkMultilayerPerceptronClassifier(_CollectFit, MultilayerPerceptronClassifier):
    """The MLP over a DataFrame: collected, then the core fit."""

    _spark_model = SparkMultilayerPerceptronClassificationModel
    _weighted = False


class SparkFMClassificationModel(FMClassificationModel):
    def transform(self, dataset: Any) -> Any:
        if not _is_spark_df(dataset):
            return super().transform(dataset)

        def matrix_fn(mat, _m=self):
            s = _m._scores(mat)
            return (np.stack([-s, s], axis=1), *_m._outputs_from_scores(s))

        return _classifier_columns_transform(self, dataset, matrix_fn, "fm transform")


class SparkFMClassifier(_CollectFit, FMClassifier):
    _spark_model = SparkFMClassificationModel
    _weighted = False


class SparkFMRegressionModel(FMRegressionModel):
    def transform(self, dataset: Any) -> Any:
        if not _is_spark_df(dataset):
            return super().transform(dataset)
        return _spark_transform(self, dataset, self._predict_matrix,
                                self.getOrDefault("predictionCol"), scalar=True)


class SparkFMRegressor(_CollectFit, FMRegressor):
    _spark_model = SparkFMRegressionModel
    _weighted = False


class SparkIsotonicRegressionModel(IsotonicRegressionModel):
    def transform(self, dataset: Any) -> Any:
        if not _is_spark_df(dataset):
            return super().transform(dataset)
        return _spark_transform(self, dataset, self._predict_matrix,
                                self.getOrDefault("predictionCol"), scalar=True)


class SparkIsotonicRegression(_CollectFit, IsotonicRegression):
    _spark_model = SparkIsotonicRegressionModel


class SparkUMAPModel(UMAPModel):
    def transform(self, dataset: Any) -> Any:
        if not _is_spark_df(dataset):
            return super().transform(dataset)
        return _spark_transform(self, dataset, self._embed_matrix,
                                self.getOrDefault("outputCol"), scalar=False)


class SparkUMAP(UMAP):
    """UMAP over a DataFrame: the rows collected (the fuzzy graph and the
    layout are global) and fitted on the driver's device; the model's
    out-of-sample transform is a mapInArrow pass."""

    def fit(self, dataset: Any, num_partitions: int | None = None):
        if not _is_spark_df(dataset):
            return _as_spark(super().fit(dataset, num_partitions), SparkUMAPModel)
        x, _, _ = _collect_xyw(dataset, _resolve_col(self, "inputCol") or "features")
        return _as_spark(UMAP.fit(self, x), SparkUMAPModel)
