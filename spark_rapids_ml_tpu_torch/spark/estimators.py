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
default) inside the worker. Besides ``"driver-merge"``, the distributions
of the mesh (``parallel/``, ``spark/spmd.py``):

- ``"mesh-local"``: the rows stream onto the driver's own mesh
  (``_driver_mesh``: every card of the estimator's device type, one shard
  on the CPU) through ``ingest.stream_to_mesh``, and the mesh program
  reduces them: SparkPCA (every solver) and SparkLinearRegression (above
  the resident cutover the per-shard chunk folds ``sharded_gram_fold`` and
  ``sharded_linear_fold``, resumable with ``checkpoint_dir``; when mesh
  creation fails with a non-fatal error, or under
  ``TPU_ML_ADMISSION_POLICY=degrade``, the one-device streamed fold on the
  estimator's own device, counted as ``degraded.cpu_fallback``),
  SparkStandardScaler, the range and histogram family (MinMax, MaxAbs,
  Robust, QuantileDiscretizer), SparkTruncatedSVD, the Newton fits of
  SparkLogisticRegression and SparkLinearSVC and the Lloyd loop of
  SparkKMeans (k-means‖ seeded on the mesh), each whole loop over the
  mesh and chunked with ``checkpoint_dir``; the forests build with one
  histogram psum a level (``_mesh_forest_builder``);
- ``"mesh-barrier"``: one barrier stage whose tasks form a process mesh
  (``spark/spmd.py``), so the driver receives one reduced row: SparkPCA
  (the Gram, or TSQR for ``solver="svd"``), SparkStandardScaler,
  SparkTruncatedSVD, SparkLinearRegression, and the whole Newton and Lloyd
  fits of SparkLogisticRegression (binary or softmax) and SparkKMeans.

SparkDBSCANModel labels on the driver's mesh when it has more than one
data shard. Every estimator accepts the distributions the JAX package
allows it. pyspark is optional and imported only for a pyspark DataFrame.
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
from spark_rapids_ml_tpu_torch.ops import dbscan as DB
from spark_rapids_ml_tpu_torch.ops import forest as FO
from spark_rapids_ml_tpu_torch.ops import kmeans as KM
from spark_rapids_ml_tpu_torch.ops import linalg as L
from spark_rapids_ml_tpu_torch.ops import linear as LIN
from spark_rapids_ml_tpu_torch.ops import scaler as S
from spark_rapids_ml_tpu_torch.spark import arrow_fns, ingest
from spark_rapids_ml_tpu_torch.telemetry import trace_range
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY
from spark_rapids_ml_tpu_torch.utils import columnar
from spark_rapids_ml_tpu_torch.utils.config import get_config
from spark_rapids_ml_tpu_torch.utils.device import block_rows_for, to_device

logger = logging.getLogger("spark_rapids_ml_tpu_torch")


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
    return L.GramStats(*(torch.as_tensor(np.array(a, dtype=np.float32), device=device)
                         for a in stats))


def _driver_mesh(device: torch.device):
    """The mesh of a mesh-local fit: one data shard per card of the
    estimator's device type, or one shard on the CPU."""
    from spark_rapids_ml_tpu_torch.parallel import mesh as M

    return M.local_mesh(device)


def _mesh_or_fallback(device: torch.device):
    """The driver's mesh for a mesh-local streamed fit, or None for the
    one-device fold on ``device``: when mesh creation fails with a non-fatal
    error (or an injected fault at ``device.init``), or when admission
    control degraded the fit (``TPU_ML_ADMISSION_POLICY=degrade`` with a
    component FAILING: the sick mesh is not touched again). Either way it
    warns and counts ``degraded.cpu_fallback``, the JAX package's flag."""
    from spark_rapids_ml_tpu_torch.resilience import faults, sites
    from spark_rapids_ml_tpu_torch.resilience import retry as R
    from spark_rapids_ml_tpu_torch.telemetry import health

    if health.admission_degrade_active():
        logger.warning(
            "DEGRADED: admission control admitted this fit under the degrade policy "
            "(a health component is FAILING); skipping mesh creation and streaming "
            "through the one-device fold on %s", device,
        )
        REGISTRY.counter_inc("degraded.cpu_fallback")
        return None
    try:
        faults.inject(sites.DEVICE_INIT)
        return _driver_mesh(device)
    except Exception as e:  # noqa: BLE001 - classified below
        if R.classify(e) is R.ErrorClass.FATAL:
            raise
        logger.warning(
            "DEGRADED: device mesh initialization failed (%s: %s); streaming this fit "
            "through the one-device fold on %s", type(e).__name__, e, device,
        )
        REGISTRY.counter_inc("degraded.cpu_fallback")
        return None


def _barrier_single_row(df, fn, fields: list[str], shapes: dict[str, tuple]) -> dict:
    """One barrier stage (``spark/spmd.py``) decoded to the ONE reduced row
    it delivers, as host f64 arrays."""
    from spark_rapids_ml_tpu_torch.spark import spmd

    T, _ = _sql_mods(df)
    out_df = df.mapInArrow(fn, schema=_spark_arrays_type(T, fields), barrier=True)
    if hasattr(out_df, "toArrow"):
        batches = out_df.toArrow().to_batches()
    else:  # pyspark 3.5
        batches = [arrow_fns.arrays_to_batch({f: np.asarray(r[f], dtype=np.float64)
                                              for f in fields})
                   for r in out_df.collect()]
    return spmd.single_row_from_batches(batches, fields, shapes)


def _mesh_gram_arrays(selected, input_col: str, precision: str, n: int, device: str,
                      exact_diagonal: bool = True) -> dict:
    """One barrier-stage Gram psum (``MeshGramPartitionFn``), decoded: the
    mesh-barrier reduce of SparkPCA and SparkTruncatedSVD."""
    from spark_rapids_ml_tpu_torch.spark import spmd

    return _barrier_single_row(
        selected, spmd.MeshGramPartitionFn(input_col, precision=precision, device=device,
                                           exact_diagonal=exact_diagonal),
        spmd.MESH_FIELDS, {"xtx": (n, n), "col_sum": (n,), "count": (), "mesh_size": ()},
    )


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
        "collective over the partitions' process group, spark/spmd.py, or over "
        "the driver's own device mesh, spark/ingest.py::stream_to_mesh), as the "
        "estimator allows",
        str,
    )

    def __init__(self, uid: str | None = None, **kwargs):
        super().__init__(uid, **kwargs)
        self._setDefault(distribution="driver-merge")

    def setDistribution(self, value: str):
        if value not in self._ALLOWED_DISTRIBUTIONS:
            raise ValueError(f"distribution must be one of {self._ALLOWED_DISTRIBUTIONS}")
        return self._set(distribution=value)

    def _degradable(self, dataset: Any) -> bool:
        """Whether admission control may degrade this fit: a mesh-local
        DataFrame fit whose mesh falls back (``_mesh_or_fallback``) to the
        one-device fold."""
        return (self._DEGRADES_MESH_LOCAL and _is_spark_df(dataset)
                and self.getOrDefault("distribution") == "mesh-local")

    _DEGRADES_MESH_LOCAL = False


class SparkPCA(_HasDistribution, PCA):
    """PCA whose ``fit``/``transform`` take a Spark DataFrame (pyspark's or
    ``localspark``'s). Every param of the core ``PCA`` and its persistence
    carry over; other inputs fall through to the core fit. The Gram pass
    runs per ``distribution``: one job merged on the driver, the driver's
    mesh (``_mesh_local_stats``) or one barrier stage."""

    _ALLOWED_DISTRIBUTIONS = ("driver-merge", "mesh-barrier", "mesh-local")
    _DEGRADES_MESH_LOCAL = True

    def fit(self, dataset: Any, num_partitions: int | None = None, **kwargs) -> "SparkPCAModel":
        checkpoint_dir, checkpoint_every = _parse_checkpoint_kwargs(
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
        T, _ = _sql_mods(dataset)
        input_col = self.getInputCol()
        solver = self.getOrDefault("solver")
        distribution = self.getOrDefault("distribution")
        precision = self.getOrDefault("precision")
        with trace_range("compute cov", self.device):
            selected = dataset.select(input_col)
            n = _infer_n(selected, input_col)
            k = self.getK()
            if k > n:  # before the cluster-wide Gram pass
                raise ValueError(f"k={k} must be <= number of features {n}")
            if checkpoint_dir is not None and (distribution != "mesh-local" or solver == "svd"):
                raise NotImplementedError(
                    "checkpoint_dir requires distribution='mesh-local' with a covariance "
                    "solver: only the streamed chunk fold has a resumable cursor"
                )
            if solver == "svd":
                if self.getOrDefault("standardize"):
                    raise ValueError(
                        "standardize=True derives the scaled covariance from GramStats "
                        "and so requires a covariance solver ('full'/'randomized'/"
                        "'auto'); solver='svd' decomposes R factors of the raw rows"
                    )
                return self._fit_svd(selected, input_col, n, k, distribution)
            # linalg's diagonal rule at "default": exact Σx² for σ only
            exact = bool(self.getOrDefault("standardize"))
            if distribution == "mesh-barrier":
                arrays = _mesh_gram_arrays(selected, input_col, precision, n, self.device.type,
                                           exact)
                stats = _host_stats_on(
                    L.GramStats(arrays["xtx"], arrays["col_sum"], arrays["count"]), self.device)
            elif distribution == "mesh-local":
                stats = self._mesh_local_stats(selected, input_col, n,
                                               checkpoint_dir=checkpoint_dir,
                                               checkpoint_every=checkpoint_every)
            else:
                fit_fn = arrow_fns.make_fit_partition_fn(
                    input_col, precision=precision, device=self.device.type,
                    exact_diagonal=exact,
                )
                stats = _host_stats_on(
                    _run_pass(selected, fit_fn,
                              _spark_arrays_type(T, ["xtx", "col_sum", "count"]),
                              arrow_fns.stats_from_batches, arrow_fns.stats_from_rows),
                    self.device)
        mean = std = None
        with trace_range("eigh", self.device):
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

    def _fit_svd(self, selected, input_col: str, n: int, k: int,
                 distribution: str) -> "SparkPCAModel":
        """Solver ``"svd"`` per distribution. Driver-merge: each partition's
        R factor (``QRPartitionFn``), merged by a ``combine_r`` tree on the
        driver's device, then the SVD of R; ``meanCentering`` costs one
        moments pass for the global mean, applied in the workers before
        padding. Mesh-local: the butterfly TSQR over the driver's mesh,
        centred in the program with the pad mask. Mesh-barrier: the same
        program across the barrier stage's process mesh, so the driver
        receives only (pc, explained variance)."""
        T, _ = _sql_mods(selected)
        mean_centering = self.getMeanCentering()
        if distribution == "mesh-local":
            from spark_rapids_ml_tpu_torch.parallel import tsqr as TSQR

            ing = ingest.stream_to_mesh(selected, features_col=input_col, n=n,
                                        mesh=_driver_mesh(self.device),
                                        with_weights=mean_centering)
            with trace_range("svd from r", self.device):
                if mean_centering:
                    pc, ev = TSQR.make_distributed_fit_svd_masked(
                        ing.mesh, k, mean_centering=True)(ing.xs, ing.ws)
                else:  # zero pad rows are exact for the uncentered QR
                    pc, ev = TSQR.make_distributed_fit_svd(ing.mesh, k)(ing.xs)
        elif distribution == "mesh-barrier":
            from spark_rapids_ml_tpu_torch.spark import spmd

            with trace_range("svd mesh fit", self.device):
                arrays = _barrier_single_row(
                    selected, spmd.MeshSVDFitFn(input_col, k, mean_centering,
                                                device=self.device.type),
                    spmd.SVD_FIT_FIELDS,
                    {"pc": (n, k), "explainedVariance": (k,), "count": (), "mesh_size": ()},
                )
            pc, ev = arrays["pc"], arrays["explainedVariance"]
        else:
            mean = None
            if mean_centering:
                shapes = {"count": (), "total": (n,), "total_sq": (n,)}
                arrays = _collect_stats(
                    selected,
                    arrow_fns.make_moments_partition_fn(input_col, device=self.device.type),
                    list(shapes), shapes,
                )
                mean = arrays["total"] / max(float(arrays["count"]), 1.0)
            r = _run_pass(selected,
                          arrow_fns.QRPartitionFn(input_col, mean, device=self.device.type),
                          _spark_arrays_type(T, ["r"]),
                          lambda b: arrow_fns.r_from_batches(b, n, self.device),
                          lambda r: arrow_fns.r_from_rows(r, n, self.device))
            with trace_range("svd from r", self.device):
                pc, ev = L.svd_from_r(r, k)
        model = SparkPCAModel(uid=self.uid, pc=arrow_fns._host(pc).astype(np.float32),
                              explainedVariance=arrow_fns._host(ev).astype(np.float32),
                              device=self.device)
        return self._copyValues(model)

    def _mesh_local_stats(self, selected, input_col: str, n: int, *,
                          checkpoint_dir=None, checkpoint_every=None) -> L.GramStats:
        """Mesh-local: the rows stream onto the driver's mesh and one psum
        Gram program reduces them (``sharded_gram_stats``: at ``"high"`` one
        ``fused_gram_moments`` launch per shard); zero pad rows are exact and
        the true count replaces the padded one. Above the resident cutover
        (``TPU_ML_STREAM_FIT_MAX_RESIDENT_BYTES``) the [rows, n] array is
        never assembled: ``stream_fold`` feeds the per-shard chunk fold
        (``sharded_gram_fold``: one ``symmetric_gram_moments`` launch per
        shard per chunk at ``"high"``), resumable with ``checkpoint_dir``,
        and one allreduce finishes it. A mesh that cannot be made degrades
        that streamed fit to the one-device fold on the estimator's device."""
        from spark_rapids_ml_tpu_torch.parallel import gram as G
        from spark_rapids_ml_tpu_torch.parallel import mesh as M

        precision = self.getOrDefault("precision")
        exact = bool(self.getOrDefault("standardize"))  # linalg's rule at "default"
        rows = selected.count()
        if ingest.use_streamed_fit(rows, n):
            from spark_rapids_ml_tpu_torch.utils.checkpoint import TrainingCheckpointer

            ckpt = TrainingCheckpointer(checkpoint_dir) if checkpoint_dir else None
            mesh = _mesh_or_fallback(self.device)
            if mesh is None:
                return ingest.stream_fold(
                    selected, L.gram_fold_step(precision, exact_diagonal=exact),
                    features_col=input_col, n=n,
                    init=L.init_gram_carry(n, self.device), device=self.device, rows=rows,
                    checkpointer=ckpt, checkpoint_every=checkpoint_every,
                ).carry
            res = ingest.stream_fold(
                selected,
                lambda c, x, w: G.sharded_gram_fold(c, x, w, mesh, precision=precision,
                                                    exact_diagonal=exact),
                features_col=input_col, n=n,
                init=G.init_chunk_carry(L.init_gram_carry(n, "meta"), mesh),
                device=mesh.first_device, rows=rows,
                chunk_rows=G.stream_chunk_rows_for_mesh(mesh, n=n, rows=rows),
                put_fn=G.chunk_put(mesh), checkpointer=ckpt,
                checkpoint_every=checkpoint_every, min_chunk_rows=mesh.shape[M.DATA_AXIS],
            )
            # unit weights on true rows only: the weighted count is the rows
            return _stats_on(G.finalize_chunk_fold(res.carry, mesh), self.device)
        if checkpoint_dir is not None:
            raise NotImplementedError(
                "checkpoint_dir applies to the out-of-core streamed fit; this dataset "
                "fits resident in device memory (lower TPU_ML_STREAM_FIT_MAX_RESIDENT_BYTES "
                "to force streaming)"
            )
        ing = ingest.stream_to_mesh(selected, features_col=input_col, n=n,
                                    mesh=_driver_mesh(self.device), rows=rows)
        stats = G.sharded_gram_stats(ing.xs, ing.mesh, precision=precision,
                                     exact_diagonal=exact)
        return _stats_on(L.GramStats(stats.xtx, stats.col_sum,
                                     torch.full_like(stats.count, float(ing.rows))), self.device)


def _stats_on(stats, device: torch.device):
    """A mesh program's statistics (on the mesh's first device) on the
    estimator's device."""
    return type(stats)(*(t.to(device) for t in stats))


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


def _total_weight(ws) -> float:
    """Σ w of a mesh ingest's weight vector (pad rows weigh 0)."""
    return float(sum(float(b.sum()) for b in ws.data_blocks()))


def _check_weights(arrays: dict, weight_col, field: str = "count") -> None:
    if weight_col and float(np.sum(arrays[field])) == 0.0:
        raise ValueError("all instance weights are zero")


# -- GLMs ----------------------------------------------------------------------


class SparkLinearRegression(_HasDistribution, LinearRegression):
    """LinearRegression over a DataFrame. The LinearStats pass runs per
    ``distribution``: one ``LinRegPartitionFn`` job merged on the driver in
    f64; the driver's mesh (``_mesh_local_stats``: one psum, or above the
    resident cutover the per-shard chunk fold, resumable with
    ``checkpoint_dir``); or one barrier stage (``MeshLinRegPartitionFn``).
    Then ``solve_from_stats`` (the closed form, or FISTA for an elastic
    net) on the estimator's device. Other inputs fall through to the core
    fit."""

    _ALLOWED_DISTRIBUTIONS = ("driver-merge", "mesh-barrier", "mesh-local")
    _DEGRADES_MESH_LOCAL = True

    def fit(self, dataset: Any, num_partitions: int | None = None, **kwargs):
        checkpoint_dir, checkpoint_every = _parse_checkpoint_kwargs(
            kwargs, get_config().stream_checkpoint_every_chunks)
        if checkpoint_dir is not None and (
                not _is_spark_df(dataset) or self.getOrDefault("distribution") != "mesh-local"):
            raise NotImplementedError(
                "LinearRegression trains in one closed-form pass; checkpoint/resume "
                "applies only to the mesh-local streamed DataFrame fit's chunk cursor"
            )
        if not _is_spark_df(dataset):
            return _as_spark(super().fit(dataset, num_partitions), SparkLinearRegressionModel)
        feats = self.getOrDefault("featuresCol")
        label = self.getOrDefault("labelCol")
        weight_col = self._paramMap.get("weightCol")
        n = _infer_n(dataset, feats)
        shapes = {"xtx": (n, n), "xty": (n,), "x_sum": (n,), "y_sum": (), "y_sq": (),
                  "count": ()}
        cols = [feats, label] + ([weight_col] if weight_col else [])
        selected = dataset.select(*cols)
        distribution = self.getOrDefault("distribution")
        with trace_range("linreg stats", self.device):
            if distribution == "mesh-local":
                arrays = self._mesh_local_stats(selected, feats, label, weight_col, n,
                                                checkpoint_dir=checkpoint_dir,
                                                checkpoint_every=checkpoint_every)
            elif distribution == "mesh-barrier":
                from spark_rapids_ml_tpu_torch.spark import spmd

                arrays = _barrier_single_row(
                    selected, spmd.MeshLinRegPartitionFn(feats, label, weight_col,
                                                         device=self.device.type),
                    spmd.LINREG_MESH_FIELDS, {**shapes, "mesh_size": ()})
                arrays.pop("mesh_size")
            else:
                fn = arrow_fns.make_linreg_partition_fn(feats, label, weight_col,
                                                        device=self.device.type)
                arrays = _collect_stats(selected, fn, list(shapes), shapes)
            _check_weights(arrays, weight_col)
        coef, intercept = self.solve_merged(arrays)
        model = SparkLinearRegressionModel(uid=self.uid, coefficients=coef,
                                           intercept=intercept, device=self.device)
        return self._copyValues(model)

    def _mesh_local_stats(self, selected, feats: str, label: str, weight_col: str | None,
                          n: int, *, checkpoint_dir=None, checkpoint_every=None) -> dict:
        """Mesh-local LinearStats as host f64 arrays: the rows stream onto
        the driver's mesh and one psum reduces them
        (``sharded_linear_stats_weighted``); above the resident cutover the
        [rows, n] array is never assembled: ``stream_fold`` feeds the
        per-shard chunk fold (``sharded_linear_fold``, into an f64 carry as
        the one-device fold's), resumable with ``checkpoint_dir``, and one
        allreduce finishes it. A mesh that cannot be made degrades the
        streamed fit to the one-device fold on the estimator's device."""
        from spark_rapids_ml_tpu_torch.parallel import gram as G
        from spark_rapids_ml_tpu_torch.parallel import linear as PL
        from spark_rapids_ml_tpu_torch.parallel import mesh as M

        rows = selected.count()
        if ingest.use_streamed_fit(rows, n):
            from spark_rapids_ml_tpu_torch.utils.checkpoint import TrainingCheckpointer

            ckpt = TrainingCheckpointer(checkpoint_dir) if checkpoint_dir else None
            common = dict(features_col=feats, n=n, label_col=label, weight_col=weight_col,
                          rows=rows, checkpointer=ckpt, checkpoint_every=checkpoint_every)
            mesh = _mesh_or_fallback(self.device)
            if mesh is None:
                stats = ingest.stream_fold(selected, LIN.linear_fold_step(),
                                           init=LIN.init_linear_carry(n, self.device),
                                           device=self.device, **common).carry
            else:
                res = ingest.stream_fold(
                    selected, lambda c, x, y, w: G.sharded_linear_fold(c, x, y, w, mesh),
                    init=G.init_chunk_carry(LIN.init_linear_carry(n, "meta"), mesh),
                    device=mesh.first_device,
                    chunk_rows=G.stream_chunk_rows_for_mesh(mesh, n=n, rows=rows),
                    put_fn=G.chunk_put(mesh), min_chunk_rows=mesh.shape[M.DATA_AXIS], **common,
                )
                stats = G.finalize_chunk_fold(res.carry, mesh)
        elif checkpoint_dir is not None:
            raise NotImplementedError(
                "checkpoint_dir applies to the out-of-core streamed fit; this dataset "
                "fits resident in device memory (lower TPU_ML_STREAM_FIT_MAX_RESIDENT_BYTES "
                "to force streaming)"
            )
        else:
            ing = ingest.stream_to_mesh(selected, features_col=feats, n=n,
                                        mesh=_driver_mesh(self.device), label_col=label,
                                        weight_col=weight_col, with_weights=True, rows=rows)
            stats = PL.sharded_linear_stats_weighted(ing.xs, ing.ys, ing.ws, ing.mesh)
        return {f: v.detach().cpu().numpy().astype(np.float64)
                for f, v in zip(stats._fields, stats)}

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
    """Distributed IRLS over a DataFrame: a label-scan job (the class
    count), then per ``distribution``:

    - ``"driver-merge"``: one job per Newton iteration with the current
      parameters in the task state and the f64 solve on the estimator's
      device between jobs (binary ``LogRegNewtonPartitionFn``, or
      ``SoftmaxNewtonPartitionFn`` for three classes or more);
    - ``"mesh-local"``: the rows stream onto the driver's mesh with the
      intercept column appended, and the whole Newton loop runs over it
      (``parallel/linear.py``);
    - ``"mesh-barrier"``: the same loop in one barrier stage
      (``MeshLogRegFitFn`` or ``MeshSoftmaxFitFn``): no job per iteration.

    ``checkpoint_dir`` saves between jobs, or between chunks of
    ``checkpoint_every`` iterations on the mesh (for ``"mesh-barrier"`` a
    path shared by the driver and every executor, where rank 0 saves), and
    a killed fit resumes."""

    _ALLOWED_DISTRIBUTIONS = ("driver-merge", "mesh-barrier", "mesh-local")

    def fit(self, dataset: Any, num_partitions: int | None = None, **kwargs):
        if not _is_spark_df(dataset):
            return _as_spark(super().fit(dataset, num_partitions, **kwargs),
                             SparkLogisticRegressionModel)
        checkpoint_dir, checkpoint_every = _parse_checkpoint_kwargs(kwargs, 5)
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
        distribution = self.getOrDefault("distribution")
        if distribution == "mesh-local":
            return self._fit_mesh_local(selected, feats, label, weight_col, n, n_classes,
                                        checkpoint_dir=checkpoint_dir,
                                        checkpoint_every=checkpoint_every)
        if distribution == "mesh-barrier":
            return self._fit_mesh_barrier(selected, feats, label, weight_col, n_params,
                                          n_classes, checkpoint_dir=checkpoint_dir,
                                          checkpoint_every=checkpoint_every)
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

    def _reg(self) -> dict:
        return dict(reg_param=self.getRegParam(), elastic_net_param=self.getElasticNetParam(),
                    fit_intercept=self.getFitIntercept())

    def _fit_mesh_local(self, selected, feats: str, label: str, weight_col: str | None, n: int,
                        n_classes: int, *, checkpoint_dir=None, checkpoint_every: int = 5):
        """Mesh-local: the rows (intercept column appended) stream onto the
        driver's mesh, then the whole Newton loop runs over it, binary or
        softmax; with ``checkpoint_dir`` it runs in chunks of
        ``checkpoint_every`` iterations with a durable checkpoint between
        them (``run_chunked_newton``), and a killed fit resumes."""
        from spark_rapids_ml_tpu_torch.parallel import linear as PL

        fit_intercept = self.getFitIntercept()
        ing = ingest.stream_to_mesh(selected, features_col=feats, n=n,
                                    mesh=_driver_mesh(self.device), label_col=label,
                                    weight_col=weight_col, with_weights=True,
                                    augment_intercept=fit_intercept)
        if weight_col and _total_weight(ing.ws) == 0.0:
            raise ValueError("all instance weights are zero")
        max_iter, tol = self.getMaxIter(), self.getTol()
        if checkpoint_dir is not None:
            d = n + 1 if fit_intercept else n
            w0, start_iter, ckpt = _resume_newton_checkpoint(
                checkpoint_dir, d if n_classes <= 2 else n_classes * d)
            if n_classes > 2:
                chunk = PL.make_distributed_softmax_chunk(
                    ing.mesh, n_classes, chunk_iters=checkpoint_every, tol=tol, **self._reg())
            else:
                chunk = PL.make_distributed_logreg_chunk(
                    ing.mesh, chunk_iters=checkpoint_every, tol=tol, **self._reg())
            with trace_range("logreg mesh-local chunked fit", self.device):
                w, _ = PL.run_chunked_newton(chunk, ing.xs, ing.ys, ing.ws, w0,
                                             start_iter=start_iter, max_iter=max_iter,
                                             tol=tol, ckpt=ckpt)
        else:
            with trace_range("logreg mesh-local fit", self.device):
                if n_classes > 2:
                    fit = PL.make_distributed_softmax_fit(ing.mesh, n_classes, max_iter=max_iter,
                                                          tol=tol, **self._reg())
                else:
                    fit = PL.make_distributed_logreg_fit(ing.mesh, max_iter=max_iter, tol=tol,
                                                         **self._reg())
                w, _, step = fit(ing.xs, ing.ys, ing.ws)
                LIN.check_newton_outcome(step, w)
        return self._model_from_params(w.cpu().numpy(), n_classes, fit_intercept)

    def _fit_mesh_barrier(self, selected, feats: str, label: str, weight_col: str | None,
                          n_params: int, n_classes: int, *, checkpoint_dir=None,
                          checkpoint_every: int = 5):
        """Mesh-barrier: one barrier stage is the whole Newton fit
        (``MeshLogRegFitFn``, or ``MeshSoftmaxFitFn`` for three classes or
        more). With ``checkpoint_dir`` (a path shared by the driver and
        every executor) the stage runs in chunks with rank-0 saves; the
        driver resolves the resume before it launches the stage, and a
        resume at maxIter launches none."""
        from spark_rapids_ml_tpu_torch.spark import spmd

        fit_intercept = self.getFitIntercept()
        w0, start_iter, ckpt = _resume_newton_checkpoint(checkpoint_dir, n_params)
        if ckpt is not None and start_iter >= self.getMaxIter():
            return self._model_from_params(np.asarray(w0), n_classes, fit_intercept)
        options = dict(
            max_iter=self.getMaxIter(), tol=self.getTol(), checkpoint_dir=checkpoint_dir,
            checkpoint_every=checkpoint_every, w0=w0 if ckpt is not None else None,
            start_iter=start_iter, device=self.device.type, **self._reg(),
        )
        if n_classes > 2:
            fn = spmd.MeshSoftmaxFitFn(feats, label, weight_col, n_classes, **options)
        else:
            fn = spmd.MeshLogRegFitFn(feats, label, weight_col, **options)
        label_trace = "logreg mesh fit" if n_classes <= 2 else "softmax mesh fit"
        with trace_range(label_trace, self.device):
            arrays = _barrier_single_row(
                selected, fn, spmd.LOGREG_FIT_FIELDS,
                {"w": (n_params,), "iterations": (), "count": (), "mesh_size": ()})
        _check_weights(arrays, weight_col)
        return self._model_from_params(arrays["w"], n_classes, fit_intercept)

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
    """LinearSVC over a DataFrame. ``"driver-merge"``: (features, label,
    weight) collected through the bounded chunker, then the core
    squared-hinge Newton loop. ``"mesh-local"``: the rows stream onto the
    driver's mesh with the intercept column appended and the whole
    squared-hinge Newton loop runs over it (``parallel/linear.py``'s binary
    chunk with ``loss="squared_hinge"``), in chunks with checkpoints under
    ``checkpoint_dir``."""

    _ALLOWED_DISTRIBUTIONS = ("driver-merge", "mesh-local")

    def fit(self, dataset: Any, num_partitions: int | None = None, **kwargs):
        checkpoint_dir, checkpoint_every = _parse_checkpoint_kwargs(kwargs, 5)
        if not _is_spark_df(dataset):
            core = super().fit(dataset, num_partitions, checkpoint_dir=checkpoint_dir,
                               checkpoint_every=checkpoint_every)
            return _as_spark(core, SparkLinearSVCModel)
        if self.getOrDefault("distribution") == "mesh-local":
            return self._fit_mesh_local(dataset, checkpoint_dir, checkpoint_every)
        x, y, w = _collect_xyw(dataset, self.getOrDefault("featuresCol"),
                               label_col=self.getOrDefault("labelCol"),
                               weight_col=self._paramMap.get("weightCol"))
        core = LinearSVC.fit(self, (x, y) if w is None else (x, y, w),
                             checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every)
        return _as_spark(core, SparkLinearSVCModel)


    def _fit_mesh_local(self, dataset, checkpoint_dir, checkpoint_every: int):
        from spark_rapids_ml_tpu_torch.parallel import linear as PL

        feats = self.getOrDefault("featuresCol")
        label = self.getOrDefault("labelCol")
        weight_col = self._paramMap.get("weightCol")
        fit_intercept = self.getFitIntercept()
        cols = [feats, label] + ([weight_col] if weight_col else [])
        n = _infer_n(dataset, feats)
        ing = ingest.stream_to_mesh(dataset.select(*cols), features_col=feats, n=n,
                                    mesh=_driver_mesh(self.device), label_col=label,
                                    weight_col=weight_col, with_weights=True,
                                    augment_intercept=fit_intercept)
        if weight_col and _total_weight(ing.ws) == 0.0:
            raise ValueError("all instance weights are zero")
        true_labels = np.unique(np.concatenate([
            y.cpu().numpy()[w.cpu().numpy() > 0]
            for y, w in zip(ing.ys.data_blocks(), ing.ws.data_blocks())]))
        if not np.all(np.isin(true_labels, (0.0, 1.0))):
            raise ValueError(f"LinearSVC requires binary 0/1 labels, got {true_labels[:8]}")
        max_iter, tol = self.getMaxIter(), self.getTol()
        d = n + 1 if fit_intercept else n
        w0, start_iter, ckpt = _resume_newton_checkpoint(checkpoint_dir, d)
        chunk = PL.make_distributed_logreg_chunk(
            ing.mesh, reg_param=self.getRegParam(), fit_intercept=fit_intercept,
            chunk_iters=checkpoint_every if checkpoint_dir is not None else max_iter,
            tol=tol, loss="squared_hinge",
        )
        with trace_range("svc mesh-local fit", self.device):
            # run_chunked_newton makes the non-finite-data check itself
            w_dev, _ = PL.run_chunked_newton(chunk, ing.xs, ing.ys, ing.ws, w0,
                                             start_iter=start_iter, max_iter=max_iter, tol=tol,
                                             ckpt=ckpt)
        w_np = w_dev.cpu().numpy()
        coef, intercept = (w_np[:-1], float(w_np[-1])) if fit_intercept else (w_np, 0.0)
        model = SparkLinearSVCModel(uid=self.uid, coefficients=coef, intercept=intercept,
                                    device=self.device)
        return self._copyValues(model)


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
    """KMeans over a DataFrame. Seeding: k-means‖ as jobs (per round a cost
    job and a Bernoulli sampling job, then a weighting job and a weighted
    k-means++ on the driver's device), or k-means++ / random on a bounded
    random sample. Then Lloyd per ``distribution``:

    - ``"driver-merge"``: one ``KMeansPartitionFn`` job per iteration, the
      centres in the task state;
    - ``"mesh-local"``: the rows stream onto the driver's mesh and the
      whole loop runs over it (``parallel/kmeans.py``); k-means‖ seeds in
      the program there (psum and all_gather passes over the shards), with
      the driver-pass init as the fallback when the oversampling
      degenerates;
    - ``"mesh-barrier"``: the whole loop in one barrier stage
      (``MeshKMeansFitFn``).

    ``checkpoint_dir`` saves between jobs, or between chunks of
    ``checkpoint_every`` iterations on the mesh (for ``"mesh-barrier"`` a
    path shared by the driver and every executor, where rank 0 saves), and
    a killed fit resumes."""

    _ALLOWED_DISTRIBUTIONS = ("driver-merge", "mesh-barrier", "mesh-local")

    _INIT_SAMPLE = 4096

    def fit(self, dataset: Any, num_partitions: int | None = None, **kwargs):
        if not _is_spark_df(dataset):
            return _as_spark(super().fit(dataset, num_partitions, **kwargs), SparkKMeansModel)
        checkpoint_dir, checkpoint_every = _parse_checkpoint_kwargs(kwargs, 1)
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
                if self.getInitMode() != "k-means||":
                    centers = self._sample_init(selected, F, weight_col, k)
                elif self.getOrDefault("distribution") != "mesh-local":
                    centers = self._kmeans_parallel_init_df(selected, input_col, weight_col, k)
                # mesh-local k-means‖ seeds in the program, over the shards
                # the Lloyd loop ingests (centers None)
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
        checkpointed cost, so a resume at maxIter still reports it. The mesh
        distributions run their loops instead (``_lloyd_mesh_local``,
        ``_lloyd_mesh_barrier``)."""
        distribution = self.getOrDefault("distribution")
        if distribution == "mesh-local":
            return self._lloyd_mesh_local(selected, input_col, weight_col, centers, ckpt=ckpt,
                                          checkpoint_every=checkpoint_every,
                                          start_iter=start_iter, cost0=cost0)
        if distribution == "mesh-barrier":
            return self._lloyd_mesh_barrier(selected, input_col, weight_col, centers, ckpt=ckpt,
                                            checkpoint_every=checkpoint_every,
                                            start_iter=start_iter, cost0=cost0)
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

    def _lloyd_mesh_local(self, selected, input_col: str, weight_col: str | None,
                          centers: np.ndarray | None, *, ckpt=None, checkpoint_every: int = 1,
                          start_iter: int = 0, cost0: float = np.inf) -> "SparkKMeansModel":
        """Mesh-local Lloyd: the rows stream onto the driver's mesh; with
        ``centers`` None, k-means‖ seeds there first
        (``make_distributed_kmeans_parallel_init``, then a weighted
        k-means++ over the candidates on the device), and when the
        oversampling degenerates (no more than k candidates own rows) the
        driver-pass init, which tops up from a uniform sample, seeds
        instead. Then the whole loop, or with ``ckpt`` chunks of
        ``checkpoint_every`` iterations with a durable checkpoint between
        them."""
        from spark_rapids_ml_tpu_torch.parallel import kmeans as PK

        k = self.getK()
        n = centers.shape[1] if centers is not None else _infer_n(selected, input_col)
        ing = ingest.stream_to_mesh(selected, features_col=input_col, n=n,
                                    mesh=_driver_mesh(self.device), weight_col=weight_col,
                                    with_weights=True)
        if weight_col and _total_weight(ing.ws) == 0.0:
            raise ValueError("all instance weights are zero")
        if centers is None:
            with trace_range("kmeans mesh init", self.device):
                init = PK.make_distributed_kmeans_parallel_init(
                    ing.mesh, k, init_steps=self.getInitSteps())
                cand, counts = init(ing.xs, ing.ws, self.getSeed())
                if int((counts > 0).sum()) <= k:
                    centers = self._kmeans_parallel_init_df(selected, input_col, weight_col, k)
                else:
                    gen = torch.Generator(device=cand.device).manual_seed(self.getSeed() + 1)
                    centers = KM.weighted_kmeans_plus_plus_init(
                        gen, cand, counts, k).cpu().numpy()
        max_iter, tol = self.getMaxIter(), self.getTol()
        centers0 = torch.as_tensor(np.asarray(centers, dtype=np.float32))
        if ckpt is not None:
            with trace_range("kmeans mesh-local chunked fit", self.device):
                c, cost, _ = PK.run_chunked_lloyd(
                    PK.make_distributed_kmeans_chunk(ing.mesh, chunk_iters=checkpoint_every,
                                                     tol=tol),
                    ing.xs, ing.ws, centers0, start_iter=start_iter, max_iter=max_iter,
                    tol=tol, ckpt=ckpt, cost0=cost0)
        else:
            with trace_range("kmeans mesh-local fit", self.device):
                c, cost_t, _ = PK.make_distributed_kmeans_fit(ing.mesh, max_iter=max_iter,
                                                              tol=tol)(ing.xs, ing.ws, centers0)
            cost = float(cost_t)
        model = SparkKMeansModel(uid=self.uid, clusterCenters=c.cpu().numpy(),
                                 trainingCost=float(cost), device=self.device)
        return self._copyValues(model)

    def _lloyd_mesh_barrier(self, selected, input_col: str, weight_col: str | None,
                            centers: np.ndarray, *, ckpt=None, checkpoint_every: int = 1,
                            start_iter: int = 0, cost0: float = np.inf) -> "SparkKMeansModel":
        """Mesh-barrier Lloyd: one barrier stage is the whole loop
        (``MeshKMeansFitFn``); a resume at maxIter launches no stage."""
        from spark_rapids_ml_tpu_torch.spark import spmd

        if start_iter >= self.getMaxIter():
            model = SparkKMeansModel(uid=self.uid, clusterCenters=centers,
                                     trainingCost=float(cost0), device=self.device)
            return self._copyValues(model)
        k, n = centers.shape
        fn = spmd.MeshKMeansFitFn(
            input_col, centers, weight_col, max_iter=self.getMaxIter(), tol=self.getTol(),
            checkpoint_dir=None if ckpt is None else str(ckpt.dir),
            checkpoint_every=checkpoint_every, start_iter=start_iter, device=self.device.type,
        )
        with trace_range("kmeans mesh fit", self.device):
            arrays = _barrier_single_row(
                selected, fn, spmd.KMEANS_FIT_FIELDS,
                {"centers": (k, n), "cost": (), "iterations": (), "count": (), "mesh_size": ()})
        _check_weights(arrays, weight_col)
        model = SparkKMeansModel(uid=self.uid, clusterCenters=arrays["centers"],
                                 trainingCost=float(arrays["cost"]), device=self.device)
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


def _collect_range_stats(est, dataset, *, return_ingest: bool = False):
    """The range pass of MinMax / MaxAbs / Robust / QuantileDiscretizer
    (f64 host arrays). Driver-merge: one ``RangeStatsPartitionFn`` job,
    merged by min / max on the driver. Mesh-local: the rows stream onto the
    driver's mesh (with the pad mask) and ``sharded_range_stats`` folds them
    by psum and pmin/pmax; with ``return_ingest`` that ingest comes back
    for the histogram pass, else None."""
    input_col = _resolve_col(est, "inputCol") or "features"
    n = _infer_n(dataset, input_col)
    ing = None
    with trace_range("scaler range stats", est.device):
        if est.getOrDefault("distribution") == "mesh-local":
            from spark_rapids_ml_tpu_torch.parallel import gram as G

            ing = ingest.stream_to_mesh(dataset.select(input_col), features_col=input_col,
                                        n=n, mesh=_driver_mesh(est.device), with_weights=True)
            stats = G.sharded_range_stats(ing.xs, ing.ws, ing.mesh)
            arrays = {f: arrow_fns._host(getattr(stats, f)) for f in arrow_fns.RANGE_STATS_FIELDS}
        else:
            arrays = _collect_stats(
                dataset.select(input_col),
                arrow_fns.make_range_stats_partition_fn(input_col, device=est.device.type),
                arrow_fns.RANGE_STATS_FIELDS, arrow_fns.range_stats_shapes(n),
                combine=arrow_fns.RANGE_COMBINE,
            )
    return (arrays, ing) if return_ingest else arrays


def _collect_histogram(est, dataset, mins, maxs, bins: int, missing=None, ing=None) -> np.ndarray:
    """The quantile sketch's second pass over the driver's [mins, maxs]:
    psum'd on the mesh when the range pass left its mesh-local ``ing``, else
    one ``HistogramPartitionFn`` job summed on the driver."""
    input_col = _resolve_col(est, "inputCol") or "features"
    n = len(mins)
    with trace_range("quantile sketch histogram", est.device):
        if ing is not None:
            from spark_rapids_ml_tpu_torch.parallel import gram as G

            bounds = [torch.as_tensor(np.asarray(v), dtype=torch.float32) for v in (mins, maxs)]
            return arrow_fns._host(G.sharded_histogram(ing.xs, ing.ws, *bounds, bins=bins,
                                                       mesh=ing.mesh))
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
    """StandardScaler over a DataFrame: the moments by distribution (one
    ``MomentsPartitionFn`` job merged on the driver; the driver's mesh, by a
    psum or, above the resident cutover, the per-shard chunk fold; or one
    barrier stage's psum), finished on the estimator's device."""

    _ALLOWED_DISTRIBUTIONS = ("driver-merge", "mesh-barrier", "mesh-local")

    def fit(self, dataset: Any, num_partitions: int | None = None):
        if not _is_spark_df(dataset):
            return _as_spark(super().fit(dataset, num_partitions), SparkStandardScalerModel)
        input_col = _resolve_col(self, "inputCol") or "features"
        n = _infer_n(dataset, input_col)
        shapes = {"count": (), "total": (n,), "total_sq": (n,)}
        distribution = self.getOrDefault("distribution")
        selected = dataset.select(input_col)
        with trace_range("scaler moments", self.device):
            if distribution == "mesh-local":
                arrays = self._mesh_local_moments(selected, input_col, n)
            elif distribution == "mesh-barrier":
                from spark_rapids_ml_tpu_torch.spark import spmd

                arrays = _barrier_single_row(
                    selected, spmd.MeshMomentsPartitionFn(input_col, device=self.device.type),
                    spmd.MOMENTS_MESH_FIELDS, {**shapes, "mesh_size": ()},
                )
                arrays.pop("mesh_size")
            else:
                arrays = _collect_stats(
                    selected,
                    arrow_fns.make_moments_partition_fn(input_col, device=self.device.type),
                    list(shapes), shapes,
                )
        mean, std = self.moments_merged(arrays)
        model = SparkStandardScalerModel(uid=self.uid, mean=mean, std=std, device=self.device)
        return self._copyValues(model)

    def _mesh_local_moments(self, selected, input_col: str, n: int) -> dict:
        """Mesh-local moments as host arrays: ``sharded_moment_stats`` over
        the streamed ingest (the true count replaces the padded one), or,
        above the resident cutover, ``sharded_moment_fold`` per chunk and one
        allreduce (unit weights on true rows: the weighted count is the
        rows)."""
        from spark_rapids_ml_tpu_torch.parallel import gram as G
        from spark_rapids_ml_tpu_torch.parallel import mesh as M

        rows = selected.count()
        mesh = _driver_mesh(self.device)
        if ingest.use_streamed_fit(rows, n):
            res = ingest.stream_fold(
                selected, lambda c, x, w: G.sharded_moment_fold(c, x, w, mesh),
                features_col=input_col, n=n,
                init=G.init_chunk_carry(S.init_moment_carry(n, "meta"), mesh),
                device=mesh.first_device, rows=rows,
                chunk_rows=G.stream_chunk_rows_for_mesh(mesh, n=n, rows=rows),
                put_fn=G.chunk_put(mesh), min_chunk_rows=mesh.shape[M.DATA_AXIS],
            )
            stats = G.finalize_chunk_fold(res.carry, mesh)
        else:
            ing = ingest.stream_to_mesh(selected, features_col=input_col, n=n, mesh=mesh,
                                        rows=rows)
            stats = G.sharded_moment_stats(ing.xs, ing.mesh)
            stats = S.MomentStats(torch.full_like(stats.count, float(ing.rows)), stats.total,
                                  stats.total_sq)
        return {f: arrow_fns._host(getattr(stats, f)) for f in S.MomentStats._fields}

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
        self._check_quantile_bounds()
        rstats, ing = _collect_range_stats(self, dataset, return_ingest=True)
        hist = _collect_histogram(self, dataset, rstats["min"], rstats["max"],
                                  self.getNumBins(), ing=ing)
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
        rstats, ing = _collect_range_stats(self, dataset, return_ingest=True)
        check_finite_range(rstats["min"], rstats["max"])
        hist = _collect_histogram(self, dataset, rstats["min"], rstats["max"],
                                  self.getNumBins(), ing=ing)
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
    """TruncatedSVD over a DataFrame. Driver-merge: solver ``"svd"`` is one
    R-factor job (``QRPartitionFn``, merged by a ``combine_r`` tree); the
    others one Gram job (``FitPartitionFn``: ``fused_gram_moments`` per
    batch at ``"high"``), decomposed on the estimator's device. Mesh-local:
    the rows on the driver's mesh, then the psum Gram or the butterfly TSQR.
    Mesh-barrier: the barrier stage's Gram psum, or its whole TSQR fit
    (``MeshTSVDFitFn``) for solver ``"svd"``."""

    _ALLOWED_DISTRIBUTIONS = ("driver-merge", "mesh-barrier", "mesh-local")

    def fit(self, dataset: Any, num_partitions: int | None = None):
        if not _is_spark_df(dataset):
            return _as_spark(super().fit(dataset, num_partitions), SparkTruncatedSVDModel)
        T, _ = _sql_mods(dataset)
        input_col = _resolve_col(self, "inputCol") or "features"
        selected = dataset.select(input_col)
        n = _infer_n(dataset, input_col)
        k = self.getK()
        if k > n:
            raise ValueError(f"k={k} must be <= number of features {n}")
        solver = self.getOrDefault("solver")
        distribution = self.getOrDefault("distribution")
        precision = self.getOrDefault("precision")
        if distribution == "mesh-barrier" and solver == "svd":
            from spark_rapids_ml_tpu_torch.spark import spmd

            with trace_range("tsvd mesh fit", self.device):
                arrays = _barrier_single_row(
                    selected, spmd.MeshTSVDFitFn(input_col, k, device=self.device.type),
                    spmd.TSVD_FIT_FIELDS,
                    {"components": (n, k), "singularValues": (k,), "count": (), "mesh_size": ()},
                )
            model = SparkTruncatedSVDModel(
                uid=self.uid, components=arrays["components"].astype(np.float32),
                singularValues=arrays["singularValues"].astype(np.float32), device=self.device)
            return self._copyValues(model)
        with trace_range("tsvd reduce", self.device):
            if distribution == "mesh-local":
                from spark_rapids_ml_tpu_torch.parallel import gram as G
                from spark_rapids_ml_tpu_torch.parallel import tsqr as TSQR

                ing = ingest.stream_to_mesh(selected, features_col=input_col, n=n,
                                            mesh=_driver_mesh(self.device))
                if solver == "svd":  # zero pad rows are exact for the uncentered QR
                    reduced = TSQR.tsqr_r(ing.xs, ing.mesh).to(self.device)
                else:
                    reduced = arrow_fns._host(G.sharded_gram_stats(ing.xs, ing.mesh,
                                                                   precision=precision).xtx)
            elif solver == "svd":
                reduced = _run_pass(
                    selected, arrow_fns.QRPartitionFn(input_col, device=self.device.type),
                    _spark_arrays_type(T, ["r"]),
                    lambda b: arrow_fns.r_from_batches(b, n, self.device),
                    lambda r: arrow_fns.r_from_rows(r, n, self.device),
                )
            elif distribution == "mesh-barrier":
                reduced = _mesh_gram_arrays(selected, input_col, precision, n,
                                            self.device.type)["xtx"]
            else:
                fn = arrow_fns.make_fit_partition_fn(
                    input_col, precision=precision, device=self.device.type)
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
    the driver's mesh when it has more than one data shard (the sharded
    label propagation, ``parallel/dbscan.py``) or on the model's device
    (the core kernel) otherwise: the same labels either way. The
    prediction column comes back appended in row order."""

    def _compute_labels(self, x, weights, eps_sq: float, min_samples: float) -> np.ndarray:
        """The kernel hook: the sharded program over ``_driver_mesh`` (rows
        padded to a multiple of the shards, pad rows invalid) when it has
        more than one data shard, the one-device kernel otherwise. The eps,
        dtype and relabel rules stay in ``_cluster_matrix``."""
        from spark_rapids_ml_tpu_torch.parallel.dbscan import make_sharded_dbscan
        from spark_rapids_ml_tpu_torch.parallel.mesh import DATA_AXIS

        mesh = _driver_mesh(self.device)
        ndev = mesh.shape[DATA_AXIS]
        if ndev <= 1:
            return super()._compute_labels(x, weights, eps_sq, min_samples)
        rows = x.shape[0]
        xp, w, valid = self._pad_inputs(x, weights, -(-rows // ndev) * ndev)
        labels = make_sharded_dbscan(mesh, block_rows=block_rows_for(
            mesh.first_device, DB.DEFAULT_BLOCK_ROWS))(xp, w, valid, eps_sq, min_samples)
        return labels.cpu().numpy()[:rows]

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


class _MeshForestFit(_CollectFit):
    """The forests' DataFrame fit: collected, then the core build on the
    driver's device; under ``"mesh-local"`` the build runs through the
    mesh-sharded program on the driver's mesh (``_mesh_forest_builder``)."""

    _ALLOWED_DISTRIBUTIONS = ("driver-merge", "mesh-local")

    def fit(self, dataset: Any, num_partitions: int | None = None):
        if not _is_spark_df(dataset) or self.getOrDefault("distribution") != "mesh-local":
            return super().fit(dataset, num_partitions)
        x, y, w = _collect_xyw(dataset, self.getOrDefault("featuresCol"),
                               label_col=self.getOrDefault("labelCol"),
                               weight_col=self._paramMap.get("weightCol"))
        core = self._make_model(x, y, w, builder=_mesh_forest_builder(self.device))
        return _as_spark(core, self._spark_model)


def _mesh_forest_builder(device: torch.device):
    """A drop-in for ``ops.forest.build_forest`` that builds on the
    driver's mesh (``_driver_mesh``): rows sharded (pad weight 0, invisible
    to every histogram), one psum a level (``parallel/forest.py``). With one
    data shard it is the one-device build."""
    from spark_rapids_ml_tpu_torch.parallel import forest as PF
    from spark_rapids_ml_tpu_torch.parallel.mesh import DATA_AXIS

    def build(binned_t, row_stats, weights, min_inst, min_gain, *, generators=None, **static):
        mesh = _driver_mesh(device)
        if mesh.shape[DATA_AXIS] <= 1:
            return FO.build_forest(binned_t, row_stats, weights, min_inst, min_gain,
                                   generators=generators, **static)
        return PF.make_sharded_forest(mesh, **static)(binned_t, row_stats, weights, min_inst,
                                                      min_gain, generators)

    return build


class SparkRandomForestClassifier(_MeshForestFit, _HasDistribution, RandomForestClassifier):
    """RandomForestClassifier over a DataFrame: collected, then the core
    build on the driver's device, or on its mesh under ``"mesh-local"``."""

    _spark_model = SparkRandomForestClassificationModel


class SparkRandomForestRegressionModel(RandomForestRegressionModel):
    def transform(self, dataset: Any) -> Any:
        if not _is_spark_df(dataset):
            return super().transform(dataset)
        return _spark_transform(self, dataset, self._predict_matrix,
                                self.getOrDefault("predictionCol"), scalar=True)


class SparkRandomForestRegressor(_MeshForestFit, _HasDistribution, RandomForestRegressor):
    """RandomForestRegressor over a DataFrame, as the classifier."""

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
