"""Spark DataFrame-facing estimators of the port: the PCA drop-in.

Port of the PCA part of ``spark_rapids_ml_tpu/spark/estimators.py``
(``:154-531``, ``:533-666``). The reference's user story (README.md:24-37):
change one import and a Spark ML PCA pipeline runs accelerated, its
``inputCol`` an ArrayType column. ``SparkPCA`` drives a pyspark DataFrame,
or one of the port's local Spark engine (``localspark``), through the Arrow
plan functions of ``spark/arrow_fns.py``:

- ``fit``: ``df.mapInArrow(FitPartitionFn)`` → the one-row stats batches
  merged on the driver → the covariance and its decomposition on the
  estimator's device (``ops/linalg.py``), every solver and precision,
  ``meanCentering`` and ``standardize``; solver ``"svd"`` ships R factors
  (``QRPartitionFn``), merged by a ``combine_r`` tree;
- ``transform``: ``df.mapInArrow(TransformPartitionFn)``, each batch
  projected on the device in the worker; the result is a lazy plan, whose
  ``TransformReport`` closes when it first materializes.

The partition functions compute on the estimator's device type (``"cuda"``
by default) inside the worker. Inputs that are not Spark DataFrames fall
through to the core ``PCA``. Only the ``"driver-merge"`` distribution runs:
``"mesh-local"`` and ``"mesh-barrier"`` are accepted as params, as in the JAX
package, and ``fit`` refuses them before any job runs (they wait for
ROADMAP Queue A item 6). pyspark is optional and imported only for a
pyspark DataFrame. There is no compilation cache to enable
(``_sql_mods``): a CUDA graph cannot outlive its process.
"""

from __future__ import annotations

import logging
from typing import Any

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.models.params import Param
from spark_rapids_ml_tpu_torch.models.pca import PCA, PCAModel
from spark_rapids_ml_tpu_torch.ops import linalg as L
from spark_rapids_ml_tpu_torch.spark import arrow_fns
from spark_rapids_ml_tpu_torch.telemetry import trace_range
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY
from spark_rapids_ml_tpu_torch.utils import columnar
from spark_rapids_ml_tpu_torch.utils.config import get_config

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


def _collect_stats(df, partition_fn, fields: list[str], shapes: dict[str, tuple],
                   combine=None) -> dict[str, np.ndarray]:
    """One stats ``mapInArrow`` pass folded on the driver (``toArrow``
    where the DataFrame has it, else ``collect()``)."""
    T, _ = _sql_mods(df)
    stats_df = df.mapInArrow(partition_fn, schema=_spark_arrays_type(T, fields))
    if hasattr(stats_df, "toArrow"):
        out = arrow_fns.arrays_from_batches(stats_df.toArrow().to_batches(), shapes, combine)
    else:
        out = arrow_fns.arrays_from_rows(stats_df.collect(), shapes, combine)
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
        distribution = self.getOrDefault("distribution")
        if distribution in _MESH_DISTRIBUTIONS:
            raise NotImplementedError(
                f"distribution={distribution!r} needs the port's device mesh "
                "(parallel/mesh.py, gram.py, tsqr.py, spark/spmd.py), which waits for "
                "ROADMAP Queue A item 6; use 'driver-merge'"
            )
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
            # n from one row, as RapidsPCA.scala:73-74 infers it
            first = selected.first()
            if first is None:
                raise ValueError("empty dataset")
            if first[0] is None:
                raise ValueError(
                    f"input column {input_col!r} contains null feature vectors; "
                    "drop or impute nulls before fit"
                )
            n = columnar.feature_dim(first[0])
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
            stats_df = selected.mapInArrow(
                fit_fn, schema=_spark_arrays_type(T, ["xtx", "col_sum", "count"])
            )
            if hasattr(stats_df, "toArrow"):  # pyspark >= 4.0 and localspark
                stats = arrow_fns.stats_from_batches(stats_df.toArrow().to_batches())
            else:  # pyspark 3.4/3.5: one [n, n] row per partition
                stats = arrow_fns.stats_from_rows(stats_df.collect())
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
        fn = arrow_fns.QRPartitionFn(input_col, mean, device=self.device.type)
        r_df = selected.mapInArrow(fn, schema=_spark_arrays_type(T, ["r"]))
        if hasattr(r_df, "toArrow"):
            r = arrow_fns.r_from_batches(r_df.toArrow().to_batches(), n, self.device)
        else:
            r = arrow_fns.r_from_rows(r_df.collect(), n, self.device)
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
