"""The port's Spark scalers, selectors, TruncatedSVD and stateless stages on
the port's local Spark engine, against the JAX package.

The rows are f32 values made with numpy from a seed, stored as the
DataFrame's float64 column (a second column holds the same rows with 2% of
the entries NaN), in 3 partitions of one module-scoped session of CPU
workers. Tolerances:

- the bodies against the JAX bodies on one Arrow ``RecordBatch``: each
  field within rtol 1e-5 of its largest entry (counts and histograms
  exactly equal), each package's batch decoded by the other's codec;
- the moment and range fits against the JAX core fits on the same f32
  rows: rtol 1e-5; the Imputer's histogram median within one bin width;
- TruncatedSVD against the JAX core fit: sign-invariant abs tol 1e-5 (the
  reference's PCA tolerance);
- every transform against the model's own local transform of the same
  rows: abs tol 1e-5 of the largest output (exactly equal for buckets).
"""

import jax  # noqa: F401  (imported at the top of every port test file)
import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import spark_rapids_ml_tpu as J
from spark_rapids_ml_tpu.spark import arrow_fns as jax_arrow_fns
from spark_rapids_ml_tpu_torch import spark as SP
from spark_rapids_ml_tpu_torch.localspark import LocalSparkSession
from spark_rapids_ml_tpu_torch.localspark import types as T
from spark_rapids_ml_tpu_torch.spark import arrow_fns

CPU = torch.device("cpu")
ROWS, N = 1_200, 8
RTOL = 1e-5
BINS = 512


@pytest.fixture(scope="module")
def spark():
    with LocalSparkSession(parallelism=2, worker_platform="cpu") as s:
        yield s


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(31)
    scales = np.linspace(0.5, 3.0, N)
    x = (rng.normal(size=(ROWS, N)) * scales + np.arange(N)).astype(np.float32)
    x[:, 3] = 2.5  # a constant feature: zero variance
    xn = x.copy()
    xn[rng.random((ROWS, N)) < 0.02] = np.nan
    return x, xn


@pytest.fixture(scope="module")
def df(spark, data):
    x, xn = data
    schema = T.StructType([T.StructField("features", T.ArrayType(T.DoubleType())),
                           T.StructField("gappy", T.ArrayType(T.DoubleType()))])
    rows = [(a.tolist(), b.tolist()) for a, b in zip(x.astype(np.float64), xn.astype(np.float64))]
    return spark.createDataFrame(rows, schema, numPartitions=3)


def _close(got, ref, rtol=RTOL):
    ref = np.asarray(ref, dtype=np.float64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * max(np.abs(ref).max(), 1e-30))


def _column(out_df, name):
    return np.asarray([r[name] for r in out_df.collect()], dtype=np.float64)


def _batch(x):
    feats = pa.FixedSizeListArray.from_arrays(pa.array(x.astype(np.float64).reshape(-1)),
                                              x.shape[1])
    return pa.RecordBatch.from_arrays([feats], names=["features"])


def _bodies(x):
    mins, maxs = np.nanmin(x, 0).astype(np.float64), np.nanmax(x, 0).astype(np.float64)
    nan_fields = {"count": (N,), "min": (N,), "max": (N,)}
    return {
        "moments": (lambda m: m.MomentsPartitionFn("features"),
                    {"count": (), "total": (N,), "total_sq": (N,)}, None),
        "range": (lambda m: m.RangeStatsPartitionFn("features"),
                  {"count": (), "min": (N,), "max": (N,), "max_abs": (N,)},
                  jax_arrow_fns.RANGE_COMBINE),
        "histogram": (lambda m: m.HistogramPartitionFn("features", mins, maxs, 64),
                      {"hist": (N, 64)}, None),
        "histogram_missing": (
            lambda m: m.HistogramPartitionFn("features", mins, maxs, 64, missing=np.nan),
            {"hist": (N, 64)}, None),
        "nan_moments": (lambda m: m.NanMomentsPartitionFn("features", np.nan),
                        {"count": (N,), "total": (N,)}, None),
        "nan_range": (lambda m: m.NanRangePartitionFn("features", np.nan), nan_fields,
                      jax_arrow_fns.RANGE_COMBINE),
    }


@pytest.mark.parametrize("body", ["moments", "range", "histogram", "histogram_missing",
                                  "nan_moments", "nan_range"])
def test_feature_bodies_match_jax_on_one_batch(data, body):
    _, xn = data
    x = xn if body.startswith(("nan", "histogram_missing")) else data[0]
    make, shapes, combine = _bodies(x)[body]
    batch = _batch(x[:600])
    port_fn = make(arrow_fns)
    port_fn.device = "cpu"
    port_b = list(port_fn(iter([batch, batch.slice(0, 0)])))
    jax_b = list(make(jax_arrow_fns)(iter([batch])))
    assert port_b[0].schema == jax_b[0].schema
    want = jax_arrow_fns.arrays_from_batches(jax_b, shapes, combine)
    for got in (arrow_fns.arrays_from_batches(port_b, shapes, combine),
                jax_arrow_fns.arrays_from_batches(port_b, shapes, combine)):
        for name in shapes:
            if name in ("count", "hist"):
                np.testing.assert_array_equal(got[name], want[name])
            else:
                _close(got[name], want[name])
    for name, v in arrow_fns.arrays_from_batches(jax_b, shapes, combine).items():
        np.testing.assert_array_equal(v, want[name])


def test_feature_bodies_read_a_frame_of_named_columns(data):
    _, xn = data
    frame = pd.DataFrame({"features": list(xn[:500])})
    stats = arrow_fns.NanMomentsPartitionFn("features", np.nan, device="cpu").partition_stats(
        [frame.iloc[:200], frame.iloc[200:]])
    valid = ~np.isnan(xn[:500])
    np.testing.assert_array_equal(stats.count.numpy(), valid.sum(0))
    _close(stats.total.numpy(), np.nansum(xn[:500].astype(np.float64), 0))
    rstats = arrow_fns.range_stats_from_batches(
        list(arrow_fns.RangeStatsPartitionFn("features", device="cpu")(iter([_batch(xn[:9])]))),
        N)
    assert float(rstats.count) == 9


CORE_FITS = {
    "standard": (lambda m: m.StandardScaler(), ("mean", "std")),
    "minmax": (lambda m: m.MinMaxScaler(), ("originalMin", "originalMax")),
    "maxabs": (lambda m: m.MaxAbsScaler(), ("maxAbs",)),
    "variance": (lambda m: m.VarianceThresholdSelector().setVarianceThreshold(0.5),
                 ("selectedFeatures",)),
    "imputer_mean": (lambda m: m.Imputer(), ("surrogate",)),
}


@pytest.mark.parametrize("kind", sorted(CORE_FITS))
def test_moment_and_range_fits_match_jax_core(df, data, kind):
    x, xn = data
    make, fields = CORE_FITS[kind]
    col = "gappy" if kind.startswith("imputer") else "features"
    rows = xn if kind.startswith("imputer") else x
    est = getattr(SP, "Spark" + type(make(J)).__name__)(device=CPU)
    for name, value in make(J)._paramMap.items():
        est._set(**{name: value})
    if kind == "variance":
        est.setFeaturesCol(col)
    else:
        est.setInputCol(col)
    model = est.fit(df)
    assert type(model).__name__ == "Spark" + type(make(J).fit(rows)).__name__
    ref = make(J).fit(rows)
    for f in fields:
        _close(getattr(model, f), getattr(ref, f))
    out_col = model.getOutputCol()
    _close(_column(model.transform(df), out_col), model.transform(rows))


def test_imputer_median_is_within_one_bin_of_jax_core(df, data):
    _, xn = data
    model = SP.SparkImputer(device=CPU).setInputCol("gappy").setStrategy("median") \
        .setNumBins(BINS).fit(df)
    ref = J.Imputer().setStrategy("median").setNumBins(BINS).fit(xn)
    width = (np.nanmax(xn, 0).astype(np.float64) - np.nanmin(xn, 0)) / BINS
    assert np.all(np.abs(model.surrogate - np.asarray(ref.surrogate)) <= width + 1e-6)
    out = _column(model.transform(df), model.getOutputCol())
    assert not np.isnan(out).any()


@pytest.mark.parametrize("solver,precision", [("gram", "high"), ("gram", "highest"),
                                              ("svd", "highest")])
def test_truncated_svd_on_driver_merge_matches_jax_core(df, data, solver, precision):
    x, _ = data
    model = SP.SparkTruncatedSVD(device=CPU).setInputCol("features").setK(3).setSolver(
        solver).setPrecision(precision).fit(df)
    ref = J.TruncatedSVD().setK(3).setSolver(solver).setPrecision(precision).fit(x)
    np.testing.assert_allclose(np.abs(model.components), np.abs(np.asarray(ref.components)),
                               rtol=0, atol=1e-5)
    _close(model.singularValues, ref.singularValues)
    got = _column(model.transform(df), model.getOutputCol())
    np.testing.assert_allclose(np.abs(got), np.abs(model._project_matrix(x)), rtol=0,
                               atol=1e-5 * np.abs(got).max())


STATELESS = {
    "Binarizer": lambda s: s.setThreshold(1.0),
    "DCT": lambda s: s,
    "ElementwiseProduct": lambda s: s.setScalingVec(np.linspace(0.5, 2.0, N)),
    "PolynomialExpansion": lambda s: s.setDegree(2),
    "VectorSlicer": lambda s: s.setIndices([0, 3, 5]),
    "Bucketizer": lambda s: s.setSplits([-np.inf, 0.0, 2.0, np.inf]),
    "Normalizer": lambda s: s.setP(1.0),
}


@pytest.mark.parametrize("name", sorted(STATELESS))
def test_stateless_stages_transform_a_dataframe_as_locally(df, data, name):
    x, _ = data
    stage = STATELESS[name](getattr(SP, "Spark" + name)(device=CPU).setInputCol("features"))
    got = _column(stage.transform(df), stage.getOutputCol())
    want = np.asarray(stage.transform(x), dtype=np.float64)
    _close(got, want)


def test_required_params_and_mesh_refusals(df, data):
    with pytest.raises(ValueError, match="scalingVec must be set"):
        SP.SparkElementwiseProduct(device=CPU).setInputCol("features").transform(df)
    # the mesh-local fits, refused before the mesh was ported, now run on
    # the driver's mesh and agree with the JAX core fits (1e-5 of the
    # largest entry; the TruncatedSVD components by min |cosine| ≥ 0.9999)
    x, _ = data
    cases = (
        (SP.SparkStandardScaler(device=CPU), J.StandardScaler(), ("mean", "std")),
        (SP.SparkMinMaxScaler(device=CPU), J.MinMaxScaler(), ("originalMin", "originalMax")),
        (SP.SparkTruncatedSVD(device=CPU).setK(2), J.TruncatedSVD().setK(2), ("singularValues",)),
    )
    for est, ref_est, fields in cases:
        model = est.setInputCol("features").setDistribution("mesh-local").fit(df)
        ref = ref_est.setInputCol("features").fit(x)
        for f in fields:
            _close(getattr(model, f), getattr(ref, f))
    comps, ref_comps = (np.asarray(m.components, np.float64) for m in (model, ref))
    cos = np.abs((comps * ref_comps).sum(0)) / (
        np.linalg.norm(comps, axis=0) * np.linalg.norm(ref_comps, axis=0))
    assert cos.min() >= 0.9999
    model = SP.SparkStandardScaler(device=CPU).fit(x)
    assert type(model) is SP.SparkStandardScalerModel
    _close(model.mean, x.astype(np.float64).mean(0))
