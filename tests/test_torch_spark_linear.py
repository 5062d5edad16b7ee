"""The port's Spark linear family on the port's local Spark engine, against
the JAX package.

The rows are f32 values made with numpy from a seed, stored as the
DataFrame's float64 columns, in 3 partitions of one module-scoped session
of CPU workers. The references, cheapest first:

- the JAX core estimator on the same f32 rows (the JAX Spark fit is the
  core math over merged statistics): coefficients and intercepts within
  1e-5 of the largest coefficient (LinearRegression 2e-5: f32 statistics
  in JAX, f64 sums of f32 products here, as ``tests/test_torch_linear.py``
  holds the core fits), multinomial fits by their probabilities (atol
  1e-5);
- the JAX plan function on the same Arrow ``RecordBatch`` for every new
  body: each field within rtol 1e-5 of its largest entry, the port's batch
  decoded by the JAX codec and the JAX batch by the port's.

Newton fits run ``maxIter`` = 5 at ``regParam`` 0.1, where both packages' iterates
have converged to within the tolerance (at 0.01 five iterations leave the
f32 statistics' differences at 2e-5 of the coefficients, in the core fits
too).
"""

import jax  # noqa: F401  (imported at the top of every port test file)
import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

from spark_rapids_ml_tpu.models import linear as JM
from spark_rapids_ml_tpu.spark import arrow_fns as jax_arrow_fns
from spark_rapids_ml_tpu_torch import LinearRegression, LogisticRegression
from spark_rapids_ml_tpu_torch.localspark import LocalSparkSession
from spark_rapids_ml_tpu_torch.localspark import types as T
from spark_rapids_ml_tpu_torch.models import linear as TM
from spark_rapids_ml_tpu_torch.spark import (
    SparkLinearRegression,
    SparkLinearRegressionModel,
    SparkLinearSVC,
    SparkLinearSVCModel,
    SparkLogisticRegression,
    SparkLogisticRegressionModel,
    arrow_fns,
)

CPU = torch.device("cpu")
ROWS, N = 1_200, 8
STATS_RTOL = 1e-5
LINREG_RTOL = 2e-5
NEWTON_ATOL = 1e-5


@pytest.fixture(scope="module")
def spark():
    with LocalSparkSession(parallelism=2, worker_platform="cpu") as s:
        yield s


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(ROWS, N)) + 0.5).astype(np.float32)
    yr = (x @ rng.normal(size=N) + 0.7 + 0.1 * rng.normal(size=ROWS)).astype(np.float32)
    yb = (x @ rng.normal(size=N) + 0.5 * rng.normal(size=ROWS) > 1.0).astype(np.float64)
    logits = x @ rng.normal(size=(N, 3)) + rng.normal(size=(ROWS, 3))
    y3 = np.argmax(logits, axis=1).astype(np.float64)
    w = rng.uniform(0.2, 2.0, size=ROWS)
    return x, yr.astype(np.float64), yb, y3, w


@pytest.fixture(scope="module")
def df(spark, data):
    x, yr, yb, y3, w = data
    schema = T.StructType([
        T.StructField("features", T.ArrayType(T.DoubleType())),
        T.StructField("reg", T.DoubleType()),
        T.StructField("label", T.DoubleType()),
        T.StructField("label3", T.DoubleType()),
        T.StructField("weight", T.DoubleType()),
    ])
    rows = [(r.tolist(), a, b, c, d)
            for r, a, b, c, d in zip(x.astype(np.float64), yr, yb, y3, w)]
    return spark.createDataFrame(rows, schema, numPartitions=3)


def _close(got, ref, rel, scale):
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(scale, 1e-30))


def _coef_close(port, ref, rel):
    scale = np.abs(ref.coefficients).max()
    _close(port.coefficients, ref.coefficients, rel, scale)
    _close(port.intercept, ref.intercept, rel, scale)


def _batch(x, **cols):
    arrays = [pa.FixedSizeListArray.from_arrays(pa.array(x.astype(np.float64).reshape(-1)),
                                                x.shape[1])]
    arrays += [pa.array(np.asarray(v, dtype=np.float64)) for v in cols.values()]
    return pa.RecordBatch.from_arrays(arrays, names=["features", *cols])


def _decoded_close(port_fn, jax_fn, batch, shapes):
    """Both bodies on one batch; each batch decoded by both codecs."""
    port_b = list(port_fn(iter([batch])))
    jax_b = list(jax_fn(iter([batch])))
    assert port_b[0].schema == jax_b[0].schema
    ref = jax_arrow_fns.arrays_from_batches(jax_b, shapes)
    for got in (arrow_fns.arrays_from_batches(port_b, shapes),
                jax_arrow_fns.arrays_from_batches(port_b, shapes)):
        for name in shapes:
            _close(got[name], ref[name], STATS_RTOL, np.abs(ref[name]).max())
    for name, v in arrow_fns.arrays_from_batches(jax_b, shapes).items():
        np.testing.assert_array_equal(v, ref[name])


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", [{}, {"regParam": 0.05, "elasticNetParam": 0.5}])
def test_linear_regression_matches_jax_core(df, data, weighted, case):
    x, yr, _, _, w = data
    est = SparkLinearRegression(device=CPU, **case).setLabelCol("reg")
    if weighted:
        est.setWeightCol("weight")
    model = est.fit(df)
    assert isinstance(model, SparkLinearRegressionModel)
    ref = JM.LinearRegression(**case).fit((x, yr, w) if weighted else (x, yr))
    _coef_close(model, ref, LINREG_RTOL)
    got = np.asarray([r["prediction"] for r in model.transform(df).collect()])
    np.testing.assert_allclose(got, model._predict_matrix(x), rtol=0,
                               atol=1e-5 * np.abs(yr).max())


@pytest.mark.parametrize("weighted", [False, True])
def test_binary_logistic_newton_jobs_match_jax_core(df, data, weighted):
    x, _, yb, _, w = data
    est = SparkLogisticRegression(device=CPU).setMaxIter(5).setRegParam(0.1)
    if weighted:
        est.setWeightCol("weight")
    model = est.fit(df)
    assert isinstance(model, SparkLogisticRegressionModel) and model.numClasses == 2
    ref = JM.LogisticRegression().setMaxIter(5).setRegParam(0.1).fit(
        (x, yb, w) if weighted else (x, yb))
    _coef_close(model, ref, NEWTON_ATOL)
    est.setProbabilityCol("probability")
    rows = est.fit(df).transform(df).collect()
    proba = np.asarray([r["probability"] for r in rows])
    want_p, want_pred = model.proba_and_predictions(x)
    np.testing.assert_allclose(proba, want_p, rtol=0, atol=1e-6)
    np.testing.assert_array_equal([r["prediction"] for r in rows], want_pred)


def test_multinomial_newton_jobs_match_jax_core(df, data):
    x, _, _, y3, _ = data
    model = SparkLogisticRegression(device=CPU).setMaxIter(5).setRegParam(0.1).setLabelCol(
        "label3").fit(df)
    assert model.numClasses == 3 and model.coefficientMatrix.shape == (3, N)
    ref = JM.LogisticRegression().setMaxIter(5).setRegParam(0.1).fit((x, y3))
    np.testing.assert_allclose(model.predict_proba_matrix(x),
                               np.asarray(ref.predict_proba_matrix(x)), rtol=0,
                               atol=NEWTON_ATOL)
    preds = np.asarray([r["prediction"] for r in model.transform(df).collect()])
    np.testing.assert_array_equal(preds, model._predict_matrix(x))


def test_linear_svc_matches_jax_core(df, data):
    x, _, yb, _, w = data
    model = SparkLinearSVC(device=CPU).setMaxIter(5).setRegParam(0.1).setWeightCol("weight").fit(df)
    assert isinstance(model, SparkLinearSVCModel)
    ref = JM.LinearSVC().setMaxIter(5).setRegParam(0.1).setWeightCol("weight").fit((x, yb, w))
    _coef_close(model, ref, NEWTON_ATOL)
    rows = model.transform(df).collect()
    raw = np.asarray([r["rawPrediction"] for r in rows])
    m = model.margins(x)
    np.testing.assert_allclose(raw, np.stack([-m, m], 1), rtol=0, atol=1e-5 * np.abs(m).max())


def test_linear_bodies_match_jax_bodies_on_one_batch(data):
    x, yr, yb, y3, w = data
    batch = _batch(x[:400], reg=yr[:400], label=yb[:400], label3=y3[:400], weight=w[:400])
    lin = {"xtx": (N, N), "xty": (N,), "x_sum": (N,), "y_sum": (), "y_sq": (), "count": ()}
    _decoded_close(arrow_fns.LinRegPartitionFn("features", "reg", "weight", device="cpu"),
                   jax_arrow_fns.LinRegPartitionFn("features", "reg", "weight"), batch, lin)
    w_full = np.linspace(-0.3, 0.3, N + 1)
    d = N + 1
    newton = {"hess": (d, d), "grad": (d,), "loss": (), "count": ()}
    _decoded_close(
        arrow_fns.LogRegNewtonPartitionFn("features", "label", w_full, weight_col="weight",
                                          device="cpu"),
        jax_arrow_fns.LogRegNewtonPartitionFn("features", "label", w_full, weight_col="weight"),
        batch, newton)
    w_flat = np.linspace(-0.2, 0.2, 3 * d)
    soft = {"hess": (3 * d, 3 * d), "grad": (3 * d,), "loss": (), "count": ()}
    _decoded_close(
        arrow_fns.SoftmaxNewtonPartitionFn("features", "label3", w_flat, 3, device="cpu"),
        jax_arrow_fns.SoftmaxNewtonPartitionFn("features", "label3", w_flat, 3), batch, soft)
    port_l = list(arrow_fns.LabelScanPartitionFn("label3")(iter([batch, batch.slice(0, 0)])))
    jax_l = list(jax_arrow_fns.LabelScanPartitionFn("label3")(iter([batch])))
    for got in (arrow_fns.labels_from_batches(port_l + jax_l),
                jax_arrow_fns.labels_from_batches(port_l)):
        np.testing.assert_array_equal(got, [0.0, 1.0, 2.0])


def test_labeled_bodies_read_a_frame_of_named_columns(data):
    """The array body the card runs: no Arrow, the label and weight read by
    ``columnar.extract_vector`` from a frame of named columns."""
    x, yr, _, _, w = data
    frame = pd.DataFrame({"features": list(x[:300]), "reg": yr[:300], "weight": w[:300]})
    fn = arrow_fns.LinRegPartitionFn("features", "reg", "weight", device="cpu")
    stats = fn.partition_stats([frame.iloc[:100], frame.iloc[100:100], frame.iloc[100:]])
    xd = x[:300].astype(np.float64)
    _close(stats.xtx.numpy(), (xd * w[:300, None]).T @ xd, STATS_RTOL,
           np.abs((xd * w[:300, None]).T @ xd).max())
    assert float(stats.count) == pytest.approx(w[:300].sum(), rel=1e-6)
    with pytest.raises(ValueError, match="requires 0/1 labels"):
        arrow_fns.LogRegNewtonPartitionFn("features", "reg", np.zeros(N + 1),
                                          device="cpu").partition_stats([frame])


def test_killed_newton_fit_resumes_between_jobs(df, tmp_path, monkeypatch):
    full = SparkLogisticRegression(device=CPU).setMaxIter(4).fit(df)
    calls = {"n": 0}
    step = SparkLogisticRegression.newton_step

    def dying(self, *a, **kw):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("killed")
        return step(self, *a, **kw)

    monkeypatch.setattr(SparkLogisticRegression, "newton_step", dying)
    est = SparkLogisticRegression(device=CPU).setMaxIter(4)
    with pytest.raises(RuntimeError, match="killed"):
        est.fit(df, checkpoint_dir=str(tmp_path), checkpoint_every=1)
    monkeypatch.setattr(SparkLogisticRegression, "newton_step", step)
    resumed = est.fit(df, checkpoint_dir=str(tmp_path), checkpoint_every=1)
    np.testing.assert_allclose(resumed.coefficients, full.coefficients, rtol=0, atol=1e-12)
    # the core fit reads the same layout: a finished Spark checkpoint resumes
    # the core loop at maxIter
    core = TM.LogisticRegression(device=CPU).setMaxIter(4).fit(
        (np.zeros((4, N), np.float32), np.array([0.0, 1.0, 0.0, 1.0])),
        checkpoint_dir=str(tmp_path))
    np.testing.assert_allclose(core.coefficients, full.coefficients, rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def jax_mesh_local_fits(data):
    """The JAX package's Spark fits under ``"mesh-local"`` (its mesh of the
    suite's 8 virtual devices) on a JAX local session over the same rows:
    weighted LinearRegression and binary LogisticRegression."""
    from spark_rapids_ml_tpu import spark as JSP
    from spark_rapids_ml_tpu.localspark import LocalSparkSession as JaxSession
    from spark_rapids_ml_tpu.localspark import types as JT

    x, yr, yb, _, w = data
    schema = JT.StructType([
        JT.StructField("features", JT.ArrayType(JT.DoubleType())),
        JT.StructField("reg", JT.DoubleType()), JT.StructField("label", JT.DoubleType()),
        JT.StructField("weight", JT.DoubleType()),
    ])
    with JaxSession(parallelism=2) as s:
        jdf = s.createDataFrame([(r.tolist(), a, b, c) for r, a, b, c in
                                 zip(x.astype(np.float64), yr, yb, w)], schema, numPartitions=3)
        linreg = JSP.SparkLinearRegression().setLabelCol("reg").setWeightCol("weight") \
            .setRegParam(0.1).setDistribution("mesh-local").fit(jdf)
        logreg = JSP.SparkLogisticRegression().setWeightCol("weight").setRegParam(0.1) \
            .setMaxIter(5).setDistribution("mesh-local").fit(jdf)
    return linreg, logreg


@pytest.mark.parametrize("distribution", ["mesh-local", "mesh-barrier"])
def test_mesh_distributions_are_refused_at_fit(df, jax_mesh_local_fits, distribution,
                                               monkeypatch):
    """The mesh distributions fit (mesh-local on four CPU shards of the
    driver's mesh, mesh-barrier in one barrier stage of CPU workers) and
    agree with the JAX package's Spark fit under ``"mesh-local"``; only
    LinearSVC's mesh-barrier, which the JAX package refuses too, is
    refused."""
    from spark_rapids_ml_tpu_torch.parallel import mesh as PM
    from spark_rapids_ml_tpu_torch.spark import estimators as SE

    monkeypatch.setattr(SE, "_driver_mesh", lambda device: PM.create_mesh(devices=[device] * 4))
    ref_lin, ref_log = jax_mesh_local_fits
    lin = SparkLinearRegression(device=CPU).setLabelCol("reg").setWeightCol("weight") \
        .setRegParam(0.1).setDistribution(distribution).fit(df)
    _coef_close(lin, ref_lin, LINREG_RTOL)
    log = SparkLogisticRegression(device=CPU).setWeightCol("weight").setRegParam(0.1) \
        .setMaxIter(5).setDistribution(distribution).fit(df)
    _coef_close(log, ref_log, NEWTON_ATOL)
    assert type(lin) is SparkLinearRegressionModel and type(log) is SparkLogisticRegressionModel
    with pytest.raises(ValueError, match="distribution must be one of"):
        SparkLinearSVC(device=CPU).setDistribution("mesh-barrier")


def test_cuda_body_in_a_cpu_worker_names_both_settings(df):
    """A body asking for the card in a worker whose cards are hidden raises
    there; nothing falls back to the CPU."""
    fields = ["xtx", "xty", "x_sum", "y_sum", "y_sq", "count"]
    schema = T.StructType([T.StructField(f, T.ArrayType(T.DoubleType())) for f in fields])
    plan = df.select("features", "reg").mapInArrow(
        arrow_fns.make_linreg_partition_fn("features", "reg"), schema=schema)
    with pytest.raises(Exception, match="worker_platform='cpu'.*device='cpu'"):
        plan.collect()


def test_non_spark_input_falls_through_to_the_core_fit(data):
    x, yr, yb, _, _ = data
    model = SparkLinearRegression(device=CPU).fit((x, yr))
    core = LinearRegression(device=CPU).fit((x, yr))
    assert type(model) is SparkLinearRegressionModel
    np.testing.assert_array_equal(model.coefficients, core.coefficients)
    logit = SparkLogisticRegression(device=CPU).setMaxIter(3).fit((x, yb))
    assert type(logit) is SparkLogisticRegressionModel
    np.testing.assert_array_equal(
        logit.coefficients, LogisticRegression(device=CPU).setMaxIter(3).fit((x, yb)).coefficients)
    with pytest.raises(NotImplementedError, match="one closed-form pass"):
        SparkLinearRegression(device=CPU).fit((x, yr), checkpoint_dir="unused")
