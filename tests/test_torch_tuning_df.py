"""The port's model selection over a DataFrame of the port's local Spark
engine, against the same search run by the JAX package's core on the same
split rows.

The folds are one ``randomSplit`` of the DataFrame; the test reads each
fold's rows back through an ``id`` column and hands the JAX package's
``CrossValidator`` arithmetic the same rows as (X, y) tuples: the JAX core
estimators fit each fold's train rows and the JAX evaluators score its
validation rows. Tolerances: each candidate's metric rtol 1e-5 (RMSE; the
fits agree to 2e-5 of the largest coefficient, ``tests/test_torch_linear.py``)
or 1e-5 absolute (AUC), ``bestIndex`` equal. The evaluators over a
DataFrame read their columns in one job and give the tuple container's
metric exactly. The rows are f32 values made with numpy from a seed,
stored as float64 columns, in 3 partitions of one module-scoped session of
CPU workers.
"""

import jax  # noqa: F401  (imported at the top of every port test file)
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.models import linear as JLIN
from spark_rapids_ml_tpu.models import tuning as JT
from spark_rapids_ml_tpu_torch.localspark import LocalSparkSession
from spark_rapids_ml_tpu_torch.localspark import types as T
from spark_rapids_ml_tpu_torch.models import tuning as PT
from spark_rapids_ml_tpu_torch.spark import SparkLinearRegression, SparkLogisticRegression

CPU = torch.device("cpu")
ROWS, N = 900, 6


@pytest.fixture(scope="module")
def spark():
    with LocalSparkSession(parallelism=2, worker_platform="cpu") as s:
        yield s


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(51)
    x = (rng.normal(size=(ROWS, N)) + 0.3).astype(np.float32)
    yr = (x @ rng.normal(size=N) + 0.5 + 0.4 * rng.normal(size=ROWS)).astype(np.float32)
    yb = (x @ rng.normal(size=N) + rng.normal(size=ROWS) > 0.2).astype(np.float64)
    return x, yr.astype(np.float64), yb


@pytest.fixture(scope="module")
def df(spark, data):
    x, yr, yb = data
    schema = T.StructType([
        T.StructField("id", T.LongType()),
        T.StructField("features", T.ArrayType(T.DoubleType())),
        T.StructField("reg", T.DoubleType()),
        T.StructField("label", T.DoubleType()),
    ])
    rows = [(i, r.tolist(), a, b) for i, (r, a, b) in
            enumerate(zip(x.astype(np.float64), yr, yb))]
    return spark.createDataFrame(rows, schema, numPartitions=3)


def _ids(split) -> np.ndarray:
    return np.asarray([r["id"] for r in split.select("id").collect()], dtype=np.int64)


def _jax_metric(est, evaluator, data, train, val):
    """One candidate of the JAX package's search on the given rows."""
    x, y = data
    return JT._fit_and_eval(est, {}, evaluator, (x[train], y[train]), (x[val], y[val]))[1]


def test_cross_validation_over_a_dataframe_matches_jax(df, data):
    x, yr, _ = data
    grid = [{"regParam": 0.0}, {"regParam": 3.0}]
    cvm = PT.CrossValidator(
        estimator=SparkLinearRegression(device=CPU).setLabelCol("reg"),
        estimatorParamMaps=grid, evaluator=PT.RegressionEvaluator().setLabelCol("reg"),
        numFolds=3, seed=5, collectSubModels=True,
    ).fit(df)
    folds = [_ids(s) for s in df.randomSplit([1.0 / 3] * 3, seed=5)]
    assert sorted(np.concatenate(folds)) == list(range(ROWS))
    want = np.zeros((2, 3))
    for f, val in enumerate(folds):
        train = np.concatenate([folds[i] for i in range(3) if i != f])
        for c, params in enumerate(grid):
            want[c, f] = _jax_metric(JLIN.LinearRegression(**params), JT.RegressionEvaluator(),
                                     (x, yr), train, val)
    np.testing.assert_allclose(cvm.avgMetrics, want.mean(1), rtol=1e-5)
    assert cvm.bestIndex == int(np.argmin(want.mean(1))) == 0
    assert len(cvm.subModels) == 3 and type(cvm.subModels[0][0]).__name__.startswith("Spark")
    # the best model refits on the whole DataFrame and transforms it
    rows = cvm.transform(df).collect()
    assert len(rows) == ROWS and "prediction" in rows[0].asDict()


def test_train_validation_split_over_a_dataframe_matches_jax(df, data):
    x, _, yb = data
    grid = [{"regParam": 0.1}, {"regParam": 5.0}]
    evaluator = PT.BinaryClassificationEvaluator()
    tvs = PT.TrainValidationSplit(
        estimator=SparkLogisticRegression(device=CPU).setMaxIter(5), estimatorParamMaps=grid,
        evaluator=evaluator, trainRatio=0.7, seed=2,
    ).fit(df)
    train, val = (_ids(s) for s in df.randomSplit([0.7, 0.3], seed=2))
    want = [_jax_metric(JLIN.LogisticRegression(maxIter=5, **p),
                        JT.BinaryClassificationEvaluator(), (x, yb), train, val) for p in grid]
    np.testing.assert_allclose(tvs.validationMetrics, want, rtol=0, atol=1e-5)
    assert tvs.bestIndex == int(np.argmax(want))


def test_evaluators_read_a_dataframe_like_the_tuple(spark, data):
    x, yr, yb = data
    rng = np.random.default_rng(3)
    pred = yr + 0.3 * rng.normal(size=ROWS)
    p1 = 1.0 / (1.0 + np.exp(-(x[:, 0] + rng.normal(size=ROWS))))
    y3 = rng.integers(0, 3, ROWS).astype(np.float64)
    proba3 = rng.dirichlet(np.ones(3), ROWS)
    w = rng.uniform(0.5, 2.0, ROWS)
    clusters = (x[:, 0] > 0.3).astype(np.float64)
    schema = T.StructType([
        T.StructField("features", T.ArrayType(T.DoubleType())),
        T.StructField("reg", T.DoubleType()), T.StructField("pred", T.DoubleType()),
        T.StructField("label", T.DoubleType()),
        T.StructField("probability", T.ArrayType(T.DoubleType())),
        T.StructField("label3", T.DoubleType()),
        T.StructField("proba3", T.ArrayType(T.DoubleType())),
        T.StructField("pred3", T.DoubleType()),
        T.StructField("weight", T.DoubleType()), T.StructField("cluster", T.DoubleType()),
    ])
    rows = [(x[i].astype(np.float64).tolist(), yr[i], pred[i], yb[i], [1 - p1[i], p1[i]],
             y3[i], proba3[i].tolist(), float(np.argmax(proba3[i])), w[i], clusters[i])
            for i in range(ROWS)]
    frame = spark.createDataFrame(rows, schema, numPartitions=3)
    reg = PT.RegressionEvaluator().setLabelCol("reg").setPredictionCol("pred") \
        .setWeightCol("weight")
    assert reg.evaluate(frame) == reg.evaluate((x, yr, w), predictions=pred)
    auc = PT.BinaryClassificationEvaluator().setWeightCol("weight")
    assert auc.evaluate(frame) == auc.evaluate((x, yb, w), predictions=p1)
    for metric in ("f1", "logLoss"):
        mc = PT.MulticlassClassificationEvaluator().setLabelCol("label3") \
            .setPredictionCol("pred3").setProbabilityCol("proba3").setMetricName(metric)
        want = proba3 if metric == "logLoss" else np.argmax(proba3, 1).astype(np.float64)
        assert mc.evaluate(frame) == mc.evaluate((x, y3), predictions=want)
    sil = PT.ClusteringEvaluator()
    sil._set(predictionCol="cluster", maxRows=ROWS)
    assert sil.evaluate(frame) == pytest.approx(sil.evaluate((x, None), predictions=clusters),
                                                rel=1e-12)
    assert PT.n_rows(frame) == ROWS


def test_a_jax_localspark_dataframe_is_refused(data):
    x, yr, _ = data
    jax_df = type("DataFrame", (), {"__module__": "spark_rapids_ml_tpu.localspark.dataframe"})()
    for call in (lambda: PT.CrossValidator(estimator=SparkLinearRegression(device=CPU),
                                           evaluator=PT.RegressionEvaluator()).fit(jax_df),
                 lambda: PT.RegressionEvaluator().evaluate(jax_df),
                 lambda: PT.n_rows(jax_df)):
        with pytest.raises(TypeError, match="JAX package's localspark"):
            call()
