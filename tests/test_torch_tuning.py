"""The port's model selection against the JAX package's.

Tolerances, each the arithmetic's:

- ``ParamGridBuilder`` and the four evaluators (Regression, Binary with
  tied-score groups, Multiclass, Clustering with its ``maxRows``
  subsample), weighted and not: equal, bit for bit. Both sides are the same
  numpy arithmetic on the same f64 host vectors.
- CrossValidator and TrainValidationSplit: the same folds
  (``np.random.default_rng(seed).permutation``, asserted through
  ``n_rows``/``row_slice`` and the candidates' training sizes), and
  ``bestIndex`` equal on grids whose JAX metrics are separated by more than
  100× the tolerance. ``avgMetrics`` by family: the port fits on f32 rows on
  its device, the JAX package in f64 (the suite runs it with x64), so RMSE
  agrees to rtol 1e-4, AUC to 1e-4 absolute, and accuracy to one
  validation row in 50 (a near-tie prediction may flip).
"""

import jax  # noqa: F401
import numpy as np
import pytest

from spark_rapids_ml_tpu.models import kmeans as JK
from spark_rapids_ml_tpu.models import linear as JLIN
from spark_rapids_ml_tpu.models import naive_bayes as JNB
from spark_rapids_ml_tpu.models import tuning as JT
from spark_rapids_ml_tpu_torch.models import kmeans as PK
from spark_rapids_ml_tpu_torch.models import linear as PLIN
from spark_rapids_ml_tpu_torch.models import naive_bayes as PNB
from spark_rapids_ml_tpu_torch.models import tuning as PT

pd = pytest.importorskip("pandas")


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(19)


def test_param_grids_match_jax():
    for mod in (PT, JT):
        grid = (mod.ParamGridBuilder().baseOn(maxIter=5).addGrid("regParam", [0.0, 0.1])
                .addGrid("fitIntercept", [True, False]).build())
        assert grid == (JT.ParamGridBuilder().baseOn(maxIter=5).addGrid("regParam", [0.0, 0.1])
                        .addGrid("fitIntercept", [True, False]).build())
    assert PT.ParamGridBuilder().addGrid(PLIN.LinearRegression.regParam, [1.0]).build() == [
        {"regParam": 1.0}]


@pytest.mark.parametrize("weighted", [False, True])
def test_evaluators_are_bit_equal(rng, weighted):
    n = 300
    y = rng.normal(size=n)
    p = y + 0.3 * rng.normal(size=n)
    yb = (rng.random(n) < 0.3).astype(float)
    scores = np.round(rng.random(n), 1)  # tied score groups
    yc = rng.integers(0, 4, size=n).astype(float)
    pc = np.where(rng.random(n) < 0.6, yc, rng.integers(0, 4, size=n)).astype(float)
    probs = rng.dirichlet(np.ones(4), size=n)
    w = rng.uniform(0.0, 2.0, size=n) if weighted else None
    x = rng.normal(size=(n, 3)) + 4.0 * rng.integers(0, 3, size=n)[:, None]
    cases = [
        ("RegressionEvaluator", m, (None, y, w), p) for m in ("rmse", "mse", "mae", "r2", "var")
    ] + [
        ("BinaryClassificationEvaluator", m, (None, yb, w), scores)
        for m in ("areaUnderROC", "areaUnderPR", "accuracy")
    ] + [
        ("MulticlassClassificationEvaluator", m, (None, yc, w), pc)
        for m in ("f1", "accuracy", "weightedPrecision", "weightedRecall")
    ] + [("MulticlassClassificationEvaluator", "logLoss", (None, yc, w), probs)]
    for name, metric, data, pred in cases:
        got = []
        for mod in (PT, JT):
            ev = getattr(mod, name)().setMetricName(metric)
            if weighted:
                ev.setWeightCol("w")
            got.append(ev.evaluate(data, predictions=pred))
            assert ev.isLargerBetter() == getattr(JT, name)().setMetricName(
                metric).isLargerBetter()
        assert got[0] == got[1], (name, metric)
    for cap in (2048, 100):
        labels = np.argmin(((x[:, None, :] - x[[0, 1, 2]][None]) ** 2).sum(-1), axis=1)
        got = [mod.ClusteringEvaluator(maxRows=cap, weightCol="w" if weighted else "").evaluate(
            (x, None, w), predictions=labels) for mod in (PT, JT)]
        assert got[0] == got[1]


def test_evaluators_read_frames_like_jax(rng):
    n = 80
    y = (rng.random(n) < 0.5).astype(float)
    prob = rng.random(n)
    df = pd.DataFrame({"label": y, "prediction": (prob > 0.5).astype(float),
                       "probability": list(np.stack([1 - prob, prob], 1)),
                       "w": rng.uniform(0.5, 1.5, size=n)})
    for metric in ("areaUnderROC", "areaUnderPR", "accuracy"):
        got = [mod.BinaryClassificationEvaluator(metricName=metric, weightCol="w").evaluate(df)
               for mod in (PT, JT)]
        assert got[0] == got[1]
    got = [mod.MulticlassClassificationEvaluator(metricName="logLoss").evaluate(df)
           for mod in (PT, JT)]
    assert got[0] == got[1]
    bare = df.drop(columns=["probability"])
    for mod in (PT, JT):
        with pytest.warns(UserWarning, match="no score column found"):
            mod.BinaryClassificationEvaluator().evaluate(bare)


def test_folds_and_slices_match_jax(rng):
    x = rng.normal(size=(37, 3)).astype(np.float32)
    y = rng.normal(size=37)
    df = pd.DataFrame({"features": list(x), "label": y})
    idx = np.random.default_rng(4).permutation(37)[:11]
    for data in ((x, y), (x, y, None), x, df):
        assert PT.n_rows(data) == JT.n_rows(data) == 37
        p, j = PT.row_slice(data, idx), JT.row_slice(data, idx)
        if isinstance(data, tuple):
            for a, b in zip(p, j):
                assert (a is None and b is None) or np.array_equal(a, b)
        elif isinstance(data, np.ndarray):
            np.testing.assert_array_equal(p, j)
        else:
            pd.testing.assert_frame_equal(p, j)


def _cv(mod, est, grid, ev, data, folds=2, seed=3):
    return mod.CrossValidator(estimator=est, estimatorParamMaps=grid, evaluator=ev,
                              numFolds=folds, seed=seed).fit(data)


def _separated(metrics, tol):
    s = sorted(metrics)
    return all(b - a > 100 * tol for a, b in zip(s, s[1:]))


def test_cv_linear_regression_matches_jax(rng):
    x = rng.normal(size=(240, 5)).astype(np.float32)
    y = x @ rng.normal(size=5) + 0.1 * rng.normal(size=240)
    grid = [{"regParam": r} for r in (0.0, 1.0, 30.0)]
    p = _cv(PT, PLIN.LinearRegression(device="cpu"), grid, PT.RegressionEvaluator(), (x, y))
    j = _cv(JT, JLIN.LinearRegression(), grid, JT.RegressionEvaluator(), (x, y))
    np.testing.assert_allclose(p.avgMetrics, j.avgMetrics, rtol=1e-4)
    assert _separated(j.avgMetrics, 1e-4 * max(j.avgMetrics))
    assert p.bestIndex == j.bestIndex == 0
    np.testing.assert_allclose(p.bestModel.coefficients, j.bestModel.coefficients,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(p.transform(x), j.transform(x), rtol=1e-4, atol=1e-4)


def test_tvs_logistic_auc_on_a_frame_matches_jax(rng):
    x = rng.normal(size=(300, 4)).astype(np.float32)
    y = (x[:, 0] - 0.5 * x[:, 1] + rng.normal(size=300) > 0).astype(float)
    df = pd.DataFrame({"features": list(x), "label": y})
    grid = [{"regParam": r} for r in (0.0, 1.0, 10.0)]
    out = []
    for mod, est in ((PT, PLIN.LogisticRegression(device="cpu")),
                     (JT, JLIN.LogisticRegression())):
        out.append(mod.TrainValidationSplit(
            estimator=est, estimatorParamMaps=grid,
            evaluator=mod.BinaryClassificationEvaluator(), trainRatio=0.75, seed=2).fit(df))
    p, j = out
    np.testing.assert_allclose(p.validationMetrics, j.validationMetrics, rtol=0, atol=1e-4)
    assert p.bestIndex == j.bestIndex
    # AUC ranks the probability surface, not the thresholded labels
    model, auc = PT._fit_and_eval(PLIN.LogisticRegression(device="cpu"), {},
                                  PT.BinaryClassificationEvaluator(),
                                  (x[:200], y[:200]), (x[200:], y[200:]))
    hard = (model.predict_proba_matrix(x[200:]) >= 0.5).astype(float)
    assert auc > PT.BinaryClassificationEvaluator().evaluate((None, y[200:]), predictions=hard)


def test_cv_naive_bayes_accuracy_matches_jax(rng):
    rows, n, classes = 400, 20, 3
    rates = rng.uniform(0.1, 2.0, size=(classes, n))
    y = rng.integers(0, classes, size=rows)
    x = rng.poisson(rates[y]).astype(np.float32)
    grid = [{"smoothing": s} for s in (0.01, 1.0, 50.0)]
    ev = {"metricName": "accuracy"}
    p = _cv(PT, PNB.NaiveBayes(device="cpu"), grid,
            PT.MulticlassClassificationEvaluator(**ev), (x, y.astype(float)))
    j = _cv(JT, JNB.NaiveBayes(), grid,
            JT.MulticlassClassificationEvaluator().setMetricName("accuracy"), (x, y.astype(float)))
    np.testing.assert_allclose(p.avgMetrics, j.avgMetrics, rtol=0, atol=1 / 50)
    assert p.bestIndex == j.bestIndex


def test_cv_kmeans_silhouette_matches_jax(rng):
    x = np.vstack([rng.normal(size=(40, 3)) + 8, rng.normal(size=(40, 3)) - 8]).astype(np.float32)
    grid = [{"k": 2}, {"k": 5}]
    p = _cv(PT, PK.KMeans(device="cpu", seed=0), grid, PT.ClusteringEvaluator(), x)
    j = _cv(JT, JK.KMeans().setSeed(0), grid, JT.ClusteringEvaluator(), x)
    assert p.bestIndex == j.bestIndex == 0
    np.testing.assert_allclose(p.avgMetrics[0], j.avgMetrics[0], rtol=1e-4)


def test_sub_models_and_refusals(rng):
    x = rng.normal(size=(60, 2)).astype(np.float32)
    y = x.sum(1)
    cvm = PT.CrossValidator(estimator=PLIN.LinearRegression(device="cpu"),
                            estimatorParamMaps=[{"regParam": 0.0}, {"regParam": 1.0}],
                            evaluator=PT.RegressionEvaluator(), numFolds=3,
                            collectSubModels=True).fit((x, y))
    assert len(cvm.subModels) == 3 and all(len(f) == 2 for f in cvm.subModels)
    with pytest.raises(ValueError, match="numFolds must be >= 2"):
        PT.CrossValidator(estimator=PLIN.LinearRegression(device="cpu"),
                          evaluator=PT.RegressionEvaluator(), numFolds=1).fit((x, y))
    with pytest.raises(ValueError, match=r"trainRatio must be in \(0, 1\)"):
        PT.TrainValidationSplit(estimator=PLIN.LinearRegression(device="cpu"),
                                evaluator=PT.RegressionEvaluator(), trainRatio=1.5).fit((x, y))
    spark_df = type("DataFrame", (), {"__module__": "pyspark.sql.dataframe"})()
    for call in (lambda: PT.CrossValidator(estimator=PLIN.LinearRegression(device="cpu"),
                                           evaluator=PT.RegressionEvaluator()).fit(spark_df),
                 lambda: PT.RegressionEvaluator().evaluate(spark_df)):
        with pytest.raises(TypeError, match="Queue A item 5"):
            call()


def test_raw_scale_logistic_fit_is_far_from_f64_and_standardized_is_not():
    """On Adult's raw numeric scales (fnlwgt ~2e5, capital-gain ~1e4) the
    port's f32 Newton (25 iterations from zero, no line search) stays far
    from the f64 Newton's optimum; standardized, its AUC, the JAX package's
    (f64 here: the suite runs JAX with x64) and the f64 Newton's agree to
    1e-6. Phase 18 (b) standardizes for that reason (PERF.md §6)."""
    import chip_smoke
    import torch

    frame = chip_smoke.adult_workload(4000, seed=3)
    cats = list(chip_smoke.ADULT_CATEGORIES)
    raw = np.concatenate([np.stack([frame[c].to_numpy() for c in chip_smoke.ADULT_NUMERIC], 1)]
                         + [chip_smoke._one_hot_numpy(frame[c].to_numpy()) for c in cats],
                         axis=1).astype(np.float32)
    y = (frame["income"].to_numpy() == ">50K").astype(np.float64)
    scaled = ((raw - raw.mean(0)) / raw.std(0)).astype(np.float32)
    aucs = {}
    for name, x in (("raw", raw), ("scaled", scaled)):
        w64, _, _ = chip_smoke.newton_oracle_f64(torch.from_numpy(x), torch.from_numpy(y), 0.0)
        p64 = torch.sigmoid(torch.from_numpy(x).double() @ w64[:-1] + w64[-1]).numpy()
        models = [PLIN.LogisticRegression(device="cpu").fit((x, y))]
        if name == "scaled":
            models.append(JLIN.LogisticRegression().fit((x, y)))
        aucs[name] = [chip_smoke._auc(y, m.predict_proba_matrix(x)) for m in models]
        aucs[name].append(chip_smoke._auc(y, p64))
    assert aucs["raw"][1] - aucs["raw"][0] > 0.2
    assert np.ptp(aucs["scaled"]) < 1e-6
