"""The port's collect-and-fit Spark families, neighbours and DBSCAN on the
port's local Spark engine; the Spark namespace; the Spark models' saves.

The rows are f32 values made with numpy from a seed, stored as the
DataFrame's float64 columns, in 3 partitions of one module-scoped session
of CPU workers. A DataFrame fit collects (features, label, weight) on the
driver and runs the core fit, so each is held to:

- the JAX core fit on the same f32 rows where the fit draws nothing the
  packages cannot share (the forests with every feature, GBT, NaiveBayes,
  OneVsRest, isotonic, exact k-NN, DBSCAN): the forests' and GBT's tree
  arrays and the k-NN ids and DBSCAN labels exactly equal, predictions
  exactly equal, GBT margins, NaiveBayes probabilities and k-NN distances
  within 1e-5 of their largest entry, OneVsRest's coefficients atol 1e-5;
- the port's core fit on the same rows where the fit starts from a torch
  draw (the MLP, FM, UMAP, the ANN quantizer), which
  ``tests/test_torch_{mlp,fm,umap,ann}.py`` hold to the JAX package: the
  fitted arrays exactly equal.

Every transform is held to the model's own local transform of the rows.
"""

import jax  # noqa: F401  (imported at the top of every port test file)
import numpy as np
import pytest
import torch

import spark_rapids_ml_tpu as J
import spark_rapids_ml_tpu.spark as JSP
from spark_rapids_ml_tpu.models.isotonic import IsotonicRegression as JaxIsotonic
from spark_rapids_ml_tpu.models.ovr import OneVsRest as JaxOneVsRest
from spark_rapids_ml_tpu.utils import persistence as jax_persistence
import spark_rapids_ml_tpu_torch as P
from spark_rapids_ml_tpu_torch import spark as SP
from spark_rapids_ml_tpu_torch.localspark import LocalSparkSession
from spark_rapids_ml_tpu_torch.localspark import types as T
from spark_rapids_ml_tpu_torch.models.base import Saveable
from torch_forest_gate import assert_trees_equal_up_to_gate_rule, forest_inputs

CPU = torch.device("cpu")
ROWS, N = 600, 6


@pytest.fixture(scope="module")
def spark():
    with LocalSparkSession(parallelism=2, worker_platform="cpu") as s:
        yield s


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(41)
    centres = 3.0 * rng.normal(size=(4, N))
    y4 = rng.integers(0, 4, size=ROWS).astype(np.float64)
    x = (centres[y4.astype(int)] + rng.normal(size=(ROWS, N))).astype(np.float32)
    yb = (y4 >= 2).astype(np.float64)
    yr = (x @ rng.normal(size=N) + 0.3 * rng.normal(size=ROWS)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=ROWS)
    return x, yb, y4, yr.astype(np.float64), w


@pytest.fixture(scope="module")
def df(spark, data):
    x, yb, y4, yr, w = data
    schema = T.StructType([
        T.StructField("features", T.ArrayType(T.DoubleType())),
        T.StructField("label", T.DoubleType()),
        T.StructField("label4", T.DoubleType()),
        T.StructField("reg", T.DoubleType()),
        T.StructField("weight", T.DoubleType()),
        T.StructField("id", T.LongType()),
    ])
    rows = [(r.tolist(), a, b, c, d, 100 + i) for i, (r, a, b, c, d) in
            enumerate(zip(x.astype(np.float64), yb, y4, yr, w))]
    return spark.createDataFrame(rows, schema, numPartitions=3)


def _col(out_df, name):
    return np.asarray([r[name] for r in out_df.collect()], dtype=np.float64)


def _close(got, ref, rel=1e-5):
    ref = np.asarray(ref, dtype=np.float64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-30))


def test_spark_namespace_exports_every_jax_spark_name():
    jax_names = {n for n in JSP.__all__ if n.startswith("Spark")}
    assert jax_names and jax_names <= set(SP.__all__) and jax_names <= set(P.__all__)
    for name in jax_names:
        assert getattr(SP, name) is getattr(P, name)
        assert getattr(SP, name).__name__ == name
        assert name not in vars(SP)  # loaded on first use, never at import


# (class, label column, params, weighted). The weighted 4-class forest is
# held to the JAX package up to the gate rule (tests/torch_forest_gate.py):
# pure nodes whose f32 gains are a few ulps of their n-scaled impurity may
# split in one package and not the other
TREES = {
    "rf_classifier": ("RandomForestClassifier", "label4",
                      dict(numTrees=3, maxDepth=4, maxBins=16, featureSubsetStrategy="all"), False),
    "rf_classifier_weighted": ("RandomForestClassifier", "label4",
                               dict(numTrees=3, maxDepth=4, maxBins=16,
                                    featureSubsetStrategy="all"), True),
    "rf_regressor": ("RandomForestRegressor", "reg",
                     dict(numTrees=3, maxDepth=4, maxBins=16, featureSubsetStrategy="all"), True),
    "gbt_classifier": ("GBTClassifier", "label",
                       dict(numTrees=4, maxDepth=3, maxBins=16, seed=3), True),
    "gbt_regressor": ("GBTRegressor", "reg", dict(numTrees=4, maxDepth=3, maxBins=16, seed=3),
                      True),
}


@pytest.mark.parametrize("case", sorted(TREES))
def test_tree_families_collect_and_fit_like_jax(df, data, case):
    x, yb, y4, yr, w = data
    name, label, params, weighted = TREES[case]
    y = {"label": yb, "label4": y4, "reg": yr}[label]
    est = getattr(SP, "Spark" + name)(device=CPU, **params).setLabelCol(label)
    ref_est = getattr(J, name)(**params)
    if weighted:
        est.setWeightCol("weight")
        ref_est.setWeightCol("weight")
    model = est.fit(df)
    ref = ref_est.fit((x, y, w) if weighted else (x, y))
    assert type(model).__name__.startswith("Spark") and model.fit_report is not None
    predicted = ref._predict_matrix(x)
    if case == "rf_classifier_weighted":
        binned, stats, weights = forest_inputs(x, y, w, num_trees=3, max_bins=16)
        assert assert_trees_equal_up_to_gate_rule(model.trees, ref.trees, binned, stats,
                                                  weights, n_bins=16) >= 1
        # rows of an excused subtree may be predicted otherwise: the
        # transform is held to the model's own prediction
        predicted = model._predict_matrix(x)
    else:
        for field in ("feature", "split_bin", "is_leaf"):
            np.testing.assert_array_equal(getattr(model.trees, field),
                                          getattr(ref.trees, field))
        np.testing.assert_array_equal(model.thresholds, ref.thresholds)
    out = model.transform(df)
    if "classifier" in case:
        np.testing.assert_array_equal(_col(out, "prediction"), predicted)
        proba = _col(out, "probability")
        np.testing.assert_allclose(proba, model.proba_and_predictions(x)[0], rtol=0, atol=1e-6)
        assert _col(out, "rawPrediction").shape == proba.shape
    else:
        _close(_col(out, "prediction"), predicted)


def test_naive_bayes_and_one_vs_rest_like_jax(df, data):
    x, _, y4, _, w = data
    nb = SP.SparkNaiveBayes(device=CPU, modelType="gaussian").setLabelCol("label4") \
        .setWeightCol("weight").fit(df)
    ref = J.NaiveBayes(modelType="gaussian").setWeightCol("weight").fit((x, y4, w))
    _close(nb.theta, ref.theta)
    out = nb.transform(df)
    np.testing.assert_array_equal(_col(out, "prediction"), ref._predict_matrix(x))
    _close(_col(out, "probability"), nb._from_raw(nb._raw_scores(x))[0])
    ovr = SP.SparkOneVsRest(classifier=P.LogisticRegression(device=CPU, regParam=0.1)) \
        .setLabelCol("label4").fit(df)
    jovr = JaxOneVsRest(classifier=J.LogisticRegression(regParam=0.1)).fit((x, y4))
    assert type(ovr) is SP.SparkOneVsRestModel and ovr.numClasses == 4
    for pm, rm in zip(ovr.models, jovr.models):
        np.testing.assert_allclose(pm.coefficients, rm.coefficients, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(_col(ovr.transform(df), "prediction"), ovr._predict_matrix(x))


def test_isotonic_and_linear_svc_weights_travel(df, data):
    x, yb, _, yr, w = data
    iso = SP.SparkIsotonicRegression().setFeaturesCol("features").setLabelCol("reg") \
        .setWeightCol("weight").setFeatureIndex(0).fit(df)
    ref = JaxIsotonic().setWeightCol("weight").setFeatureIndex(0).fit((x, yr, w))
    _close(iso.boundaries, ref.boundaries)
    _close(iso.predictions, ref.predictions)
    _close(_col(iso.transform(df), "prediction"), iso._predict_matrix(x))


def test_randomized_families_equal_the_port_core_fit(df, data):
    x, yb, _, yr, _ = data
    cases = [
        (SP.SparkMultilayerPerceptronClassifier, P.MultilayerPerceptronClassifier,
         dict(layers=[N, 5, 2], maxIter=5, seed=1), "label", ("weights",)),
        (SP.SparkFMClassifier, P.FMClassifier, dict(maxIter=5, seed=1), "label",
         ("flatWeights",)),
        (SP.SparkFMRegressor, P.FMRegressor, dict(maxIter=5, seed=1), "reg", ("flatWeights",)),
    ]
    for spark_cls, core_cls, params, label, fields in cases:
        model = spark_cls(device=CPU, **params).setLabelCol(label).fit(df)
        core = core_cls(device=CPU, **params).fit((x, {"label": yb, "reg": yr}[label]))
        for f in fields:
            for a, b in zip(np.atleast_1d(getattr(model, f)), np.atleast_1d(getattr(core, f))):
                np.testing.assert_array_equal(a, b)
        out = model.transform(df)
        _close(_col(out, "prediction"), core._predict_matrix(x))
    umap = SP.SparkUMAP(device=CPU, nNeighbors=5, seed=2).setInputCol("features").fit(df)
    core = P.UMAP(device=CPU, nNeighbors=5, seed=2).fit(x)
    np.testing.assert_array_equal(umap.embedding_, core.embedding_)
    got = _col(umap.transform(df.limit(40)), "embedding")
    _close(got, umap._embed_matrix(x[:40]), 1e-4)


def test_neighbours_and_dbscan_like_jax(df, data):
    x = data[0]
    knn = SP.SparkNearestNeighbors(device=CPU, k=4).setInputCol("features").setIdCol("id").fit(df)
    np.testing.assert_array_equal(knn.itemIds, 100 + np.arange(ROWS))
    rows = knn.kneighbors(df.limit(30)).collect()
    d_ref, i_ref = J.NearestNeighbors(k=4).fit(x).kneighbors(x[:30])
    np.testing.assert_array_equal([r["indices"] for r in rows], np.asarray(i_ref) + 100)
    # squared: f32 cancellation leaves a self-distance of about 1e-3
    _close(np.square([r["distances"] for r in rows]), np.square(d_ref))
    ann = SP.SparkApproximateNearestNeighbors(device=CPU, k=4, nlist=4, nprobe=4, seed=0) \
        .setInputCol("features").fit(df)
    core = P.ApproximateNearestNeighbors(device=CPU, k=4, nlist=4, nprobe=4, seed=0).fit(x)
    np.testing.assert_array_equal(ann.centroids, core.centroids)
    got = ann.transform(df.limit(30)).collect()
    np.testing.assert_array_equal([r["indices"] for r in got], np.asarray(i_ref))
    db = SP.SparkDBSCAN(device=CPU, eps=2.5, minSamples=5).setInputCol("features").fit(df)
    assert type(db) is SP.SparkDBSCANModel
    labels = np.asarray([r["prediction"] for r in db.transform(df).collect()])
    np.testing.assert_array_equal(
        labels, J.DBSCAN(eps=2.5, minSamples=5).fit(x).clusterLabels(x))
    np.testing.assert_array_equal(db.clusterLabels(df), labels)


SAVES = {
    "SparkKMeansModel": lambda x, y: J.KMeans(k=3, maxIter=3).fit(x),
    "SparkLinearSVCModel": lambda x, y: J.LinearSVC(maxIter=3).fit((x, y)),
    "SparkRandomForestClassificationModel": lambda x, y: J.RandomForestClassifier(
        numTrees=2, maxDepth=2).fit((x, y)),
    "SparkNearestNeighborsModel": lambda x, y: J.NearestNeighbors(k=3).fit(x),
    "SparkGBTRegressionModel": lambda x, y: J.GBTRegressor(numTrees=2, maxDepth=2).fit((x, y)),
    "SparkStandardScalerModel": lambda x, y: J.StandardScaler().fit(x),
    "SparkImputerModel": lambda x, y: J.Imputer().fit(x),
    "SparkLogisticRegressionModel": lambda x, y: J.LogisticRegression(maxIter=3).fit((x, y)),
}


def _same_arrays(got: dict, want: dict):
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(value))


@pytest.mark.parametrize("name", sorted(SAVES))
def test_spark_models_save_and_load_both_ways(data, tmp_path, name):
    """The JAX package's native saves load in the port's Spark classes (a
    core model's through the subclass upgrade, a Spark model's by its
    recorded class); the port's saves read in the JAX package's Spark
    class through ``load_arrays`` and ``_fromSaved``, as every port save
    crosses (``tests/test_torch_persistence.py``)."""
    x, yb = data[0], data[1]
    ref = SAVES[name](x, yb)
    want = ref._saveData()
    ref.save(str(tmp_path / "core"))
    up = getattr(SP, name).load(str(tmp_path / "core"), device=CPU)
    assert type(up) is getattr(SP, name) and up.uid == ref.uid
    _same_arrays(up._saveData(), want)
    jax_spark = getattr(JSP, name)._fromSaved(ref.uid, want)
    jax_spark.save(str(tmp_path / "jax"))
    again = Saveable.load(str(tmp_path / "jax"), device=CPU)
    assert type(again) is getattr(SP, name)
    _same_arrays(again._saveData(), want)
    again.save(str(tmp_path / "port"))
    back = getattr(JSP, name)._fromSaved(None, jax_persistence.load_arrays(str(tmp_path / "port")))
    assert type(back).__name__ == name
    _same_arrays(back._saveData(), want)
