"""The port's gradient-boosted trees (``models/gbt.py``) against the JAX
package's.

Both packages get the same f32 rows and labels, made from a numpy seed; the
port runs with device="cpu". Tolerances and properties:

- with all features (GBT's "auto") there is no random draw: every stage's
  ``feature``, ``split_bin`` and ``is_leaf`` exactly equal; ``leaf_stats``
  and ``gain`` within 1e-6 of their largest value; ``treeWeights`` exactly
  equal; ``trainLosses`` and the margins rtol 1e-6 (the residuals, the loss
  sums and the leaf means round in each package's own order). The same
  holds for ``subsamplingRate`` < 1, whose per-stage Bernoulli rows are
  numpy's in both packages;
- with a feature subset the per-node subsets come from torch generators,
  so the fit is held by properties: the same seed gives the same model and
  the held-out accuracy is within 0.03 of the JAX package's;
- the params, defaults and messages are the JAX package's; the regressor's
  training loss never rises; the model is refused by the serving registry
  (``tests/test_torch_serving.py`` holds that).
"""

from __future__ import annotations

import jax  # noqa: F401  (imported at the top of every port test file)
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.models import gbt as JG
from spark_rapids_ml_tpu_torch import (
    GBTClassificationModel,
    GBTClassifier,
    GBTRegressionModel,
    GBTRegressor,
)
from spark_rapids_ml_tpu_torch.convert import model_from_arrays

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3000, 8)).astype(np.float32)
    y_cls = ((x[:, 0] * x[:, 1] + x[:, 2]) > 0).astype(np.float64)
    y_reg = (2.0 * x[:, 0] - np.abs(x[:, 3]) + 0.3 * rng.normal(size=3000)).astype(np.float64)
    return x, y_cls, y_reg


def _pair(kind: str, **params):
    jax_cls, port_cls = {
        "classifier": (JG.GBTClassifier, GBTClassifier),
        "regressor": (JG.GBTRegressor, GBTRegressor),
    }[kind]
    return jax_cls(**params), port_cls(device=CPU, **params)


def _assert_same_ensemble(ref, port, x):
    for f in ("feature", "split_bin", "is_leaf"):
        np.testing.assert_array_equal(getattr(port.trees, f), getattr(ref.trees, f))
    for f in ("leaf_stats", "gain"):
        want = getattr(ref.trees, f)
        np.testing.assert_allclose(getattr(port.trees, f), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    np.testing.assert_array_equal(port.thresholds, ref.thresholds)
    np.testing.assert_array_equal(port.treeWeights, ref.treeWeights)
    np.testing.assert_allclose(port.trainLosses, ref.trainLosses, rtol=1e-6)
    np.testing.assert_allclose(port._margins(x), ref._margins(x), rtol=1e-6,
                               atol=1e-6 * np.abs(ref._margins(x)).max())


@pytest.mark.parametrize("kind", ["classifier", "regressor"])
def test_fit_with_all_features_equals_jax(data, kind):
    x, y_cls, y_reg = data
    y = y_cls if kind == "classifier" else y_reg
    jax_est, port_est = _pair(kind, numTrees=8, maxDepth=4, maxBins=16, seed=3)
    ref, port = jax_est.fit((x, y)), port_est.fit((x, y))
    _assert_same_ensemble(ref, port, x)
    if kind == "classifier":
        np.testing.assert_array_equal(port._predict_matrix(x), ref._predict_matrix(x))
    np.testing.assert_allclose(port.featureImportances, ref.featureImportances, rtol=1e-5,
                               atol=1e-7)


@pytest.mark.parametrize("kind", ["classifier", "regressor"])
def test_subsampled_fit_equals_jax(data, kind):
    x, y_cls, y_reg = data
    y = y_cls if kind == "classifier" else y_reg
    jax_est, port_est = _pair(kind, numTrees=6, maxDepth=3, maxBins=16, seed=7,
                              subsamplingRate=0.6, stepSize=0.3)
    _assert_same_ensemble(jax_est.fit((x, y)), port_est.fit((x, y)), x)


def test_weighted_fit_equals_jax(data):
    x, _, y_reg = data
    w = np.random.default_rng(4).uniform(0.0, 2.0, size=len(x))
    jax_est, port_est = _pair("regressor", numTrees=5, maxDepth=3, maxBins=16, seed=2)
    _assert_same_ensemble(jax_est.fit((x, y_reg, w)), port_est.fit((x, y_reg, w)), x)


def test_classifier_outputs_equal_jax(data):
    x, y_cls, _ = data
    jax_est, port_est = _pair("classifier", numTrees=6, maxDepth=3, maxBins=16, seed=5)
    ref, port = jax_est.fit((x, y_cls)), port_est.fit((x, y_cls))
    proba, preds = port.proba_and_predictions(x[:500])
    ref_proba, ref_preds = ref.proba_and_predictions(x[:500])
    np.testing.assert_allclose(proba, ref_proba, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(preds, ref_preds)
    assert port.numClasses == 2 and port.getNumTrees() == 6 and port.numFeatures == 8
    assert port.predict(x[0]) == preds[0]


def test_feature_subset_is_seeded_and_as_accurate_as_jax(data):
    """Subsets are drawn per stage from torch generators: the same seed
    gives the same ensemble, and the held-out accuracy is the JAX
    package's within 0.03."""
    x, y_cls, _ = data
    train, test = slice(0, 2000), slice(2000, None)
    params = dict(numTrees=10, maxDepth=4, maxBins=16, featureSubsetStrategy="sqrt")
    accs = []
    for seed in (0, 1, 2):
        port = GBTClassifier(device=CPU, seed=seed, **params).fit((x[train], y_cls[train]))
        again = GBTClassifier(device=CPU, seed=seed, **params).fit((x[train], y_cls[train]))
        for a, b in zip(port.trees, again.trees):
            np.testing.assert_array_equal(a, b)
        ref = JG.GBTClassifier(seed=seed, **params).fit((x[train], y_cls[train]))
        accs.append((np.mean(port._predict_matrix(x[test]) == y_cls[test]),
                     np.mean(ref._predict_matrix(x[test]) == y_cls[test])))
    port_acc, ref_acc = np.mean(accs, axis=0)
    assert abs(port_acc - ref_acc) <= 0.03, accs


def test_regressor_training_loss_never_rises(data):
    x, _, y_reg = data
    port = GBTRegressor(device=CPU, numTrees=12, maxDepth=3, seed=0).fit((x, y_reg))
    losses = port.trainLosses
    assert np.all(np.diff(losses) <= 1e-6 * losses[:-1])


def test_params_and_messages_match_jax(data):
    x, y_cls, y_reg = data
    ref, port = JG.GBTClassifier(), GBTClassifier(device=CPU)
    for name in ("stepSize", "numTrees", "maxDepth", "maxBins", "featureSubsetStrategy",
                 "impurity", "subsamplingRate", "minInstancesPerNode", "minInfoGain", "seed",
                 "probabilityCol", "rawPredictionCol"):
        assert port.getOrDefault(name) == ref.getOrDefault(name), name
    assert port.getMaxIter() == ref.getMaxIter() == 20
    for setter, bad in (("setStepSize", 0.0), ("setStepSize", 1.5), ("setMaxIter", 0)):
        with pytest.raises(ValueError) as port_err:
            getattr(port, setter)(bad)
        with pytest.raises(ValueError) as ref_err:
            getattr(ref, setter)(bad)
        assert str(port_err.value) == str(ref_err.value)
    with pytest.raises(ValueError, match="binary 0/1 labels"):
        GBTClassifier(device=CPU, numTrees=2).fit((x, y_cls + 1.0))
    with pytest.raises(ValueError, match="impurity must be one of"):
        GBTRegressor(device=CPU).setImpurity("gini")


def test_fit_books_a_report_and_transform_appends_columns(data):
    pd = pytest.importorskip("pandas")
    x, y_cls, _ = data
    df = pd.DataFrame({"features": list(x[:400]), "label": y_cls[:400]})
    model = GBTClassifier(device=CPU, numTrees=3, maxDepth=3).fit(df)
    assert model.fit_report is not None and model.fit_report.estimator == "GBTClassifier"
    out = model.transform(df)
    for col in ("rawPrediction", "probability", "prediction"):
        assert col in out.columns
    np.testing.assert_array_equal(out["prediction"].to_numpy(), model._predict_matrix(x[:400]))


@pytest.mark.parametrize("name", ["GBTClassificationModel", "GBTRegressionModel"])
def test_jax_model_carries_across(data, name):
    x, y_cls, y_reg = data
    est = JG.GBTClassifier if name == "GBTClassificationModel" else JG.GBTRegressor
    ref = est(numTrees=4, maxDepth=3, seed=1).fit((x, y_cls if "Class" in name else y_reg))
    port = model_from_arrays(name, ref._saveData(), device="cpu", params=dict(ref._paramMap))
    assert isinstance(port, GBTClassificationModel if "Class" in name else GBTRegressionModel)
    np.testing.assert_allclose(port._margins(x), ref._margins(x), rtol=1e-6,
                               atol=1e-6 * np.abs(ref._margins(x)).max())
    np.testing.assert_array_equal(port.trainLosses, ref.trainLosses)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["classifier", "regressor"])
def test_card_fit_equals_cpu_fit(data, kind):
    """On the card the regression histograms add in atomic order, so a near
    tie may pick another split; on these rows no split is that close, and
    the card's ensemble is the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, y_cls, y_reg = data
    y = y_cls if kind == "classifier" else y_reg
    cls = GBTClassifier if kind == "classifier" else GBTRegressor
    params = dict(numTrees=6, maxDepth=4, maxBins=16, seed=3)
    card = cls(device="cuda", **params).fit((x, y))
    cpu = cls(device=CPU, **params).fit((x, y))
    for f in ("feature", "split_bin", "is_leaf"):
        np.testing.assert_array_equal(getattr(card.trees, f), getattr(cpu.trees, f))
    np.testing.assert_allclose(card.trainLosses, cpu.trainLosses, rtol=1e-5)
    np.testing.assert_allclose(card._margins(x), cpu._margins(x), rtol=0,
                               atol=1e-5 * np.abs(cpu._margins(x)).max())
