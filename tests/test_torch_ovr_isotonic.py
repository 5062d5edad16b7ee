"""The port's host meta-estimators, OneVsRest (``models/ovr.py``) and
IsotonicRegression (``models/isotonic.py``), against the JAX package's.

Both get the same f32 rows (numpy seed); the port's sub-estimators run with
device="cpu". Properties:

- OneVsRest over LogisticRegression (the probability surface), LinearSVC
  (the margin surface) and GBTClassifier: each class model's parameters
  within the tolerance of its own family's differential test, and every
  prediction equal to the JAX package's except where two classes' scores
  are within 1e-5 of each other (a near tie of the argmax);
- IsotonicRegression is the same host numpy in both packages: boundaries,
  predictions and interpolated outputs exactly equal, isotonic and
  antitonic, weighted and with tied features;
- params, messages and the drop-in namespaces are the JAX package's.
"""

from __future__ import annotations

import jax  # noqa: F401  (imported at the top of every port test file)
import numpy as np
import pytest
import torch

import spark_rapids_ml_tpu.classification as jax_classification
import spark_rapids_ml_tpu.regression as jax_regression
import spark_rapids_ml_tpu.umap as jax_umap
from spark_rapids_ml_tpu.models import gbt as JG
from spark_rapids_ml_tpu.models import isotonic as JI
from spark_rapids_ml_tpu.models import linear as JL
from spark_rapids_ml_tpu.models import ovr as JO
from spark_rapids_ml_tpu_torch import (
    GBTClassifier,
    IsotonicRegression,
    IsotonicRegressionModel,
    LinearSVC,
    LogisticRegression,
    OneVsRest,
    OneVsRestModel,
)
from spark_rapids_ml_tpu_torch import classification, regression, umap
from spark_rapids_ml_tpu_torch.convert import model_from_arrays, one_vs_rest_model_from_arrays
from spark_rapids_ml_tpu_torch.models import ovr as PO

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def four_classes():
    rng = np.random.default_rng(0)
    centres = 3.0 * rng.normal(size=(4, 6))
    y = rng.integers(0, 4, size=1200).astype(np.float64)
    x = (centres[y.astype(int)] + rng.normal(size=(1200, 6))).astype(np.float32)
    return x, y


def _predictions_agree(port_model, ref_model, x, rel: float = 1e-5):
    scores = np.stack([PO._positive_score(m, x) for m in port_model.models], axis=1)
    ordered = np.sort(scores, axis=1)
    near_tie = ordered[:, -1] - ordered[:, -2] <= rel * np.maximum(np.abs(ordered[:, -1]), 1e-30)
    got, want = port_model._predict_matrix(x), ref_model._predict_matrix(x)
    assert np.all((got == want) | near_tie)
    return float(np.mean(got == want))


@pytest.mark.parametrize("family", ["logistic", "svc", "gbt"])
def test_one_vs_rest_equals_jax(four_classes, family):
    x, y = four_classes
    port_clf, ref_clf = {
        "logistic": (LogisticRegression(device=CPU, regParam=0.01),
                     JL.LogisticRegression(regParam=0.01)),
        "svc": (LinearSVC(device=CPU, regParam=0.01), JL.LinearSVC(regParam=0.01)),
        "gbt": (GBTClassifier(device=CPU, numTrees=4, maxDepth=3, seed=1),
                JG.GBTClassifier(numTrees=4, maxDepth=3, seed=1)),
    }[family]
    port = OneVsRest(classifier=port_clf).fit((x, y))
    ref = JO.OneVsRest(classifier=ref_clf).fit((x, y))
    assert isinstance(port, OneVsRestModel) and port.numClasses == ref.numClasses == 4
    assert port.fit_report is not None
    for pm, rm in zip(port.models, ref.models):
        if family == "gbt":
            np.testing.assert_array_equal(pm.trees.feature, rm.trees.feature)
        else:
            np.testing.assert_allclose(pm.coefficients, rm.coefficients, rtol=1e-4, atol=1e-5)
    assert _predictions_agree(port, ref, x) > 0.99
    # the port's model scores through the JAX package's rule on its own models
    np.testing.assert_array_equal(PO._positive_score(port.models[0], x[:5]).shape, (5,))
    out = port.transform(x[:50])
    np.testing.assert_array_equal(np.asarray(out), port._predict_matrix(x[:50]))


def test_one_vs_rest_messages_match_jax(four_classes):
    x, y = four_classes
    for bad_y, match in ((y + 0.5, "integer class labels"), (np.zeros_like(y), "at least 2")):
        with pytest.raises(ValueError, match=match):
            OneVsRest(classifier=LogisticRegression(device=CPU)).fit((x, bad_y))
    with pytest.raises(ValueError, match="setClassifier"):
        OneVsRest().fit((x, y))
    with pytest.raises(TypeError, match="no probability or margin"):
        PO._positive_score(object(), x)


def test_one_vs_rest_model_carries_across(four_classes):
    x, y = four_classes
    ref = JO.OneVsRest(classifier=JL.LogisticRegression(regParam=0.01)).fit((x, y))
    port = one_vs_rest_model_from_arrays(
        [{"class": type(m).__name__, "data": m._saveData(), "params": dict(m._paramMap)}
         for m in ref.models], device="cpu", params=dict(ref._paramMap))
    assert port.numClasses == 4
    np.testing.assert_array_equal(port._predict_matrix(x), ref._predict_matrix(x))


@pytest.fixture(scope="module")
def monotone():
    rng = np.random.default_rng(3)
    x = np.round(rng.uniform(0, 10, size=(500, 3)), 1).astype(np.float32)  # tied features
    y = np.sin(x[:, 1] / 3.0) + 0.3 * rng.normal(size=500)
    w = rng.uniform(0.0, 2.0, size=500)
    w[:20] = 0.0
    return x, y, w


@pytest.mark.parametrize("isotonic", [True, False])
@pytest.mark.parametrize("weighted", [False, True])
def test_isotonic_equals_jax(monotone, isotonic, weighted):
    x, y, w = monotone
    data = (x, y, w) if weighted else (x, y)
    port = IsotonicRegression(isotonic=isotonic, featureIndex=1).fit(data)
    ref = JI.IsotonicRegression(isotonic=isotonic, featureIndex=1).fit(data)
    np.testing.assert_array_equal(port.boundaries, ref.boundaries)
    np.testing.assert_array_equal(port.predictions, ref.predictions)
    probe = np.random.default_rng(9).uniform(-1, 11, size=(200, 3)).astype(np.float32)
    np.testing.assert_array_equal(port._predict_matrix(probe), ref._predict_matrix(probe))
    assert port.predict(4.2) == ref.predict(4.2)
    steps = np.diff(port.predictions)
    assert np.all(steps >= 0) if isotonic else np.all(steps <= 0)
    assert port.fit_report is not None


def test_isotonic_is_host_only_and_carries_across(monotone):
    x, y, _ = monotone
    assert not hasattr(IsotonicRegression(), "device")
    with pytest.raises(KeyError, match="device"):
        IsotonicRegression(device="cpu")
    ref = JI.IsotonicRegression(featureIndex=2).fit((x, y))
    port = model_from_arrays("IsotonicRegressionModel", ref._saveData(), device="cpu",
                             params=dict(ref._paramMap))
    assert isinstance(port, IsotonicRegressionModel) and port.getFeatureIndex() == 2
    np.testing.assert_array_equal(port._predict_matrix(x), ref._predict_matrix(x))
    with pytest.raises(ValueError, match="featureIndex=5 out of range"):
        IsotonicRegression(featureIndex=5).fit((x, y))
    with pytest.raises(ValueError, match="must be >= 0"):
        IsotonicRegression().setFeatureIndex(-1)


@pytest.mark.parametrize("port_ns,jax_ns", [
    (classification, jax_classification), (regression, jax_regression), (umap, jax_umap),
])
def test_namespaces_have_the_jax_names(port_ns, jax_ns):
    assert sorted(port_ns.__all__) == sorted(jax_ns.__all__)
    for name in port_ns.__all__:
        cls = getattr(port_ns, name)
        assert cls.__name__ == name
        assert cls.__module__.startswith("spark_rapids_ml_tpu_torch.")


@pytest.mark.cuda
def test_card_one_vs_rest_equals_cpu(four_classes):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, y = four_classes
    card = OneVsRest(classifier=LogisticRegression(device="cuda", regParam=0.01)).fit((x, y))
    cpu = OneVsRest(classifier=LogisticRegression(device=CPU, regParam=0.01)).fit((x, y))
    assert _predictions_agree(card, cpu, x) > 0.99
