"""The port's NaiveBayes (``ops/naive_bayes.py``, ``models/naive_bayes.py``)
against the JAX package's.

Both packages get the same f32 rows, labels and weights, made from a numpy
seed; the port runs with device="cpu". Tolerances:

- ``nb_stats`` and ``nb_centered_sq``: counts exactly equal (integer
  weights), sums rtol 1e-5 (the blocks and the tree change the order of
  the f32 sums);
- the three model types: ``pi``, ``theta`` and ``sigma`` rtol 1e-5 (atol
  1e-8 for values near 0), predictions exactly equal, probabilities
  within F·1e-5 (F features: each gaussian raw score sums F terms whose
  σ² agree within 1e-5);
- the input checks raise where the JAX package's raise, with its messages.
"""

from __future__ import annotations

import jax  # noqa: F401  (imported at the top of every port test file)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.models.naive_bayes import NaiveBayes as JaxNB
from spark_rapids_ml_tpu.models.naive_bayes import NaiveBayesModel as JaxNBModel
from spark_rapids_ml_tpu.ops import naive_bayes as JNB
from spark_rapids_ml_tpu_torch import NaiveBayes, NaiveBayesModel
from spark_rapids_ml_tpu_torch.convert import model_from_arrays
from spark_rapids_ml_tpu_torch.models.base import Saveable
from spark_rapids_ml_tpu_torch.ops import naive_bayes as NB

CPU = torch.device("cpu")
RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _data(model_type, rows=900, n=12, classes=4, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, classes, rows).astype(np.float64)
    if model_type == "gaussian":
        # offset-heavy features: the centred second pass is what keeps the
        # variance
        x = (rng.normal(size=(rows, n)) + y[:, None] * 0.7 + 50.0).astype(np.float32)
    elif model_type == "bernoulli":
        x = (rng.random((rows, n)) < (0.2 + 0.15 * y[:, None])).astype(np.float32)
    else:
        x = rng.poisson(1.0 + y[:, None] * 0.5, size=(rows, n)).astype(np.float32)
    return x, y


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                               rtol=RTOL, atol=1e-8)


@pytest.mark.parametrize("block_rows", [8192, 100, 37])
def test_nb_stats_and_centered_sq_equal_jax(block_rows):
    x, y = _data("gaussian")
    w = np.random.default_rng(1).integers(0, 3, len(x)).astype(np.float32)
    got = NB.nb_stats(_t(x), _t(y.astype(np.float32)), _t(w), 4, block_rows=block_rows)
    ref = JNB.nb_stats(jnp.asarray(x), jnp.asarray(y.astype(np.float32)), jnp.asarray(w), 4)
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(ref.counts))
    _close(got.feat_sum.numpy(), ref.feat_sum)
    mu = np.asarray(ref.feat_sum) / np.asarray(ref.counts)[:, None]
    got_sq = NB.nb_centered_sq(_t(x), _t(y.astype(np.float32)), _t(w), _t(mu.astype(np.float32)),
                               4, block_rows=block_rows)
    ref_sq = JNB.nb_centered_sq(jnp.asarray(x), jnp.asarray(y.astype(np.float32)),
                                jnp.asarray(w), jnp.asarray(mu.astype(np.float32)), 4)
    _close(got_sq.numpy(), ref_sq)
    both = NB.combine_nb_stats(got, got)
    np.testing.assert_array_equal(both.counts.numpy(), 2 * got.counts.numpy())


@pytest.mark.parametrize("model_type", ["multinomial", "bernoulli", "gaussian"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("smoothing", [1.0, 0.3])
def test_fit_and_predict_equal_jax(model_type, weighted, smoothing):
    x, y = _data(model_type)
    w = np.random.default_rng(2).uniform(0.5, 2.0, len(x)) if weighted else None
    arg = (x, y) if w is None else (x, y, w)
    got = NaiveBayes(device=CPU, modelType=model_type, smoothing=smoothing).fit(arg, 3)
    ref = JaxNB(modelType=model_type, smoothing=smoothing).fit(arg, 3)
    for name in ("pi", "theta", "sigma"):
        assert getattr(got, name).shape == getattr(ref, name).shape
        _close(getattr(got, name), getattr(ref, name))
    gp, gpred = got.proba_and_predictions(x)
    rp, rpred = ref.proba_and_predictions(x)
    np.testing.assert_array_equal(gpred, rpred)
    # probabilities follow from the parameters: a gaussian raw score sums
    # F quadratic terms of order 1 whose σ² are each within 1e-5, so the
    # scores, and the probabilities, move by up to about F·1e-5
    np.testing.assert_allclose(gp, rp, rtol=0, atol=x.shape[1] * RTOL)
    assert got.numClasses == 4


def test_carried_model_and_transform_columns_match_jax():
    import pandas as pd

    x, y = _data("multinomial")
    ref = JaxNB(modelType="multinomial").fit((x, y))
    port = model_from_arrays("NaiveBayesModel", ref._saveData(), device="cpu",
                             params=dict(ref._paramMap))
    df = pd.DataFrame({"features": list(x[:40]), "label": y[:40]})
    got, exp = port.transform(df), ref.transform(df)
    for col in ("rawPrediction", "probability", "prediction"):
        np.testing.assert_allclose(np.stack(got[col]), np.stack(exp[col]), rtol=1e-9)
    assert port.predict(x[0]) == ref.predict(x[0])


def test_input_checks_raise_like_jax():
    x, y = _data("multinomial")
    cases = [
        (dict(modelType="multinomial"), (x, y + 0.5), "integer class labels"),
        (dict(modelType="multinomial"), (x, -y - 1), "integer class labels"),
        (dict(modelType="multinomial"), (x - 5.0, y), "non-negative"),
        (dict(modelType="bernoulli"), (x, y), "0/1 features"),
    ]
    for params, arg, msg in cases:
        with pytest.raises(ValueError, match=msg):
            NaiveBayes(device=CPU, **params).fit(arg)
        with pytest.raises(ValueError, match=msg):
            JaxNB(**params).fit(arg)
    for est in (NaiveBayes(device=CPU), JaxNB()):
        with pytest.raises(ValueError, match="modelType"):
            est.setModelType("poisson")
        with pytest.raises(ValueError, match="smoothing"):
            est.setSmoothing(-1.0)
        with pytest.raises(ValueError, match="distribution"):
            est.setDistribution("ring")
    xb, yb = _data("bernoulli")
    model = NaiveBayes(device=CPU, modelType="bernoulli").fit((xb, yb))
    with pytest.raises(ValueError, match="0 or 1"):
        model.transform(xb * 2.0)
    with pytest.raises(ValueError, match="0 or 1"):
        JaxNB(modelType="bernoulli").fit((xb, yb)).transform(xb * 2.0)


def test_mesh_local_distribution_fits_alike():
    x, y = _data("gaussian")
    a = NaiveBayes(device=CPU, modelType="gaussian").fit((x, y))
    b = NaiveBayes(device=CPU, modelType="gaussian", distribution="mesh-local").fit((x, y))
    for name in ("pi", "theta", "sigma"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


def test_persistence_crosses_the_packages(tmp_path):
    x, y = _data("gaussian")
    ref = JaxNB(modelType="gaussian").fit((x, y))
    ref.save(str(tmp_path / "j"))
    port = Saveable.load(str(tmp_path / "j"), device="cpu")
    assert type(port) is NaiveBayesModel and port.getModelType() == "gaussian"
    np.testing.assert_array_equal(port._predict_matrix(x), ref._predict_matrix(x))
    port.save(str(tmp_path / "p"))
    from spark_rapids_ml_tpu.utils import persistence as jax_persistence

    back = JaxNBModel._fromSaved("p", jax_persistence.load_arrays(str(tmp_path / "p")))
    back._set(modelType="gaussian")
    np.testing.assert_array_equal(back._predict_matrix(x), ref._predict_matrix(x))
