"""The port's factorization machines (``models/fm.py``) against the JAX
package's.

The JAX package draws its factor start from ``jax.random``, which torch
cannot reproduce, so each comparison passes the JAX start (``flat0``) to
both packages' ``train_fm`` on the same f32 rows (numpy seed; the port on
the CPU). Tolerances:

- ``fm_score`` on the same weights: rtol 1e-6 of the largest score;
- ``solver="adamW"`` (Spark's default; decoupled weight decay, the optax
  order written out by hand), with the intercept and linear masks on and
  off: the first 20 iterates rtol 1e-5 of the largest weight;
- ``solver="gd"`` (loss-side L2): every iterate rtol 1e-5;
- the model's params, messages, outputs and persistence arrays are the JAX
  package's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.models import fm as JF
from spark_rapids_ml_tpu_torch import (
    FMClassificationModel,
    FMClassifier,
    FMRegressionModel,
    FMRegressor,
)
from spark_rapids_ml_tpu_torch.convert import model_from_arrays
from spark_rapids_ml_tpu_torch.models import fm as PF

CPU = torch.device("cpu")
N_FEAT, K = 10, 4


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(400, N_FEAT)).astype(np.float32)
    y_reg = (x[:, 0] * x[:, 1] + 0.5 * x[:, 2] + 0.1 * rng.normal(size=400)).astype(np.float32)
    return x, y_reg, (y_reg > 0).astype(np.float32)


def _jax_flat0(seed: int = 0) -> np.ndarray:
    """The JAX package's start (``_FMEstimator.fit``, initStd 0.01)."""
    return np.array(jnp.concatenate([
        jnp.zeros((1 + N_FEAT,), jnp.float32),
        0.01 * jax.random.normal(jax.random.PRNGKey(seed), (N_FEAT * K,), jnp.float32),
    ]))


def _iterates(x, y, steps: int, **kw):
    rec = []
    PF.train_fm(torch.from_numpy(_jax_flat0()), torch.from_numpy(x), torch.from_numpy(y),
                torch.ones(len(x)), n_feat=N_FEAT, k=K, max_iter=steps,
                callback=lambda it, f, loss: rec.append(f.clone().numpy()), **kw)
    return rec


def _jax_at(x, y, steps: int, **kw) -> np.ndarray:
    flat, _, it = JF.train_fm(jnp.asarray(_jax_flat0()), jnp.asarray(x), jnp.asarray(y),
                              jnp.ones(len(x), jnp.float32), n_feat=N_FEAT, k=K,
                              max_iter=steps, **kw)
    assert int(it) == steps
    return np.asarray(flat)


def test_fm_score_equals_jax(data):
    x, _, _ = data
    flat = np.random.default_rng(3).normal(size=1 + N_FEAT + N_FEAT * K).astype(np.float32)
    ref = np.asarray(JF.fm_score(jnp.asarray(flat), jnp.asarray(x), n_feat=N_FEAT, k=K))
    got = PF.fm_score(torch.from_numpy(flat), torch.from_numpy(x), n_feat=N_FEAT, k=K).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("classification,fit_intercept,fit_linear,reg", [
    (True, True, True, 0.01),
    (False, True, True, 0.0),
    (False, False, False, 0.01),
    (True, False, True, 0.0),
])
def test_adamw_first_20_iterates_equal_jax(data, classification, fit_intercept, fit_linear, reg):
    x, y_reg, y_cls = data
    y = y_cls if classification else y_reg
    kw = dict(solver="adamW", classification=classification, fit_intercept=fit_intercept,
              fit_linear=fit_linear, step_size=0.05, reg_param=reg, tol=0.0)
    port = _iterates(x, y, 20, **kw)
    assert len(port) == 20
    for k in (1, 2, 5, 10, 20):
        ref = _jax_at(x, y, k, **kw)
        np.testing.assert_allclose(port[k - 1], ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    if not fit_intercept:
        assert port[-1][0] == 0.0
    if not fit_linear:
        assert not port[-1][1:1 + N_FEAT].any()


@pytest.mark.parametrize("classification", [False, True])
def test_gd_every_iterate_equals_jax(data, classification):
    x, y_reg, y_cls = data
    y = y_cls if classification else y_reg
    kw = dict(solver="gd", classification=classification, fit_intercept=True,
              fit_linear=True, step_size=0.2, reg_param=0.01, tol=0.0)
    port = _iterates(x, y, 6, **kw)
    for k in range(1, 7):
        ref = _jax_at(x, y, k, **kw)
        np.testing.assert_allclose(port[k - 1], ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_adamw_update_order_differs_from_torch_adamw():
    """optax's AdamW adds wd·param to the Adam direction and then scales by
    lr; ``torch.optim.AdamW`` multiplies the param by (1 − lr·wd) first.
    The port's step is optax's: after one step from p with gradient g,
    p − lr·(g/(|g|+eps) + wd·p)."""
    p = torch.tensor([1.0, -2.0, 0.5])
    g = torch.tensor([0.3, -0.1, 0.0])
    opt = PF.optim.AdamW(0.1, weight_decay=0.5)
    step = p + opt.update(g, p)
    want = p - 0.1 * (g / (g.abs() + 1e-8) + 0.5 * p)
    torch.testing.assert_close(step, want, rtol=1e-6, atol=1e-7)


def test_estimators_fit_and_match_jax_decision_rule(data):
    x, y_reg, y_cls = data
    clf = FMClassifier(device=CPU, stepSize=0.05, maxIter=50, seed=2).fit((x, y_cls))
    reg = FMRegressor(device=CPU, stepSize=0.05, maxIter=50, seed=2).fit((x, y_reg))
    assert clf.fit_report is not None and reg.fit_report is not None
    assert np.mean(clf._predict_matrix(x) == y_cls) > 0.7
    for port, jax_cls in ((clf, JF.FMClassificationModel), (reg, JF.FMRegressionModel)):
        ref = jax_cls(flatWeights=port.flatWeights, numFeatures=N_FEAT)
        ref._set(factorSize=port.getFactorSize())
        np.testing.assert_allclose(port._predict_matrix(x), ref._predict_matrix(x), rtol=1e-5,
                                   atol=1e-6)
    proba, preds = clf.proba_and_predictions(x)
    assert proba.shape == (len(x), 2) and np.array_equal(preds, clf._predict_matrix(x))
    assert clf.intercept == float(clf.flatWeights[0]) and clf.factors.shape == (N_FEAT, 8)
    # the recorded loss is the loss at the returned weights
    mask = PF.param_mask(N_FEAT, 8, fit_intercept=True, fit_linear=True,
                         dtype=torch.float32, device=CPU)
    loss = PF.fm_loss(torch.from_numpy(reg.flatWeights), torch.from_numpy(x),
                      torch.from_numpy(y_reg), torch.ones(len(x)), mask, n_feat=N_FEAT, k=8,
                      classification=False, l2=0.0)
    np.testing.assert_allclose(reg.trainLoss, float(loss), rtol=1e-6)


def test_params_and_messages_match_jax(data):
    x, _, y_cls = data
    port, ref = FMClassifier(device=CPU), JF.FMClassifier()
    for name in ("factorSize", "fitIntercept", "fitLinear", "regParam", "maxIter", "stepSize",
                 "tol", "solver", "initStd", "seed", "probabilityCol", "rawPredictionCol"):
        assert port.getOrDefault(name) == ref.getOrDefault(name), name
    for setter, bad in (("setFactorSize", 0), ("setRegParam", -1.0), ("setStepSize", 0.0),
                        ("setSolver", "adam"), ("setInitStd", 0.0)):
        with pytest.raises(ValueError) as port_err:
            getattr(port, setter)(bad)
        with pytest.raises(ValueError) as ref_err:
            getattr(ref, setter)(bad)
        assert str(port_err.value) == str(ref_err.value)
    with pytest.raises(ValueError, match="binary 0/1 labels"):
        FMClassifier(device=CPU).fit((x, y_cls + 1))


@pytest.mark.parametrize("name", ["FMClassificationModel", "FMRegressionModel"])
def test_jax_model_carries_across(data, name):
    x, y_reg, y_cls = data
    est = JF.FMClassifier if "Class" in name else JF.FMRegressor
    ref = est(stepSize=0.05, maxIter=10).fit((x, y_cls if "Class" in name else y_reg))
    port = model_from_arrays(name, ref._saveData(), device="cpu", params=dict(ref._paramMap))
    assert isinstance(port, FMClassificationModel if "Class" in name else FMRegressionModel)
    assert port.numFeatures == N_FEAT and port.iterations == ref.iterations
    np.testing.assert_allclose(port._scores(x), ref._scores(x), rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_card_adamw_follows_the_cpu(data):
    """The card's first 10 AdamW steps against the same function on the
    CPU from the same start."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, y_reg, _ = data
    out = {}
    for dev in ("cpu", "cuda"):
        rec = []
        PF.train_fm(torch.from_numpy(_jax_flat0()).to(dev), torch.from_numpy(x).to(dev),
                    torch.from_numpy(y_reg).to(dev), torch.ones(len(x), device=dev),
                    n_feat=N_FEAT, k=K, solver="adamW", max_iter=10, classification=False,
                    fit_intercept=True, fit_linear=True, step_size=0.05, tol=0.0,
                    callback=lambda it, f, loss: rec.append(f.cpu().numpy()))
        out[dev] = np.stack(rec)
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=0,
                               atol=1e-4 * np.abs(out["cpu"]).max())
