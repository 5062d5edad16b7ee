"""The port's MultilayerPerceptronClassifier (``models/mlp.py``) and its
optimizers (``ops/optim.py``) against the JAX package's.

The JAX package draws its Glorot start from ``jax.random``, which torch
cannot reproduce, so each comparison passes the JAX start (``flat0``) to
both packages' ``train_mlp`` on the same f32 rows (numpy seed; the port on
the CPU). Tolerances:

- ``solver="gd"``: every iterate (weights and loss) rtol 1e-5;
- ``solver="l-bfgs"`` (the port's reproduction of ``optax.lbfgs()``): the
  losses and weights of the first 5 iterations rtol 1e-4. With a hidden
  layer the loss is not convex and the two packages' f32 roundings part
  slowly along the path, so the stop test may fire an iteration apart:
  the whole fit is held to the same predictions on at least 99% of rows
  and its final loss within 1e-3; without a hidden layer (softmax
  regression, one minimum) the final loss is rtol 1e-4;
- the model's params, messages, outputs and persistence arrays are the JAX
  package's.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.models import mlp as JM
from spark_rapids_ml_tpu_torch import (
    MultilayerPerceptronClassificationModel,
    MultilayerPerceptronClassifier,
)
from spark_rapids_ml_tpu_torch.convert import model_from_arrays
from spark_rapids_ml_tpu_torch.models import mlp as PM

CPU = torch.device("cpu")


def _noisy_blobs(n: int, f: int, c: int, seed: int, flip: float = 0.3):
    rng = np.random.default_rng(seed)
    centres = 2.0 * rng.normal(size=(c, f))
    y = rng.integers(0, c, size=n).astype(np.float64)
    x = (centres[y.astype(int)] + rng.normal(size=(n, f))).astype(np.float32)
    flipped = rng.random(n) < flip
    y[flipped] = rng.integers(0, c, size=flipped.sum())
    return x, y


def _jax_flat0(layers: tuple, seed: int) -> np.ndarray:
    """The JAX package's Glorot start (``MultilayerPerceptronClassifier.fit``)."""
    key = jax.random.PRNGKey(seed)
    pieces = []
    for fan_in, fan_out in zip(layers[:-1], layers[1:]):
        key, k1 = jax.random.split(key)
        limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
        pieces.append(jax.random.uniform(k1, (fan_in * fan_out,), jnp.float32, -limit, limit))
        pieces.append(jnp.zeros((fan_out,), jnp.float32))
    return np.array(jnp.concatenate(pieces))


def _both(x, y, layers, flat0, solver, max_iter, **kw):
    """(JAX (flat, loss, it) at ``max_iter``, port (flat, loss, it), the
    port's iterates)."""
    w = np.ones(len(x), np.float32)
    ref = JM.train_mlp(jnp.asarray(flat0), jnp.asarray(x), jnp.asarray(y), jnp.asarray(w),
                       layers=layers, solver=solver, max_iter=max_iter, **kw)
    iterates = []
    port = PM.train_mlp(torch.from_numpy(flat0.copy()), torch.from_numpy(x), torch.from_numpy(y),
                        torch.from_numpy(w), layers=layers, solver=solver, max_iter=max_iter,
                        callback=lambda it, f, loss: iterates.append((f.clone().numpy(), loss)),
                        **kw)
    return tuple(np.asarray(a) for a in ref), port, iterates


def test_gd_every_iterate_equals_jax():
    x, y = _noisy_blobs(500, 6, 3, seed=0)
    layers = (6, 5, 3)
    flat0 = _jax_flat0(layers, 0)
    _, _, iterates = _both(x, y, layers, flat0, "gd", 8, step_size=0.5)
    assert len(iterates) == 8
    for k in range(1, 9):
        ref_flat, ref_loss, ref_it = _both(x, y, layers, flat0, "gd", k, step_size=0.5)[0]
        assert int(ref_it) == k
        np.testing.assert_allclose(iterates[k - 1][0], ref_flat, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref_flat).max())
        np.testing.assert_allclose(iterates[k - 1][1], float(ref_loss), rtol=1e-5)


def test_lbfgs_first_iterations_equal_jax():
    x, y = _noisy_blobs(800, 4, 3, seed=0)
    layers = (4, 3, 3)
    flat0 = _jax_flat0(layers, 0)
    _, _, iterates = _both(x, y, layers, flat0, "l-bfgs", 5)
    for k in range(1, 6):
        ref_flat, ref_loss, _ = _both(x, y, layers, flat0, "l-bfgs", k)[0]
        np.testing.assert_allclose(iterates[k - 1][1], float(ref_loss), rtol=1e-4)
        np.testing.assert_allclose(iterates[k - 1][0], ref_flat, rtol=1e-4,
                                   atol=1e-4 * np.abs(ref_flat).max())


def test_lbfgs_whole_fit_with_a_hidden_layer_agrees_with_jax():
    x, y = _noisy_blobs(800, 4, 3, seed=1)
    layers = (4, 3, 3)
    (ref_flat, ref_loss, _), (flat, loss, it), _ = _both(
        x, y, layers, _jax_flat0(layers, 1), "l-bfgs", 100)
    assert it > 5
    np.testing.assert_allclose(loss, float(ref_loss), rtol=1e-3)
    ref_pred = np.asarray(JM._forward(jnp.asarray(ref_flat), jnp.asarray(x), layers)).argmax(1)
    pred = PM._forward(flat, torch.from_numpy(x), layers).argmax(1).numpy()
    assert np.mean(pred == ref_pred) >= 0.99


def test_lbfgs_softmax_regression_reaches_the_jax_minimum():
    x, y = _noisy_blobs(1000, 6, 4, seed=3, flip=0.2)
    layers = (6, 4)
    (ref_flat, ref_loss, _), (flat, loss, _), _ = _both(
        x, y, layers, _jax_flat0(layers, 3), "l-bfgs", 100)
    np.testing.assert_allclose(loss, float(ref_loss), rtol=1e-4)
    ref_pred = np.asarray(JM._forward(jnp.asarray(ref_flat), jnp.asarray(x), layers)).argmax(1)
    assert np.mean(PM._forward(flat, torch.from_numpy(x), layers).argmax(1).numpy()
                   == ref_pred) >= 0.99


def test_estimator_fit_params_and_outputs():
    x, y = _noisy_blobs(600, 5, 3, seed=2, flip=0.1)
    est = MultilayerPerceptronClassifier(device=CPU, layers=[5, 4, 3], maxIter=30, seed=4)
    ref_est = JM.MultilayerPerceptronClassifier(layers=[5, 4, 3], maxIter=30, seed=4)
    for name in ("maxIter", "tol", "stepSize", "solver", "seed", "probabilityCol",
                 "rawPredictionCol", "layers"):
        assert est.getOrDefault(name) == ref_est.getOrDefault(name), name
    model = est.fit((x, y))
    assert model.fit_report is not None and 0 < model.iterations <= 30
    # the recorded loss is the loss at the returned weights
    w = torch.ones(len(x))
    np.testing.assert_allclose(
        model.trainLoss,
        float(PM.cross_entropy_loss(torch.from_numpy(model.weights), torch.from_numpy(x),
                                    torch.from_numpy(y).long(), w, (5, 4, 3))),
        rtol=1e-6)
    # the same seed gives the same start and the same fit
    again = MultilayerPerceptronClassifier(device=CPU, layers=[5, 4, 3], maxIter=30, seed=4)
    np.testing.assert_array_equal(again.fit((x, y)).weights, model.weights)
    assert np.mean(model._predict_matrix(x) == y) > 0.8
    # the JAX model's decision rule on the port's weights
    ref_model = JM.MultilayerPerceptronClassificationModel(weights=model.weights)
    ref_model._set(layers=[5, 4, 3])
    proba, preds = model.proba_and_predictions(x)
    ref_proba, ref_preds = ref_model.proba_and_predictions(x)
    np.testing.assert_allclose(proba, ref_proba, rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(preds, ref_preds)
    assert model.numClasses == 3 and model.predict(x[0]) == preds[0]


def test_glorot_start_is_bounded_and_seeded():
    layers = (20, 10, 3)
    a = PM.glorot_init(layers, 7, CPU)
    b = PM.glorot_init(layers, 7, CPU)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert a.numel() == 20 * 10 + 10 + 10 * 3 + 3
    params = PM._unflatten(a, layers)
    for (w, bias), (fan_in, fan_out) in zip(params, zip(layers[:-1], layers[1:])):
        assert float(w.abs().max()) <= np.sqrt(6.0 / (fan_in + fan_out))
        assert float(bias.abs().max()) == 0.0


def test_setters_and_messages_match_jax():
    x, y = _noisy_blobs(100, 4, 3, seed=0)
    port, ref = MultilayerPerceptronClassifier(device=CPU), JM.MultilayerPerceptronClassifier()
    for setter, bad in (("setLayers", [4]), ("setStepSize", 0.0), ("setSolver", "adam")):
        with pytest.raises(ValueError) as port_err:
            getattr(port, setter)(bad)
        with pytest.raises(ValueError) as ref_err:
            getattr(ref, setter)(bad)
        assert str(port_err.value) == str(ref_err.value)
    with pytest.raises(ValueError, match="setLayers"):
        port.fit((x, y))
    with pytest.raises(ValueError, match="features"):
        MultilayerPerceptronClassifier(device=CPU, layers=[5, 3]).fit((x, y))
    with pytest.raises(ValueError, match="classes"):
        MultilayerPerceptronClassifier(device=CPU, layers=[4, 2]).fit((x, y))


def test_jax_model_carries_across():
    x, y = _noisy_blobs(300, 4, 3, seed=5, flip=0.1)
    ref = JM.MultilayerPerceptronClassifier(layers=[4, 3, 3], maxIter=20).fit((x, y))
    port = model_from_arrays("MultilayerPerceptronClassificationModel", ref._saveData(),
                             device="cpu", params=dict(ref._paramMap))
    assert isinstance(port, MultilayerPerceptronClassificationModel)
    assert port.iterations == ref.iterations and port.trainLoss == ref.trainLoss
    np.testing.assert_array_equal(port._predict_matrix(x), ref._predict_matrix(x))


@pytest.mark.cuda
def test_card_lbfgs_follows_the_cpu():
    """The card's first 5 L-BFGS iterations against the same function run
    on the CPU from the same start."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    x, y = _noisy_blobs(2000, 8, 4, seed=0)
    layers = (8, 6, 4)
    flat0 = PM.glorot_init(layers, 0, CPU)
    out = {}
    for dev in ("cpu", "cuda"):
        rec = []
        PM.train_mlp(flat0.to(dev), torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev),
                     torch.ones(len(x), device=dev), layers=layers, solver="l-bfgs",
                     max_iter=5, callback=lambda it, f, loss: rec.append(loss))
        out[dev] = rec
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=1e-4)
