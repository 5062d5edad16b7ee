"""The port's incremental estimators against the JAX package's.

The same f32 batches (a seeded stream of uneven batches) go through
``partial_fit`` in both packages, then ``finalize``; the port runs with
device="cpu". Tolerances:

- IncrementalPCA and IncrementalTruncatedSVD at "highest" (f32 folds):
  components atol 5e-5 (up to each column's sign), explained variance and
  singular values rtol 1e-5; at "high" (the symmetric kernel's plain
  version, ~16 mantissa bits) components min |cosine| ≥ 0.9999;
- IncrementalStandardScaler: mean and std rtol 1e-5;
- IncrementalLinearRegression: coefficients atol 2e-5 of the largest (f32
  carry there, f64 here), as the one-shot fits; 5e-5 against the port's
  one-shot fit, whose f32 products run over other blocks of rows;
- IncrementalKMeans with initMode="random" (both packages draw the seeds
  with numpy): centres atol 1e-5 of the data's scale. The JAX estimator
  gets the rows as f64: with x64 on, its f32 rows meet f64 pad weights in
  a ``lax.scan`` that refuses the mixed carry.

A JAX estimator's ``to_state()`` loads into the port (``from_state``,
``convert.incremental_from_state``) and the stream continues there; the
port's state loads back into the JAX package.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import jax  # noqa: F401  (imported at the top of every port test file)

from spark_rapids_ml_tpu.models import incremental as JI
from spark_rapids_ml_tpu_torch import LinearRegression, PCA
from spark_rapids_ml_tpu_torch.convert import incremental_from_state
from spark_rapids_ml_tpu_torch.models import incremental as TI
from spark_rapids_ml_tpu_torch.ops import gram_moments as G
from spark_rapids_ml_tpu_torch.utils.checkpoint import TrainingCheckpointer

CPU = torch.device("cpu")
EDGES = [0, 130, 400, 410, 700]


def _rows(rows=700, n=10, seed=21):
    rng = np.random.default_rng(seed)
    scales = np.linspace(6.0, 0.5, n)
    return (rng.normal(size=(rows, n)) * scales + 2.0).astype(np.float32)


def _batches(a):
    return [a[lo:hi] for lo, hi in zip(EDGES[:-1], EDGES[1:])]


def _stream(est, batches):
    for b in batches:
        est.partial_fit(b)
    return est


def _abs_close(a, b, atol):
    np.testing.assert_allclose(np.abs(np.asarray(a)), np.abs(np.asarray(b)), rtol=0, atol=atol)


def _min_cos(a, b):
    cos = np.abs(np.sum(a * b, axis=0)) / (np.linalg.norm(a, axis=0) * np.linalg.norm(b, axis=0))
    return float(cos.min())


SPECTRAL = {
    "pca_full": (JI.IncrementalPCA, TI.IncrementalPCA, dict(k=3), ("pc", "explainedVariance")),
    "pca_centred": (JI.IncrementalPCA, TI.IncrementalPCA, dict(k=3, meanCentering=True),
                    ("pc", "explainedVariance")),
    "pca_svd": (JI.IncrementalPCA, TI.IncrementalPCA, dict(k=3, solver="svd"),
                ("pc", "explainedVariance")),
    "tsvd_gram": (JI.IncrementalTruncatedSVD, TI.IncrementalTruncatedSVD, dict(k=3),
                  ("components", "singularValues")),
    "tsvd_svd": (JI.IncrementalTruncatedSVD, TI.IncrementalTruncatedSVD,
                 dict(k=3, solver="svd"), ("components", "singularValues")),
}


@pytest.mark.parametrize("case", sorted(SPECTRAL))
def test_spectral_streams_match_jax(case):
    jcls, tcls, kw, (vectors, values) = SPECTRAL[case]
    batches = _batches(_rows())
    ref = _stream(jcls(precision="highest", **kw), batches).finalize()
    port_est = _stream(tcls(device="cpu", precision="highest", **kw), batches)
    got = port_est.finalize()
    _abs_close(getattr(got, vectors), getattr(ref, vectors), 5e-5)
    np.testing.assert_allclose(getattr(got, values), getattr(ref, values), rtol=1e-5)
    if case.startswith("pca") and case != "pca_svd":
        assert port_est.n_rows_seen == 700


@pytest.mark.parametrize("cls,kw", [(TI.IncrementalPCA, dict(k=3)),
                                    (TI.IncrementalTruncatedSVD, dict(k=3))])
def test_high_folds_run_the_symmetric_kernel(cls, kw, monkeypatch):
    batches = _batches(_rows())
    calls = []

    def counted(x, **kwargs):
        calls.append((x.shape[0], kwargs.get("products")))
        return G.symmetric_gram_moments(x, **kwargs)

    monkeypatch.setattr(TI.L, "symmetric_gram_moments", counted)
    got = _stream(cls(device="cpu", precision="high", **kw), batches).finalize()
    # one symmetric call a batch, on its true rows, three products
    assert calls == [(hi - lo, 3) for lo, hi in zip(EDGES[:-1], EDGES[1:])]
    ref = _stream(cls(device="cpu", precision="highest", **kw), batches).finalize()
    vec = "pc" if cls is TI.IncrementalPCA else "components"
    assert _min_cos(getattr(got, vec), getattr(ref, vec)) >= 0.9999


def test_incremental_pca_equals_the_one_shot_fit():
    x = _rows()
    port = _stream(TI.IncrementalPCA(device="cpu", k=3), _batches(x)).finalize()
    one = PCA(device="cpu", k=3).fit(x)
    _abs_close(port.pc, one.pc, 1e-5)
    np.testing.assert_allclose(port.explainedVariance, one.explainedVariance, rtol=1e-5)


def test_scaler_stream_matches_jax():
    batches = _batches(_rows())
    ref = _stream(JI.IncrementalStandardScaler(), batches).finalize()
    got = _stream(TI.IncrementalStandardScaler(device="cpu"), batches).finalize()
    np.testing.assert_allclose(got.mean, ref.mean, rtol=1e-5)
    np.testing.assert_allclose(got.std, ref.std, rtol=1e-5)


def _labeled(seed=4):
    x = _rows(seed=seed)
    rng = np.random.default_rng(seed)
    y = (x @ rng.normal(size=x.shape[1]) - 1.0 + 0.1 * rng.normal(size=len(x))).astype(np.float32)
    w = rng.uniform(0.1, 2.0, size=len(x))
    return x, y, w


@pytest.mark.parametrize("kw", [{}, {"regParam": 0.05, "elasticNetParam": 0.5}])
@pytest.mark.parametrize("weighted", [False, True])
def test_linear_regression_stream_matches_jax_and_the_one_shot_fit(kw, weighted):
    x, y, w = _labeled()
    batches = [(x[lo:hi], y[lo:hi], w[lo:hi] if weighted else None)
               for lo, hi in zip(EDGES[:-1], EDGES[1:])]
    ref = _stream(JI.IncrementalLinearRegression(**kw), batches).finalize()
    est = _stream(TI.IncrementalLinearRegression(device="cpu", **kw), batches)
    got = est.finalize()
    scale = np.abs(ref.coefficients).max()
    np.testing.assert_allclose(got.coefficients, ref.coefficients, rtol=0, atol=2e-5 * scale)
    assert got.intercept == pytest.approx(ref.intercept, abs=2e-5 * scale)
    assert est.n_rows_seen == len(x)
    # the one-shot fit takes its f32 products over other blocks of rows
    one = LinearRegression(device="cpu", **kw).fit((x, y, w) if weighted else (x, y))
    np.testing.assert_allclose(got.coefficients, one.coefficients, rtol=0, atol=5e-5 * scale)


def test_linear_regression_stream_takes_frames():
    x, y, w = _labeled()
    df = pd.DataFrame({"features": list(x), "label": y, "wt": w})
    got = _stream(TI.IncrementalLinearRegression(device="cpu", weightCol="wt"),
                  [df.iloc[:300], df.iloc[300:]]).finalize()
    one = LinearRegression(device="cpu").fit((x, y, w))
    scale = np.abs(one.coefficients).max()
    np.testing.assert_allclose(got.coefficients, one.coefficients, rtol=0, atol=5e-5 * scale)


def test_kmeans_stream_matches_jax():
    x = _rows()
    kw = dict(k=4, initMode="random", seed=3, seedRows=200)
    ref_est = _stream(JI.IncrementalKMeans(**kw), _batches(x.astype(np.float64)))
    est = _stream(TI.IncrementalKMeans(device="cpu", **kw), _batches(x))
    ref, got = ref_est.finalize(), est.finalize()
    np.testing.assert_allclose(got.clusterCenters, ref.clusterCenters, rtol=0, atol=1e-5 * 6.0)
    assert got.trainingCost == pytest.approx(ref.trainingCost, rel=1e-5)
    assert est.n_rows_seen == 700


def test_minibatch_center_update_matches_jax():
    rng = np.random.default_rng(0)
    centers, sums = rng.normal(size=(4, 3)), rng.normal(size=(4, 3))
    cum, counts = np.array([0.0, 2.0, 0.0, 5.0]), np.array([3.0, 1.0, 0.0, 0.0])
    got = TI._minibatch_center_update(*(torch.from_numpy(a) for a in (centers, cum, sums, counts)))
    ref = JI._minibatch_center_update(centers, cum, sums, counts)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-15)
    # a centre that has owned nothing stays put
    np.testing.assert_array_equal(got[0][2].numpy(), centers[2])


def test_short_kmeans_stream_seeds_at_finalize_and_errors_match():
    x = _rows(rows=40)
    got = TI.IncrementalKMeans(device="cpu", k=3, initMode="random").partial_fit(x).finalize()
    ref = JI.IncrementalKMeans(k=3, initMode="random").partial_fit(x.astype(np.float64)).finalize()
    np.testing.assert_allclose(got.clusterCenters, ref.clusterCenters, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="finalize"):
        TI.IncrementalKMeans(device="cpu", k=3).finalize()
    with pytest.raises(ValueError, match="positive weight"):
        TI.IncrementalKMeans(device="cpu", k=3, seedRows=2).partial_fit(x[:5], sample_weight=np.zeros(5))
    with pytest.raises(ValueError, match="seedRows"):
        TI.IncrementalKMeans(device="cpu").setSeedRows(0)


STATE_CASES = {
    "pca": (JI.IncrementalPCA, dict(k=3), lambda m: m.pc),
    "pca_svd": (JI.IncrementalPCA, dict(k=3, solver="svd"), lambda m: m.pc),
    "tsvd": (JI.IncrementalTruncatedSVD, dict(k=3), lambda m: m.components),
    "tsvd_svd": (JI.IncrementalTruncatedSVD, dict(k=3, solver="svd"), lambda m: m.components),
    "scaler": (JI.IncrementalStandardScaler, dict(), lambda m: m.std),
    "linreg": (JI.IncrementalLinearRegression, dict(), lambda m: m.coefficients),
    "kmeans": (JI.IncrementalKMeans, dict(k=3, initMode="random", seedRows=150),
               lambda m: m.clusterCenters),
    "kmeans_seeding": (JI.IncrementalKMeans, dict(k=3, initMode="random", seedRows=5000),
                       lambda m: m.clusterCenters),
}


@pytest.mark.parametrize("case", sorted(STATE_CASES))
def test_state_crosses_between_packages_mid_stream(case, tmp_path):
    jcls, kw, result = STATE_CASES[case]
    name = jcls.__name__
    if name == "IncrementalLinearRegression":
        x, y, _ = _labeled()
        batches = [(x[lo:hi], y[lo:hi]) for lo, hi in zip(EDGES[:-1], EDGES[1:])]
    else:
        batches = _batches(_rows().astype(np.float64 if "KMeans" in name else np.float32))
    ref = _stream(jcls(**kw), batches).finalize()
    # the first half in JAX, the state through a checkpoint, the rest here
    half = _stream(jcls(**kw), batches[:2])
    ckpt = TrainingCheckpointer(tmp_path / "state")
    arrays, state = half.to_state()
    ckpt.save(0, arrays, state)
    _, arrays, state = ckpt.latest()
    state.pop("step")
    port = incremental_from_state(name, arrays, state, "cpu", kw)
    got = _stream(port, batches[2:]).finalize()
    np.testing.assert_allclose(np.abs(result(got)), np.abs(result(ref)), rtol=1e-4, atol=1e-5)
    # and back: the port's state resumes in the JAX package
    port_half = _stream(getattr(TI, name)(device="cpu", **kw), batches[:2])
    back = _stream(jcls(**kw).from_state(*port_half.to_state()), batches[2:]).finalize()
    np.testing.assert_allclose(np.abs(result(back)), np.abs(result(ref)), rtol=1e-4, atol=1e-5)


def test_state_guards_match_jax():
    x = _rows()
    port = TI.IncrementalPCA(device="cpu", k=3).partial_fit(x[:100])
    with pytest.raises(ValueError, match="checkpoint state is for"):
        TI.IncrementalTruncatedSVD(device="cpu").from_state(*port.to_state())
    with pytest.raises(ValueError, match="inconsistent feature dim"):
        port.partial_fit(x[:10, :4])
    port.setSolver("randomized")
    with pytest.raises(ValueError, match="solver changed mid-stream"):
        port.partial_fit(x[:10])
    with pytest.raises(ValueError, match="finalize"):
        TI.IncrementalPCA(device="cpu", k=2).finalize()
    with pytest.raises(ValueError, match="svd"):
        TI.IncrementalPCA(device="cpu", k=2, solver="svd", meanCentering=True).partial_fit(x)
    assert port.reset().n_rows_seen == 0


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (TI.IncrementalPCA, TI.IncrementalTruncatedSVD, TI.IncrementalStandardScaler,
                TI.IncrementalLinearRegression, TI.IncrementalKMeans):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls()
