"""The port's PCA against the JAX package's, through fit and transform.

Both estimators get the same f32 data in the same container; the port runs
with device="cpu". Components must agree to min |cosine| >= 0.9999,
explainedVariance to rtol 1e-4, and transforms to 1e-4·max|out| (sign_flip
orients both sides' components the same way).
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

from spark_rapids_ml_tpu import PCA as JaxPCA
from spark_rapids_ml_tpu_torch import PCA, PCAModel
from spark_rapids_ml_tpu_torch.convert import pca_model_from_arrays

ROWS, N, K = 900, 96, 6
COSINE_BAR = 0.9999


def _workload(rows=ROWS, n=N, seed=7):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(rows, 64)).astype(np.float32)
    mix = rng.normal(size=(64, n)).astype(np.float32)
    return base @ mix + 0.1 * rng.normal(size=(rows, n)).astype(np.float32)


def _container(x, kind):
    if kind == "ndarray":
        return x
    if kind == "pandas":
        return pd.DataFrame({"features": list(x)})
    values = pa.array(x.reshape(-1))
    return pa.table({"features": pa.FixedSizeListArray.from_arrays(values, x.shape[1])})


def _output(out, kind):
    if kind == "ndarray":
        return np.asarray(out)
    if kind == "pandas":
        return np.stack(out["pca_features"].to_numpy())
    return np.asarray(out.column("pca_features").combine_chunks().flatten()).reshape(
        out.num_rows, -1
    )


def _min_abs_cosine(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    cos = np.abs((a * b).sum(0)) / (np.linalg.norm(a, axis=0) * np.linalg.norm(b, axis=0))
    return cos.min()


def _assert_models_agree(port, ref):
    assert port.pc.shape == ref.pc.shape == (N, K)
    assert _min_abs_cosine(port.pc, ref.pc) >= COSINE_BAR
    np.testing.assert_allclose(port.explainedVariance, ref.explainedVariance, rtol=1e-4)


@pytest.fixture(scope="module")
def x():
    return _workload()


@pytest.mark.parametrize("kind", ["ndarray", "pandas", "arrow"])
@pytest.mark.parametrize("partitions", [1, 3])
@pytest.mark.parametrize("center", [False, True])
@pytest.mark.parametrize("precision", ["highest", "high"])
def test_fit_transform_matches_jax(x, kind, partitions, center, precision):
    data = _container(x, kind)
    ref = (
        JaxPCA().setInputCol("features").setK(K).setMeanCentering(center)
        .setPrecision(precision).fit(data, num_partitions=partitions)
    )
    port = (
        PCA(device="cpu").setInputCol("features").setK(K).setMeanCentering(center)
        .setPrecision(precision).fit(data, num_partitions=partitions)
    )
    _assert_models_agree(port, ref)
    out = _output(port.transform(data), kind)
    expected = _output(ref.transform(data), kind)
    assert out.shape == (ROWS, K)
    np.testing.assert_allclose(out, expected, rtol=0, atol=1e-4 * np.abs(expected).max())


def test_transform_rows_matches_jax(x):
    ref = JaxPCA().setInputCol("features").setK(K).fit(x)
    port = pca_model_from_arrays(ref._saveData(), device="cpu")
    rows = list(x[:5])
    for a, b in zip(port.transform_rows(rows), ref.transform_rows(rows)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * np.abs(b).max())


@pytest.mark.parametrize("standardize", [False, True])
def test_model_from_jax_arrays_transforms_alike(x, standardize):
    ref = (
        JaxPCA().setInputCol("features").setOutputCol("pca_features").setK(K)
        .setStandardize(standardize).fit(x)
    )
    port = pca_model_from_arrays(ref._saveData(), device="cpu")
    assert isinstance(port, PCAModel) and port.device.type == "cpu"
    port.setInputCol("features")
    expected = np.asarray(ref.transform(x))
    out = port.transform(x)
    np.testing.assert_allclose(out, expected, rtol=0, atol=1e-4 * np.abs(expected).max())


def test_model_from_arrays_rejects_partial_state():
    with pytest.raises(KeyError):
        pca_model_from_arrays({"pc": np.eye(3)}, device="cpu")
    with pytest.raises(KeyError):
        pca_model_from_arrays(
            {"pc": np.eye(3), "explainedVariance": np.ones(3), "mean": np.zeros(3)},
            device="cpu",
        )


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PCA()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PCAModel(pc=np.eye(3), explainedVariance=np.ones(3))


def test_params_match_jax():
    port, ref = PCA(device="cpu"), JaxPCA()
    for name in ("meanCentering", "standardize", "outputCol", "precision", "solver"):
        assert port.getOrDefault(name) == ref.getOrDefault(name)
    assert {p.name for p in PCA.params()} == {p.name for p in JaxPCA.params()}
    assert PCA(k=3, device="cpu").getK() == 3
    with pytest.raises(ValueError, match="precision"):
        PCA(device="cpu").setPrecision("fast")
    with pytest.raises(ValueError, match="solver"):
        PCA(device="cpu").setSolver("qr")


def test_k_larger_than_features_raises(x):
    with pytest.raises(ValueError, match="k="):
        PCA(device="cpu").setK(N + 1).fit(x)


@pytest.mark.parametrize(
    "configure,match",
    [
        pytest.param(lambda p: p.setStandardize(True), "standardize", id="standardize"),
        pytest.param(lambda p: p.setSolver("randomized"), "randomized", id="randomized"),
        pytest.param(lambda p: p.setSolver("svd"), "svd", id="svd"),
        pytest.param(lambda p: p.setSolver("auto"), "auto", id="auto"),
        pytest.param(lambda p: p.setPrecision("default"), "default", id="default_precision"),
    ],
)
def test_unported_options_raise(x, configure, match):
    pca = configure(PCA(device="cpu").setK(K))
    with pytest.raises(NotImplementedError, match=match):
        pca.fit(x)


def test_streamed_cutover_raises(x, monkeypatch):
    monkeypatch.setenv("TPU_ML_STREAM_FIT_MAX_RESIDENT_BYTES", str(x.nbytes))
    with pytest.raises(NotImplementedError, match="streamed fold"):
        PCA(device="cpu").setK(K).fit(x)


def test_save_load_raise(x, tmp_path):
    model = PCA(device="cpu").setK(K).fit(x)
    with pytest.raises(NotImplementedError, match="persistence"):
        model.save(str(tmp_path / "m"))
    with pytest.raises(NotImplementedError, match="persistence"):
        PCAModel.load(str(tmp_path / "m"))
