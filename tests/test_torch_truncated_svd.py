"""The port's TruncatedSVD against the JAX package's.

Both packages get the same f32 rows, made from a numpy seed: a rank-6 mix
with well separated singular values plus 0.05 noise, so components
compare one by one. The port runs with device="cpu", where the Gram
kernels run their plain versions. Tolerances:

- precision "highest", solvers "gram", "svd", "auto": components atol
  2e-5, singular values rtol 1e-5 (f32 products summed in other orders;
  the svd route's QR of f32 rows);
- "randomized": the port sketches with a ``torch.Generator``, the JAX
  package with ``jax.random``, so the sketches differ; after two power
  iterations on this spectrum both capture the top 4 to 1e-4 (components)
  and 1e-5 (singular values);
- precision "high" (the split's three bf16 products, about 16 mantissa
  bits) and "default" (one bf16 pass, about 8 bits, diagonal exact): the
  port against the JAX package at "highest", min |cosine| ≥ 0.9999 and
  singular values rtol 1e-4 (high) and 1e-2 (default).
"""

import numpy as np
import pandas as pd
import pytest
import torch

import jax  # noqa: F401  (imported at the top of every port test file)

from spark_rapids_ml_tpu.models.truncated_svd import TruncatedSVD as JaxTSVD
from spark_rapids_ml_tpu.models.truncated_svd import TruncatedSVDModel as JaxTSVDModel
from spark_rapids_ml_tpu_torch import TruncatedSVD, TruncatedSVDModel
from spark_rapids_ml_tpu_torch.convert import model_from_arrays
from spark_rapids_ml_tpu_torch.models import truncated_svd as T
from spark_rapids_ml_tpu_torch.models.base import Saveable
from spark_rapids_ml_tpu_torch.ops import gram_moments as G

K = 4


def _data(rows=900, n=24, seed=9):
    rng = np.random.default_rng(seed)
    scales = np.array([40.0, 25.0, 15.0, 9.0, 5.0, 3.0])
    base = rng.normal(size=(rows, 6)) * scales
    q, _ = np.linalg.qr(rng.normal(size=(n, 6)))
    return (base @ q.T + 0.05 * rng.normal(size=(rows, n))).astype(np.float32)


def _min_cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    cos = np.abs(np.sum(a * b, axis=0)) / (np.linalg.norm(a, axis=0) * np.linalg.norm(b, axis=0))
    return float(cos.min())


@pytest.mark.parametrize("solver", ["gram", "svd", "auto"])
@pytest.mark.parametrize("partitions", [1, 3])
def test_fit_matches_jax(solver, partitions):
    x = _data()
    port = TruncatedSVD(device="cpu", k=K, solver=solver, precision="highest").fit(
        x, num_partitions=partitions)
    ref = JaxTSVD(k=K, solver=solver, precision="highest").fit(x, num_partitions=partitions)
    np.testing.assert_allclose(port.components, ref.components, rtol=0, atol=2e-5)
    np.testing.assert_allclose(port.singularValues, ref.singularValues, rtol=1e-5)
    assert port.components.shape == (x.shape[1], K) and port.singularValues.shape == (K,)


def test_randomized_solver_matches_jax():
    x = _data(n=64)
    port = TruncatedSVD(device="cpu", k=K, solver="randomized").fit(x)
    ref = JaxTSVD(k=K, solver="randomized").fit(x)
    np.testing.assert_allclose(np.abs(port.components), np.abs(ref.components), rtol=0, atol=1e-4)
    np.testing.assert_allclose(port.singularValues, ref.singularValues, rtol=1e-5)


@pytest.mark.parametrize("precision,sv_rtol", [("high", 1e-4), ("default", 1e-2)])
def test_kernel_tiers_match_jax_highest(precision, sv_rtol, monkeypatch):
    x = _data()
    launches = []

    def counted(*args, **kwargs):
        launches.append(kwargs.get("products"))
        return G.fused_gram_moments(*args, **kwargs)

    monkeypatch.setattr(T.L, "fused_gram_moments", counted)
    port = TruncatedSVD(device="cpu", k=K, precision=precision).fit(x, num_partitions=3)
    ref = JaxTSVD(k=K, precision="highest").fit(x, num_partitions=3)
    # one fused kernel call a partition, with the tier's count of products
    assert launches == [3 if precision == "high" else 1] * 3
    assert _min_cos(port.components, ref.components) >= 0.9999
    np.testing.assert_allclose(port.singularValues, ref.singularValues, rtol=sv_rtol)


def test_gram_of_each_tier_against_f64():
    x = _data(rows=300)
    g64 = x.astype(np.float64).T @ x.astype(np.float64)
    for precision, rtol in [("highest", 1e-6), ("high", 1e-5), ("default", 1e-2)]:
        got = T._gram(torch.from_numpy(x), precision).numpy()
        np.testing.assert_allclose(got, g64, rtol=0, atol=rtol * np.abs(g64).max())
        # the diagonal is the kernel's Σx² of the tier, exact enough for σ
        np.testing.assert_allclose(np.diag(got), np.diag(g64), rtol=1e-5)
    with pytest.raises(ValueError, match="precision"):
        T._gram(torch.from_numpy(x), "fast")


@pytest.mark.parametrize("kind", ["ndarray", "pandas"])
def test_transform_matches_jax(kind):
    x = _data(rows=200)
    port = TruncatedSVD(device="cpu", k=K, inputCol="f", outputCol="svd").fit(x)
    ref = JaxTSVD(k=K).setInputCol("f").setOutputCol("svd").fit(x)
    data = x if kind == "ndarray" else pd.DataFrame({"f": list(x)})
    got, want = port.transform(data), ref.transform(data)
    if kind == "pandas":
        got, want = np.stack(got["svd"]), np.stack(want["svd"])
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-4 * np.abs(want).max())
    rows = port.transform_rows(x[:3])
    np.testing.assert_allclose(np.stack(rows), np.stack(ref.transform_rows(x[:3])), rtol=1e-5)
    np.testing.assert_allclose(port.explained_variance_ratio(), ref.explained_variance_ratio(),
                               rtol=1e-5)
    assert "tsvd transform" in port.transform_report.phases


def test_params_checks_and_report_match_jax():
    port, ref = TruncatedSVD(device="cpu"), JaxTSVD()
    assert port._defaultParamMap == ref._defaultParamMap
    assert {p.name for p in type(port).params()} == {p.name for p in type(ref).params()}
    for setter, value, match in [("setSolver", "lanczos", "solver"),
                                 ("setPrecision", "fast", "precision")]:
        with pytest.raises(ValueError, match=match):
            getattr(port, setter)(value)
        with pytest.raises(ValueError, match=match):
            getattr(ref, setter)(value)
    x = _data(rows=50, n=8)
    with pytest.raises(ValueError, match="k=9"):
        TruncatedSVD(device="cpu", k=9).fit(x)
    with pytest.raises(ValueError, match="unknown solver"):
        T._decompose_gram(torch.eye(4), 2, "lanczos")
    model = TruncatedSVD(device="cpu", k=2).fit(x)
    assert {"tsvd reduce", "tsvd decompose"} <= set(model.fit_report.phases)


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (TruncatedSVD, TruncatedSVDModel):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls()


def test_models_cross_between_packages(tmp_path):
    x = _data(rows=200)
    ref = JaxTSVD(k=K).fit(x)
    want = np.asarray(ref.transform(x))
    ref.save(str(tmp_path / "jax"))
    loaded = Saveable.load(str(tmp_path / "jax"), device="cpu")
    assert isinstance(loaded, TruncatedSVDModel) and loaded.getK() == K
    np.testing.assert_array_equal(loaded.components, ref.components)
    conv = model_from_arrays("TruncatedSVDModel", ref._saveData(), "cpu", {"k": K})
    np.testing.assert_allclose(conv.transform(x), want, rtol=0, atol=1e-4 * np.abs(want).max())
    conv.save(str(tmp_path / "port"))
    from spark_rapids_ml_tpu.utils.persistence import load_arrays

    back = JaxTSVDModel._fromSaved(None, load_arrays(str(tmp_path / "port")))
    np.testing.assert_array_equal(back.singularValues, ref.singularValues)
    np.testing.assert_array_equal(np.asarray(back.transform(x)), want)
