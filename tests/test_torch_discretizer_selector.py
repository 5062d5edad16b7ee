"""The port's Bucketizer, QuantileDiscretizer and VarianceThresholdSelector
against the JAX package's, on the CPU.

The same seeded f32 rows go through both packages. Bucket ids and the
selected features are held exactly; the learned splits at rtol 1e-5 (both
sides interpolate the same f32 histogram in f32, in orders that may differ
in the last bit), and the ids they give exactly; values on the split
points are binned exactly alike under the same splits. Models cross both ways:
JAX saves load in the port (both layouts for the selector), the port's
Spark-layout selector loads in the JAX package, and the ``_saveData``
dicts build port models (``convert.model_from_arrays``).
"""

from __future__ import annotations

import jax  # noqa: F401  (imported at the top of every port test file)
import numpy as np
import pytest

from spark_rapids_ml_tpu.models import discretizer as JD
from spark_rapids_ml_tpu.models import selector as JSel
from spark_rapids_ml_tpu_torch import convert
from spark_rapids_ml_tpu_torch.models import discretizer as TD
from spark_rapids_ml_tpu_torch.models import selector as TSel
from spark_rapids_ml_tpu_torch.models.base import Saveable

ROWS, N = 500, 6


@pytest.fixture(scope="module")
def x():
    rng = np.random.default_rng(31)
    x = rng.normal(size=(ROWS, N)).astype(np.float32)
    x[:, 1] = rng.integers(0, 5, size=ROWS)  # ties: collapsed quantiles
    x[:, 2] = np.exp(x[:, 2])                # skewed
    x[:, 4] *= 0.01                          # low variance
    x[:, 5] = 2.0                            # constant
    return x


@pytest.mark.parametrize("splits", [[-np.inf, -1.0, 0.0, 1.0, np.inf], [-10.0, 0.0, 0.5, 10.0]])
@pytest.mark.parametrize("handle", ["error", "keep"])
def test_bucketizer_matches_jax(x, splits, handle):
    xs = x.copy()
    xs[:3, 0] = [-1.0, 0.0, 1.0]  # on split points
    xs[3, 3] = 20.0               # outside [-10, 10]
    port = TD.Bucketizer(device="cpu", splits=splits, handleInvalid=handle)
    ref = JD.Bucketizer(splits=splits, handleInvalid=handle)
    if handle == "error" and np.isfinite(splits[0]):
        with pytest.raises(ValueError) as port_err:
            port.transform(xs)
        with pytest.raises(ValueError) as jax_err:
            ref.transform(xs)
        assert str(port_err.value) == str(jax_err.value)
        return
    np.testing.assert_array_equal(port.transform(xs), ref.transform(xs))


@pytest.mark.parametrize("buckets", [2, 4, 7])
@pytest.mark.parametrize("partitions", [1, 3])
def test_quantile_discretizer_matches_jax(x, buckets, partitions):
    ref = JD.QuantileDiscretizer(numBuckets=buckets, numBins=256).fit(
        x, num_partitions=partitions)
    port = TD.QuantileDiscretizer(device="cpu", numBuckets=buckets, numBins=256).fit(
        x, num_partitions=partitions)
    assert port.splits.shape == ref.splits.shape == (N, buckets + 1)
    np.testing.assert_allclose(port.splits, ref.splits, rtol=1e-5, atol=1e-6)
    got = port.transform(x)
    np.testing.assert_array_equal(got, ref.transform(x))
    assert got.min() >= 0 and got.max() <= buckets - 1
    # the learned splits may differ in their last bit (the interpolation's
    # f32 order), so values on split points are held with the JAX splits
    # carried across: each goes to the bucket it opens on both sides
    carried = convert.model_from_arrays("QuantileDiscretizerModel", ref._saveData(),
                                        device="cpu")
    xs = x.copy()
    for j in range(N):
        xs[: buckets - 1, j] = ref.splits[j, 1:buckets].astype(np.float32)
    np.testing.assert_array_equal(carried.transform(xs), ref.transform(xs))


def test_splits_from_histogram_matches_jax(x):
    import jax.numpy as jnp
    import torch

    from spark_rapids_ml_tpu.ops import scaler as JS

    mins, maxs = x.min(0), x.max(0)
    hist = np.asarray(JS.histogram_stats(jnp.asarray(x), jnp.asarray(ROWS), jnp.asarray(mins),
                                         jnp.asarray(maxs), bins=64))
    port = TD.splits_from_histogram(torch.from_numpy(hist), torch.from_numpy(mins),
                                    torch.from_numpy(maxs), 5)
    ref = JD.splits_from_histogram(hist, mins, maxs, 5)
    np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-6)


def test_discretizer_refuses_nan_like_jax(x):
    xn = x.copy()
    xn[7, 2] = np.nan
    for fit in (lambda: TD.QuantileDiscretizer(device="cpu").fit(xn),
                lambda: JD.QuantileDiscretizer().fit(xn)):
        with pytest.raises(ValueError, match=r"feature\(s\) \[2\] contain NaN"):
            fit()
    model = TD.QuantileDiscretizer(device="cpu").fit(x)
    with pytest.raises(ValueError, match="NaN at row 7 feature 2"):
        model.transform(xn)


@pytest.mark.parametrize("threshold", [0.0, 0.5, 1.2])
def test_variance_selector_matches_jax(x, threshold):
    ref = JSel.VarianceThresholdSelector(varianceThreshold=threshold).fit(x, num_partitions=2)
    port = TSel.VarianceThresholdSelector(device="cpu", varianceThreshold=threshold).fit(
        x, num_partitions=2)
    np.testing.assert_array_equal(port.selectedFeatures, ref.selectedFeatures)
    np.testing.assert_array_equal(port.transform(x), ref.transform(x))


def test_variance_selector_refuses_like_jax(x):
    with pytest.raises(ValueError) as port_err:
        TSel.VarianceThresholdSelector(device="cpu", varianceThreshold=1e6).fit(x)
    with pytest.raises(ValueError) as jax_err:
        JSel.VarianceThresholdSelector(varianceThreshold=1e6).fit(x)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("layout", ["native", "spark"])
def test_selector_saves_cross_both_ways(x, tmp_path, layout):
    ref = JSel.VarianceThresholdSelector(varianceThreshold=0.5).fit(x)
    ref.save(str(tmp_path / "jax"), layout=layout)
    loaded = Saveable.load(str(tmp_path / "jax"), device="cpu")
    assert isinstance(loaded, TSel.VarianceThresholdSelectorModel) and loaded.uid == ref.uid
    np.testing.assert_array_equal(loaded.selectedFeatures, ref.selectedFeatures)
    assert loaded.getVarianceThreshold() == 0.5
    if layout == "spark":
        loaded.save(str(tmp_path / "port"), layout="spark")
        back = JSel.VarianceThresholdSelectorModel.load(str(tmp_path / "port"))
        np.testing.assert_array_equal(back.selectedFeatures, ref.selectedFeatures)


def test_discretizer_saves_cross_and_refuse_the_spark_layout(x, tmp_path):
    ref = JD.QuantileDiscretizer(numBuckets=3).fit(x)
    ref.save(str(tmp_path / "jax"))
    loaded = Saveable.load(str(tmp_path / "jax"), device="cpu")
    np.testing.assert_array_equal(loaded.splits, ref.splits)
    np.testing.assert_array_equal(loaded.transform(x), ref.transform(x))
    with pytest.raises(NotImplementedError, match="native layout"):
        loaded.save(str(tmp_path / "spark"), layout="spark")
    assert not (tmp_path / "spark").exists()


@pytest.mark.parametrize("which", ["discretizer", "selector"])
def test_models_carry_across_from_arrays(x, which):
    if which == "discretizer":
        ref = JD.QuantileDiscretizer(numBuckets=4).fit(x)
    else:
        ref = JSel.VarianceThresholdSelector(varianceThreshold=0.5).fit(x)
    port = convert.model_from_arrays(type(ref).__name__, ref._saveData(), device="cpu",
                                     params=dict(ref._paramMap))
    np.testing.assert_array_equal(port.transform(x), ref.transform(x))
