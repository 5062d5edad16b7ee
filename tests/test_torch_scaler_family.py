"""The port's scaler family against the JAX package's, on the CPU.

Every case runs the same seeded numpy f32 input through the JAX function
(eagerly, on its CPU backend, x64 on) and the port's (``device="cpu"``).
Tolerances, by what the function computes:

- exact equality where the result is a count, an id, a selection or a
  comparison: histograms, bucket ids, binarize, min/max, the slicer, the
  polynomial expansion and the elementwise product (host numpy on both
  sides);
- rtol 1e-5 (atol 1e-6 × the scale of the values) for sums, moments and
  every scaler's statistics and transform: both sides compute in f32 here,
  in other orders of summation. A sample std from f32 moments,
  (Σx² − m·μ²)/(m − 1), loses digits to cancellation in proportion to
  1 + μ²/σ², the same on both sides, so a std, and what it scales, is
  held to rtol 1e-5 × (1 + μ²/σ²) per feature (``_std_rtol``): 1e-5 where
  the feature is centred, about 0.025 for the feature 50 σ from zero.

Both persistence layouts cross in both directions: a JAX-package save
loads in the port, a port Spark-layout save loads in the JAX package, and a
port native save's arrays read there (its loader admits only its own
classes).
"""

from __future__ import annotations

import math

import jax  # noqa: F401  (imported at the top of every port test file)
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from spark_rapids_ml_tpu.models import scaler as JM
from spark_rapids_ml_tpu.ops import scaler as JS
from spark_rapids_ml_tpu.utils import persistence as jax_persistence
from spark_rapids_ml_tpu.utils.config import get_config as jax_config
from spark_rapids_ml_tpu.utils.config import set_config as set_jax_config
from spark_rapids_ml_tpu_torch import convert
from spark_rapids_ml_tpu_torch.models import scaler as TM
from spark_rapids_ml_tpu_torch.models.base import Saveable
from spark_rapids_ml_tpu_torch.ops import scaler as TS
from spark_rapids_ml_tpu_torch.spark import ingest

RTOL = 1e-5
ROWS, N = 300, 7


@pytest.fixture(scope="module")
def x():
    """f32 rows with a constant feature, a feature far from zero, a wide
    feature and a feature of small integers (values on bin and split
    edges)."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(ROWS, N)).astype(np.float32)
    x[:, 1] = 3.0
    x[:, 2] += 50.0
    x[:, 3] *= 20.0
    x[:, 6] = rng.integers(-3, 4, size=ROWS).astype(np.float32)
    return x


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, expected, rtol=RTOL):
    """Equal within ``rtol`` (a scalar, or one per feature: the last axis)
    and atol 1e-6 × the largest finite |expected| (at least 1e-6)."""
    got, expected = _np(got).astype(np.float64), _np(expected).astype(np.float64)
    assert got.shape == expected.shape
    scale = max(np.abs(expected[np.isfinite(expected)]).max(initial=0.0), 1.0)
    bound = np.asarray(rtol) * np.abs(expected) + 1e-6 * scale
    both_nan = np.isnan(got) & np.isnan(expected)
    bad = ~both_nan & ~(np.abs(got - expected) <= bound) & ~(got == expected)
    assert not bad.any(), f"{bad.sum()} mismatches, worst {np.abs(got - expected)[bad].max()}"


def _std_rtol(x) -> np.ndarray:
    """rtol 1e-5 × (1 + μ²/σ²) per feature: what f32 cancellation in the
    one-pass variance costs (see the module note); 1e-5 for a constant
    feature, whose std is exactly 0 on both sides."""
    x64 = np.asarray(x, np.float64)
    var = x64.var(0)
    cond = np.where(var > 0, x64.mean(0) ** 2 / np.where(var > 0, var, 1.0), 0.0)
    return RTOL * (1.0 + cond)


def _equal(got, expected):
    got, expected = _np(got), _np(expected)
    assert got.shape == expected.shape
    np.testing.assert_array_equal(got, expected)


# -- ops: moments ---------------------------------------------------------------------


def test_moment_stats_and_finalize_match_jax(x):
    t, j = TS.moment_stats(_t(x)), JS.moment_stats(jnp.asarray(x))
    for a, b in zip(t, j):
        _close(a, b)
    (tm, ts), (jm, js) = TS.finalize_moments(t), JS.finalize_moments(j)
    _close(tm, jm)
    _close(ts, js, rtol=_std_rtol(x))


@pytest.mark.parametrize("weights", ["unit_with_pads", "instance"])
def test_weighted_moments_match_jax(x, weights):
    rng = np.random.default_rng(2)
    if weights == "unit_with_pads":
        w = np.ones(ROWS, np.float32)
        w[-40:] = 0.0
    else:
        w = rng.uniform(0.1, 2.0, size=ROWS).astype(np.float32)
    t = TS.moment_stats_weighted(_t(x), _t(w))
    j = JS.moment_stats_weighted(jnp.asarray(x), jnp.asarray(w))
    for a, b in zip(t, j):
        _close(a, b)


def test_moment_fold_through_stream_fold_matches_jax(x):
    """The streamed StandardScaler's fold: chunks of 64 rows (the rows do
    not divide them) through ``ingest.stream_fold``, against the JAX fold
    over the same chunks."""
    rep = ingest.stream_fold(
        [x[:100], x[100:]], TS.moment_fold_step(), n=N,
        init=TS.init_moment_carry(N, torch.device("cpu")),
        device=torch.device("cpu"), chunk_rows=64,
    )
    carry = JS.init_moment_carry(N, jnp.float32)
    for lo in range(0, ROWS, 64):
        chunk = x[lo:lo + 64]
        carry = JS.fold_moment_stats(carry, jnp.asarray(chunk),
                                     jnp.ones(len(chunk), jnp.float32))
    assert rep.chunks == math.ceil(ROWS / 64) and rep.rows == ROWS
    for a, b in zip(rep.carry, carry):
        _close(a, b)
    _close(TS.finalize_moments(rep.carry)[1], JS.finalize_moments(carry)[1], rtol=_std_rtol(x))


# -- ops: ranges, histograms, quantiles ------------------------------------------


@pytest.mark.parametrize("mask", ["true_rows", "row_valid", "entry_valid"])
def test_range_stats_match_jax(x, mask):
    rng = np.random.default_rng(4)
    if mask == "true_rows":
        t, j = TS.range_stats(_t(x), 250), JS.range_stats(jnp.asarray(x), jnp.asarray(250))
    else:
        shape = (ROWS,) if mask == "row_valid" else (ROWS, N)
        valid = rng.uniform(size=shape) < 0.7
        t = TS.range_stats(_t(x), valid=_t(valid))
        j = JS.range_stats(jnp.asarray(x), valid=jnp.asarray(valid))
    _close(t.count, j.count)
    for a, b in zip(t[1:], j[1:]):
        _equal(a, b)


@pytest.mark.parametrize("bins", [2, 7, 64])
@pytest.mark.parametrize("valid", [False, True])
def test_histogram_stats_match_jax_exactly(x, bins, valid):
    """Counts are equal bin for bin, pads and invalid entries dropped.
    Feature 6 holds the integers −3…3, so with 2 bins the value 0 and with
    7 bins every value lies on its range's bin grid, and its max 3 falls in
    the last bin."""
    xs = x.copy()
    xs[5, 6] = 3.0
    true_rows = 280
    mins = jnp.asarray(xs[:true_rows].min(0))
    maxs = jnp.asarray(xs[:true_rows].max(0))
    vmask = np.random.default_rng(8).uniform(size=xs.shape) < 0.8 if valid else None
    t = TS.histogram_stats(_t(xs), true_rows, _t(np.asarray(mins)), _t(np.asarray(maxs)),
                           bins=bins, valid=None if vmask is None else _t(vmask))
    j = JS.histogram_stats(jnp.asarray(xs), jnp.asarray(true_rows), mins, maxs, bins=bins,
                           valid=None if vmask is None else jnp.asarray(vmask))
    _equal(t, np.asarray(j).astype(np.int64))
    expected_total = true_rows if vmask is None else vmask[:true_rows].sum(0)
    _equal(t.sum(1), np.broadcast_to(expected_total, (N,)))


@pytest.mark.parametrize("q", [0.0, 0.1, 0.25, 0.5, 0.75, 1.0])
def test_quantile_from_histogram_matches_jax(x, q):
    mins, maxs = x.min(0), x.max(0)
    hist = np.asarray(JS.histogram_stats(jnp.asarray(x), jnp.asarray(ROWS), jnp.asarray(mins),
                                         jnp.asarray(maxs), bins=128))
    t = TS.quantile_from_histogram(_t(hist), _t(mins), _t(maxs), q)
    j = JS.quantile_from_histogram(jnp.asarray(hist), jnp.asarray(mins), jnp.asarray(maxs), q)
    _close(t, j)
    assert _np(t)[1] == 3.0  # the constant feature: its value


# -- ops: transforms -------------------------------------------------------------------


@pytest.mark.parametrize("with_mean,with_std", [(False, True), (True, False), (True, True)])
def test_standardize_matches_jax(x, with_mean, with_std):
    mean, std = x.mean(0), x.std(0, ddof=1)
    t = TS.standardize(_t(x), _t(mean), _t(std), with_mean=with_mean, with_std=with_std)
    j = JS.standardize(jnp.asarray(x), jnp.asarray(mean), jnp.asarray(std),
                       with_mean=with_mean, with_std=with_std)
    _close(t, j)


@pytest.mark.parametrize("p", [1.0, 2.0, 3.0, float("inf")])
def test_normalize_matches_jax(x, p):
    xz = x.copy()
    xz[3] = 0.0  # a zero row stays zero
    t = TS.normalize(_t(xz), p)
    _close(t, JS.normalize(jnp.asarray(xz), p))
    assert not _np(t)[3].any()


@pytest.mark.parametrize("op", ["minmax", "maxabs", "robust", "binarize", "impute"])
def test_elementwise_ops_match_jax(x, op):
    lo, hi, med, rng_ = x.min(0), x.max(0), np.median(x, 0), x.max(0) - x.min(0)
    if op == "minmax":
        t = TS.minmax_scale(_t(x), _t(lo), _t(hi), -1.0, 2.0)
        j = JS.minmax_scale(jnp.asarray(x), jnp.asarray(lo), jnp.asarray(hi), -1.0, 2.0)
    elif op == "maxabs":
        m = np.abs(x).max(0)
        t, j = TS.maxabs_scale(_t(x), _t(m)), JS.maxabs_scale(jnp.asarray(x), jnp.asarray(m))
    elif op == "robust":
        t = TS.robust_scale(_t(x), _t(med), _t(rng_), with_centering=True, with_scaling=True)
        j = JS.robust_scale(jnp.asarray(x), jnp.asarray(med), jnp.asarray(rng_),
                            with_centering=True, with_scaling=True)
    elif op == "binarize":
        t = TS.binarize(_t(x), threshold=0.5)
        _equal(t, JS.binarize(jnp.asarray(x), threshold=0.5))
        return
    else:
        xm = x.copy()
        xm[::7, 2] = np.nan
        fill = np.arange(N, dtype=np.float32)
        t = TS.impute(_t(xm), _t(fill), float("nan"))
        _equal(t, JS.impute(jnp.asarray(xm), jnp.asarray(fill), float("nan")))
        return
    _close(t, j)


@pytest.mark.parametrize("missing", [float("nan"), -1.0])
def test_nan_stats_match_jax(x, missing):
    xm = x.copy()
    xm[::5, 0] = missing
    xm[:, 4] = missing  # an all-missing feature
    for tf, jf in ((TS.nan_moment_stats, JS.nan_moment_stats),
                   (TS.nan_range_stats, JS.nan_range_stats)):
        t, j = tf(_t(xm), 290, missing), jf(jnp.asarray(xm), jnp.asarray(290), missing)
        for a, b in zip(t, j):
            _close(a, b)


@pytest.mark.parametrize("per_feature", [False, True])
def test_bucketize_matches_jax_on_split_points(x, per_feature):
    """Values exactly on split points go to the bucket they open (the top
    edge closes the last bucket); ids are equal."""
    if per_feature:
        splits = np.sort(np.random.default_rng(3).normal(size=(N, 5)) * 2, axis=1)
        splits = np.concatenate([np.full((N, 1), -np.inf), splits, np.full((N, 1), np.inf)], 1)
    else:
        splits = np.broadcast_to(np.array([-np.inf, -2.0, 0.0, 1.0, 3.0, np.inf]), (N, 6))
    xs = x.copy()
    xs[:4, 6] = [-2.0, 0.0, 1.0, 3.0]  # on the split points
    t = TS.bucketize(_t(xs), _t(np.ascontiguousarray(splits)))
    j = JS.bucketize(jnp.asarray(xs), jnp.asarray(splits))
    _equal(t, j)
    assert _np(t).dtype == np.float32


@pytest.mark.parametrize("n", [1, 5, 16])
def test_dct_basis_and_transform_match_jax(n, x):
    basis = TS.dct2_matrix(n)
    np.testing.assert_allclose(_np(basis), np.asarray(JS.dct2_matrix(n)), rtol=0, atol=1e-14)
    rows = np.resize(x, (40, n)).astype(np.float32)
    for inverse in (False, True):
        t = TS.dct2(_t(rows), basis.float(), inverse=inverse)
        j = JS.dct2(jnp.asarray(rows), JS.dct2_matrix(n).astype(jnp.float32), inverse=inverse)
        _close(t, j)


# -- models --------------------------------------------------------------------------------


@pytest.fixture
def streamed(monkeypatch):
    """Every fit of both packages streams, in chunks of 64 rows bucketed
    to ``TPU_ML_MIN_BUCKET`` (128)."""
    monkeypatch.setenv("TPU_ML_STREAM_FIT_MAX_RESIDENT_BYTES", "1")
    monkeypatch.setenv("TPU_ML_STREAM_CHUNK_ROWS", "64")
    monkeypatch.setenv("TPU_ML_AUTOTUNE", "off")
    old = jax_config().stream_fit_max_resident_bytes
    set_jax_config(stream_fit_max_resident_bytes=1)
    yield
    set_jax_config(stream_fit_max_resident_bytes=old)


def _scaled(model, x):
    return np.asarray(model.transform(x))


@pytest.mark.parametrize("with_mean,with_std", [(False, True), (True, True), (True, False)])
@pytest.mark.parametrize("partitions", [1, 3])
def test_standard_scaler_matches_jax(x, with_mean, with_std, partitions):
    ref = JM.StandardScaler(withMean=with_mean, withStd=with_std).fit(x, num_partitions=partitions)
    port = TM.StandardScaler(device="cpu", withMean=with_mean, withStd=with_std).fit(
        x, num_partitions=partitions)
    _close(port.mean, ref.mean)
    _close(port.std, ref.std, rtol=_std_rtol(x))
    assert port.std[1] == 0.0 and port.stream_report is None
    _close(_scaled(port, x), _scaled(ref, x), rtol=_std_rtol(x) if with_std else RTOL)


def test_streamed_standard_scaler_matches_jax(x, streamed):
    ref = JM.StandardScaler().fit(x, num_partitions=3)
    port = TM.StandardScaler(device="cpu").fit(x, num_partitions=3)
    assert port.stream_report is not None and port.stream_report.rows == ROWS
    assert port.stream_report.chunks == math.ceil(ROWS / ingest.stream_chunk_rows())
    _close(port.mean, ref.mean)
    _close(port.std, ref.std, rtol=_std_rtol(x))
    _close(port.std, x.astype(np.float64).std(0, ddof=1), rtol=_std_rtol(x))


@pytest.mark.parametrize("name", ["minmax", "maxabs", "robust"])
def test_range_scalers_match_jax(x, name):
    if name == "minmax":
        ref = JM.MinMaxScaler(min=-1.0, max=2.0).fit(x, num_partitions=2)
        port = TM.MinMaxScaler(device="cpu", min=-1.0, max=2.0).fit(x, num_partitions=2)
        _equal(port.originalMin, ref.originalMin)
        _equal(port.originalMax, ref.originalMax)
    elif name == "maxabs":
        ref = JM.MaxAbsScaler().fit(x, num_partitions=2)
        port = TM.MaxAbsScaler(device="cpu").fit(x, num_partitions=2)
        _equal(port.maxAbs, ref.maxAbs)
    else:
        ref = JM.RobustScaler(withCentering=True, numBins=512).fit(x, num_partitions=2)
        port = TM.RobustScaler(device="cpu", withCentering=True, numBins=512).fit(
            x, num_partitions=2)
        _close(port.median, ref.median)
        _close(port.range, ref.range)
    _close(_scaled(port, x), _scaled(ref, x))


@pytest.mark.parametrize("strategy", ["mean", "median"])
def test_imputer_matches_jax(x, strategy):
    xm = x.copy()
    xm[::4, 0] = np.nan
    xm[:, 5] = np.nan  # no valid entry: surrogate 0.0 and a warning
    with pytest.warns(UserWarning, match=r"feature\(s\) \[5\]"):
        ref = JM.Imputer(strategy=strategy, numBins=256).fit(xm, num_partitions=2)
    with pytest.warns(UserWarning, match=r"feature\(s\) \[5\]"):
        port = TM.Imputer(device="cpu", strategy=strategy, numBins=256).fit(
            xm, num_partitions=2)
    _close(port.surrogate, ref.surrogate)
    out = _scaled(port, xm)
    assert not np.isnan(out).any()
    _close(out, _scaled(ref, xm))


@pytest.mark.parametrize(
    "make",
    [
        lambda m, **kw: m.Normalizer(p=1.0, **kw),
        lambda m, **kw: m.Normalizer(**kw),
        lambda m, **kw: m.Binarizer(threshold=0.25, **kw),
        lambda m, **kw: m.ElementwiseProduct(scalingVec=np.arange(N) - 2.5, **kw),
        lambda m, **kw: m.VectorSlicer(indices=[6, 0, 3], **kw),
        lambda m, **kw: m.DCT(**kw),
        lambda m, **kw: m.DCT(inverse=True, **kw),
        lambda m, **kw: m.PolynomialExpansion(degree=3, **kw),
    ],
    ids=["normalizer_p1", "normalizer_p2", "binarizer", "elementwise", "slicer", "dct",
         "idct", "poly3"],
)
def test_stateless_transformers_match_jax(x, make):
    port, ref = make(TM, device="cpu"), make(JM)
    got, expected = _scaled(port, x), _scaled(ref, x)
    if type(port).__name__ in ("Binarizer", "ElementwiseProduct", "VectorSlicer",
                               "PolynomialExpansion"):
        _equal(got, expected)
    else:
        _close(got, expected)


def test_polynomial_expansion_order_is_sparks():
    out = TM.PolynomialExpansion(device="cpu").transform(np.array([[2.0, 3.0]]))
    _equal(out, np.array([[2.0, 4.0, 3.0, 6.0, 9.0]]))
    assert TM._poly_plan(4, 3)[0].tolist() == JM._poly_plan(4, 3)[0].tolist()


def test_scalers_keep_the_container(x):
    df = pd.DataFrame({"features": list(x)})
    port = TM.StandardScaler(device="cpu").setInputCol("features").setOutputCol("s").fit(df)
    ref = JM.StandardScaler().setInputCol("features").setOutputCol("s").fit(df)
    _close(np.stack(port.transform(df)["s"]), np.stack(ref.transform(df)["s"]),
           rtol=_std_rtol(x))


def test_params_and_messages_match_jax():
    for name in ("StandardScaler", "MinMaxScaler", "MaxAbsScaler", "RobustScaler", "Imputer",
                 "Normalizer", "Binarizer", "DCT", "PolynomialExpansion"):
        port, ref = getattr(TM, name)(device="cpu"), getattr(JM, name)()
        assert {p.name for p in type(port).params()} == {p.name for p in type(ref).params()}
        assert {k: v for k, v in port._defaultParamMap.items() if v == v} == {
            k: v for k, v in ref._defaultParamMap.items() if v == v}
    for bad in (lambda m: m.MinMaxScaler(min=1.0, max=0.0).fit(np.ones((4, 2))),
                lambda m: m.RobustScaler(lower=0.8, upper=0.2).fit(np.ones((4, 2))),
                lambda m: m.Imputer().setStrategy("mode")):
        with pytest.raises(ValueError) as port_err:
            bad(_cpu(TM))
        with pytest.raises(ValueError) as jax_err:
            bad(JM)
        assert str(port_err.value) == str(jax_err.value)


def _cpu(module):
    """``module`` with every class made on the CPU."""

    class _On:
        def __getattr__(self, name):
            cls = getattr(module, name)
            return lambda *a, **kw: cls(*a, device="cpu", **kw)

    return _On()


# -- persistence and carrying models across ------------------------------------------------


def _fitted(x):
    return {
        "StandardScalerModel": (JM.StandardScaler(withMean=True).fit(x),
                                TM.StandardScaler(device="cpu", withMean=True).fit(x)),
        "MinMaxScalerModel": (JM.MinMaxScaler().fit(x), TM.MinMaxScaler(device="cpu").fit(x)),
        "MaxAbsScalerModel": (JM.MaxAbsScaler().fit(x), TM.MaxAbsScaler(device="cpu").fit(x)),
        "RobustScalerModel": (JM.RobustScaler(numBins=256).fit(x),
                              TM.RobustScaler(device="cpu", numBins=256).fit(x)),
        "ImputerModel": (JM.Imputer().fit(x), TM.Imputer(device="cpu").fit(x)),
    }


SPARK_LAYOUT = ("StandardScalerModel", "MinMaxScalerModel", "MaxAbsScalerModel",
                "RobustScalerModel")


@pytest.mark.parametrize("name", ["StandardScalerModel", "MinMaxScalerModel",
                                  "MaxAbsScalerModel", "RobustScalerModel", "ImputerModel"])
@pytest.mark.parametrize("layout", ["native", "spark"])
def test_jax_saves_load_in_the_port(x, tmp_path, name, layout):
    ref, _ = _fitted(x)[name]
    if layout == "spark" and name not in SPARK_LAYOUT:
        with pytest.raises(NotImplementedError, match="native layout"):
            _fitted(x)[name][1].save(str(tmp_path / "p"), layout="spark")
        return
    ref.save(str(tmp_path / "m"), layout=layout)
    loaded = Saveable.load(str(tmp_path / "m"), device="cpu")
    assert type(loaded).__name__ == name and loaded.uid == ref.uid
    for key, arr in ref._saveData().items():
        _equal(loaded._saveData()[key], arr)
    _close(_scaled(loaded, x), _scaled(ref, x))


@pytest.mark.parametrize("name", list(SPARK_LAYOUT))
def test_port_saves_cross_to_jax(x, tmp_path, name):
    _, port = _fitted(x)[name]
    port.save(str(tmp_path / "spark"), layout="spark")
    loaded = getattr(JM, name).load(str(tmp_path / "spark"))
    for key, arr in port._saveData().items():
        _equal(loaded._saveData()[key], arr)
    port.save(str(tmp_path / "native"))
    # the JAX class does not load the port's native save, by design: the
    # save records the port's class, which the JAX load policy refuses
    with pytest.raises(TypeError, match=f"not a {name}"):
        getattr(JM, name).load(str(tmp_path / "native"))
    arrays = jax_persistence.load_arrays(str(tmp_path / "native"))
    for key, arr in port._saveData().items():
        _equal(arrays[key], arr)
    again = Saveable.load(str(tmp_path / "native"), device="cpu")
    assert type(again) is type(port) and again.uid == port.uid
    _equal(_scaled(again, x), _scaled(port, x))


@pytest.mark.parametrize("name", ["StandardScalerModel", "MinMaxScalerModel",
                                  "MaxAbsScalerModel", "RobustScalerModel", "ImputerModel"])
def test_models_carry_across_from_arrays(x, name):
    ref, _ = _fitted(x)[name]
    port = convert.model_from_arrays(name, ref._saveData(), device="cpu",
                                     params=dict(ref._paramMap))
    assert type(port).__name__ == name
    _close(_scaled(port, x), _scaled(ref, x))


def test_stateless_stage_carries_across_with_its_params(x):
    ref = JM.Normalizer(p=3.0)
    port = convert.model_from_arrays("Normalizer", {}, device="cpu", params=dict(ref._paramMap))
    assert port.getP() == 3.0
    _close(_scaled(port, x), _scaled(ref, x))
    with pytest.raises(KeyError, match="no 'MeshKMeansFitFn'"):
        convert.model_from_arrays("MeshKMeansFitFn", {}, device="cpu")
