"""The Spark estimators' mesh distributions on the port's local Spark engine.

``"mesh-local"`` streams the DataFrame onto the driver's mesh (here four
CPU shards: ``estimators._driver_mesh`` is patched, as the JAX package's
tests run its mesh on 8 virtual devices) and ``"mesh-barrier"`` runs one
barrier stage of CPU workers. Every fit is held, on the same f32 rows
(stored as float64 columns, in 3 partitions), to:

- the JAX package's Spark estimator fitting ``"mesh-local"`` on its own
  local engine with the f32 wire dtype (components min |cosine| ≥ 0.9999,
  explained variance rtol 1e-5; the scalers' statistics within 1e-5 of
  their largest entry; ranges exact);
- the JAX core fit of the same rows, where one exists (the same bounds).

Streamed fits drop both packages' resident cutover and use 128-row chunks;
the resumed fit is held bit-equal to the uninterrupted one.
"""

import jax  # noqa: F401  (imported at the top of every port test file)
import numpy as np
import pytest
import torch

import spark_rapids_ml_tpu as J
from spark_rapids_ml_tpu import spark as JSP
from spark_rapids_ml_tpu.localspark import LocalSparkSession as JaxSession
from spark_rapids_ml_tpu.localspark import types as JT
from spark_rapids_ml_tpu.utils.config import get_config as jax_config
from spark_rapids_ml_tpu.utils.config import set_config as set_jax_config
from spark_rapids_ml_tpu_torch import spark as SP
from spark_rapids_ml_tpu_torch.localspark import LocalSparkSession
from spark_rapids_ml_tpu_torch.localspark import types as T
from spark_rapids_ml_tpu_torch.parallel import gram as G
from spark_rapids_ml_tpu_torch.parallel import mesh as M
from spark_rapids_ml_tpu_torch.resilience import faults
from spark_rapids_ml_tpu_torch.spark import estimators as SE
from spark_rapids_ml_tpu_torch.telemetry import health, report
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY

CPU = torch.device("cpu")
ROWS, N, K = 900, 10, 3


@pytest.fixture(scope="module")
def spark():
    with LocalSparkSession(parallelism=2, worker_platform="cpu") as s:
        yield s


@pytest.fixture(scope="module")
def jax_spark():
    with JaxSession(parallelism=2) as s:
        yield s


@pytest.fixture(scope="module")
def x():
    rng = np.random.default_rng(29)
    base = rng.normal(size=(ROWS, N)) * np.linspace(5.0, 0.5, N)
    return (base @ np.linalg.qr(rng.normal(size=(N, N)))[0] + 2.0).astype(np.float32)


def _rows(x):
    return [(r.tolist(),) for r in x.astype(np.float64)]


@pytest.fixture(scope="module")
def df(spark, x):
    schema = T.StructType([T.StructField("features", T.ArrayType(T.DoubleType()))])
    return spark.createDataFrame(_rows(x), schema, numPartitions=3)


@pytest.fixture(scope="module")
def jax_df(jax_spark, x):
    schema = JT.StructType([JT.StructField("features", JT.ArrayType(JT.DoubleType()))])
    return jax_spark.createDataFrame(_rows(x), schema, numPartitions=3)


@pytest.fixture(autouse=True)
def four_shards(monkeypatch):
    monkeypatch.setattr(SE, "_driver_mesh", lambda device: M.create_mesh(devices=[device] * 4))
    monkeypatch.setenv("TPU_ML_MESH_LOCAL_WIRE_DTYPE", "float32")


@pytest.fixture
def streamed(monkeypatch):
    old = jax_config().stream_fit_max_resident_bytes
    set_jax_config(stream_fit_max_resident_bytes=1)
    monkeypatch.setenv("TPU_ML_STREAM_FIT_MAX_RESIDENT_BYTES", "1")
    monkeypatch.setenv("TPU_ML_STREAM_CHUNK_ROWS", "128")
    yield
    set_jax_config(stream_fit_max_resident_bytes=old)


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (np.abs((a * b).sum(0)) / (np.linalg.norm(a, axis=0) * np.linalg.norm(b, axis=0))).min()


def _close_pca(model, ref):
    assert _cos(model.pc, ref.pc) >= 0.9999
    np.testing.assert_allclose(model.explainedVariance, ref.explainedVariance, rtol=1e-5)


def _close(got, ref, tol=1e-5):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-30))


def _port(**params):
    est = SP.SparkPCA(device=CPU).setInputCol("features").setK(K)
    for name, value in params.items():
        getattr(est, "set" + name[0].upper() + name[1:])(value)
    return est


def _jax(**params):
    est = JSP.SparkPCA().setInputCol("features").setK(K)
    for name, value in params.items():
        getattr(est, "set" + name[0].upper() + name[1:])(value)
    return est


@pytest.mark.parametrize("params", [
    dict(meanCentering=True), dict(meanCentering=True, solver="svd"), dict(standardize=True),
    dict(solver="randomized"),
], ids=["full", "svd", "standardize", "randomized"])
def test_pca_mesh_local_resident_matches_jax(df, jax_df, x, params):
    model = _port(distribution="mesh-local", **params).fit(df)
    ref = _jax(distribution="mesh-local", **params).fit(jax_df)
    _close_pca(model, ref)
    core = J.PCA(k=K, **params).fit(x)
    _close_pca(model, core)
    if params.get("standardize"):
        _close(model.mean, ref.mean)
        _close(model.std, ref.std)


def test_pca_mesh_local_on_one_cpu_shard(df, x, monkeypatch):
    """The production mesh of a CPU estimator: one shard."""
    monkeypatch.undo()
    assert SE._driver_mesh(CPU).shape == {"data": 1, "feat": 1}
    _close_pca(_port(distribution="mesh-local", meanCentering=True).fit(df),
               J.PCA(k=K, meanCentering=True).fit(x))


def test_pca_mesh_local_streamed_and_resumed(df, jax_df, x, streamed, tmp_path, monkeypatch):
    """The per-shard chunk fold: against the JAX streamed mesh-local fit and
    the core fit; then a fit killed after its 4th chunk fold resumes from
    its checkpoint to the uninterrupted fit's bits."""
    s0 = REGISTRY.snapshot()
    model = _port(distribution="mesh-local", meanCentering=True).fit(df)
    # the streamed path: one allreduce of the three stacked leaves
    assert REGISTRY.snapshot().delta(s0).counter("collective.count", kind="allreduce") == 3
    ref = _jax(distribution="mesh-local", meanCentering=True).fit(jax_df)
    _close_pca(model, ref)
    _close_pca(model, J.PCA(k=K, meanCentering=True).fit(x))

    real = G.sharded_gram_fold
    calls = {"n": 0}

    class Killed(RuntimeError):
        error_class = "FATAL"

    def dies(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 5:
            raise Killed("killed mid-stream")
        return real(*a, **kw)

    monkeypatch.setattr(G, "sharded_gram_fold", dies)
    with pytest.raises(Killed):
        _port(distribution="mesh-local", meanCentering=True).fit(
            df, checkpoint_dir=str(tmp_path), checkpoint_every=2)
    monkeypatch.setattr(G, "sharded_gram_fold", real)
    s0 = REGISTRY.snapshot()
    resumed = _port(distribution="mesh-local", meanCentering=True).fit(
        df, checkpoint_dir=str(tmp_path), checkpoint_every=2)
    assert REGISTRY.snapshot().delta(s0).counter("stream.resumes") == 1
    np.testing.assert_array_equal(resumed.pc, model.pc)
    np.testing.assert_array_equal(resumed.explainedVariance, model.explainedVariance)


def test_failed_mesh_init_degrades_to_the_one_device_fold(df, streamed, monkeypatch):
    """A non-fatal fault at ``device.init`` streams through the one-device
    fold on the estimator's device, counted as ``degraded.cpu_fallback``;
    under the degrade admission policy ``begin_fit`` admits a mesh-local fit
    on a card instead of refusing it."""
    one_device = _port(meanCentering=True).fit(df)
    monkeypatch.setenv("TPU_ML_FAULT_PLAN", "device.init:io:1")
    faults.reset_faults()
    s0 = REGISTRY.snapshot()
    try:
        model = _port(distribution="mesh-local", meanCentering=True).fit(df)
    finally:
        monkeypatch.delenv("TPU_ML_FAULT_PLAN")
        faults.reset_faults()
    assert REGISTRY.snapshot().delta(s0).counter("degraded.cpu_fallback") == 1
    _close_pca(model, one_device)
    monkeypatch.setattr(health, "admission_check",
                        lambda: {"action": "degrade", "reason": "a component is FAILING"})
    cap = report.begin_fit("SparkPCA", device=torch.device("cuda", 0), degradable=True)
    assert health.admission_degrade_active()
    report.end_fit(cap)
    assert not health.admission_degrade_active()
    with pytest.raises(health.AdmissionRefused, match="cannot be degraded"):
        report.begin_fit("SparkPCA", device=torch.device("cuda", 0))
    est = _port(distribution="mesh-local")
    assert est._degradable(df) and not _port()._degradable(df)
    assert not SP.SparkStandardScaler(device=CPU).setDistribution("mesh-local")._degradable(df)


@pytest.mark.parametrize("params", [
    dict(meanCentering=True), dict(meanCentering=True, solver="svd"), dict(standardize=True),
], ids=["full", "svd", "standardize"])
def test_pca_mesh_barrier_matches_jax(df, jax_df, x, params):
    model = _port(distribution="mesh-barrier", **params).fit(df)
    ref = _jax(distribution="mesh-local", **params).fit(jax_df)
    _close_pca(model, ref)
    _close_pca(model, J.PCA(k=K, **params).fit(x))
    out = model.transform(df).first()["pca_features"]
    assert len(out) == K


@pytest.mark.parametrize("distribution", ["mesh-local", "mesh-barrier"])
def test_standard_scaler_mesh_fits_match_jax(df, jax_df, x, distribution, streamed):
    ref = JSP.SparkStandardScaler().setInputCol("features").setDistribution(
        "mesh-local").fit(jax_df)
    core = J.StandardScaler().setInputCol("features").fit(x)
    model = SP.SparkStandardScaler(device=CPU).setInputCol("features").setDistribution(
        distribution).fit(df)
    for got, want in ((model.mean, ref.mean), (model.std, ref.std), (model.mean, core.mean),
                      (model.std, core.std)):
        _close(got, want)


def test_standard_scaler_mesh_local_resident_matches_jax(df, jax_df):
    ref = JSP.SparkStandardScaler().setInputCol("features").setDistribution(
        "mesh-local").fit(jax_df)
    model = SP.SparkStandardScaler(device=CPU).setInputCol("features").setDistribution(
        "mesh-local").fit(df)
    _close(model.mean, ref.mean)
    _close(model.std, ref.std)


@pytest.mark.parametrize("name,fields", [
    ("MinMaxScaler", ("originalMin", "originalMax")),
    ("MaxAbsScaler", ("maxAbs",)),
    ("RobustScaler", ("median", "range")),
    ("QuantileDiscretizer", ("splits",)),
])
def test_range_and_sketch_family_mesh_local_matches_jax(df, jax_df, name, fields):
    est = getattr(SP, "Spark" + name)(device=CPU).setInputCol("features")
    ref_est = getattr(JSP, "Spark" + name)().setInputCol("features")
    if name == "QuantileDiscretizer":
        est.setNumBuckets(4)
        ref_est.setNumBuckets(4)
    model = est.setDistribution("mesh-local").fit(df)
    ref = ref_est.setDistribution("mesh-local").fit(jax_df)
    for f in fields:
        if name in ("MinMaxScaler", "MaxAbsScaler"):
            np.testing.assert_array_equal(np.asarray(getattr(model, f), np.float32),
                                          np.asarray(getattr(ref, f), np.float32))
        else:
            _close(getattr(model, f), getattr(ref, f))
    dm = getattr(SP, "Spark" + name)(device=CPU).setInputCol("features")
    if name == "QuantileDiscretizer":
        dm.setNumBuckets(4)
    dm = dm.fit(df)
    for f in fields:
        np.testing.assert_array_equal(getattr(model, f), getattr(dm, f))


@pytest.mark.parametrize("distribution,solver", [
    ("mesh-local", "gram"), ("mesh-local", "svd"), ("mesh-barrier", "svd"),
])
def test_truncated_svd_mesh_fits_match_jax(df, jax_df, x, distribution, solver):
    model = SP.SparkTruncatedSVD(device=CPU).setInputCol("features").setK(K).setSolver(
        solver).setDistribution(distribution).fit(df)
    ref = JSP.SparkTruncatedSVD().setInputCol("features").setK(K).setSolver(solver).setDistribution(
        "mesh-local").fit(jax_df)
    core = J.TruncatedSVD().setInputCol("features").setK(K).setSolver(solver).fit(x)
    for want in (ref, core):
        assert _cos(model.components, want.components) >= 0.9999
        np.testing.assert_allclose(model.singularValues, want.singularValues, rtol=1e-5)
