"""The mesh distributions of the Spark linear family, KMeans and the forests
on the port's local Spark engine, against the JAX package's Spark fits.

``"mesh-local"`` streams the DataFrame onto the driver's mesh (four CPU
shards: ``estimators._driver_mesh`` is patched) and ``"mesh-barrier"`` runs
one barrier stage of CPU workers (one such stage in this file: the softmax
fit with its checkpoint contract). The references are the JAX package's
Spark fits under ``"mesh-local"`` (its mesh of the suite's 8 virtual
devices) on one JAX local session over the same f32 rows (float64 columns,
3 partitions). Bounds: linear coefficients within 2e-5 of the largest,
Newton parameters 1e-5 (``regParam`` 0.1, converged: LinearSVC after 20
iterations), multinomial fits by their probabilities (atol 1e-5), KMeans
centres within 1e-5 after sorting; forest trees at unit weight and
integer labels equal to the port's driver-merge build and to JAX's. Streamed or chunked fits killed mid-way and resumed
from ``checkpoint_dir`` are bit-equal to the uninterrupted fit.
"""

import jax  # noqa: F401  (imported at the top of every port test file)
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu import spark as JSP
from spark_rapids_ml_tpu.localspark import LocalSparkSession as JaxSession
from spark_rapids_ml_tpu.localspark import types as JT
from spark_rapids_ml_tpu_torch import spark as SP
from spark_rapids_ml_tpu_torch.localspark import LocalSparkSession
from spark_rapids_ml_tpu_torch.localspark import types as T
from spark_rapids_ml_tpu_torch.parallel import gram as G
from spark_rapids_ml_tpu_torch.parallel import kmeans as PK
from spark_rapids_ml_tpu_torch.parallel import linear as PL
from spark_rapids_ml_tpu_torch.parallel import mesh as M
from spark_rapids_ml_tpu_torch.resilience import faults
from spark_rapids_ml_tpu_torch.spark import estimators as SE
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY

CPU = torch.device("cpu")
ROWS, N, K = 900, 6, 3
COLUMNS = ("reg", "label", "label3", "weight")
#: the softmax fits' iterations: converged to the f32 statistics' noise
#: floor, where the packages' probabilities agree within 1e-5
SOFTMAX_ITER = 10


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(47)
    means = rng.normal(size=(K, N)) * 3.0
    blob = rng.integers(0, K, ROWS)
    x = (means[blob] + rng.normal(size=(ROWS, N))).astype(np.float32)
    beta = rng.normal(size=N) * 0.3
    reg = x @ beta + 0.5 + 0.1 * rng.normal(size=ROWS)
    label = (x @ beta + rng.normal(size=ROWS) > 0.4).astype(np.float64)
    label3 = np.argmax(x[:, :3] * 0.3 + rng.gumbel(size=(ROWS, 3)), axis=1).astype(np.float64)
    weight = rng.uniform(0.5, 2.0, ROWS)
    # KMeans's column: the same blobs farther apart, so that every seeding
    # ends at the blob means
    blobs = (means[blob] * 4.0 + rng.normal(size=(ROWS, N))).astype(np.float32)
    return x, {"reg": reg, "label": label, "label3": label3, "weight": weight, "blobs": blobs}


def _rows(x, cols):
    return [(r.tolist(), *(float(cols[c][i]) for c in COLUMNS),
             cols["blobs"][i].astype(np.float64).tolist())
            for i, r in enumerate(x.astype(np.float64))]


@pytest.fixture(scope="module")
def df(data):
    schema = T.StructType([T.StructField("features", T.ArrayType(T.DoubleType()))]
                          + [T.StructField(c, T.DoubleType()) for c in COLUMNS]
                          + [T.StructField("blobs", T.ArrayType(T.DoubleType()))])
    with LocalSparkSession(parallelism=2, worker_platform="cpu") as s:
        yield s.createDataFrame(_rows(*data), schema, numPartitions=3)


@pytest.fixture(scope="module")
def jax_df(data):
    schema = JT.StructType([JT.StructField("features", JT.ArrayType(JT.DoubleType()))]
                           + [JT.StructField(c, JT.DoubleType()) for c in COLUMNS]
                           + [JT.StructField("blobs", JT.ArrayType(JT.DoubleType()))])
    with JaxSession(parallelism=2) as s:
        yield s.createDataFrame(_rows(*data), schema, numPartitions=3)


@pytest.fixture(autouse=True)
def four_shards(monkeypatch):
    monkeypatch.setattr(SE, "_driver_mesh", lambda device: M.create_mesh(devices=[device] * 4))


@pytest.fixture
def streamed(monkeypatch):
    from spark_rapids_ml_tpu.utils.config import get_config as jax_config
    from spark_rapids_ml_tpu.utils.config import set_config as set_jax_config

    old = jax_config().stream_fit_max_resident_bytes
    set_jax_config(stream_fit_max_resident_bytes=1)
    monkeypatch.setenv("TPU_ML_STREAM_FIT_MAX_RESIDENT_BYTES", "1")
    monkeypatch.setenv("TPU_ML_STREAM_CHUNK_ROWS", "128")
    yield
    set_jax_config(stream_fit_max_resident_bytes=old)


def _close(got, ref, tol=1e-5):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-30))


def _coef_close(got, ref, tol):
    scale = np.abs(ref.coefficients).max()
    np.testing.assert_allclose(got.coefficients, ref.coefficients, rtol=0, atol=tol * scale)
    np.testing.assert_allclose(got.intercept, ref.intercept, rtol=0, atol=tol * scale)


class _Killed(RuntimeError):
    error_class = "FATAL"


def _dies_at(module, name: str, call: int, monkeypatch):
    """``module.name`` raising ``_Killed`` at its ``call``-th call."""
    real = getattr(module, name)
    calls = {"n": 0}

    def dies(*a, **kw):
        calls["n"] += 1
        if calls["n"] == call:
            raise _Killed(f"killed at call {call}")
        return real(*a, **kw)

    monkeypatch.setattr(module, name, dies)
    return real


def test_linreg_mesh_local_streamed_and_resumed(df, jax_df, streamed, tmp_path, monkeypatch):
    """The per-shard chunk fold into an f64 carry, against the JAX streamed
    mesh-local fit; killed after its 3rd chunk fold, resumed to the
    uninterrupted fit's bits."""
    def est():
        return SP.SparkLinearRegression(device=CPU).setLabelCol("reg").setWeightCol(
            "weight").setRegParam(0.1).setDistribution("mesh-local")

    s0 = REGISTRY.snapshot()
    model = est().fit(df)
    assert REGISTRY.snapshot().delta(s0).counter("collective.count", kind="allreduce") == 6
    ref = JSP.SparkLinearRegression().setLabelCol("reg").setWeightCol("weight").setRegParam(
        0.1).setDistribution("mesh-local").fit(jax_df)
    _coef_close(model, ref, 2e-5)
    real = _dies_at(G, "sharded_linear_fold", 4, monkeypatch)
    with pytest.raises(_Killed):
        est().fit(df, checkpoint_dir=str(tmp_path), checkpoint_every=2)
    monkeypatch.setattr(G, "sharded_linear_fold", real)
    s0 = REGISTRY.snapshot()
    resumed = est().fit(df, checkpoint_dir=str(tmp_path), checkpoint_every=2)
    assert REGISTRY.snapshot().delta(s0).counter("stream.resumes") == 1
    np.testing.assert_array_equal(resumed.coefficients, model.coefficients)
    assert resumed.intercept == model.intercept


def test_linreg_streamed_mesh_failure_degrades_to_the_one_device_fold(df, streamed, monkeypatch):
    one = SP.SparkLinearRegression(device=CPU).setLabelCol("reg").fit(df)
    monkeypatch.setenv("TPU_ML_FAULT_PLAN", "device.init:io:1")
    faults.reset_faults()
    s0 = REGISTRY.snapshot()
    try:
        model = SP.SparkLinearRegression(device=CPU).setLabelCol("reg").setDistribution(
            "mesh-local").fit(df)
    finally:
        monkeypatch.delenv("TPU_ML_FAULT_PLAN")
        faults.reset_faults()
    assert REGISTRY.snapshot().delta(s0).counter("degraded.cpu_fallback") == 1
    _coef_close(model, one, 2e-5)
    assert SP.SparkLinearRegression(device=CPU).setDistribution("mesh-local")._degradable(df)


def _proba(model, x):
    return model.proba_and_predictions(x)[0]


def test_softmax_and_svc_mesh_local_match_jax(df, jax_df, data):
    x, _ = data
    got = SP.SparkLogisticRegression(device=CPU).setLabelCol("label3").setWeightCol(
        "weight").setRegParam(0.1).setMaxIter(SOFTMAX_ITER).setDistribution("mesh-local").fit(df)
    ref = JSP.SparkLogisticRegression().setLabelCol("label3").setWeightCol("weight") \
        .setRegParam(0.1).setMaxIter(SOFTMAX_ITER).setDistribution("mesh-local").fit(jax_df)
    np.testing.assert_allclose(_proba(got, x), ref.proba_and_predictions(x)[0], rtol=0,
                               atol=1e-5)
    svc = SP.SparkLinearSVC(device=CPU).setWeightCol("weight").setRegParam(0.1).setMaxIter(
        20).setDistribution("mesh-local").fit(df)
    ref = JSP.SparkLinearSVC().setWeightCol("weight").setRegParam(0.1).setMaxIter(20) \
        .setDistribution("mesh-local").fit(jax_df)
    _coef_close(svc, ref, 1e-5)
    assert type(svc) is SP.SparkLinearSVCModel


def test_logreg_mesh_local_chunked_resume_is_bit_equal(df, tmp_path, monkeypatch):
    def est():
        return SP.SparkLogisticRegression(device=CPU).setRegParam(0.1).setMaxIter(6) \
            .setTol(0.0).setDistribution("mesh-local")

    full = est().fit(df, checkpoint_dir=str(tmp_path / "full"), checkpoint_every=2)
    whole = est().fit(df)  # the whole loop: one full-budget chunk
    np.testing.assert_array_equal(full.coefficients, whole.coefficients)
    real = PL.make_distributed_logreg_chunk

    def dying_chunks(*a, **kw):
        chunk = real(*a, **kw)
        calls = {"n": 0}

        def run(*args):
            calls["n"] += 1
            if calls["n"] == 2:
                raise _Killed("killed after the first chunk")
            return chunk(*args)

        return run

    monkeypatch.setattr(PL, "make_distributed_logreg_chunk", dying_chunks)
    with pytest.raises(_Killed):
        est().fit(df, checkpoint_dir=str(tmp_path / "cut"), checkpoint_every=2)
    monkeypatch.setattr(PL, "make_distributed_logreg_chunk", real)
    resumed = est().fit(df, checkpoint_dir=str(tmp_path / "cut"), checkpoint_every=2)
    np.testing.assert_array_equal(resumed.coefficients, full.coefficients)
    assert resumed.intercept == full.intercept


def test_softmax_mesh_barrier_checkpoints_on_rank_0(df, jax_df, data, tmp_path, monkeypatch):
    """One barrier stage runs the chunked softmax loop; rank 0 saves its
    chunks into the shared directory, the answer agrees with the JAX
    mesh-local fit, and a refit resumed at maxIter launches no stage."""
    from spark_rapids_ml_tpu_torch.utils.checkpoint import TrainingCheckpointer

    x, _ = data

    def est():
        return SP.SparkLogisticRegression(device=CPU).setLabelCol("label3").setWeightCol(
            "weight").setRegParam(0.1).setMaxIter(SOFTMAX_ITER).setDistribution("mesh-barrier")

    got = est().fit(df, checkpoint_dir=str(tmp_path), checkpoint_every=2)
    ref = JSP.SparkLogisticRegression().setLabelCol("label3").setWeightCol("weight") \
        .setRegParam(0.1).setMaxIter(SOFTMAX_ITER).setDistribution("mesh-local").fit(jax_df)
    np.testing.assert_allclose(_proba(got, x), ref.proba_and_predictions(x)[0], rtol=0,
                               atol=1e-5)
    assert TrainingCheckpointer(tmp_path).steps()[-1] == SOFTMAX_ITER - 1

    def no_stage(*a, **kw):
        raise AssertionError("a resume at maxIter launched a stage")

    monkeypatch.setattr(SE, "_barrier_single_row", no_stage)
    again = est().fit(df, checkpoint_dir=str(tmp_path), checkpoint_every=2)
    np.testing.assert_array_equal(again.coefficientMatrix, got.coefficientMatrix)


def _sorted(c):
    c = np.asarray(c, np.float64)
    return c[np.lexsort(c.T[::-1])]


def test_kmeans_mesh_local_chunked_resume_is_bit_equal(df, jax_df, tmp_path, monkeypatch):
    def est():
        return SP.SparkKMeans(device=CPU).setInputCol("blobs").setK(K).setSeed(5) \
            .setInitMode("k-means||").setWeightCol("weight").setDistribution("mesh-local") \
            .setTol(0.0).setMaxIter(6)

    full = est().fit(df, checkpoint_dir=str(tmp_path / "full"), checkpoint_every=1)
    ref = JSP.SparkKMeans().setInputCol("blobs").setK(K).setSeed(5).setInitMode("k-means||") \
        .setWeightCol("weight").setDistribution("mesh-local").setTol(0.0).setMaxIter(6) \
        .fit(jax_df)
    _close(_sorted(full.clusterCenters), _sorted(ref.clusterCenters))
    real = PK.make_distributed_kmeans_chunk

    def dying_chunks(*a, **kw):
        chunk = real(*a, **kw)
        calls = {"n": 0}

        def run(*args):
            calls["n"] += 1
            if calls["n"] == 2:
                raise _Killed("killed after the first chunk")
            return chunk(*args)

        return run

    monkeypatch.setattr(PK, "make_distributed_kmeans_chunk", dying_chunks)
    with pytest.raises(_Killed):
        est().fit(df, checkpoint_dir=str(tmp_path / "cut"), checkpoint_every=1)
    monkeypatch.setattr(PK, "make_distributed_kmeans_chunk", real)
    resumed = est().fit(df, checkpoint_dir=str(tmp_path / "cut"), checkpoint_every=1)
    np.testing.assert_array_equal(resumed.clusterCenters, full.clusterCenters)
    assert resumed.trainingCost == full.trainingCost


@pytest.mark.parametrize("name", ["RandomForestClassifier", "RandomForestRegressor"])
def test_forest_mesh_local_builds_the_driver_merge_trees(df, jax_df, name):
    """Unit instance weights (Poisson bootstrap counts) and integer labels:
    the classifier's class counts and the regressor's w, w·y and w·y² are
    integer sums, exact in f32 in any order, so the sharded trees equal the
    driver-merge build and the JAX mesh-local build field for field (every
    feature per node: JAX draws its subsets from ``jax.random``)."""
    label = "label3"
    params = dict(numTrees=3, maxDepth=4, maxBins=16, featureSubsetStrategy="all", seed=2)

    def fit(cls, distribution, frame, **kw):
        return cls(**kw, **params).setLabelCol(label).setDistribution(distribution).fit(frame)

    port = getattr(SP, "Spark" + name)
    mesh = fit(port, "mesh-local", df, device=CPU)
    merged = fit(port, "driver-merge", df, device=CPU)
    assert type(mesh) is type(merged)
    ref = fit(getattr(JSP, "Spark" + name), "mesh-local", jax_df)
    for field in ("feature", "split_bin", "is_leaf", "leaf_stats"):
        np.testing.assert_array_equal(getattr(mesh.trees, field), getattr(merged.trees, field))
        np.testing.assert_array_equal(getattr(mesh.trees, field), getattr(ref.trees, field))
