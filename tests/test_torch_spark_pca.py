"""The port's ``SparkPCA`` on the port's local Spark engine, against the JAX
package's PCA.

BASELINE config 1 (PCA k=3 on a 10,000 x 64 ArrayType DataFrame, one
partition) fits and transforms through the DataFrame path and is held to
the JAX core ``PCA`` on the same rows by the reference's sign-invariant
abs tol 1e-5 (PCASuite.scala:80-87, ``tests/test_spark_integration.py``).
The rows are f32 values (stored as the column's float64) with a separated
spectrum, made with numpy from a seed. The solvers, meanCentering and
standardize run on driver-merge against the same fits; solver
"randomized" draws its sketch Ω from torch, which cannot draw
``jax.random``'s, so it is held to the port's core fit at 1e-5 and to the
JAX fit by min |cosine| >= 0.9999. Then: validation before any job, the
transform's appended column, save/load both ways, the stats batch across
packages, the lazy transform's report and the refused mesh distributions.
One module-scoped session of CPU workers serves the file.
"""

import jax  # noqa: F401  (imported at the top of every port test file)
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_ml_tpu import PCA as JaxPCA
from spark_rapids_ml_tpu.spark import arrow_fns as jax_arrow_fns
from spark_rapids_ml_tpu.spark.estimators import SparkPCA as JaxSparkPCA
from spark_rapids_ml_tpu.spark.estimators import SparkPCAModel as JaxSparkPCAModel
from spark_rapids_ml_tpu.utils import persistence as jax_persistence
from spark_rapids_ml_tpu_torch import PCA, SparkPCA, SparkPCAModel
from spark_rapids_ml_tpu_torch.localspark import LocalSparkSession
from spark_rapids_ml_tpu_torch.localspark import types as T
from spark_rapids_ml_tpu_torch.models.base import Saveable
from spark_rapids_ml_tpu_torch.spark import arrow_fns
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY

CPU = torch.device("cpu")
ROWS, N, K = 10_000, 64, 3
ATOL = 1e-5  # the reference's sign-invariant tolerance
COSINE_BAR = 0.9999


@pytest.fixture(scope="module")
def spark():
    with LocalSparkSession(parallelism=4, worker_platform="cpu") as s:
        yield s


@pytest.fixture(scope="module")
def x():
    """10,000 x 64 f32 rows whose top three eigenvalues stand apart."""
    rng = np.random.default_rng(1)
    scales = np.concatenate([[6.0, 4.0, 2.5], np.linspace(1.0, 0.3, N - 3)])
    q, _ = np.linalg.qr(rng.normal(size=(N, N)))
    return ((rng.normal(size=(ROWS, N)) * scales) @ q.T).astype(np.float32)


def _df(spark, x, partitions):
    schema = T.StructType([T.StructField("features", T.ArrayType(T.DoubleType()))])
    return spark.createDataFrame([(r.tolist(),) for r in x.astype(np.float64)], schema,
                                 numPartitions=partitions)


@pytest.fixture(scope="module")
def config1(spark, x):
    return _df(spark, x, 1)


@pytest.fixture(scope="module")
def df4(spark, x):
    return _df(spark, x[:2000], 4)


def _est(**params):
    est = SparkPCA(device=CPU).setInputCol("features").setOutputCol("pca").setK(K)
    for name, value in params.items():
        getattr(est, "set" + name[0].upper() + name[1:])(value)
    return est


def _jax(x, **params):
    est = JaxPCA().setInputCol("features").setOutputCol("pca").setK(K)
    for name, value in params.items():
        getattr(est, "set" + name[0].upper() + name[1:])(value)
    return est.fit(x)


def _close(port, ref, atol=ATOL):
    np.testing.assert_allclose(np.abs(port.pc), np.abs(ref.pc), rtol=0, atol=atol)
    np.testing.assert_allclose(port.explainedVariance, ref.explainedVariance, rtol=0, atol=atol)


def test_baseline_config1_fits_and_transforms_like_jax(config1, x):
    model = _est().fit(config1)
    ref = _jax(x)
    assert isinstance(model, SparkPCAModel) and model.pc.shape == (N, K)
    _close(model, ref)
    rows = model.transform(config1).collect()
    got = np.asarray([r["pca"] for r in rows])
    want = np.asarray(ref.transform_rows(x))
    assert got.shape == (ROWS, K) and np.isfinite(got).all()
    np.testing.assert_allclose(np.abs(got), np.abs(want), rtol=0, atol=ATOL)
    # one partition, one batch: one Gram booked in the worker, merged here
    gram = model.fit_report.cost_model["kernels"]["linalg.gram_stats"]
    assert gram["calls"] == 1 and gram["flops"] == 2.0 * 16_384 * N * N + 2.0 * 16_384 * N


@pytest.mark.parametrize("solver", ["full", "svd", "auto"])
@pytest.mark.parametrize("mean_centering", [False, True])
def test_solvers_on_driver_merge_match_jax(df4, x, solver, mean_centering):
    model = _est(solver=solver, meanCentering=mean_centering).fit(df4)
    _close(model, _jax(x[:2000], solver=solver, meanCentering=mean_centering))


@pytest.mark.parametrize("mean_centering", [False, True])
def test_randomized_solver_on_driver_merge(df4, x, mean_centering):
    model = _est(solver="randomized", meanCentering=mean_centering).fit(df4)
    core = PCA(device=CPU).setK(K).setSolver("randomized").setMeanCentering(
        mean_centering).fit(x[:2000], num_partitions=4)
    _close(model, core)
    ref = _jax(x[:2000], solver="randomized", meanCentering=mean_centering)
    cos = np.abs((model.pc * ref.pc).sum(0)) / (
        np.linalg.norm(model.pc, axis=0) * np.linalg.norm(ref.pc, axis=0))
    assert cos.min() >= COSINE_BAR


def test_standardize_on_driver_merge_matches_jax(df4, x):
    model = _est(standardize=True).fit(df4)
    ref = _jax(x[:2000], standardize=True)
    _close(model, ref)
    np.testing.assert_allclose(model.mean, ref.mean, rtol=1e-5)
    np.testing.assert_allclose(model.std, ref.std, rtol=1e-5)
    with pytest.raises(ValueError, match="requires a covariance solver"):
        _est(standardize=True, solver="svd").fit(df4)


def test_bad_inputs_fail_before_any_job(spark):
    s0 = REGISTRY.snapshot()
    small = _df(spark, np.ones((12, 3), np.float32), 2)
    with pytest.raises(ValueError, match="k=5 must be <="):
        _est().setK(5).fit(small)
    schema = T.StructType([T.StructField("features", T.ArrayType(T.DoubleType()))])
    nulls = spark.createDataFrame([(None,), ([1.0, 2.0],)], schema, numPartitions=1)
    with pytest.raises(ValueError, match="null feature"):
        _est().setK(1).fit(nulls)
    # the mesh distributions run now (tests/test_torch_spark_mesh.py); their
    # bad inputs fail before any job too
    for distribution in ("mesh-local", "mesh-barrier"):
        with pytest.raises(ValueError, match="k=5 must be <="):
            _est(distribution=distribution).setK(5).fit(small)
        with pytest.raises(NotImplementedError, match="checkpoint_dir"):
            _est(distribution=distribution).setSolver("svd").fit(small, checkpoint_dir="/x")
    with pytest.raises(NotImplementedError, match="checkpoint_dir"):
        _est(distribution="mesh-barrier").fit(small, checkpoint_dir="/nonexistent")
    with pytest.raises(ValueError, match="distribution must be one of"):
        _est(distribution="nowhere")
    with pytest.raises(NotImplementedError, match="checkpoint_dir"):
        _est().fit(small, checkpoint_dir="/nonexistent")
    assert REGISTRY.snapshot().delta(s0).counter("scheduler.tasks") == 0


def test_transform_appends_its_column_and_keeps_the_input(df4):
    model = _est().setK(2).fit(df4)
    out = model.transform(df4)
    assert [f.name for f in out.schema.fields] == ["features", "pca"]
    row = out.first()
    assert len(row["features"]) == N and len(row["pca"]) == 2


def test_non_spark_input_falls_through_to_the_core_fit(x):
    model = _est().fit(x[:2000], num_partitions=2)
    core = PCA(device=CPU).setK(K).fit(x[:2000], num_partitions=2)
    assert isinstance(model, SparkPCAModel)
    np.testing.assert_array_equal(model.pc, core.pc)
    out = model.transform(x[:10])
    np.testing.assert_array_equal(out, core.transform(x[:10]))


def test_model_saves_and_loads_both_ways(df4, x, tmp_path):
    ref = JaxSparkPCA().setInputCol("features").setK(K).fit(x[:2000])
    assert isinstance(ref, JaxSparkPCAModel)
    ref.save(str(tmp_path / "jax"))
    for loader in (SparkPCAModel.load, Saveable.load):
        loaded = loader(str(tmp_path / "jax"), device=CPU)
        assert type(loaded) is SparkPCAModel and loaded.uid == ref.uid
        np.testing.assert_array_equal(loaded.pc, ref.pc)
        assert loaded.getInputCol() == "features"
    port = _est().fit(df4)
    port.save(str(tmp_path / "port"))
    again = SparkPCAModel.load(str(tmp_path / "port"), device=CPU)
    np.testing.assert_array_equal(again.pc, port.pc)
    got = np.asarray([r["pca"] for r in again.transform(df4).collect()])
    want = np.asarray([r["pca"] for r in port.transform(df4).collect()])
    np.testing.assert_array_equal(got, want)
    arrays = jax_persistence.load_arrays(str(tmp_path / "port"))
    np.testing.assert_array_equal(arrays["pc"], port.pc)
    port.save(str(tmp_path / "spark"), layout="spark")
    in_jax = JaxSparkPCAModel.load(str(tmp_path / "spark"))
    assert isinstance(in_jax, JaxSparkPCAModel)
    np.testing.assert_array_equal(in_jax.pc, port.pc)


def test_stats_batch_crosses_packages(x):
    batch = pa.RecordBatch.from_arrays(
        [pa.FixedSizeListArray.from_arrays(pa.array(x[:500].reshape(-1)), N)], names=["features"])
    port_batches = list(arrow_fns.FitPartitionFn("features", device="cpu")(iter([batch])))
    jax_batches = list(jax_arrow_fns.FitPartitionFn("features")(iter([batch])))
    assert port_batches[0].schema == jax_batches[0].schema
    for decoded in (jax_arrow_fns.stats_from_batches(port_batches),
                    arrow_fns.stats_from_batches(jax_batches)):
        want = x[:500].astype(np.float64)
        np.testing.assert_allclose(decoded.xtx, want.T @ want, rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(decoded.col_sum, want.sum(0), rtol=1e-5, atol=1e-4)
        assert float(decoded.count) == 500
    both = arrow_fns.stats_from_batches(port_batches + jax_batches)
    assert float(both.count) == 1000


def test_partition_stats_reads_a_frame_without_arrow(x):
    """The array body the card runs: one Gram per batch, any container
    ``extract_matrix`` reads."""
    fn = arrow_fns.FitPartitionFn("features", precision="high", device="cpu")
    stats = fn.partition_stats([x[:300], x[300:300], x[300:700]])
    want = x[:700].astype(np.float64)
    np.testing.assert_allclose(stats.xtx.double().numpy(), want.T @ want, rtol=1e-4, atol=1e-2)
    assert float(stats.count) == 700
    assert fn.partition_stats([]) is None


def test_lazy_transform_report_closes_at_materialization(df4):
    model = _est().fit(df4)
    model.transform_report = None
    out = model.transform(df4)
    assert model.transform_report is None  # the plan has not run
    rows = out.collect()
    report = model.transform_report
    assert report is not None and report.rows == len(rows) == 2000
    assert sorted(report.partitions) == ["0", "1", "2", "3"]
    assert sum(p["rows"] for p in report.partitions.values()) == 2000
    assert report.partition_latency["count"] == 4
    project = report.cost_model["kernels"]["linalg.project"]
    assert project["calls"] == 4 and project["flops"] == 2.0 * 512 * N * K


def test_row_codecs_equal_the_batch_codecs(x):
    """The ``collect()`` decoders (pyspark < 4.0) read what the batch
    decoders read, and ``stats_to_batch`` is the fit body's layout."""
    frames = [pa.RecordBatch.from_arrays(
        [pa.FixedSizeListArray.from_arrays(pa.array(part.reshape(-1)), N)], names=["features"])
        for part in (x[:300], x[300:800])]
    stats_batches = [b for f in frames
                     for b in arrow_fns.FitPartitionFn("features", device="cpu")(iter([f]))]
    rows = [{name: b.column(name)[0].as_py() for name in b.schema.names} for b in stats_batches]
    by_rows, by_batches = arrow_fns.stats_from_rows(rows), arrow_fns.stats_from_batches(stats_batches)
    for a, b in zip(by_rows, by_batches):
        np.testing.assert_array_equal(a, b)
    again = arrow_fns.stats_to_batch(by_batches)
    assert again.schema == stats_batches[0].schema
    np.testing.assert_array_equal(jax_arrow_fns.stats_from_batches([again]).xtx, by_batches.xtx)
    r_batches = [b for f in frames
                 for b in arrow_fns.QRPartitionFn("features", device="cpu")(iter([f]))]
    r_rows = [{"r": b.column("r")[0].as_py()} for b in r_batches]
    r = arrow_fns.r_from_batches(r_batches, N, device="cpu")
    torch.testing.assert_close(arrow_fns.r_from_rows(r_rows, N, device="cpu"), r, rtol=0, atol=0)
    want = x[:800].astype(np.float64)
    rtr = (r.T @ r).double().numpy()
    np.testing.assert_allclose(rtr, want.T @ want, rtol=1e-4, atol=1e-2 * np.abs(want).max())
