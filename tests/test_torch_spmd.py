"""The barrier stage (``spark/spmd.py``) on the port's local Spark engine.

Each stage's tasks are fresh CPU worker processes that join one gloo
process group through rank 0's store and run the shard program on the
[N, 1] process mesh; rank 0 alone yields the one reduced row. The JAX
package's barrier path cannot run on its CPU backend ("Multiprocess
computations aren't implemented on the CPU backend"), so each row is held
to the JAX in-process mesh program over the same rows on the suite's 8
virtual devices (the same program, ``spark/spmd.py:26-29`` of the JAX
package), and to the JAX core PCA:

- the Gram stage (2 workers): statistics at 1e-5 of their largest entry,
  the count exact; the fit from them against the JAX core fit, components
  min |cosine| ≥ 0.9999, explained variance rtol 1e-5;
- the TSQR stage (4 workers, one partition empty, centred): against the
  JAX masked TSQR fit and the JAX core ``solver="svd"`` fit, the same
  bounds.
"""

import jax  # noqa: F401  (imported at the top of every port test file)
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_ml_tpu import PCA as JaxPCA
from spark_rapids_ml_tpu.parallel import gram as JG
from spark_rapids_ml_tpu.parallel import mesh as JM
from spark_rapids_ml_tpu.parallel import tsqr as JT
from spark_rapids_ml_tpu_torch.localspark import LocalSparkSession
from spark_rapids_ml_tpu_torch.localspark import types as T
from spark_rapids_ml_tpu_torch.ops import linalg as TL
from spark_rapids_ml_tpu_torch.spark import arrow_fns, spmd

ROWS, N, K = 1024, 12, 3
SCHEMA = T.StructType([T.StructField("features", T.ArrayType(T.DoubleType()))])


@pytest.fixture(scope="module")
def spark():
    with LocalSparkSession(parallelism=2, worker_platform="cpu") as s:
        yield s


@pytest.fixture(scope="module")
def x():
    rng = np.random.default_rng(17)
    base = rng.normal(size=(ROWS, N)) * np.linspace(6.0, 0.5, N)
    return (base + 1.5).astype(np.float32)


def _df(spark, x, parts):
    return spark.createDataFrame([(r.tolist(),) for r in x.astype(np.float64)], SCHEMA,
                                 numPartitions=parts)


def _fields_schema(fields):
    return T.StructType([T.StructField(f, T.ArrayType(T.DoubleType())) for f in fields])


def _stage(df, fn, fields):
    return df.mapInArrow(fn, schema=_fields_schema(fields), barrier=True).toArrow().to_batches()


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (np.abs((a * b).sum(0)) / (np.linalg.norm(a, axis=0) * np.linalg.norm(b, axis=0))).min()


def _close(got, ref, tol=1e-5):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * np.abs(ref).max())


def test_gram_stage_on_two_workers_matches_the_jax_mesh_program(spark, x):
    batches = _stage(_df(spark, x, 2), spmd.MeshGramPartitionFn("features", device="cpu"),
                     spmd.MESH_FIELDS)
    stats, mesh_size = spmd.single_stats_from_batches(batches, N)
    assert mesh_size == 2 and float(stats.count) == ROWS
    jm = JM.create_mesh(data=8)
    ref = JG.sharded_gram_stats(jax.device_put(jnp.asarray(x), JM.data_sharding(jm)), jm)
    _close(stats.xtx, ref.xtx)
    _close(stats.col_sum, ref.col_sum)
    cov = TL.covariance_from_stats(
        TL.GramStats(*(torch.as_tensor(np.array(a, np.float32)) for a in stats)),
        mean_centering=True)
    pc, ev = TL.pca_fit_from_cov(cov, K)
    core = JaxPCA().setK(K).setMeanCentering(True).fit(x)
    assert _cos(pc.numpy(), core.pc) >= 0.9999
    np.testing.assert_allclose(ev.numpy(), core.explainedVariance, rtol=1e-5)


def test_svd_stage_on_four_workers_with_an_empty_partition(spark, x):
    df = _df(spark, x, 3).union(spark.createDataFrame([], SCHEMA, numPartitions=1))
    assert df.rdd.getNumPartitions() == 4
    batches = _stage(df, spmd.MeshSVDFitFn("features", K, True, device="cpu"),
                     spmd.SVD_FIT_FIELDS)
    row = spmd.single_row_from_batches(
        batches, spmd.SVD_FIT_FIELDS,
        {"pc": (N, K), "explainedVariance": (K,), "count": (), "mesh_size": ()})
    assert row["mesh_size"] == 4 and row["count"] == ROWS
    # the JAX masked program on padded shards, and the JAX core direct fit
    jm = JM.create_mesh(data=8)
    xp = np.concatenate([x, np.zeros((1024, N), np.float32)])
    w = np.concatenate([np.ones(ROWS, np.float32), np.zeros(1024, np.float32)])
    jw = jax.device_put(jnp.asarray(w), jax.sharding.NamedSharding(
        jm, jax.sharding.PartitionSpec(JM.DATA_AXIS)))
    ref_pc, ref_ev = JT.make_distributed_fit_svd_masked(jm, K, mean_centering=True)(
        jax.device_put(jnp.asarray(xp), JM.data_sharding(jm)), jw)
    core = JaxPCA().setK(K).setMeanCentering(True).setSolver("svd").fit(x)
    for pc, ev in ((ref_pc, ref_ev), (core.pc, core.explainedVariance)):
        assert _cos(row["pc"], pc) >= 0.9999
        np.testing.assert_allclose(row["explainedVariance"], np.asarray(ev), rtol=1e-5)


def test_a_failing_rank_fails_the_stage_and_emits_no_row(spark, x):
    class FailingRank(spmd.MeshGramPartitionFn):
        def _run_on_mesh(self, mesh, gx, gw, gy):
            if mesh.rank == 1:
                raise RuntimeError("rank 1 failed on purpose")
            return super()._run_on_mesh(mesh, gx, gw, gy)

    with pytest.raises(Exception, match="rank 1 failed on purpose"):
        _stage(_df(spark, x[:64], 2), FailingRank("features", device="cpu"), spmd.MESH_FIELDS)


def test_single_row_decoding_refuses_leaked_or_missing_rows():
    row = {"xtx": np.eye(2), "col_sum": np.ones(2), "count": 3.0, "mesh_size": 2.0}
    batch = arrow_fns.arrays_to_batch(row)
    with pytest.raises(AssertionError, match="exactly ONE"):
        spmd.single_stats_from_batches([batch, batch], 2)
    with pytest.raises(ValueError, match="no statistics"):
        spmd.single_stats_from_batches([pa.RecordBatch.from_pylist([], schema=batch.schema)], 2)
    stats, size = spmd.single_stats_from_batches([batch], 2)
    assert size == 2 and float(stats.count) == 3.0
