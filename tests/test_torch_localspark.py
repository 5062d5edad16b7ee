"""The port's local Spark engine (``spark_rapids_ml_tpu_torch.localspark``).

The behaviours ``tests/test_localspark.py`` checks for the JAX engine, on
the port's: DataFrame semantics, and the worker boundary (cloudpickle,
Arrow IPC, schema casting, reuse). The driver-side operations that draw
random numbers (``sample``, ``randomSplit``, ``rand``) are held to the JAX
engine's on the same rows and seeds. Then what is the port's own: the
worker policy (``worker_platform="cpu"`` hides the cards, and a partition
function on ``"cuda"`` raises there naming both settings; the default is
``"cuda"``), and the workers' counters and timeline merged through the
telemetry trailer, labelled by partition. One module-scoped session of
CPU workers serves the file; a worker imports torch cold.
"""

import os

import jax  # noqa: F401  (imported at the top of every port test file)
import numpy as np
import pyarrow as pa
import pytest

from spark_rapids_ml_tpu.localspark import LocalSparkSession as JaxSession
from spark_rapids_ml_tpu.localspark import functions as JF
from spark_rapids_ml_tpu.localspark import types as JT
from spark_rapids_ml_tpu_torch.localspark import LocalSparkSession, Row
from spark_rapids_ml_tpu_torch.localspark import functions as F
from spark_rapids_ml_tpu_torch.localspark import session as S
from spark_rapids_ml_tpu_torch.localspark import types as T
from spark_rapids_ml_tpu_torch.localspark.session import WorkerException
from spark_rapids_ml_tpu_torch.localspark.taskcontext import BarrierTaskContext
from spark_rapids_ml_tpu_torch.spark import arrow_fns
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY
from spark_rapids_ml_tpu_torch.telemetry.timeline import TIMELINE
from spark_rapids_ml_tpu_torch.utils import devicepolicy


@pytest.fixture(scope="module")
def spark():
    with LocalSparkSession(parallelism=3, worker_platform="cpu") as s:
        yield s


@pytest.fixture(scope="module")
def jax_spark():
    # driver-side operations only: no job runs, so no worker starts
    with JaxSession(parallelism=3) as s:
        yield s


def _schema(types):
    return types.StructType([
        types.StructField("features", types.ArrayType(types.DoubleType())),
        types.StructField("idx", types.LongType()),
    ])


def _features_df(spark, rows=30, dim=4, parallelism=None, seed=0, types=T):
    x = np.random.default_rng(seed).normal(size=(rows, dim))
    df = spark.createDataFrame([(row.tolist(), i) for i, row in enumerate(x)], _schema(types),
                               numPartitions=parallelism)
    return df, x


def test_types_map_to_arrow_as_the_jax_engines():
    s = T.StructType([T.StructField("a", T.ArrayType(T.DoubleType())),
                      T.StructField("b", T.LongType()), T.StructField("c", T.StringType())])
    j = JT.StructType([JT.StructField("a", JT.ArrayType(JT.DoubleType())),
                       JT.StructField("b", JT.LongType()), JT.StructField("c", JT.StringType())])
    assert s.to_arrow() == j.to_arrow()
    assert T.from_arrow_schema(s.to_arrow()) == s
    assert T.ArrayType(T.DoubleType()) != T.ArrayType(T.LongType())


def test_create_and_collect(spark):
    df, x = _features_df(spark)
    rows = df.collect()
    assert len(rows) == 30
    r = rows[7]
    assert r[1] == 7 and r["idx"] == 7 and r.idx == 7
    np.testing.assert_allclose(r["features"], x[7])


def test_partitioning(spark):
    df, _ = _features_df(spark)
    assert df.rdd.getNumPartitions() == 3
    df8 = df.repartition(8)
    assert df8.rdd.getNumPartitions() == 8 and df8.count() == 30


def test_select_where_first_limit(spark):
    df, x = _features_df(spark)
    sel = df.select("features")
    assert sel.schema.names == ["features"]
    np.testing.assert_allclose(sel.first()[0], x[0])
    assert len(df.limit(5).collect()) == 5
    assert df.where(F.col("idx") >= 20).count() == 10
    assert df.where((F.col("idx") >= 10) & (F.col("idx") < 12)).count() == 2
    with pytest.raises(KeyError):
        df.select("nope")


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_sample_and_random_split_are_the_jax_engines(spark, jax_spark, seed):
    """The same seed selects the same rows in both engines."""
    df, _ = _features_df(spark, rows=600, seed=seed)
    jdf, _ = _features_df(jax_spark, rows=600, seed=seed, types=JT)
    for frac in (0.3, 0.5):
        port = [r.idx for r in df.sample(fraction=frac, seed=seed).collect()]
        ref = [r.idx for r in jdf.sample(fraction=frac, seed=seed).collect()]
        assert port == ref and 0 < len(port) < 600
    assert [r.idx for r in df.sample(0.5, seed).collect()] == \
        [r.idx for r in df.sample(fraction=0.5, seed=seed).collect()]
    splits = df.randomSplit([0.8, 0.2], seed=seed)
    jsplits = jdf.randomSplit([0.8, 0.2], seed=seed)
    for a, b in zip(splits, jsplits):
        assert [r.idx for r in a.collect()] == [r.idx for r in b.collect()]
    assert sum(s.count() for s in splits) == 600
    rand = [r.idx for r in df.where(F.rand(seed) < 0.25).collect()]
    assert rand == [r.idx for r in jdf.where(JF.rand(seed) < 0.25).collect()]


def test_to_arrow_and_schema_inference(spark):
    df, _ = _features_df(spark)
    table = df.toArrow()
    assert table.num_rows == 30 and table.schema.field("features").type == pa.list_(pa.float64())
    inferred = spark.createDataFrame([([1.0, 2.0], 3, "a"), ([0.5, 1.5], 4, "b")],
                                     ["vec", "n", "s"])
    assert inferred.schema["vec"].dataType == T.ArrayType(T.DoubleType())
    assert inferred.schema["n"].dataType == T.LongType()
    assert spark.createDataFrame(pa.table({"a": [1.0, 2.0]})).count() == 2


def test_closure_crosses_process(spark):
    """The plan function runs in another process and carries what it
    captured."""
    df, x = _features_df(spark)
    factor = 3.5
    out_schema = T.StructType([T.StructField("scaled", T.ArrayType(T.DoubleType())),
                               T.StructField("pid", T.LongType())])

    def scale(batches):
        import os

        for b in batches:
            arr = np.asarray([np.asarray(v) * factor for v in b.column("features").to_pylist()])
            offsets = pa.array(np.arange(0, arr.size + 1, arr.shape[1], dtype=np.int32))
            col = pa.ListArray.from_arrays(offsets, pa.array(arr.reshape(-1)))
            pid = pa.array(np.full(b.num_rows, os.getpid(), dtype=np.int64))
            yield pa.RecordBatch.from_arrays([col, pid], schema=out_schema.to_arrow())

    rows = df.select("features").mapInArrow(scale, out_schema).collect()
    assert os.getpid() not in {r.pid for r in rows}
    np.testing.assert_allclose(rows[0]["scaled"], x[0] * factor, rtol=1e-12)


def test_worker_exception_carries_traceback(spark):
    df, _ = _features_df(spark)

    def boom(batches):
        for _ in batches:
            raise ValueError("deliberate kaboom in worker")
        yield  # pragma: no cover

    with pytest.raises(WorkerException, match="deliberate kaboom"):
        df.mapInArrow(boom, df.schema).collect()


def test_output_schema_mismatch_detected(spark):
    df, _ = _features_df(spark)

    def wrong_cols(batches):
        for b in batches:
            yield pa.RecordBatch.from_arrays([pa.array(np.zeros(b.num_rows))],
                                             names=["unexpected"])

    declared = T.StructType([T.StructField("expected", T.DoubleType())])
    with pytest.raises(WorkerException, match="missing declared column"):
        df.mapInArrow(wrong_cols, declared).collect()
    with pytest.raises(TypeError, match="StructType"):
        df.mapInArrow(lambda it: it, "a double")


def test_worker_print_does_not_corrupt_protocol(spark):
    df, _ = _features_df(spark)

    def chatty(batches):
        print("spamming stdout from the worker")
        yield from batches

    assert df.mapInArrow(chatty, df.schema).count() == 30


def test_worker_reuse_across_jobs(spark):
    df, _ = _features_df(spark)

    def tag_pid(batches):
        import os

        for b in batches:
            yield pa.RecordBatch.from_arrays(
                [pa.array(np.full(b.num_rows, os.getpid(), dtype=np.int64))], names=["pid"])

    schema = T.StructType([T.StructField("pid", T.LongType())])
    pids1 = {r.pid for r in df.mapInArrow(tag_pid, schema).collect()}
    pids2 = {r.pid for r in df.mapInArrow(tag_pid, schema).collect()}
    assert pids1 == pids2 and len(pids1) == 1


def test_empty_partition_runs_fn(spark):
    df, _ = _features_df(spark, rows=5)

    def ident(batches):  # defined here: a worker cannot import this module
        yield from batches

    assert df.where(F.col("idx") > 100).mapInArrow(ident, df.schema).count() == 0


def test_unpicklable_fn_fails_at_submit(spark):
    df, _ = _features_df(spark)
    import threading

    lock = threading.Lock()

    def bad(batches):
        with lock:
            yield from batches

    with pytest.raises(TypeError):
        df.mapInArrow(bad, df.schema).collect()


def test_cpu_workers_see_no_card(spark):
    df, _ = _features_df(spark)

    def probe(batches):
        import os

        import torch

        n = sum(b.num_rows for b in batches)
        yield pa.RecordBatch.from_arrays([
            pa.array([os.environ.get("CUDA_VISIBLE_DEVICES", "unset")] * n),
            pa.array([os.environ.get("TPU_ML_WORKER_PLATFORM", "unset")] * n),
            pa.array([torch.cuda.is_available()] * n),
        ], names=["cvd", "platform", "cuda"])

    schema = T.StructType([T.StructField("cvd", T.StringType()),
                           T.StructField("platform", T.StringType()),
                           T.StructField("cuda", T.BooleanType())])
    assert {tuple(r) for r in df.mapInArrow(probe, schema).collect()} == {("", "cpu", False)}


def test_a_cuda_partition_fn_in_a_cpu_worker_names_both_settings(spark):
    df, _ = _features_df(spark)
    fn = arrow_fns.FitPartitionFn("features", device="cuda")
    schema = T.StructType([T.StructField(f, T.ArrayType(T.DoubleType()))
                           for f in ("xtx", "col_sum", "count")])
    with pytest.raises(WorkerException, match=r"device='cuda'.*worker_platform='cpu'"):
        df.select("features").mapInArrow(fn, schema).collect()


def test_the_default_worker_platform_is_cuda():
    session = LocalSparkSession()  # no job runs, so no worker starts
    try:
        assert session._worker_env[devicepolicy.PLATFORM_VAR] == "cuda"
        assert devicepolicy.CUDA_VISIBLE_DEVICES_VAR not in session._worker_env
    finally:
        session.stop()
    hidden = LocalSparkSession(worker_platform="cpu")
    try:
        assert hidden._worker_env[devicepolicy.CUDA_VISIBLE_DEVICES_VAR] == ""
    finally:
        hidden.stop()


def test_worker_counters_merge_through_the_trailer(spark):
    df, _ = _features_df(spark, rows=30)

    def book(batches):
        from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY as WREG
        from spark_rapids_ml_tpu_torch.telemetry.timeline import TIMELINE as WTL

        for b in batches:
            WREG.counter_inc("test.worker_rows", b.num_rows, fn="book")
            WREG.histogram_record("test.worker_seconds", 0.5)
            WTL.record_instant("test.worker_batch", rows=b.num_rows)
            yield b

    s0 = REGISTRY.snapshot()
    seq = TIMELINE.seq()
    assert df.mapInArrow(book, df.schema).count() == 30
    d = REGISTRY.snapshot().delta(s0)
    assert {p: d.counter("test.worker_rows", fn="book", partition=str(p))
            for p in range(3)} == {0: 10, 1: 10, 2: 10}
    assert d.hist("test.worker_seconds").count == 3
    assert d.hist("span.seconds", phase="worker.task").count == 3
    events = [e for e in TIMELINE.events(since_seq=seq) if e["name"] == "test.worker_batch"]
    assert sorted(e["args"]["partition"] for e in events) == ["0", "1", "2"]
    assert all(e["pid"] != os.getpid() for e in events)


def test_barrier_stage_gathers_every_rank():
    with LocalSparkSession(parallelism=2, worker_platform="cpu") as s:
        df, _ = _features_df(s, rows=10)

        def gather(batches):
            ctx = BarrierTaskContext.get()
            n = sum(b.num_rows for b in batches)
            got = ctx.allGather(str(n))
            yield pa.RecordBatch.from_arrays(
                [pa.array([ctx.partitionId()]), pa.array([",".join(got)])],
                names=["rank", "gathered"])

        schema = T.StructType([T.StructField("rank", T.LongType()),
                               T.StructField("gathered", T.StringType())])
        rows = df.mapInArrow(gather, schema, barrier=True).collect()
        assert sorted((r.rank, r.gathered) for r in rows) == [(0, "5,5"), (1, "5,5")]


def test_missing_partition_result_raises_not_silent():
    with pytest.raises(WorkerException, match=r"partition\(s\) \[1\]"):
        S._require_results([[], None, []], "mapInArrow")
    assert S._require_results([[], []], "mapInArrow") == [[], []]


def test_row_api():
    r = Row([1.0, "x"], ["a", "b"])
    assert r[0] == 1.0 and r["b"] == "x" and r.a == 1.0
    assert r.asDict() == {"a": 1.0, "b": "x"}
    with pytest.raises(KeyError):
        r["nope"]
    with pytest.raises(AttributeError):
        r.nope
