"""The port's SparkKMeans on the port's local Spark engine, against the JAX
package; and the fits whose Spark algorithm has no core counterpart
(k-means‖ over jobs with its checkpoint resume, SparkRobustScaler's and
SparkQuantileDiscretizer's range-and-histogram passes), against the JAX
package's Spark fits on one module-scoped JAX local session of
parallelism 2, the only JAX workers the Spark glue's tests start.

The rows are f32 values made with numpy from a seed (well-separated blobs),
stored as the DataFrame's float64 column. Tolerances:

- the bodies against the JAX bodies on one Arrow ``RecordBatch``: counts
  exactly equal, sums and costs rtol 1e-5 of each field's largest entry,
  each package's batch decoded by the other's codec;
- the k-means‖ sample: each row drawn by both packages or by neither,
  except near ties, rows whose p = min(1, ℓ·w·d²/φ) lies within 1e-5
  (relative) of its uniform draw, where the port's f32 distance may flip
  the trial;
- Lloyd over jobs from given centres against the JAX ops' Lloyd on the
  whole matrix: centres and cost rtol 1e-5;
- whole k-means‖ fits against the JAX Spark fit: centres within 1e-5 after
  sorting (the final weighted k-means++ draws from torch in the port and
  from ``jax.random`` in the JAX package, so the two agree where Lloyd
  converges to the same blob means);
- medians, quantile ranges and splits of the sketches: within one bin
  width of the JAX Spark fit's.
"""

import shutil

import jax  # noqa: F401  (imported at the top of every port test file)
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

from spark_rapids_ml_tpu.localspark import LocalSparkSession as JaxSession
from spark_rapids_ml_tpu.localspark import types as JT
from spark_rapids_ml_tpu.ops import kmeans as JKM
from spark_rapids_ml_tpu.spark import arrow_fns as jax_arrow_fns
from spark_rapids_ml_tpu.spark import estimators as JE
from spark_rapids_ml_tpu_torch import KMeans
from spark_rapids_ml_tpu_torch.localspark import LocalSparkSession
from spark_rapids_ml_tpu_torch.localspark import types as T
from spark_rapids_ml_tpu_torch.spark import (
    SparkKMeans,
    SparkKMeansModel,
    SparkQuantileDiscretizer,
    SparkRobustScaler,
    arrow_fns,
)

CPU = torch.device("cpu")
ROWS, N, K = 1_200, 8, 4
RTOL = 1e-5
TIE = 1e-5


@pytest.fixture(scope="module")
def spark():
    with LocalSparkSession(parallelism=2, worker_platform="cpu") as s:
        yield s


@pytest.fixture(scope="module")
def jax_spark():
    with JaxSession(parallelism=2) as s:
        yield s


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    means = rng.normal(size=(K, N)) * 8.0
    x = (means[rng.integers(0, K, ROWS)] + rng.normal(size=(ROWS, N))).astype(np.float32)
    w = rng.uniform(0.2, 2.0, size=ROWS)
    w[:50] = 0.0  # excluded instances: never a candidate
    return x, w


def _rows(x, w):
    return [(r.tolist(), float(v)) for r, v in zip(x.astype(np.float64), w)]


@pytest.fixture(scope="module")
def df(spark, data):
    schema = T.StructType([T.StructField("features", T.ArrayType(T.DoubleType())),
                           T.StructField("weight", T.DoubleType())])
    return spark.createDataFrame(_rows(*data), schema, numPartitions=3)


@pytest.fixture(scope="module")
def jax_df(jax_spark, data):
    schema = JT.StructType([JT.StructField("features", JT.ArrayType(JT.DoubleType())),
                            JT.StructField("weight", JT.DoubleType())])
    return jax_spark.createDataFrame(_rows(*data), schema, numPartitions=3)


def _batch(x, w):
    feats = pa.FixedSizeListArray.from_arrays(pa.array(x.astype(np.float64).reshape(-1)),
                                              x.shape[1])
    return pa.RecordBatch.from_arrays([feats, pa.array(w)], names=["features", "weight"])


def _close(got, ref, rtol=RTOL):
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * max(np.abs(ref).max(), 1e-30))


def _sorted(c):
    c = np.asarray(c, dtype=np.float64)
    return c[np.lexsort(c.T[::-1])]


@pytest.mark.parametrize("fn_name", ["KMeansPartitionFn", "KMeansAssignStatsFn"])
def test_stats_bodies_match_jax_on_one_batch(data, fn_name):
    x, w = data
    batch = _batch(x[:500], w[:500])
    centers = x[[60, 61, 62, 63]].astype(np.float64)
    port = list(getattr(arrow_fns, fn_name)("features", centers, "weight", device="cpu")(
        iter([batch, batch.slice(0, 0)])))
    ref = list(getattr(jax_arrow_fns, fn_name)("features", centers, "weight")(iter([batch])))
    assert port[0].schema == ref[0].schema
    shapes = ({"sums": (K, N), "counts": (K,), "cost": ()} if fn_name == "KMeansPartitionFn"
              else {"counts": (K,), "cost": ()})
    want = jax_arrow_fns.arrays_from_batches(ref, shapes)
    for got in (arrow_fns.arrays_from_batches(port, shapes),
                jax_arrow_fns.arrays_from_batches(port, shapes)):
        for name in shapes:
            _close(got[name], want[name])
    np.testing.assert_array_equal(arrow_fns.arrays_from_batches(ref, shapes)["cost"],
                                  want["cost"])


def test_sample_body_draws_the_jax_sample_but_near_ties(data):
    import zlib

    x, w = data
    xs, ws = x[:600], w[:600]
    centers = x[[60, 200]].astype(np.float64)
    d2 = ((xs.astype(np.float64)[:, None, :] - centers[None]) ** 2).sum(-1).min(1)
    ell_over_phi = 2.0 * K / float(np.dot(d2, ws)) * 40.0  # many p in (0, 1)
    seed = 7
    port_b = list(arrow_fns.KMeansParallelSampleFn("features", centers, ell_over_phi, seed,
                                                   "weight", device="cpu")(
        iter([_batch(xs, ws)])))
    jax_b = list(jax_arrow_fns.KMeansParallelSampleFn("features", centers, ell_over_phi, seed,
                                                      "weight")(iter([_batch(xs, ws)])))
    assert port_b[0].schema == jax_b[0].schema
    index = {r.tobytes(): i for i, r in enumerate(xs.astype(np.float64))}

    def mask(cands):
        m = np.zeros(len(xs), bool)
        m[[index[r.tobytes()] for r in cands]] = True
        return m

    port_m = mask(arrow_fns.candidates_from_batches(port_b))
    jax_m = mask(jax_arrow_fns.candidates_from_batches(port_b + jax_b)[len(
        arrow_fns.candidates_from_batches(port_b)):])
    h = zlib.crc32(np.ascontiguousarray(xs[0], dtype=np.float64).tobytes()) ^ len(xs)
    u = np.random.default_rng([seed, h]).random(len(xs))
    p = np.minimum(1.0, ell_over_phi * ws * d2)
    near = np.abs(p - u) <= TIE * np.maximum(p, 1e-12)
    assert 0 < port_m.sum() < len(xs) and not port_m[ws == 0].any()
    np.testing.assert_array_equal(port_m[~near], jax_m[~near])
    np.testing.assert_array_equal(port_m[~near], (u < p)[~near])
    # the array body on a frame of f32 rows hashes the same f64 values
    frame = pd.DataFrame({"features": list(xs), "weight": ws})
    body = arrow_fns.KMeansParallelSampleFn("features", centers, ell_over_phi, seed,
                                            "weight", device="cpu")
    np.testing.assert_array_equal(mask(body.partition_candidates([frame])), port_m)


def test_lloyd_jobs_from_given_centers_match_the_jax_ops(df, data):
    x, w = data
    centers = x[[60, 61, 62, 63]].astype(np.float64)
    est = SparkKMeans(device=CPU).setK(K).setMaxIter(3).setTol(0.0).setWeightCol("weight")
    model = est._lloyd_df(df.select("features", "weight"), "features", "weight", centers)
    c = jnp.asarray(x[[60, 61, 62, 63]])
    for _ in range(3):
        stats = JKM.kmeans_stats(jnp.asarray(x), c, jnp.asarray(w, dtype=jnp.float32))
        c = JKM.update_centers(stats, c)
    _close(model.clusterCenters, np.asarray(c))
    _close(model.trainingCost, float(stats.cost))
    preds = np.asarray([r["prediction"] for r in model.transform(df).collect()])
    np.testing.assert_array_equal(preds, model._predict_matrix(x))
    _close(model.computeCost(df), model.computeCost(x))


def test_kmeans_parallel_over_jobs_matches_the_jax_spark_fit(df, jax_df):
    port = SparkKMeans(device=CPU).setK(K).setMaxIter(5).setSeed(3).setWeightCol(
        "weight").setInitMode("k-means||").fit(df)
    ref = JE.SparkKMeans().setK(K).setMaxIter(5).setSeed(3).setWeightCol(
        "weight").setInitMode("k-means||").fit(jax_df)
    assert isinstance(port, SparkKMeansModel)
    _close(_sorted(port.clusterCenters), _sorted(ref.clusterCenters))
    _close(port.trainingCost, ref.trainingCost)


def test_checkpoint_resumes_across_jobs_and_packages(df, jax_df, tmp_path, monkeypatch):
    def est(it):
        return SparkKMeans(device=CPU).setK(K).setMaxIter(it).setSeed(5).setTol(0.0)

    full = est(4).fit(df)
    calls = {"n": 0}
    step = SparkKMeans.lloyd_step

    def dying(self, *a, **kw):
        calls["n"] += 1
        if calls["n"] == 3:
            raise RuntimeError("killed")
        return step(self, *a, **kw)

    monkeypatch.setattr(SparkKMeans, "lloyd_step", dying)
    with pytest.raises(RuntimeError, match="killed"):
        est(4).fit(df, checkpoint_dir=str(tmp_path / "port"))
    monkeypatch.setattr(SparkKMeans, "lloyd_step", step)
    resumed = est(4).fit(df, checkpoint_dir=str(tmp_path / "port"))
    np.testing.assert_array_equal(resumed.clusterCenters, full.clusterCenters)
    # a JAX Spark fit's checkpoint: the port resumes it, at maxIter and past it
    jax_ckpt = str(tmp_path / "jax")
    ref3 = JE.SparkKMeans().setK(K).setMaxIter(3).setSeed(5).setTol(0.0).fit(
        jax_df, checkpoint_dir=jax_ckpt)
    at_end = est(3).fit(df, checkpoint_dir=jax_ckpt)
    np.testing.assert_array_equal(at_end.clusterCenters, ref3.clusterCenters)
    assert at_end.trainingCost == ref3.trainingCost
    shutil.copytree(jax_ckpt, str(tmp_path / "jax5"))
    on = est(5).fit(df, checkpoint_dir=str(tmp_path / "jax5"))
    ref5 = JE.SparkKMeans().setK(K).setMaxIter(5).setSeed(5).setTol(0.0).fit(jax_df)
    _close(_sorted(on.clusterCenters), _sorted(ref5.clusterCenters))


@pytest.mark.parametrize("mode", ["k-means++", "random"])
def test_sampled_seeding_fits_and_never_seeds_from_zero_weight(df, data, mode):
    x, w = data
    model = SparkKMeans(device=CPU).setK(K).setMaxIter(30).setInitMode(mode).setSeed(1) \
        .setWeightCol("weight").fit(df)
    assert model.clusterCenters.shape == (K, N)
    # a Lloyd fixed point, whatever the start: each centre is the weighted
    # mean of the rows it owns
    labels = model._predict_matrix(x)
    for c in range(K):
        sel = (labels == c) & (w > 0)
        want = (x[sel].astype(np.float64) * w[sel, None]).sum(0) / w[sel].sum()
        _close(model.clusterCenters[c], want, 1e-4)


@pytest.fixture(scope="module")
def jax_mesh_local_fit(jax_df):
    """The JAX package's Spark fit under ``"mesh-local"``: k-means‖ seeded
    in its mesh program on the suite's 8 virtual devices."""
    return JE.SparkKMeans().setK(K).setSeed(3).setInitMode("k-means||").setWeightCol(
        "weight").setDistribution("mesh-local").fit(jax_df)


@pytest.mark.parametrize("distribution", ["mesh-local", "mesh-barrier"])
def test_mesh_distributions_are_refused_at_fit(df, jax_mesh_local_fit, distribution,
                                               monkeypatch):
    """The mesh distributions fit (mesh-local on four CPU shards of the
    driver's mesh, seeding by k-means‖ in the mesh program; mesh-barrier as
    one barrier stage of CPU workers after the k-means‖ jobs) and agree
    with the JAX package's mesh-local Spark fit: sorted centres within 1e-5
    (the seeds' draws differ, the blob means do not), the cost at rtol
    1e-5."""
    from spark_rapids_ml_tpu_torch.parallel import kmeans as PK
    from spark_rapids_ml_tpu_torch.parallel import mesh as PM
    from spark_rapids_ml_tpu_torch.spark import estimators as SE

    monkeypatch.setattr(SE, "_driver_mesh", lambda device: PM.create_mesh(devices=[device] * 4))
    seeded = {"n": 0}
    real = PK.make_distributed_kmeans_parallel_init

    def counted(*a, **kw):
        seeded["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(PK, "make_distributed_kmeans_parallel_init", counted)
    model = SparkKMeans(device=CPU).setK(K).setSeed(3).setInitMode("k-means||") \
        .setWeightCol("weight").setDistribution(distribution).fit(df)
    assert type(model) is SparkKMeansModel
    assert seeded["n"] == (distribution == "mesh-local")
    ref = jax_mesh_local_fit
    _close(_sorted(model.clusterCenters), _sorted(ref.clusterCenters))
    np.testing.assert_allclose(model.trainingCost, ref.trainingCost, rtol=RTOL)


def test_non_spark_input_falls_through_to_the_core_fit(data):
    x, _ = data
    model = SparkKMeans(device=CPU).setK(K).setMaxIter(3).setInitMode("random").fit(x)
    core = KMeans(device=CPU).setK(K).setMaxIter(3).setInitMode("random").fit(x)
    assert type(model) is SparkKMeansModel
    np.testing.assert_array_equal(model.clusterCenters, core.clusterCenters)


@pytest.mark.parametrize("kind", ["robust", "discretizer"])
def test_sketch_fits_match_the_jax_spark_fit(df, jax_df, data, kind):
    """RobustScaler and QuantileDiscretizer read a range job and a histogram
    job: their reference is the JAX Spark fit, within one bin width."""
    x, _ = data
    bins = 256
    width = (x.max(0).astype(np.float64) - x.min(0)) / bins
    if kind == "robust":
        port = SparkRobustScaler(device=CPU).setInputCol("features").setNumBins(bins).fit(df)
        ref = JE.SparkRobustScaler().setInputCol("features").setNumBins(bins).fit(jax_df)
        assert np.all(np.abs(port.median - ref.median) <= width)
        assert np.all(np.abs(port.range - ref.range) <= 2 * width)
        got = np.asarray([r["scaled_features"] for r in port.transform(df).collect()])
        np.testing.assert_allclose(got, port._scale(x), rtol=0, atol=1e-5 * np.abs(got).max())
    else:
        port = SparkQuantileDiscretizer(device=CPU).setInputCol("features").setNumBins(
            bins).setNumBuckets(4).fit(df)
        ref = JE.SparkQuantileDiscretizer().setInputCol("features").setNumBins(bins) \
            .setNumBuckets(4).fit(jax_df)
        inner = np.abs(port.splits[:, 1:-1] - np.asarray(ref.splits)[:, 1:-1])
        assert np.all(inner <= width[:, None])
        got = np.asarray([r["bucketed_features"] for r in port.transform(df).collect()])
        np.testing.assert_array_equal(got, port._bucket(x))
