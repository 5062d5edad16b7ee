"""The port's DBSCAN against the JAX package's.

DBSCAN's labels are deterministic (cluster id = smallest core index,
relabeled ascending; border → smallest core-neighbour cluster; noise −1),
so the port's must equal the JAX package's exactly on the same f32 rows,
weighted and unweighted, whatever the block. Each eps is set in the widest
gap between the pairwise f64 squared distances near its target
(``_eps_away``), so that no pair lies within f32 reach (relative 1e-4) of
it and the two backends' f32 distances fall on the same side.
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_ml_tpu.models.dbscan import DBSCAN as JaxDBSCAN
from spark_rapids_ml_tpu.ops import dbscan as JDB
from spark_rapids_ml_tpu_torch import DBSCAN, DBSCANModel
from spark_rapids_ml_tpu_torch import clustering
from spark_rapids_ml_tpu_torch.models.base import Saveable
from spark_rapids_ml_tpu_torch.ops import dbscan as DB

CPU = torch.device("cpu")


def _blobs(seed=0, n_out=25):
    rng = np.random.default_rng(seed)
    blobs = [
        rng.normal(loc, 0.25, size=(60, 3))
        for loc in ([0, 0, 0], [5, 5, 5], [-5, 5, 0])
    ]
    outliers = rng.uniform(-10, 10, size=(n_out, 3))
    x = np.concatenate(blobs + [outliers])
    return x[rng.permutation(len(x))].astype(np.float32)


def _pair_sq_dists(x):
    return ((x[:, None, :].astype(np.float64) - x[None, :, :]) ** 2).sum(-1)


def _eps_away(x, target):
    """eps within ±20% of ``target`` whose square is the midpoint of the
    widest gap between pairwise squared distances."""
    d = np.unique(_pair_sq_dists(x))
    lo, hi = 0.8 * target**2, 1.2 * target**2
    edges = np.concatenate([[lo], d[(d > lo) & (d < hi)], [hi]])
    i = np.argmax(np.diff(edges))
    eps_sq = (edges[i] + edges[i + 1]) / 2
    assert np.abs(d - eps_sq).min() / eps_sq > 1e-4  # no pair within f32 reach
    return float(np.sqrt(eps_sq))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("eps,min_samples", [(0.5, 5.0), (0.8, 10.0), (0.3, 3.0)])
def test_labels_equal_jax(seed, eps, min_samples):
    x = _blobs(seed)
    eps = _eps_away(x, eps)
    got = DBSCAN(device=CPU, eps=eps, minSamples=min_samples).fit().clusterLabels(x)
    ref = JaxDBSCAN(eps=eps, minSamples=min_samples).fit().clusterLabels(x)
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.int32 and (got == -1).any() and got.max() >= 2


def test_sqeuclidean_metric_equal_jax():
    x = _blobs(4)
    got = DBSCAN(device=CPU, eps=0.36, metric="sqeuclidean").fit().clusterLabels(x)
    ref = JaxDBSCAN(eps=0.36, metric="sqeuclidean").fit().clusterLabels(x)
    np.testing.assert_array_equal(got, ref)


def test_chain_cluster_long_diameter_equal_jax():
    """A 400-point line spaced under eps: one cluster of diameter 399, which
    the pointer jumps collapse in a few sweeps."""
    x = np.stack([np.arange(400) * 0.5, np.zeros(400)], axis=1).astype(np.float32)
    got = DBSCAN(device=CPU).setEps(0.6).setMinSamples(2).fit().clusterLabels(x)
    ref = JaxDBSCAN().setEps(0.6).setMinSamples(2).fit().clusterLabels(x)
    np.testing.assert_array_equal(got, ref)
    assert np.all(got == 0)


@pytest.mark.parametrize("kind", ["pandas", "arrow"])
def test_weighted_labels_equal_jax(kind):
    rng = np.random.default_rng(7)
    x = _blobs(5)
    w = rng.choice([0.0, 0.5, 1.0, 2.0, 4.0], size=len(x))
    if kind == "pandas":
        data = pd.DataFrame({"features": list(x), "w": w})
    else:
        data = pa.table({
            "features": pa.FixedSizeListArray.from_arrays(pa.array(x.reshape(-1)), 3),
            "w": pa.array(w),
        })
    kw = dict(inputCol="features", weightCol="w", eps=0.5, minSamples=6.0)
    got = DBSCAN(device=CPU, **kw).fit().clusterLabels(data)
    ref = JaxDBSCAN(**kw).fit().clusterLabels(data)
    np.testing.assert_array_equal(got, ref)


def test_zero_weight_point_is_labeled_not_core():
    rng = np.random.default_rng(2)
    blob = rng.normal(0, 0.2, size=(20, 2))
    x = np.concatenate([blob, [[0.05, 0.0]], [[9.0, 9.0]]]).astype(np.float32)
    w = np.ones(len(x))
    w[20] = 0.0
    df = pd.DataFrame({"features": list(x), "w": w})
    kw = dict(inputCol="features", weightCol="w", eps=0.5, minSamples=5)
    got = DBSCAN(device=CPU, **kw).fit().clusterLabels(df)
    np.testing.assert_array_equal(got, JaxDBSCAN(**kw).fit().clusterLabels(df))
    assert got[20] == 0 and got[21] == -1


@pytest.mark.parametrize("block_rows", [2048, 17, 64])
def test_kernel_with_padding_equal_jax(block_rows):
    x = _blobs(3)
    rows = len(x)
    xp = np.concatenate([x, np.zeros((30, 3), np.float32)])
    w = np.concatenate([np.ones(rows), np.zeros(30)]).astype(np.float32)
    valid = np.arange(len(xp)) < rows
    got = DB.dbscan_labels(
        torch.from_numpy(xp), torch.from_numpy(w), torch.from_numpy(valid), 1.0, 5.0,
        block_rows=block_rows,
    ).numpy()
    ref = np.asarray(JDB.dbscan_labels(
        jnp.asarray(xp), jnp.asarray(w), jnp.asarray(valid),
        jnp.asarray(np.float32(1.0)), jnp.asarray(np.float32(5.0)),
    ))
    np.testing.assert_array_equal(got, ref)
    assert (got[rows:] == -1).all() and got.dtype == np.int32
    core = DB.dbscan_core_mask(
        torch.from_numpy(xp), torch.from_numpy(w), torch.from_numpy(valid), 1.0, 5.0,
        block_rows=block_rows,
    ).numpy()
    ref_core = np.asarray(JDB.dbscan_core_mask(
        jnp.asarray(xp), jnp.asarray(w), jnp.asarray(valid),
        jnp.asarray(np.float32(1.0)), jnp.asarray(np.float32(5.0)),
    ))
    np.testing.assert_array_equal(core, ref_core)


def test_transform_appends_prediction_and_books_the_span():
    x = _blobs(1)
    df = pd.DataFrame({"features": list(x)})
    model = DBSCAN(device=CPU, inputCol="features", eps=0.5).fit()
    out = model.transform(df)
    ref = JaxDBSCAN(inputCol="features", eps=0.5).fit().transform(df)
    np.testing.assert_array_equal(out["prediction"], ref["prediction"])
    assert "dbscan cluster" in model.transform_report.phases
    with pytest.raises(TypeError, match="named columns"):
        model.transform(x)


def test_params_and_validation_match_jax():
    port, ref = DBSCAN(device=CPU), JaxDBSCAN()
    for name in ("eps", "minSamples", "metric", "predictionCol"):
        assert port.getOrDefault(name) == ref.getOrDefault(name)
    with pytest.raises(ValueError, match="eps"):
        DBSCAN(device=CPU).setEps(0)
    with pytest.raises(ValueError, match="minSamples"):
        DBSCAN(device=CPU).setMinSamples(0.5)
    with pytest.raises(ValueError, match="metric"):
        DBSCAN(device=CPU).setMetric("cosine")
    assert clustering.DBSCAN is DBSCAN


def test_save_load_and_jax_save_loads(tmp_path):
    x = _blobs(2)
    model = DBSCAN(device=CPU, eps=0.4, minSamples=4).fit()
    model.save(str(tmp_path / "m"))
    back = DBSCANModel.load(str(tmp_path / "m"), device="cpu")
    assert back.getEps() == 0.4 and back.getMinSamples() == 4.0
    JaxDBSCAN(eps=0.4, minSamples=4).fit().save(str(tmp_path / "jax"))
    loaded = Saveable.load(str(tmp_path / "jax"), device="cpu")
    assert isinstance(loaded, DBSCANModel)
    np.testing.assert_array_equal(loaded.clusterLabels(x), back.clusterLabels(x))
