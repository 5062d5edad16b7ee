"""``parallel/dbscan.py`` and ``parallel/neighbors.py`` of the port against
the JAX package's mesh programs.

The JAX programs run on 4 of the suite's 8 virtual CPU devices
(``create_mesh(data=4)``); the port's mesh is four CPU shards. Both get the
same f32 rows, zero-padded to a multiple of 4 and masked as invalid.

- DBSCAN on lattice rows (integer coordinates, so every squared distance is
  an exact integer in f32 and eps never falls near one): the sharded
  labels equal the port's one-device labels and JAX's, exactly, pad rows
  included; so do SparkDBSCANModel's on a four-shard driver mesh.
- kNN: the indices equal JAX's but where two candidates' f64 distances lie
  within 1e-5 relative of each other (``torch.topk`` and ``lax.top_k`` may
  order near ties differently), the scores at rtol 1e-5; and the port's
  one-device ``knn_topk`` alike.
"""

import jax  # noqa: F401  (imported at the top of every port test file)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from spark_rapids_ml_tpu.parallel import dbscan as JPD
from spark_rapids_ml_tpu.parallel import mesh as JM
from spark_rapids_ml_tpu.parallel import neighbors as JPN
from spark_rapids_ml_tpu_torch.ops import dbscan as DB
from spark_rapids_ml_tpu_torch.ops import neighbors as NN
from spark_rapids_ml_tpu_torch.parallel import dbscan as PD
from spark_rapids_ml_tpu_torch.parallel import mesh as M
from spark_rapids_ml_tpu_torch.parallel import neighbors as PN
from spark_rapids_ml_tpu_torch.spark import estimators as SE

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def jax_mesh():
    return JM.create_mesh(data=4)


@pytest.fixture(scope="module")
def mesh():
    return M.create_mesh(data=4, devices=[CPU] * 4)


def _padded(a, rows):
    return np.concatenate([a, np.zeros((rows - len(a),) + a.shape[1:], a.dtype)])


def _jax_sharded(jm, *arrays):
    out = []
    for a in arrays:
        spec = P(JM.DATA_AXIS, None) if a.ndim == 2 else P(JM.DATA_AXIS)
        out.append(jax.device_put(jnp.asarray(a), NamedSharding(jm, spec)))
    return out


def _lattice(seed=0):
    """Three lattice blobs (a 7×7 and a 5×5 square, a 12-point line), 14
    scattered integer points, shuffled: 100 rows of integer coordinates."""
    rng = np.random.default_rng(seed)
    square = np.stack(np.meshgrid(np.arange(7), np.arange(7)), -1).reshape(-1, 2)
    small = np.stack(np.meshgrid(np.arange(5), np.arange(5)), -1).reshape(-1, 2) + [30, 0]
    line = np.stack([np.arange(12) * 2, np.full(12, 40)], -1)
    noise = rng.integers(-60, -20, size=(14, 2))
    x = np.concatenate([square, small, line, noise]).astype(np.float32)
    return x[rng.permutation(len(x))]


@pytest.mark.parametrize("eps_sq,min_pts,weighted", [
    (1.5, 3.0, False), (2.5, 5.0, False), (4.5, 2.0, False), (1.5, 4.0, True),
])
def test_sharded_dbscan_labels_equal_one_device_and_jax(jax_mesh, mesh, eps_sq, min_pts,
                                                         weighted):
    x = _lattice()
    rows = len(x)
    padded = -(-rows // 4) * 4
    w = (np.random.default_rng(1).choice([0.0, 1.0, 2.0], size=rows) if weighted
         else np.ones(rows)).astype(np.float32)
    valid = np.ones(rows, np.float32)
    xp, wp, vp = _padded(x, padded), _padded(w, padded), _padded(valid, padded)
    got = PD.make_sharded_dbscan(mesh, block_rows=16)(xp, wp, vp, eps_sq, min_pts)
    one = DB.dbscan_labels(torch.from_numpy(xp), torch.from_numpy(wp), torch.from_numpy(vp),
                           eps_sq, min_pts, block_rows=16)
    ref = JPD.make_sharded_dbscan(jax_mesh, block_rows=16)(
        *_jax_sharded(jax_mesh, xp, wp, vp), jnp.float32(eps_sq), jnp.float32(min_pts))
    np.testing.assert_array_equal(got.numpy(), one.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert (got.numpy()[rows:] == -1).all() and len(np.unique(got.numpy()[:rows])) >= 3


def test_spark_dbscan_model_labels_on_a_four_shard_mesh(monkeypatch):
    x = _lattice(2)
    model = SE.SparkDBSCAN(device=CPU).setEps(1.2).setMinSamples(3.0).fit()
    one = model.clusterLabels(x)
    monkeypatch.setattr(SE, "_driver_mesh", lambda device: M.create_mesh(devices=[device] * 4))
    calls = {"n": 0}
    real = PD.make_sharded_dbscan

    def counted(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(PD, "make_sharded_dbscan", counted)
    got = model.clusterLabels(x)
    assert calls["n"] == 1
    np.testing.assert_array_equal(got, one)


def _near_tie_equal(got_i, ref_i, queries, corpus):
    """Indices equal but where the two candidates' f64 distances lie within
    1e-5 relative: such a swap is a near tie, not a fault."""
    q64, c64 = queries.astype(np.float64), corpus.astype(np.float64)
    for r, (a, b) in enumerate(zip(got_i, ref_i)):
        for ia, ib in zip(a, b):
            if ia == ib:
                continue
            da = ((q64[r] - c64[ia]) ** 2).sum()
            db = ((q64[r] - c64[ib]) ** 2).sum()
            assert abs(da - db) <= 1e-5 * max(da, db), (r, ia, ib, da, db)


@pytest.mark.parametrize("rows,k,metric", [(403, 7, "sqeuclidean"), (403, 5, "dot"),
                                           (10, 4, "sqeuclidean")])
def test_sharded_knn_matches_jax(jax_mesh, mesh, rows, k, metric):
    """Short shards (10 rows: 3 a shard, k = 4) pad with −inf and −1."""
    rng = np.random.default_rng(rows + k)
    corpus = rng.normal(size=(rows, 8)).astype(np.float32)
    queries = rng.normal(size=(9, 8)).astype(np.float32)
    padded = -(-rows // 4) * 4
    cp, vp = _padded(corpus, padded), _padded(np.ones(rows, np.float32), padded)
    s, i = PN.make_sharded_knn(mesh, k, metric=metric, block_rows=32)(cp, vp, queries)
    jc, jv = _jax_sharded(jax_mesh, cp, vp)
    rs, ri = JPN.make_sharded_knn(jax_mesh, k, metric=metric, block_rows=32)(
        jc, jv, jnp.asarray(queries))
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-5, atol=1e-6)
    one_s, one_i = NN.knn_topk(torch.from_numpy(queries), torch.from_numpy(corpus),
                               torch.ones(rows, dtype=torch.bool), k, metric=metric)
    np.testing.assert_allclose(s.numpy(), one_s.numpy(), rtol=1e-5, atol=1e-6)
    if metric == "sqeuclidean":
        _near_tie_equal(i.numpy(), np.asarray(ri), queries, corpus)
        _near_tie_equal(i.numpy(), one_i.numpy(), queries, corpus)
    else:
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    assert (i.numpy() >= 0).all() and (i.numpy() < rows).all()
