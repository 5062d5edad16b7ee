"""``parallel/kmeans.py`` of the port against the JAX package's.

The JAX programs run on 4 of the suite's 8 virtual CPU devices
(``create_mesh(data=4)``); the port's mesh is four CPU shards and, where
named, one. Both get the same seeded f32 rows (1,001, zero-padded to a
multiple of 4 with weight 0 for JAX). Bounds: statistics within 1e-5 of
their largest entry, counts exact; Lloyd centres from the same initial
centres at rtol 1e-5 (the cost, an f32 sum of 1,001 distances added in
another order, at 1e-4). The k-means‖ seeding draws from ``torch.Generator``s,
not ``jax.random``, so it is held by its quality, as the JAX package's own
test holds its seeding: on well-separated blobs the Lloyd fit from the
port's seeds ends within 1e-4 of the cost of the fit from JAX's seeds. A
chunked Lloyd run killed after its first chunk and resumed is bit-equal to
the uninterrupted chunked run.
"""

import jax  # noqa: F401  (imported at the top of every port test file)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from spark_rapids_ml_tpu.ops import kmeans as JKM
from spark_rapids_ml_tpu.parallel import kmeans as JPK
from spark_rapids_ml_tpu.parallel import mesh as JM
from spark_rapids_ml_tpu_torch.ops import kmeans as KM
from spark_rapids_ml_tpu_torch.parallel import kmeans as PK
from spark_rapids_ml_tpu_torch.parallel import mesh as M
from spark_rapids_ml_tpu_torch.utils.checkpoint import TrainingCheckpointer

CPU = torch.device("cpu")
ROWS, N, K = 1001, 5, 4


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(3)
    centres = rng.normal(size=(K, N)) * 20.0
    x = (centres[rng.integers(0, K, ROWS)] + rng.normal(size=(ROWS, N))).astype(np.float32)
    w = rng.uniform(0.5, 2.0, ROWS).astype(np.float32)
    w[::50] = 0.0  # excluded rows
    return x, w


@pytest.fixture(scope="module")
def jax_mesh():
    return JM.create_mesh(data=4)


@pytest.fixture(scope="module")
def mesh():
    return M.create_mesh(data=4, devices=[CPU] * 4)


def _close(got, ref, tol=1e-5):
    ref = np.asarray(ref, np.float64)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-30))


def _jax_sharded(jm, *arrays):
    out = []
    for a in arrays:
        a = np.concatenate([a, np.zeros((-len(a) % 4,) + a.shape[1:], a.dtype)])
        spec = P(JM.DATA_AXIS, None) if a.ndim == 2 else P(JM.DATA_AXIS)
        out.append(jax.device_put(jnp.asarray(a), NamedSharding(jm, spec)))
    return out


def test_sharded_kmeans_stats_match_jax(blobs, jax_mesh, mesh):
    x, w = blobs
    c = x[:K] + 0.5
    ref = JKM.kmeans_stats(jnp.asarray(x), jnp.asarray(c), jnp.asarray(w))
    got = PK.sharded_kmeans_stats(x, c, mesh, weights=w)
    for a, b in zip(got, ref):
        _close(a, b)
    jx = _jax_sharded(jax_mesh, x[:1000])[0]
    ref = JPK.sharded_kmeans_stats(jx, jnp.asarray(c), jax_mesh)
    got = PK.sharded_kmeans_stats(x[:1000], c, mesh)
    for a, b in zip(got, ref):
        _close(a, b)
    assert got.counts.sum().item() == 1000.0
    new, cost = PK.make_distributed_lloyd(mesh)(x[:1000], c)
    ref_new, ref_cost = JPK.make_distributed_lloyd(jax_mesh)(jx, jnp.asarray(c))
    np.testing.assert_allclose(new.numpy(), np.asarray(ref_new), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(cost), float(ref_cost), rtol=1e-5)


@pytest.mark.parametrize("shards", [4, 1])
def test_lloyd_fit_from_the_same_centres_matches_jax(blobs, jax_mesh, shards):
    x, w = blobs
    c0 = x[[1, 300, 600, 900]] + 0.25
    jx, jw = _jax_sharded(jax_mesh, x, w)
    ref_c, ref_cost, ref_it = JPK.make_distributed_kmeans_fit(jax_mesh, max_iter=20, tol=1e-4)(
        jx, jw, jnp.asarray(c0))
    mesh = M.create_mesh(data=shards, devices=[CPU] * shards)
    c, cost, it = PK.make_distributed_kmeans_fit(mesh, max_iter=20, tol=1e-4)(x, w, c0)
    assert it == int(ref_it) < 20
    np.testing.assert_allclose(c.numpy(), np.asarray(ref_c), rtol=1e-5, atol=1e-5)
    # the cost is an f32 sum of 1,001 weighted distances in another order
    np.testing.assert_allclose(float(cost), float(ref_cost), rtol=1e-4)


def test_kmeans_parallel_seeding_by_quality(blobs, jax_mesh, mesh):
    x, w = blobs
    init = PK.make_distributed_kmeans_parallel_init(mesh, K, init_steps=2)
    cand, counts = init(x, w, 7)
    cand2, counts2 = init(x, w, 7)
    assert torch.equal(cand, cand2) and torch.equal(counts, counts2)  # seeded
    np.testing.assert_allclose(counts.sum().item(), w.sum(dtype=np.float64), rtol=1e-6)
    picked = cand[counts > 0].numpy()
    excluded = x[w == 0]
    assert not (picked[:, None, :] == excluded[None, :, :]).all(-1).any()  # never a 0-weight row
    gen = torch.Generator().manual_seed(8)
    seeds = KM.weighted_kmeans_plus_plus_init(gen, cand, counts, K)
    _, cost, _ = PK.make_distributed_kmeans_fit(mesh, max_iter=20)(x, w, seeds)

    jx, jw = _jax_sharded(jax_mesh, x, w)
    jc, jn = JPK.make_distributed_kmeans_parallel_init(jax_mesh, K, init_steps=2)(
        jx, jw, jax.random.PRNGKey(7))
    jseeds = JKM.weighted_kmeans_plus_plus_init(jax.random.PRNGKey(8), jc, jn, K)
    _, jcost, _ = JPK.make_distributed_kmeans_fit(jax_mesh, max_iter=20)(jx, jw, jseeds)
    np.testing.assert_allclose(float(cost), float(jcost), rtol=1e-4)


class _Killed(RuntimeError):
    pass


def test_chunked_lloyd_resume_is_bit_equal(blobs, mesh, tmp_path):
    x, w = blobs
    c0 = torch.from_numpy(x[[1, 2, 3, 4]].copy())  # a poor start: Lloyd moves for a while
    chunk = PK.make_distributed_kmeans_chunk(mesh, chunk_iters=2, tol=0.0)
    full, cost_full, it_full = PK.run_chunked_lloyd(chunk, x, w, c0, start_iter=0, max_iter=6,
                                                    tol=0.0, ckpt=None)
    calls = {"n": 0}

    def dies_after_one(*args):
        calls["n"] += 1
        if calls["n"] == 2:
            raise _Killed("killed after the first chunk")
        return chunk(*args)

    with pytest.raises(_Killed):
        PK.run_chunked_lloyd(dies_after_one, x, w, c0, start_iter=0, max_iter=6, tol=0.0,
                             ckpt=TrainingCheckpointer(tmp_path))
    step, arrays, state = TrainingCheckpointer(tmp_path).latest()
    assert step == 1
    resumed, cost, it = PK.run_chunked_lloyd(chunk, x, w, torch.from_numpy(arrays["centers"]),
                                             start_iter=step + 1, max_iter=6, tol=0.0,
                                             ckpt=TrainingCheckpointer(tmp_path),
                                             cost0=state["cost"])
    assert it == it_full > 2 and cost == cost_full
    assert torch.equal(resumed, full)
