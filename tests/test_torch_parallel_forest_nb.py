"""``parallel/forest.py`` and ``parallel/naive_bayes.py`` of the port, and
``build_tree``'s per-level reduction hook.

The JAX programs run on 4 of the suite's 8 virtual CPU devices
(``create_mesh(data=4)``, rows zero-padded to a multiple of 4 at weight
0); the port's mesh is four CPU shards. Both get the same seeded f32 rows.

- Trees under integer weights (Poisson bootstrap counts, unit instance
  weights): the class counts are integer sums, exact in f32 in any order,
  so the sharded build equals the port's one-device build field for field
  (feature subsets on: every shard draws the per-tree generator's), and,
  with every feature per node (JAX's subsets come from ``jax.random``),
  the JAX sharded program's. Under instance weights the trees equal JAX's
  up to the gate rule of ``tests/torch_forest_gate.py``.
- NaiveBayes statistics within 1e-5 of their largest entry of JAX's
  sharded ones; the ``"mesh-local"`` fit's parameters within 1e-5 of the
  JAX package's ``"mesh-local"`` fit.
"""

import jax  # noqa: F401  (imported at the top of every port test file)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from spark_rapids_ml_tpu.models.naive_bayes import NaiveBayes as JaxNaiveBayes
from spark_rapids_ml_tpu.parallel import forest as JPF
from spark_rapids_ml_tpu.parallel import mesh as JM
from spark_rapids_ml_tpu.parallel import naive_bayes as JPNB
from spark_rapids_ml_tpu_torch.models.forest import tree_generators
from spark_rapids_ml_tpu_torch.models.naive_bayes import NaiveBayes
from spark_rapids_ml_tpu_torch.ops import forest as FO
from spark_rapids_ml_tpu_torch.parallel import forest as PF
from spark_rapids_ml_tpu_torch.parallel import mesh as M
from spark_rapids_ml_tpu_torch.parallel import naive_bayes as PNB

from torch_forest_gate import assert_trees_equal_up_to_gate_rule, forest_inputs

CPU = torch.device("cpu")
ROWS, F, BINS, TREES = 1001, 6, 16, 3


@pytest.fixture(scope="module")
def jax_mesh():
    return JM.create_mesh(data=4)


@pytest.fixture(scope="module")
def mesh():
    return M.create_mesh(data=4, devices=[CPU] * 4)


@pytest.fixture(scope="module")
def classes():
    rng = np.random.default_rng(23)
    centres = 2.0 * rng.normal(size=(3, F))
    y = rng.integers(0, 3, size=ROWS).astype(np.float64)
    x = (centres[y.astype(int)] + rng.normal(size=(ROWS, F))).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=ROWS)
    return x, y, w


def _close(got, ref, tol=1e-5):
    ref = np.asarray(ref, np.float64)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-30))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_forest(jm, binned, stats, weights, **static):
    """The JAX sharded program on rows padded to a multiple of 4."""
    pad = -len(binned) % 4
    binned = np.concatenate([binned, np.zeros((pad, binned.shape[1]), binned.dtype)])
    stats = np.concatenate([stats, np.zeros((pad, stats.shape[1]), stats.dtype)])
    weights = np.concatenate([weights, np.zeros((weights.shape[0], pad), weights.dtype)], axis=1)
    keys = jax.random.split(jax.random.PRNGKey(0), weights.shape[0])
    run = JPF.make_sharded_forest(jm, **static)
    trees = run(keys, jnp.asarray(binned), jnp.asarray(stats), jnp.asarray(weights),
                jnp.float32(1.0), jnp.float32(0.0))
    return FO.TreeArrays(*(np.asarray(a) for a in trees))


@pytest.mark.parametrize("impurity,k_features", [("gini", 3), ("entropy", 3), ("gini", F)])
def test_sharded_build_equals_the_one_device_build(classes, mesh, impurity, k_features):
    x, y, _ = classes
    binned, stats, weights = forest_inputs(x, y, None, num_trees=TREES, max_bins=BINS)
    static = dict(max_depth=4, n_bins=BINS, k_features=k_features, impurity=impurity)
    one = FO.build_forest(_t(binned.T), _t(stats), _t(weights), 1.0, 0.0,
                          generators=tree_generators(5, TREES, CPU), **static)
    got = PF.make_sharded_forest(mesh, **static)(_t(binned.T), _t(stats), _t(weights), 1.0, 0.0,
                                                 tree_generators(5, TREES, CPU))
    for field, a, b in zip(FO.TreeArrays._fields, got, one):
        assert torch.equal(a, b), field
    assert int((~got.is_leaf).sum()) > TREES  # the trees grew


def test_sharded_build_equals_the_jax_sharded_program(classes, jax_mesh, mesh):
    x, y, _ = classes
    binned, stats, weights = forest_inputs(x, y, None, num_trees=TREES, max_bins=BINS)
    static = dict(max_depth=4, n_bins=BINS, k_features=F, impurity="gini")
    got = PF.make_sharded_forest(mesh, **static)(_t(binned.T), _t(stats), _t(weights), 1.0, 0.0)
    ref = _jax_forest(jax_mesh, binned, stats, weights, **static)
    for field in ("feature", "split_bin", "is_leaf", "leaf_stats"):
        np.testing.assert_array_equal(getattr(got, field).numpy(), getattr(ref, field))


def test_weighted_sharded_build_within_the_gate_rule_against_jax(classes, jax_mesh, mesh):
    x, y, w = classes
    binned, stats, weights = forest_inputs(x, y, w, num_trees=TREES, max_bins=BINS)
    static = dict(max_depth=4, n_bins=BINS, k_features=F, impurity="gini")
    got = PF.make_sharded_forest(mesh, **static)(_t(binned.T), _t(stats), _t(weights), 1.0, 0.0)
    ref = _jax_forest(jax_mesh, binned, stats, weights, **static)
    assert_trees_equal_up_to_gate_rule(FO.TreeArrays(*(a.numpy() for a in got)), ref, binned,
                                       stats, weights, n_bins=BINS)


def test_reduce_hook_sums_the_shards_level_histograms(classes):
    """Two shards of one tree's rows through ``build_tree(reduce=...)``: the
    hook sees each level's two histograms, and the tree is the one-device
    tree."""
    x, y, _ = classes
    binned, stats, weights = forest_inputs(x, y, None, num_trees=1, max_bins=BINS)
    bt, st, wt = _t(binned.T), _t(stats), _t(weights[0])
    static = dict(max_depth=3, n_bins=BINS, k_features=F, impurity="gini")
    seen = []

    def reduce(hists):
        seen.append(len(hists))
        return hists[0] + hists[1]

    half = ROWS // 2
    got = FO.build_tree([bt[:, :half], bt[:, half:]], [st[:half], st[half:]],
                        [wt[:half], wt[half:]], 1.0, 0.0, reduce=reduce, **static)
    one = FO.build_tree(bt, st, wt, 1.0, 0.0, **static)
    assert seen == [2] * 4  # one reduction a level, depths 0–3
    for a, b in zip(got, one):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def counts():
    rng = np.random.default_rng(31)
    y = rng.integers(0, 3, size=ROWS).astype(np.float32)
    x = rng.poisson(1.0 + y[:, None] * np.linspace(0.2, 1.0, F), size=(ROWS, F)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=ROWS).astype(np.float32)
    return x, y, w


def test_sharded_nb_statistics_match_jax(counts, jax_mesh, mesh):
    x, y, w = counts
    pad = -ROWS % 4
    jx, jy, jw = (jax.device_put(jnp.asarray(np.concatenate([a, np.zeros((pad,) + a.shape[1:],
                                                                          a.dtype)])),
                                 NamedSharding(jax_mesh, P(JM.DATA_AXIS, None) if a.ndim == 2
                                               else P(JM.DATA_AXIS)))
                  for a in (x, y, w))
    ref = JPNB.sharded_nb_stats(jx, jy, jw, 3, jax_mesh)
    got = PNB.sharded_nb_stats(x, y, w, 3, mesh)
    for a, b in zip(got, ref):
        _close(a, b)
    mu = np.asarray(ref.feat_sum) / np.asarray(ref.counts)[:, None]
    ref_sq = JPNB.sharded_nb_centered_sq(jx, jy, jw, jnp.asarray(mu, jnp.float32), 3, jax_mesh)
    got_sq = PNB.sharded_nb_centered_sq(x, y, w, torch.from_numpy(mu.astype(np.float32)), 3, mesh)
    _close(got_sq, ref_sq)


@pytest.mark.parametrize("model_type", ["multinomial", "gaussian"])
def test_mesh_local_naive_bayes_matches_jax(counts, model_type, monkeypatch):
    x, y, w = counts
    calls = {"n": 0}
    real = PNB.sharded_nb_stats

    def counted(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(M, "local_mesh", lambda device: M.create_mesh(devices=[device] * 4))
    monkeypatch.setattr(PNB, "sharded_nb_stats", counted)
    got = NaiveBayes(device=CPU).setModelType(model_type).setDistribution("mesh-local").fit(
        (x, y, w))
    assert calls["n"] == 1  # the sharded program, not the one-device fit
    ref = JaxNaiveBayes().setModelType(model_type).setDistribution("mesh-local").fit((x, y, w))
    one = NaiveBayes(device=CPU).setModelType(model_type).fit((x, y, w))
    for name in ("pi", "theta", "sigma"):
        if model_type == "multinomial" and name == "sigma":
            continue
        _close(getattr(got, name), getattr(ref, name))
        _close(getattr(got, name), getattr(one, name))
