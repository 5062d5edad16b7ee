"""The port's tree family (``ops/forest.py``, ``models/forest.py``, the
``"forest"`` servable) against the JAX package's.

Both packages get the same f32 rows and labels, made from a numpy seed; the
port runs with device="cpu". Tolerances and properties:

- ``quantile_bin_edges``, ``bin_features``, ``split_thresholds``,
  ``subset_size`` and ``tree_feature_importances``: exactly equal;
- ``build_tree`` with all features, for gini, entropy and variance:
  ``feature``, ``split_bin`` and ``is_leaf`` exactly equal, ``leaf_stats``
  and ``gain`` rtol 1e-6 (the histograms and running sums add in the JAX
  package's order on the CPU; entropy's log may differ in its last bit);
- ``forest_apply`` and ``tree_apply_binned`` on the same trees: exactly
  equal leaf stats;
- whole fits with featureSubsetStrategy "all" (no random draw; the
  bootstrap and Bernoulli weights are numpy's in both): ``feature``,
  ``split_bin``, ``is_leaf``, ``leaf_stats``, the thresholds and the
  predictions exactly equal; ``gain`` within 1e-6 of the largest gain (an
  n-scaled f32 difference of impurities, which the JAX package's vmapped
  program rounds in its own order);
- with "sqrt" the per-node subsets come from a torch generator, so the
  forests are held by properties: the same seed gives the same forest, and
  the mean held-out accuracy over four seeds within 0.02 of the JAX
  package's;
- the DecisionTree estimators, persistence across the packages, and the
  servable (its answer the eager prediction, bit for bit).
"""

from __future__ import annotations

import jax  # noqa: F401  (imported at the top of every port test file)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.models import forest as JF
from spark_rapids_ml_tpu.ops import forest as JFO
from spark_rapids_ml_tpu.utils import persistence as jax_persistence
from spark_rapids_ml_tpu_torch import (
    DecisionTreeClassificationModel,
    DecisionTreeClassifier,
    DecisionTreeRegressionModel,
    DecisionTreeRegressor,
    RandomForestClassificationModel,
    RandomForestClassifier,
    RandomForestRegressor,
)
from spark_rapids_ml_tpu_torch.convert import model_from_arrays
from spark_rapids_ml_tpu_torch.models import forest as PF
from spark_rapids_ml_tpu_torch.models.base import Saveable
from spark_rapids_ml_tpu_torch.ops import forest as FO
from spark_rapids_ml_tpu_torch.serving import buckets
from spark_rapids_ml_tpu_torch.serving import registry as registry_mod

CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3000, 8)).astype(np.float32)
    y_cls = ((x[:, 0] * x[:, 1] + x[:, 2]) > 0).astype(np.float64)
    y_reg = (2.0 * x[:, 0] - np.abs(x[:, 3]) + 0.3 * rng.normal(size=3000)).astype(np.float64)
    return x, y_cls, y_reg


@pytest.fixture(autouse=True)
def serve_env(monkeypatch):
    monkeypatch.setenv("TPU_ML_SERVE_MIN_BUCKET", "8")
    monkeypatch.setenv("TPU_ML_SERVE_MAX_BATCH_ROWS", "64")
    monkeypatch.delenv("TPU_ML_SERVE_HBM_BUDGET_BYTES", raising=False)
    monkeypatch.delenv("TPU_ML_TUNING_CACHE_PATH", raising=False)
    yield
    registry_mod.reset_for_tests()


# -- binning -----------------------------------------------------------------


@pytest.mark.parametrize("n_bins", [2, 16, 32])
def test_bin_edges_and_bins_equal_jax(data, n_bins):
    x, _, _ = data
    w = np.where(np.arange(len(x)) % 5 == 0, 0.0, 1.0)
    edges = PF.quantile_bin_edges(x, n_bins, 3, w)
    np.testing.assert_array_equal(edges, JF.quantile_bin_edges(x, n_bins, 3, w))
    np.testing.assert_array_equal(PF.bin_features(x, edges), JF.bin_features(x, edges))
    # values exactly on an edge go left (bin b ⇔ edges[b−1] < x ≤ edges[b])
    on_edge = edges[:, :1].T.astype(np.float32)
    np.testing.assert_array_equal(PF.bin_features(on_edge, edges),
                                  JF.bin_features(on_edge, edges))


def test_bin_edges_sample_a_large_input_like_jax():
    x = np.random.default_rng(4).normal(size=(200_100, 2)).astype(np.float32)
    np.testing.assert_array_equal(PF.quantile_bin_edges(x, 8, 5),
                                  JF.quantile_bin_edges(x, 8, 5))


@pytest.mark.parametrize("strategy", ["auto", "all", "sqrt", "log2", "onethird", "3", "0.5"])
@pytest.mark.parametrize("classification", [True, False])
def test_subset_size_equals_jax(strategy, classification):
    for f in (1, 10, 28):
        assert PF.subset_size(strategy, f, classification=classification) == JF.subset_size(
            strategy, f, classification=classification)
    with pytest.raises(ValueError):
        PF.subset_size("nope", 4, classification=True)


# -- the tree kernels --------------------------------------------------------


def _row_stats(impurity, rng, binned):
    rows = binned.shape[0]
    if impurity == "variance":
        y = (binned[:, 1] * 0.3 + rng.normal(size=rows)).astype(np.float32)
        return np.stack([np.ones_like(y), y, y * y], axis=1)
    y = (binned[:, 0] + binned[:, 2] > 15).astype(int) + (binned[:, 4] > 12)
    return np.eye(3, dtype=np.float32)[y]


@pytest.mark.parametrize("impurity", ["gini", "entropy", "variance"])
@pytest.mark.parametrize("max_depth", [0, 3, 5])
def test_build_tree_equals_jax(impurity, max_depth):
    rng = np.random.default_rng(max_depth)
    binned = rng.integers(0, 16, (4000, 6)).astype(np.int32)
    rs = _row_stats(impurity, rng, binned)
    w = rng.poisson(1.0, len(binned)).astype(np.float32)
    ref = JFO.build_tree(
        jax.random.PRNGKey(0), jnp.asarray(binned), jnp.asarray(rs), jnp.asarray(w),
        jnp.asarray(np.float32(2.0)), jnp.asarray(np.float32(0.0)),
        max_depth=max_depth, n_bins=16, k_features=6, impurity=impurity,
    )
    got = FO.build_tree(_t(binned.T), _t(rs), _t(w), 2.0, 0.0, max_depth=max_depth,
                        n_bins=16, k_features=6, impurity=impurity)
    for name in ("feature", "split_bin", "is_leaf"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))
    for name in ("leaf_stats", "gain"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-6)
    assert (got.feature >= 0).sum() > 0 or max_depth == 0


def test_build_tree_refuses_an_unknown_impurity():
    with pytest.raises(ValueError, match="impurity"):
        FO.build_tree(torch.zeros((1, 4), dtype=torch.int32), torch.ones((4, 2)),
                      torch.ones(4), 1.0, 0.0, max_depth=1, n_bins=2, k_features=1,
                      impurity="mse")


def test_level_histogram_is_the_segment_sum():
    rng = np.random.default_rng(9)
    binned = rng.integers(0, 8, (500, 3)).astype(np.int32)
    local = rng.integers(0, 4, 500)
    contrib = rng.normal(size=(500, 2)).astype(np.float32)
    got = FO.level_histogram(_t(binned.T), _t(local), _t(contrib), 4, 8).numpy()
    ref = np.zeros((3, 4, 8, 2), np.float64)
    for f in range(3):
        np.add.at(ref[f], (local, binned[:, f]), contrib)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_feature_subsets_draw_k_features_per_node():
    rng = np.random.default_rng(2)
    binned = rng.integers(0, 16, (3000, 10)).astype(np.int32)
    rs = _row_stats("gini", rng, binned)
    w = np.ones(len(binned), np.float32)

    def grow(seed):
        gen = torch.Generator().manual_seed(seed)
        return FO.build_tree(_t(binned.T), _t(rs), _t(w), 1.0, 0.0, max_depth=4, n_bins=16,
                             k_features=2, impurity="gini", generator=gen)

    a, b, c = grow(5), grow(5), grow(6)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert any(not torch.equal(x, y) for x, y in zip(a, c))
    # with all ten features the root splits on an informative one (0, 2 or
    # 4); with two drawn per node, the splits use other features too
    full = FO.build_tree(_t(binned.T), _t(rs), _t(w), 1.0, 0.0, max_depth=4, n_bins=16,
                         k_features=10, impurity="gini")
    assert int(full.feature[0]) in (0, 2, 4)
    drawn = torch.cat([a.feature, c.feature])
    assert len(set(drawn[drawn >= 0].tolist()) - {0, 2, 4}) > 0


@pytest.fixture(scope="module")
def jax_forest(data):
    x, y, _ = data
    return JF.RandomForestClassifier(numTrees=4, maxDepth=4, maxBins=16,
                                     featureSubsetStrategy="all", seed=2).fit((x, y))


def test_forest_apply_and_tree_apply_binned_equal_jax(data, jax_forest):
    x, _, _ = data
    trees = jax_forest.trees
    ref = np.asarray(JFO.forest_apply(JFO.TreeArrays(*(jnp.asarray(a) for a in trees)),
                                      jnp.asarray(x), jnp.asarray(jax_forest.thresholds),
                                      max_depth=4))
    got = FO.forest_apply(FO.TreeArrays(*(_t(a) for a in trees)), _t(x),
                          _t(jax_forest.thresholds.astype(np.float64)), max_depth=4)
    np.testing.assert_array_equal(got.numpy(), ref)
    edges = JF.quantile_bin_edges(x, 16, 2)
    binned = JF.bin_features(x, edges)
    one = JFO.TreeArrays(*(a[1] for a in trees))
    ref = np.asarray(JFO.tree_apply_binned(JFO.TreeArrays(*(jnp.asarray(a) for a in one)),
                                           jnp.asarray(binned), max_depth=4))
    got = FO.tree_apply_binned(FO.TreeArrays(*(_t(a) for a in one)), _t(binned.T), max_depth=4)
    np.testing.assert_array_equal(got.numpy(), ref)


# -- whole fits --------------------------------------------------------------


CASES = [
    ("RandomForestClassifier", dict(numTrees=3, featureSubsetStrategy="all")),
    ("RandomForestClassifier", dict(numTrees=2, featureSubsetStrategy="all",
                                    bootstrap=False, subsamplingRate=0.6, impurity="entropy")),
    ("RandomForestRegressor", dict(numTrees=3, featureSubsetStrategy="all")),
    ("DecisionTreeClassifier", dict(minInstancesPerNode=5)),
    ("DecisionTreeRegressor", dict(minInfoGain=0.01)),
]


@pytest.mark.parametrize("name,params", CASES)
def test_fit_with_all_features_equals_jax(data, name, params):
    x, y_cls, y_reg = data
    y = y_reg if "Regressor" in name else y_cls
    w = np.random.default_rng(3).uniform(0.5, 2.0, len(x))
    for weights in (None, w):
        arg = (x, y) if weights is None else (x, y, weights)
        ref = getattr(JF, name)(maxDepth=4, maxBins=16, **params).fit(arg)
        got = getattr(PF, name)(device=CPU, maxDepth=4, maxBins=16, **params).fit(arg)
        for field in ("feature", "split_bin", "is_leaf", "leaf_stats"):
            np.testing.assert_array_equal(getattr(got.trees, field), getattr(ref.trees, field))
        # a gain is imp(parent) − imp(left) − imp(right) of n-scaled f32
        # impurities: its last bits are those of the root's impurity scale
        scale = np.abs(ref.trees.gain).max()
        np.testing.assert_allclose(got.trees.gain, ref.trees.gain, rtol=1e-6, atol=1e-6 * scale)
        np.testing.assert_array_equal(got.thresholds, ref.thresholds)
        np.testing.assert_array_equal(got._predict_matrix(x), ref._predict_matrix(x))
        # importances are normalized gains, so they carry the gains' bound
        np.testing.assert_allclose(got.featureImportances, ref.featureImportances, atol=1e-6)
        assert got.totalNumNodes == ref.totalNumNodes


def test_sqrt_forests_by_their_properties():
    """One 30-tree forest's held-out accuracy moves by about ±0.015 from
    seed to seed on these rows, so the packages are compared by their mean
    over four seeds each."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(10_000, 8)).astype(np.float32)
    y = ((x[:, 0] * x[:, 1] + x[:, 2]) > 0).astype(np.float64)
    train, test = slice(0, 6000), slice(6000, None)
    est = RandomForestClassifier(device=CPU, numTrees=30, maxDepth=6, seed=0)
    a = est.fit((x[train], y[train]))
    b = est.fit((x[train], y[train]))
    for p, q in zip(a.trees, b.trees):
        np.testing.assert_array_equal(p, q)
    # each node draws its own subset: the splits use many features
    assert len(np.unique(a.trees.feature[a.trees.feature >= 0])) > 3

    def accuracy(model):
        return np.mean(model._predict_matrix(x[test]) == y[test])

    acc = np.mean([accuracy(RandomForestClassifier(
        device=CPU, numTrees=30, maxDepth=6, seed=s).fit((x[train], y[train])))
        for s in range(4)])
    ref_acc = np.mean([accuracy(JF.RandomForestClassifier(
        numTrees=30, maxDepth=6, seed=s).fit((x[train], y[train]))) for s in range(4)])
    assert abs(acc - ref_acc) <= 0.02, (acc, ref_acc)


def test_classifier_transform_columns_match_jax(data, jax_forest):
    import pandas as pd

    x, y, _ = data
    port = model_from_arrays("RandomForestClassificationModel", jax_forest._saveData(),
                             device="cpu", params=dict(jax_forest._paramMap))
    df = pd.DataFrame({"features": list(x[:50]), "label": y[:50]})
    got, ref = port.transform(df), jax_forest.transform(df)
    for col in ("rawPrediction", "probability", "prediction"):
        np.testing.assert_allclose(np.stack(got[col]), np.stack(ref[col]), rtol=1e-6)
    assert port.numClasses == 2 and port.getNumTrees() == 4


def test_labels_must_be_class_indices(data):
    x, _, y_reg = data
    with pytest.raises(ValueError, match="non-negative integers"):
        RandomForestClassifier(device=CPU).fit((x, y_reg))


@pytest.mark.parametrize("setter,bad", [("setNumTrees", 0), ("setMaxDepth", 15),
                                        ("setMaxBins", 1), ("setMinInstancesPerNode", 0.5),
                                        ("setSubsamplingRate", 0.0), ("setImpurity", "variance")])
def test_param_checks_match_jax(setter, bad):
    with pytest.raises(ValueError):
        getattr(RandomForestClassifier(device=CPU), setter)(bad)
    with pytest.raises(ValueError):
        getattr(JF.RandomForestClassifier(), setter)(bad)


def test_decision_trees(data):
    x, y, y_reg = data
    with pytest.raises(AttributeError):
        DecisionTreeClassifier(device=CPU).setNumTrees(3)
    clf = DecisionTreeClassifier(device=CPU, maxDepth=3).fit((x, y))
    ref = JF.DecisionTreeClassifier(maxDepth=3).fit((x, y))
    assert isinstance(clf, DecisionTreeClassificationModel) and clf.depth == ref.depth == 3
    reg = DecisionTreeRegressor(device=CPU, maxDepth=2).fit((x, y_reg))
    assert isinstance(reg, DecisionTreeRegressionModel) and reg.depth == 2
    np.testing.assert_allclose(reg._predict_matrix(x),
                               JF.DecisionTreeRegressor(maxDepth=2).fit((x, y_reg))
                               ._predict_matrix(x), rtol=1e-6)


# -- persistence -------------------------------------------------------------


def test_jax_saves_load_in_the_port(data, jax_forest, tmp_path):
    x, y, _ = data
    jax_forest.save(str(tmp_path / "f"))
    port = Saveable.load(str(tmp_path / "f"), device="cpu")
    assert type(port) is RandomForestClassificationModel
    np.testing.assert_array_equal(port._predict_matrix(x), jax_forest._predict_matrix(x))
    tree = JF.DecisionTreeClassifier(maxDepth=2).fit((x, y))
    tree.save(str(tmp_path / "t"))
    assert type(Saveable.load(str(tmp_path / "t"), device="cpu")) is \
        DecisionTreeClassificationModel
    with pytest.raises(TypeError, match="exactly"):
        DecisionTreeClassificationModel.load(str(tmp_path / "f"), device="cpu")


def test_port_saves_cross_as_arrays(data, tmp_path):
    x, _, y_reg = data
    model = RandomForestRegressor(device=CPU, numTrees=2, maxDepth=3).fit((x, y_reg))
    model.save(str(tmp_path / "r"))
    loaded = Saveable.load(str(tmp_path / "r"), device="cpu")
    np.testing.assert_array_equal(loaded._predict_matrix(x), model._predict_matrix(x))
    arrays = jax_persistence.load_arrays(str(tmp_path / "r"))
    jm = JF.RandomForestRegressionModel._fromSaved("r", arrays)
    np.testing.assert_allclose(jm._predict_matrix(x), model._predict_matrix(x), rtol=1e-6)


# -- the servable ------------------------------------------------------------


def test_forest_servable_is_the_eager_prediction(data, jax_forest):
    x, _, _ = data
    port = model_from_arrays("RandomForestClassificationModel", jax_forest._saveData(),
                             device="cpu")
    reg = registry_mod.ModelRegistry(device="cpu")
    entry = reg.register("f", port)
    assert entry.family == "forest" and "forest" in registry_mod.FAMILIES
    for rows in (1, 7, 64):
        got = reg.predict("f", x[:rows])
        np.testing.assert_array_equal(got, port._predict_matrix(x[:rows]))
        np.testing.assert_array_equal(got, jax_forest._predict_matrix(x[:rows]))
    # the JAX package's forest servable answers alike
    from spark_rapids_ml_tpu.serving import registry as jregistry

    try:
        jreg = jregistry.get_registry()
        jreg.register("f", jax_forest, bucket_list=(8,))
        np.testing.assert_array_equal(jreg.predict("f", x[:5]), reg.predict("f", x[:5]))
    finally:
        jregistry.reset_for_tests()


def test_regressor_has_no_serve_contract(data):
    x, _, y_reg = data
    model = RandomForestRegressor(device=CPU, numTrees=1, maxDepth=1).fit((x, y_reg))
    with pytest.raises(TypeError, match="no serve contract"):
        registry_mod.ModelRegistry(device="cpu").register("r", model)


@pytest.mark.cuda
def test_forest_graph_replay_matches_eager_at_every_rung(data, jax_forest, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the registry captures CUDA graphs only there")
    monkeypatch.setenv("TPU_ML_SERVE_MAX_BATCH_ROWS", "4096")
    port = model_from_arrays("RandomForestClassificationModel", jax_forest._saveData(),
                             device="cuda")
    reg = registry_mod.ModelRegistry(device="cuda")
    entry = reg.register("f", port)
    rng = np.random.default_rng(5)
    for b in buckets.bucket_ladder():
        padded = rng.normal(size=(b, x_cols(data))).astype(np.float32)
        served = reg.dispatch_padded(entry, padded, b)
        eager = entry.kernel(entry.params, torch.from_numpy(padded).cuda()).cpu().numpy()
        assert np.array_equal(served, eager), b


def x_cols(data):
    return data[0].shape[1]
