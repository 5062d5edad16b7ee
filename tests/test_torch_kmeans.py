"""The port's KMeans against the JAX package's, op by op and fit by fit.

Both packages get the same f32 rows, made from a numpy seed; the port runs
with device="cpu". Tolerances, each stated where it is used:

- ``pairwise_sq_dists``: atol 1e-5·max(‖x‖² + ‖c‖²) under each policy (the
  two backends sum the f32 cross term in different orders);
- ``assign_clusters`` on separated blobs: labels exactly equal;
- ``kmeans_stats`` from the same centres, weighted and padded: counts
  exactly equal, sums and cost rtol 1e-5;
- ``int8_quantized_matmul``: the int8 operands and the int32 accumulator
  exactly equal to numpy's, the result rtol 1e-6 of the JAX package's;
- whole fits with ``initMode="random"`` (both packages draw the start from
  numpy, so it is the same): centres rtol 1e-4, transform labels equal,
  trainingCost rtol 1e-5;
- ``k-means++``/``k-means||`` draw from a torch generator, so they are held
  by their properties: k distinct data rows, zero-weight rows never seed,
  the same seed gives the same centres, and the final cost within 1.05× of
  the JAX package's fit on the same blobs.
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_ml_tpu.models.kmeans import KMeans as JaxKMeans
from spark_rapids_ml_tpu.models.kmeans import KMeansModel as JaxKMeansModel
from spark_rapids_ml_tpu.ops import kmeans as JKM
from spark_rapids_ml_tpu.ops import linalg as JL
from spark_rapids_ml_tpu_torch import KMeans, KMeansModel
from spark_rapids_ml_tpu_torch import clustering
from spark_rapids_ml_tpu_torch.convert import model_from_arrays
from spark_rapids_ml_tpu_torch.models.base import Saveable
from spark_rapids_ml_tpu_torch.ops import kmeans as KM
from spark_rapids_ml_tpu_torch.ops import linalg as L

CPU = torch.device("cpu")
POLICIES = ("f32", "bf16_f32acc", "int8_dist")


def _blobs(rows=600, n=8, k=4, seed=3, spread=0.4):
    rng = np.random.default_rng(seed)
    centers = (rng.normal(size=(k, n)) * 5.0).astype(np.float32)
    labels = rng.integers(0, k, rows)
    x = (centers[labels] + spread * rng.normal(size=(rows, n))).astype(np.float32)
    return x, centers, labels


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("policy", POLICIES)
def test_pairwise_sq_dists_match_jax(policy):
    x, centers, _ = _blobs()
    c = centers + 0.3
    got = KM.pairwise_sq_dists(_t(x), _t(c), policy=policy).numpy()
    ref = np.asarray(JKM.pairwise_sq_dists(jnp.asarray(x), jnp.asarray(c), policy=policy))
    scale = float((x * x).sum(1).max() + (c * c).sum(1).max())
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * scale)
    assert (got >= 0).all()


def test_assign_clusters_labels_equal_on_blobs():
    x, centers, truth = _blobs()
    labels, dists = KM.assign_clusters(_t(x), _t(centers))
    ref_labels, ref_dists = JKM.assign_clusters(jnp.asarray(x), jnp.asarray(centers))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref_labels))
    np.testing.assert_array_equal(labels.numpy(), truth)
    scale = float((x * x).sum(1).max() + (centers * centers).sum(1).max())
    np.testing.assert_allclose(dists.numpy(), np.asarray(ref_dists), rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("policy", POLICIES)
def test_min_sq_dists_match_jax(policy):
    x, centers, _ = _blobs()
    got = KM.min_sq_dists(_t(x), _t(centers), policy=policy).numpy()
    ref = np.asarray(JKM.min_sq_dists(jnp.asarray(x), jnp.asarray(centers), policy=policy))
    scale = float((x * x).sum(1).max() + (centers * centers).sum(1).max())
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("block_rows", [8192, 64, 100])
def test_assign_blocks_equals_one_block(block_rows):
    x, centers, _ = _blobs()
    labels, dists = KM.assign_blocks(_t(x), _t(centers), block_rows=block_rows)
    one_l, one_d = KM.assign_clusters(_t(x), _t(centers))
    np.testing.assert_array_equal(labels.numpy(), one_l.numpy())
    np.testing.assert_array_equal(dists.numpy(), one_d.numpy())
    assert labels.dtype == torch.int32


@pytest.mark.parametrize("block_rows", [8192, 128, 100])
def test_kmeans_stats_match_jax_weighted_and_padded(block_rows):
    x, centers, _ = _blobs()
    rng = np.random.default_rng(9)
    w = rng.choice([0.5, 1.0, 2.0], size=len(x)).astype(np.float32)
    # 40 padding rows at weight 0, far from every centre
    xp = np.concatenate([x, np.full((40, x.shape[1]), 50.0, np.float32)])
    wp = np.concatenate([w, np.zeros(40, np.float32)])
    c = centers + 0.2
    got = KM.kmeans_stats(_t(xp), _t(c), _t(wp), block_rows=block_rows)
    ref = JKM.kmeans_stats(jnp.asarray(xp), jnp.asarray(c), jnp.asarray(wp))
    # counts exactly equal (dyadic weights sum exactly); sums and cost rtol 1e-5
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(ref.counts))
    np.testing.assert_allclose(got.sums.numpy(), np.asarray(ref.sums), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(got.cost), float(ref.cost), rtol=1e-5)


@pytest.mark.parametrize("policy", POLICIES)
def test_kmeans_stats_policies_match_jax(policy):
    x, centers, _ = _blobs()
    got = KM.kmeans_stats(_t(x), _t(centers + 0.1), policy=policy)
    ref = JKM.kmeans_stats(jnp.asarray(x), jnp.asarray(centers + 0.1), policy=policy)
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(ref.counts))
    np.testing.assert_allclose(got.sums.numpy(), np.asarray(ref.sums), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(got.cost), float(ref.cost), rtol=1e-5)


def _near_tie_bound(n):
    """``chip_smoke.f32_dist_error_bound``: |f32 − exact| of one expanded
    squared distance, relative to ‖x‖² + ‖c‖²; two distances whose gap is
    under twice this can rank either way in f32."""
    return 2.0 * (n + 2) * 2.0**-24


def _policy_dists_f64(x, c, policy):
    """([rows, k] squared distances in f64 from the cross term each policy
    ranks by, its operands rounded as the policy rounds them, clamped at 0;
    [rows] ‖x‖² + max ‖c‖², the scale of their f32 error)."""
    x64, c64 = x.double(), c.double()
    if policy == "int8_dist":
        (qx, sx), (qc, sc) = L.quantize_int8(x), L.quantize_int8(c.T)
        cross = (qx.double() @ qc.double()) * (float(sx) * float(sc))
    elif policy == "bf16_f32acc":
        cross = x.to(torch.bfloat16).double() @ c.to(torch.bfloat16).double().T
    else:
        cross = x64 @ c64.T
    x_sq, c_sq = (x64 * x64).sum(1), (c64 * c64).sum(1)
    return (x_sq[:, None] + c_sq[None, :] - 2.0 * cross).clamp(min=0.0), x_sq + c_sq.max()


@pytest.mark.parametrize("policy", POLICIES)
def test_argmin_path_labels_equal_full_tile_but_near_ties(policy):
    """The argmin of ‖c‖² − 2·x·cᵀ against the argmin over the whole
    distance tile: the labels differ only on rows whose two best distances
    (in f64, from the policy's cross term) lie within twice the f32 near-tie
    bound of ‖x‖² + ‖c‖²; the minima agree within 1e-5 of that scale."""
    x, centers, _ = _blobs(rows=2000, n=16, k=12, seed=5)
    xt, ct = _t(x), _t(centers + 0.3)
    labels, dists = KM.assign_clusters(xt, ct, policy=policy)
    ref_d, ref_l = torch.min(KM.pairwise_sq_dists(xt, ct, policy=policy), dim=1)
    d64, scale = _policy_dists_f64(xt, ct, policy)
    top = torch.topk(d64, 2, dim=1, largest=False).values
    near = (top[:, 1] - top[:, 0]) < 2.0 * _near_tie_bound(x.shape[1]) * scale
    assert not ((labels != ref_l) & ~near).any()
    assert labels.dtype == ref_l.dtype
    scale = float((x * x).sum(1).max() + (ct * ct).sum(1).max())
    np.testing.assert_allclose(dists.numpy(), ref_d.numpy(), rtol=0, atol=1e-5 * scale)
    assert (dists >= 0).all()


@pytest.mark.parametrize("policy", POLICIES)
def test_duplicate_centres_pick_the_lower_index(policy):
    x, centers, truth = _blobs(rows=300, k=3)
    # centres 0, 1, 2 planted again at 3, 4 and 5: every row ties exactly
    dup = np.concatenate([centers, centers])
    labels, _ = KM.assign_clusters(_t(x), _t(dup), policy=policy)
    assert int(labels.max()) < 3
    np.testing.assert_array_equal(labels.numpy(), truth)
    labels, _ = KM.assign_blocks(_t(x), _t(dup[::-1].copy()), block_rows=64, policy=policy)
    np.testing.assert_array_equal(labels.numpy(), 2 - truth)


@pytest.mark.parametrize("policy", POLICIES)
def test_row_on_a_centre_reads_zero_and_that_label(policy):
    """Integer coordinates in [−127, 127] with 127 reached make every
    product exact under each policy (bf16 holds them, the int8 scale is 1),
    so a row equal to a centre is at distance 0 exactly."""
    rng = np.random.default_rng(13)
    centers = rng.integers(-127, 128, size=(6, 8)).astype(np.float32)
    centers[0, 0] = 127.0
    x = rng.integers(-127, 128, size=(50, 8)).astype(np.float32)
    x[0, 0] = -127.0
    on = [7, 21, 40]
    x[on] = centers[[4, 1, 5]]
    labels, dists = KM.assign_clusters(_t(x), _t(centers), policy=policy)
    np.testing.assert_array_equal(labels.numpy()[on], [4, 1, 5])
    np.testing.assert_array_equal(dists.numpy()[on], 0.0)
    exact = ((x[:, None, :].astype(np.float64) - centers[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(dists.numpy(), exact.min(1))


def test_assign_blocks_counter_books_one_per_block():
    from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY

    def booked(policy):
        return REGISTRY.snapshot().counter("kmeans.assign.blocks", policy=policy)

    x, centers, _ = _blobs(rows=600)
    before = booked("f32")
    KM.assign_blocks(_t(x), _t(centers), block_rows=64)
    assert booked("f32") - before == -(-600 // 64)
    before = booked("int8_dist")
    KM.kmeans_stats(_t(x), _t(centers), block_rows=128, policy="int8_dist")
    assert booked("int8_dist") - before == -(-600 // 128)


def test_update_centers_empty_cluster_keeps_old_and_shift():
    old = np.arange(12, dtype=np.float32).reshape(3, 4)
    sums = np.ones((3, 4), np.float32) * np.array([[2.0], [0.0], [9.0]], np.float32)
    counts = np.array([2.0, 0.0, 3.0], np.float32)
    cost = np.float32(1.0)
    got = KM.update_centers(KM.KMeansStats(_t(sums), _t(counts), torch.tensor(cost)), _t(old))
    ref = JKM.update_centers(
        JKM.KMeansStats(jnp.asarray(sums), jnp.asarray(counts), jnp.asarray(cost)),
        jnp.asarray(old),
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy()[1], old[1])
    shift = KM.center_shift_sq(_t(old), got)
    ref_shift = JKM.center_shift_sq(jnp.asarray(old), ref)
    assert float(shift) == pytest.approx(float(ref_shift), rel=1e-6)


def test_combine_kmeans_stats_sums_fields():
    a = KM.KMeansStats(torch.ones(2, 3), torch.ones(2), torch.tensor(1.0))
    b = KM.combine_kmeans_stats(a, a)
    assert float(b.cost) == 2.0 and b.sums.sum() == 12 and b.counts.tolist() == [2.0, 2.0]


def _np_quantize(t):
    amax = np.float32(np.abs(t).max())
    scale = np.float32(amax / np.float32(127.0)) if amax > 0 else np.float32(1.0)
    return np.clip(np.round(t / scale), -127, 127).astype(np.int8), scale


@pytest.mark.parametrize("shape", [(40, 16, 8), (5, 7, 3), (33, 128, 10)])
def test_int8_quantized_matmul_exact_accumulator(shape):
    m, kk, n = shape
    rng = np.random.default_rng(m + kk + n)
    a = rng.normal(size=(m, kk)).astype(np.float32)
    b = rng.normal(size=(kk, n)).astype(np.float32)
    qa, sa = L.quantize_int8(_t(a))
    qb, sb = L.quantize_int8(_t(b))
    na, nsa = _np_quantize(a)
    nb, nsb = _np_quantize(b)
    np.testing.assert_array_equal(qa.numpy(), na)
    np.testing.assert_array_equal(qb.numpy(), nb)
    assert float(sa) == float(nsa) and float(sb) == float(nsb)
    acc = L.int8_matmul(qa, qb)
    assert acc.dtype == torch.int32
    # the int32 accumulator: exactly the integer product
    np.testing.assert_array_equal(acc.numpy(), na.astype(np.int64) @ nb.astype(np.int64))
    got = L.int8_quantized_matmul(_t(a), _t(b)).numpy()
    ref = np.asarray(JL.int8_quantized_matmul(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_int8_quantized_matmul_of_zeros():
    z = torch.zeros(20, 8)
    assert torch.equal(L.int8_quantized_matmul(z, z.T), torch.zeros(20, 20))


def _container(x, kind, weights=None):
    if kind == "ndarray":
        return x
    cols = {"features": list(x)}
    if weights is not None:
        cols["w"] = weights
    if kind == "pandas":
        return pd.DataFrame(cols)
    out = {"features": pa.FixedSizeListArray.from_arrays(pa.array(x.reshape(-1)), x.shape[1])}
    if weights is not None:
        out["w"] = pa.array(weights)
    return pa.table(out)


def _labels_of(out, kind):
    if kind == "ndarray":
        return np.asarray(out)
    if kind == "pandas":
        return np.asarray(out["prediction"])
    return out.column("prediction").to_numpy()


@pytest.mark.parametrize("kind", ["ndarray", "pandas", "arrow"])
@pytest.mark.parametrize("partitions", [1, 3])
def test_random_init_fit_matches_jax(kind, partitions):
    x, _, _ = _blobs(rows=900, k=5)
    data = _container(x, kind)
    kw = dict(k=5, seed=11, initMode="random", maxIter=15)
    port = KMeans(device=CPU, **kw)
    ref = JaxKMeans(**kw)
    if kind != "ndarray":
        port.setInputCol("features")
        ref.setInputCol("features")
    pm = port.fit(data, num_partitions=partitions)
    rm = ref.fit(data, num_partitions=partitions)
    # centres rtol 1e-4; labels equal; trainingCost rtol 1e-5
    np.testing.assert_allclose(pm.clusterCenters, rm.clusterCenters, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(
        _labels_of(pm.transform(data), kind), _labels_of(rm.transform(data), kind)
    )
    assert pm.trainingCost == pytest.approx(rm.trainingCost, rel=1e-5)
    assert pm.computeCost(data) == pytest.approx(rm.computeCost(data), rel=1e-5)
    row = x[17]
    assert pm.predict(row) == rm.predict(row)


@pytest.mark.parametrize("mode", ["k-means++", "k-means||"])
def test_seeding_properties(mode):
    x, _, _ = _blobs(rows=1200, k=8, seed=5)
    est = KMeans(device=CPU, k=8, seed=4, initMode=mode)
    mats = [x[:500], x[500:]]
    parts = [(_t(m), torch.ones(len(m)), len(m)) for m in mats]
    c1 = est._init_centers(mats, 8, None, parts).numpy()
    c2 = est._init_centers(mats, 8, None, parts).numpy()
    np.testing.assert_array_equal(c1, c2)  # the same seed, the same centres
    assert len({tuple(r) for r in c1}) == 8  # k distinct rows ...
    rows = {tuple(r) for r in x}
    assert all(tuple(r) in rows for r in c1)  # ... of the data
    other = KMeans(device=CPU, k=8, seed=5, initMode=mode)._init_centers(mats, 8, None, parts)
    assert not np.array_equal(other.numpy(), c1)


@pytest.mark.parametrize("mode", ["k-means++", "k-means||"])
def test_seeded_fit_cost_within_5_percent_of_jax(mode):
    x, _, _ = _blobs(rows=1500, k=10, seed=8, spread=1.0)
    port = KMeans(device=CPU, k=10, seed=2, initMode=mode).fit(x, num_partitions=2)
    ref = JaxKMeans(k=10, seed=2, initMode=mode).fit(x, num_partitions=2)
    assert port.trainingCost <= 1.05 * ref.trainingCost
    assert port.clusterCenters.shape == (10, x.shape[1])


@pytest.mark.parametrize("mode", ["k-means++", "k-means||", "random"])
def test_zero_weight_rows_never_seed(mode):
    x, _, _ = _blobs(rows=400, k=4, seed=6)
    w = np.ones(len(x))
    w[::2] = 0.0  # every other row excluded
    est = KMeans(device=CPU, k=4, seed=1, initMode=mode)
    mats = [x]
    parts = [(_t(x), _t(w.astype(np.float32)), len(x))]
    centers = est._init_centers(mats, 4, [w], parts).numpy()
    excluded = {tuple(r) for r in x[::2]}
    assert not any(tuple(r) in excluded for r in centers)


def test_parallel_init_tops_up_on_tiny_data():
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    est = KMeans(device=CPU, k=5, seed=0, initMode="k-means||", initSteps=1)
    c = est._init_centers([x], 5, None, [(_t(x), torch.ones(6), 6)])
    assert c.shape == (5, 2)
    assert len({tuple(r) for r in c.numpy()}) == 5


def test_weighted_plus_plus_respects_weights():
    x = np.array([[0.0, 0.0], [10.0, 0.0], [0.0, 10.0], [10.0, 10.0]], np.float32)
    w = torch.tensor([0.0, 1.0, 0.0, 1.0])
    for seed in range(5):
        gen = torch.Generator().manual_seed(seed)
        c = KM.weighted_kmeans_plus_plus_init(gen, _t(x), w, 2).numpy()
        assert {tuple(r) for r in c} == {(10.0, 0.0), (10.0, 10.0)}


def test_sample_weight_matches_jax():
    x, _, _ = _blobs(rows=700, k=4, seed=12)
    rng = np.random.default_rng(2)
    w = rng.choice([0.0, 0.5, 1.0, 3.0], size=len(x))
    kw = dict(k=4, seed=3, initMode="random", maxIter=10)
    pm = KMeans(device=CPU, **kw).fit(x, sample_weight=w)
    rm = JaxKMeans(**kw).fit(x, sample_weight=w)
    np.testing.assert_allclose(pm.clusterCenters, rm.clusterCenters, rtol=1e-4, atol=1e-5)
    assert pm.trainingCost == pytest.approx(rm.trainingCost, rel=1e-5)


@pytest.mark.parametrize("kind", ["pandas", "arrow"])
def test_weight_col_matches_sample_weight(kind):
    x, _, _ = _blobs(rows=500, k=3, seed=13)
    w = np.random.default_rng(4).choice([0.5, 1.0, 2.0], size=len(x))
    kw = dict(k=3, seed=3, initMode="random", maxIter=10)
    by_col = KMeans(device=CPU, inputCol="features", weightCol="w", **kw).fit(
        _container(x, kind, w)
    )
    ref = JaxKMeans(inputCol="features", weightCol="w", **kw).fit(_container(x, kind, w))
    by_arg = KMeans(device=CPU, **kw).fit(x, sample_weight=w)
    np.testing.assert_array_equal(by_col.clusterCenters, by_arg.clusterCenters)
    np.testing.assert_allclose(by_col.clusterCenters, ref.clusterCenters, rtol=1e-4, atol=1e-5)


def test_weights_are_validated():
    x, _, _ = _blobs(rows=50)
    with pytest.raises(ValueError, match="non-negative"):
        KMeans(device=CPU, k=2).fit(x, sample_weight=-np.ones(50))
    with pytest.raises(ValueError, match="all instance weights are zero"):
        KMeans(device=CPU, k=2).fit(x, sample_weight=np.zeros(50))
    with pytest.raises(ValueError, match="rows but weights"):
        KMeans(device=CPU, k=2).fit(x, sample_weight=np.ones(49))


def test_params_defaults_and_validation_match_jax():
    port, ref = KMeans(device=CPU), JaxKMeans()
    for name in ("maxIter", "tol", "seed", "initMode", "initSteps", "outputCol"):
        assert port.getOrDefault(name) == ref.getOrDefault(name)
    with pytest.raises(ValueError, match="initMode"):
        KMeans(device=CPU).setInitMode("bogus")
    with pytest.raises(ValueError, match="initSteps"):
        KMeans(device=CPU).setInitSteps(0)
    with pytest.raises(ValueError, match="checkpoint_every"):
        KMeans(device=CPU, k=2).fit(np.zeros((4, 2), np.float32), checkpoint_every=0)
    assert clustering.KMeans is KMeans


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KMeans(k=2)


def test_policy_from_environment_reaches_the_lloyd_pass(monkeypatch):
    x, _, _ = _blobs(rows=600, k=4)
    seen = []
    real = KM.kmeans_stats

    def spy(*args, **kwargs):
        seen.append(kwargs["policy"])
        return real(*args, **kwargs)

    monkeypatch.setattr(KM, "kmeans_stats", spy)
    monkeypatch.setenv("TPU_ML_PRECISION_POLICY", "int8_dist")
    port = KMeans(device=CPU, k=4, seed=1, initMode="random", maxIter=3).fit(x)
    ref = JaxKMeans(k=4, seed=1, initMode="random", maxIter=3).fit(x)
    assert set(seen) == {"int8_dist"}
    np.testing.assert_allclose(port.clusterCenters, ref.clusterCenters, rtol=1e-4, atol=1e-5)


def test_fit_and_transform_reports_book_the_spans():
    x, _, _ = _blobs()
    model = KMeans(device=CPU, k=4, seed=0).fit(x)
    assert {"kmeans init", "kmeans lloyd"} <= set(model.fit_report.phases)
    assert model.fit_report.estimator == "KMeans"
    model.transform(x)
    assert "kmeans transform" in model.transform_report.phases


def test_native_save_load_round_trip(tmp_path):
    x, _, _ = _blobs()
    model = KMeans(device=CPU, k=4, seed=0, initMode="random").fit(x)
    model.save(str(tmp_path / "m"))
    back = KMeansModel.load(str(tmp_path / "m"), device="cpu")
    np.testing.assert_array_equal(back.clusterCenters, model.clusterCenters)
    assert back.trainingCost == model.trainingCost and back.getK() == 4
    np.testing.assert_array_equal(back.transform(x), model.transform(x))


def test_models_cross_between_packages(tmp_path):
    x, _, _ = _blobs()
    ref = JaxKMeans(k=4, seed=0, initMode="random").fit(x)
    # a JAX-package save loads in the port
    ref.save(str(tmp_path / "jax"))
    loaded = Saveable.load(str(tmp_path / "jax"), device="cpu")
    assert isinstance(loaded, KMeansModel)
    np.testing.assert_array_equal(loaded.clusterCenters, ref.clusterCenters)
    np.testing.assert_array_equal(loaded.transform(x), np.asarray(ref.transform(x)))
    # the JAX model's arrays in, the port's arrays out to the JAX package
    conv = model_from_arrays("KMeansModel", ref._saveData(), "cpu", {"k": 4})
    np.testing.assert_array_equal(conv.clusterCenters, ref.clusterCenters)
    back = JaxKMeansModel._fromSaved(None, conv._saveData())
    np.testing.assert_array_equal(np.asarray(back.transform(x)), conv.transform(x))
