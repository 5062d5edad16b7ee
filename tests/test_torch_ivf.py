"""The port's IVF packing and search (``ops/ivf.py``) against the JAX
package's.

Both packages get the same f32 rows, made from a numpy seed, at unit scale
(the f32 expansion ‖q‖² + ‖x‖² − 2q·x then loses little to cancellation);
the port runs on CPU tensors. Tolerances:

- ``bucket_cap`` and ``build_ivf_buckets`` (host numpy in both): every
  array exactly equal, with and without spill;
- ``ivf_search`` on one index built by the JAX package: ids exactly equal,
  scores rtol 1e-5 under ``f32``; under ``bf16_f32acc`` and ``int8_dist``
  the tolerances of ``tests/test_ivf.py``: rtol and atol·max|score| 1e-2
  and 5e-2 against the JAX package's f32 search, neighbour overlap ≥ 0.95;
- the int8 batched cross term exactly equal to numpy's int32 einsum, for
  a width under and a width over 1,040 (where the f32 product is split);
- with ``nprobe == nlist``, ids exactly equal to the port's ``knn_topk``
  and scores within rtol 1e-5.
"""

import jax  # noqa: F401  (imported at the top of every port test file)
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.ops import ivf as JIVF
from spark_rapids_ml_tpu_torch.ops import ivf as IVF
from spark_rapids_ml_tpu_torch.ops import linalg as L
from spark_rapids_ml_tpu_torch.ops import neighbors as NN


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def index():
    """A JAX-built index over 2,000 unit-scale rows in 16 lists, with a
    spill list (cap at the 80th percentile)."""
    rng = np.random.default_rng(11)
    items = rng.normal(size=(2000, 16)).astype(np.float32)
    queries = rng.normal(size=(300, 16)).astype(np.float32)
    centroids = items[rng.choice(2000, 16, replace=False)]
    labels = np.argmin(((items[:, None, :] - centroids[None]) ** 2).sum(-1), axis=1)
    packed = JIVF.build_ivf_buckets(items, labels, 16, cap_percentile=80.0)
    assert packed.spill_ids.size > 0
    return items, queries, centroids, packed


def _search(pkg, queries, centroids, packed, k, nprobe, policy="f32"):
    if pkg == "jax":
        s, i = JIVF.ivf_search(
            queries, centroids, packed.bucket_items, packed.bucket_ids, k, nprobe,
            spill_items=packed.spill_items, spill_ids=packed.spill_ids, policy=policy,
        )
        return np.asarray(s), np.asarray(i)
    s, i = IVF.ivf_search(
        _t(queries), _t(centroids), _t(packed.bucket_items), _t(packed.bucket_ids), k, nprobe,
        spill_items=_t(packed.spill_items), spill_ids=_t(packed.spill_ids), policy=policy,
    )
    return s.numpy(), i.numpy()


@pytest.mark.parametrize("percentile", [100.0, 99.0, 50.0, 12.5])
def test_bucket_cap_equals_jax(percentile):
    counts = np.random.default_rng(1).integers(0, 300, 40)
    assert IVF.bucket_cap(counts, percentile) == JIVF.bucket_cap(counts, percentile)


@pytest.mark.parametrize("bad", [0.0, -1.0, 100.5])
def test_bucket_cap_refuses_what_jax_refuses(bad):
    with pytest.raises(ValueError, match="cap_percentile"):
        IVF.bucket_cap(np.ones(4, int), bad)
    with pytest.raises(ValueError, match="cap_percentile"):
        JIVF.bucket_cap(np.ones(4, int), bad)


@pytest.mark.parametrize("percentile", [100.0, 90.0, 40.0])
def test_build_ivf_buckets_equals_jax(percentile):
    rng = np.random.default_rng(5)
    items = rng.normal(size=(700, 9)).astype(np.float32)
    # a skewed label histogram: one hot list
    labels = np.where(rng.random(700) < 0.3, 3, rng.integers(0, 12, 700))
    got = IVF.build_ivf_buckets(items, labels, 12, cap_percentile=percentile)
    ref = JIVF.build_ivf_buckets(items, labels, 12, cap_percentile=percentile)
    assert got.cap == ref.cap
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    spilled = int((got.spill_ids >= 0).sum())
    assert got.spill_ids.size == IVF.spill_pad_rows(spilled)
    assert (percentile == 100.0) == (spilled == 0)


def test_cap_percentile_knob_is_read_leniently(monkeypatch):
    rng = np.random.default_rng(2)
    items = rng.normal(size=(300, 4)).astype(np.float32)
    labels = rng.integers(0, 5, 300)
    monkeypatch.setenv("TPU_ML_ANN_CAP_PERCENTILE", "50")
    assert IVF.default_cap_percentile() == 50.0
    assert IVF.build_ivf_buckets(items, labels, 5).cap == JIVF.build_ivf_buckets(
        items, labels, 5).cap
    monkeypatch.setenv("TPU_ML_ANN_CAP_PERCENTILE", "not-a-number")
    assert IVF.default_cap_percentile() == 99.0


@pytest.mark.parametrize("k,nprobe", [(8, 1), (8, 4), (10, 16), (3, 7)])
def test_ivf_search_equals_jax_f32(index, k, nprobe):
    _, queries, centroids, packed = index
    gs, gi = _search("port", queries, centroids, packed, k, nprobe)
    rs, ri = _search("jax", queries, centroids, packed, k, nprobe)
    np.testing.assert_array_equal(gi, ri)
    np.testing.assert_allclose(gs, rs, rtol=1e-5)


@pytest.mark.parametrize("policy,tol", [("bf16_f32acc", 1e-2), ("int8_dist", 5e-2)])
def test_ivf_search_policies_within_the_jax_tolerances(index, policy, tol):
    _, queries, centroids, packed = index
    k, nlist = 8, 16
    ds, di = _search("port", queries, centroids, packed, k, nlist, policy)
    fs, fi = _search("jax", queries, centroids, packed, k, nlist)
    scale = np.abs(fs).max()
    np.testing.assert_allclose(ds, fs, rtol=tol, atol=tol * scale)
    overlap = np.mean([len(set(a) & set(b)) / k for a, b in zip(di, fi)])
    assert overlap >= 0.95, overlap
    # and the JAX package's own quantized search, within the same tolerance
    js, _ = _search("jax", queries, centroids, packed, k, nlist, policy)
    np.testing.assert_allclose(ds, js, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("n", [16, 1040, 1500])
def test_int8_bucket_cross_term_is_numpys_int32_einsum(n):
    rng = np.random.default_rng(n)
    qq = rng.integers(-127, 128, size=(5, n)).astype(np.int8)
    qx = rng.integers(-127, 128, size=(5, 7, n)).astype(np.int8)
    # the extremes: every product 127², so a partial sum of n ≥ 1041 terms
    # would leave f32's integers
    qq[0] = 127
    qx[0] = 127
    got = IVF._int8_bucket_dot(_t(qq), _t(qx))
    assert got.dtype == torch.int32
    ref = np.einsum("qn,qcn->qc", qq.astype(np.int32), qx.astype(np.int32))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_int8_bucket_cross_term_quantizes_like_jax():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(6, 12)).astype(np.float32)
    x = rng.normal(size=(6, 9, 12)).astype(np.float32)
    got = IVF._policy_bucket_cross(_t(q), _t(x), "int8_dist").numpy()
    ref = np.asarray(JIVF._policy_bucket_cross(q, x, None, "int8_dist"))
    np.testing.assert_allclose(got, ref, rtol=1e-6)
    qq, _ = L.quantize_int8(_t(x))
    assert qq.dtype == torch.int8


def test_full_probe_equals_knn_topk(index):
    items, queries, centroids, packed = index
    k = 9
    gs, gi = _search("port", queries, centroids, packed, k, 16)
    es, ei = NN.knn_topk(_t(queries), _t(items), torch.ones(len(items), dtype=torch.bool), k)
    np.testing.assert_array_equal(gi, ei.numpy())
    np.testing.assert_allclose(gs, es.numpy(), rtol=1e-5)


def test_unfilled_slots_are_minus_inf_and_minus_one():
    rng = np.random.default_rng(8)
    items = rng.normal(size=(6, 4)).astype(np.float32)
    packed = IVF.build_ivf_buckets(items, np.array([0, 0, 0, 1, 1, 1]), 2,
                                   cap_percentile=100.0)
    s, i = IVF.ivf_search(_t(items[:2]), _t(items[[0, 3]]), _t(packed.bucket_items),
                          _t(packed.bucket_ids), 5, 1)
    assert (i[:, 3:] == -1).all() and torch.isinf(s[:, 3:]).all()
    js, ji = JIVF.ivf_search(items[:2], items[[0, 3]], packed.bucket_items,
                             packed.bucket_ids, 5, 1)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def test_last_block_is_padded_as_jax_pads_it(index):
    """300 queries: two full 128-row blocks and a 44-row block padded to 128
    with zero rows probing list 0; under int8 the padded block's scale is
    the JAX package's, so the two agree as closely as on full blocks."""
    _, queries, centroids, packed = index
    ds, _ = _search("port", queries, centroids, packed, 5, 3, "int8_dist")
    js, _ = _search("jax", queries, centroids, packed, 5, 3, "int8_dist")
    np.testing.assert_allclose(ds[256:], js[256:], rtol=1e-4, atol=1e-4)
