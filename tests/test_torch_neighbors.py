"""The port's exact NearestNeighbors against the JAX package's.

The same f32 items and queries go through both packages (the port with
device="cpu"): ids exactly equal, distances rtol 1e-5 (atol 1e-6 for the
values near 0 of the cosine and dot metrics), for each metric the JAX
package offers. Ties are kept in the JAX package's order (the earlier corpus
row first): a corpus of repeated rows makes every score tie, and the ids
must still be equal.
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_ml_tpu.models.neighbors import NearestNeighbors as JaxNN
from spark_rapids_ml_tpu.models.neighbors import NearestNeighborsModel as JaxNNModel
from spark_rapids_ml_tpu.ops import neighbors as JNN
from spark_rapids_ml_tpu_torch import NearestNeighbors, NearestNeighborsModel
from spark_rapids_ml_tpu_torch.convert import model_from_arrays
from spark_rapids_ml_tpu_torch.models.base import Saveable
from spark_rapids_ml_tpu_torch.ops import neighbors as NN

CPU = torch.device("cpu")
METRICS = ("euclidean", "sqeuclidean", "cosine", "inner_product")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    corpus = rng.normal(size=(500, 24)).astype(np.float32)
    queries = rng.normal(size=(73, 24)).astype(np.float32)
    return corpus, queries


def _check(got, ref):
    (gd, gi), (rd, ri) = got, ref
    np.testing.assert_array_equal(gi, ri)
    np.testing.assert_allclose(gd, rd, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("metric", METRICS)
def test_kneighbors_equal_jax(data, metric):
    corpus, queries = data
    port = NearestNeighbors(device=CPU, k=9, metric=metric).fit(corpus)
    ref = JaxNN(k=9, metric=metric).fit(corpus)
    _check(port.kneighbors(queries), ref.kneighbors(queries))


@pytest.mark.parametrize("metric", ["sqeuclidean", "dot"])
@pytest.mark.parametrize("block_rows", [8192, 64, 37])
def test_knn_topk_equal_jax_across_blocks(data, metric, block_rows):
    corpus, queries = data
    valid = np.ones(len(corpus), bool)
    valid[::7] = False  # masked rows are never selected
    got = NN.knn_topk(
        torch.from_numpy(queries), torch.from_numpy(corpus), torch.from_numpy(valid), 6,
        metric=metric, block_rows=block_rows, index_offset=1000,
    )
    ref = JNN.knn_topk(
        jnp.asarray(queries), jnp.asarray(corpus), jnp.asarray(valid), 6,
        metric=metric, index_offset=1000,
    )
    _check((got[0].numpy(), got[1].numpy()), (np.asarray(ref[0]), np.asarray(ref[1])))
    assert not np.isin(got[1].numpy() - 1000, np.flatnonzero(~valid)).any()


@pytest.mark.parametrize("block_rows", [8192, 4, 3])
def test_ties_keep_the_earlier_row_first(block_rows):
    rng = np.random.default_rng(1)
    base = rng.normal(size=(5, 6)).astype(np.float32)
    corpus = np.tile(base, (8, 1))  # every row repeated 8 times: scores tie
    queries = base[:3] + 0.01
    got = NN.knn_topk(
        torch.from_numpy(queries), torch.from_numpy(corpus),
        torch.ones(len(corpus), dtype=torch.bool), 12, block_rows=block_rows,
    )
    ref = JNN.knn_topk(
        jnp.asarray(queries), jnp.asarray(corpus), jnp.ones(len(corpus), bool), 12,
    )
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    # within a tie the ids ascend
    first = got[1].numpy()[0, :8]
    assert (first == np.arange(8) * 5).all()


def test_merge_topk_is_stable():
    a = torch.tensor([[3.0, 1.0]])
    b = torch.tensor([[3.0, 2.0, 1.0]])
    best, ids = NN.merge_topk(a, torch.tensor([[0, 1]]), b, torch.tensor([[5, 6, 7]]), 4)
    assert best.tolist() == [[3.0, 3.0, 2.0, 1.0]] and ids.tolist() == [[0, 5, 6, 1]]


@pytest.mark.parametrize("policy", ["bf16_f32acc", "int8_dist"])
def test_block_scores_policies_equal_jax(data, policy):
    corpus, queries = data
    got = NN._block_scores(torch.from_numpy(queries), torch.from_numpy(corpus), "sqeuclidean",
                           policy).numpy()
    ref = np.asarray(JNN._block_scores(jnp.asarray(queries), jnp.asarray(corpus), "sqeuclidean",
                                       None, policy))
    scale = float((queries**2).sum(1).max() + (corpus**2).sum(1).max())
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * scale)


def test_cosine_edges_equal_jax():
    corpus = np.array([[1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, 0.0]], np.float32)
    q = np.array([[2.0, 0.0]], np.float32)
    port = NearestNeighbors(device=CPU).setMetric("cosine").setK(4).fit(corpus)
    ref = JaxNN().setMetric("cosine").setK(4).fit(corpus)
    _check(port.kneighbors(q), ref.kneighbors(q))


@pytest.mark.parametrize("kind", ["pandas", "arrow"])
def test_id_col_transform_and_report(data, kind):
    corpus, queries = data
    ids = np.random.default_rng(3).permutation(10_000)[: len(corpus)]
    if kind == "pandas":
        items = pd.DataFrame({"features": list(corpus), "item_id": ids})
        q = pd.DataFrame({"features": list(queries)})
    else:
        items = pa.table({
            "features": pa.FixedSizeListArray.from_arrays(pa.array(corpus.reshape(-1)), 24),
            "item_id": pa.array(ids),
        })
        q = pa.table({
            "features": pa.FixedSizeListArray.from_arrays(pa.array(queries.reshape(-1)), 24),
        })
    kw = dict(inputCol="features", idCol="item_id", k=4)
    port = NearestNeighbors(device=CPU, **kw).fit(items)
    ref = JaxNN(**kw).fit(items)
    pd_, pi = port.kneighbors(q)
    assert pi.dtype == np.int64
    _check((pd_, pi), ref.kneighbors(q))
    out = port.transform(q)
    if kind == "pandas":
        np.testing.assert_array_equal(np.stack(out["indices"]), pi)
    else:
        assert out.column("indices").type.list_size == 4
    assert "knn kneighbors" in port.transform_report.phases


def test_k_override_and_validation(data):
    corpus, queries = data
    model = NearestNeighbors(device=CPU).setK(3).fit(corpus)
    d5, _ = model.kneighbors(queries, k=5)
    d3, _ = model.kneighbors(queries)
    np.testing.assert_allclose(d3, d5[:, :3])
    with pytest.raises(ValueError, match="k="):
        model.kneighbors(queries, k=len(corpus) + 1)
    with pytest.raises(ValueError, match="features"):
        model.kneighbors(np.zeros((2, 3), np.float32))
    with pytest.raises(ValueError, match="exceeds the fitted item count"):
        NearestNeighbors(device=CPU).setK(10).fit(corpus[:4])
    with pytest.raises(ValueError, match="metric"):
        NearestNeighbors(device=CPU).setMetric("manhattan")


def test_save_load_and_arrays_cross(tmp_path, data):
    corpus, queries = data
    model = NearestNeighbors(device=CPU, k=6, metric="cosine").fit(corpus)
    model.save(str(tmp_path / "nn"))
    back = NearestNeighborsModel.load(str(tmp_path / "nn"), device="cpu")
    assert back.getMetric() == "cosine"
    _check(back.kneighbors(queries), model.kneighbors(queries))
    ref = JaxNN(k=6, metric="cosine").fit(corpus)
    ref.save(str(tmp_path / "jax"))
    loaded = Saveable.load(str(tmp_path / "jax"), device="cpu")
    assert isinstance(loaded, NearestNeighborsModel)
    _check(loaded.kneighbors(queries), ref.kneighbors(queries))
    conv = model_from_arrays("NearestNeighborsModel", ref._saveData(), "cpu",
                             {"k": 6, "metric": "cosine"})
    _check(conv.kneighbors(queries), ref.kneighbors(queries))
    jax_back = JaxNNModel._fromSaved(None, model._saveData())
    jax_back._set(k=6, metric="cosine")
    _check(model.kneighbors(queries), jax_back.kneighbors(queries))
