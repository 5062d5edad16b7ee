"""The port's approximate nearest neighbours (``ApproximateNearestNeighbors``,
``IVFFlatIndex``, the ``"ann"`` servable) against the JAX package's.

Both packages get the same f32 rows, made from a numpy seed; the port runs
with device="cpu". Tolerances and properties:

- a JAX-fitted index carried across with ``convert.model_from_arrays``:
  ``kneighbors`` ids exactly equal, distances rtol 1e-5 (unit-scale rows),
  for each metric the index offers;
- the port's own fit draws its k-means++ seeds from a torch generator, so it
  is held by properties: recall@10 ≥ 0.9 at a partial probe on clustered
  rows (the JAX test's floor), the same seed gives the same index, the
  cosine branch's unfilled slots and zero rows;
- the streamed build: the reservoir sample equals the JAX package's (numpy
  draws); the pack pass, from the same centroids, equals
  ``build_ivf_buckets`` on the concatenated corpus (bucket ids and items
  exactly, the spill list the same rows as a set) and the JAX package's
  streamed pack array for array; ``_rebalance_cells`` equals the JAX
  package's on the same inputs;
- save and load across the packages: a JAX save loads in the port, a port
  save's arrays load in the JAX package, with equal answers;
- the wire: the servable's packed ``distances | ids`` equal to the JAX
  package's ``_make_finalize`` on the same kernel block, unpacked alike by
  both ``unpack_query_result``; ``/v1/indexes`` over HTTP, UDS and the fast
  lane on the CPU, every answer equal to the model's ``search``.
"""

from __future__ import annotations

import http.client
import json
import socket

import jax  # noqa: F401  (imported at the top of every port test file)
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.ann import index as jindex
from spark_rapids_ml_tpu.ann import serving as jann_serving
from spark_rapids_ml_tpu.knn import ApproximateNearestNeighbors as JaxANN
from spark_rapids_ml_tpu.knn import ApproximateNearestNeighborsModel as JaxANNModel
from spark_rapids_ml_tpu.ops import ivf as JIVF
from spark_rapids_ml_tpu.serving import fastlane as jfastlane
from spark_rapids_ml_tpu.utils import persistence as jax_persistence
from spark_rapids_ml_tpu_torch import ann, knn
from spark_rapids_ml_tpu_torch.ann import index as pindex
from spark_rapids_ml_tpu_torch.ann import serving as ann_serving
from spark_rapids_ml_tpu_torch.convert import model_from_arrays
from spark_rapids_ml_tpu_torch.models.base import Saveable
from spark_rapids_ml_tpu_torch.ops import ivf as IVF
from spark_rapids_ml_tpu_torch.serving import buckets
from spark_rapids_ml_tpu_torch.serving import client as client_mod
from spark_rapids_ml_tpu_torch.serving import registry as registry_mod
from spark_rapids_ml_tpu_torch.serving import server as server_mod
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def serve_env(monkeypatch):
    monkeypatch.setenv("TPU_ML_SERVE_MIN_BUCKET", "8")
    monkeypatch.setenv("TPU_ML_SERVE_MAX_BATCH_ROWS", "64")
    monkeypatch.delenv("TPU_ML_SERVE_HBM_BUDGET_BYTES", raising=False)
    monkeypatch.delenv("TPU_ML_TUNING_CACHE_PATH", raising=False)
    monkeypatch.delenv("TPU_ML_ANN_CAP_PERCENTILE", raising=False)
    yield
    client_mod.reset_client()
    server_mod.stop_serving()
    registry_mod.reset_for_tests()


@pytest.fixture(scope="module")
def unit():
    rng = np.random.default_rng(21)
    items = rng.normal(size=(1500, 16)).astype(np.float32)
    queries = rng.normal(size=(90, 16)).astype(np.float32)
    return items, queries


@pytest.fixture(scope="module")
def clustered():
    """The JAX test's clustered rows (25 centres, scale 10), in f32."""
    rng = np.random.default_rng(0)
    centers = rng.normal(scale=10, size=(25, 16))
    items = np.concatenate([c + rng.normal(scale=0.8, size=(80, 16)) for c in centers])
    queries = np.concatenate([c + rng.normal(scale=0.8, size=(4, 16)) for c in centers])
    return items.astype(np.float32), queries.astype(np.float32)


def _recall(got, exact):
    k = exact.shape[1]
    return float(np.mean([len(set(a) & set(b)) / k for a, b in zip(got, exact)]))


def _carried(jmodel):
    return model_from_arrays(
        type(jmodel).__name__, jmodel._saveData(), device="cpu", params=dict(jmodel._paramMap)
    )


@pytest.mark.parametrize("metric", ["euclidean", "sqeuclidean", "cosine"])
@pytest.mark.parametrize("nprobe", [3, 12])
def test_jax_fitted_index_carried_across_answers_alike(unit, metric, nprobe):
    items, queries = unit
    jm = JaxANN(k=7, nlist=12, nprobe=nprobe, seed=4, metric=metric).fit(items)
    pm = _carried(jm)
    assert type(pm) is knn.ApproximateNearestNeighborsModel
    gd, gi = pm.kneighbors(queries)
    rd, ri = jm.kneighbors(queries)
    np.testing.assert_array_equal(gi, ri)
    np.testing.assert_allclose(gd, rd, rtol=1e-5, atol=1e-6)


def test_jax_streamed_index_carried_across_answers_alike(unit):
    """The JAX package's IVFFlatIndex builds in f64 under x64, so it is
    built here with x64 off (f32, as the port builds)."""
    items, queries = unit
    jax.config.update("jax_enable_x64", False)
    try:
        jm = jindex.IVFFlatIndex(k=5, nlist=10, nprobe=4, seed=2).fit(
            [items[lo:lo + 400] for lo in range(0, len(items), 400)])
    finally:
        jax.config.update("jax_enable_x64", True)
    assert jm.bucketItems.dtype == np.float32
    pm = _carried(jm)
    assert type(pm) is ann.IVFFlatIndexModel and pm.nlist == 10
    for nprobe in (1, 4, 10):
        gd, gi = pm.search(queries, nprobe=nprobe)
        rd, ri = jm.search(queries, nprobe=nprobe)
        np.testing.assert_array_equal(gi, ri)
        np.testing.assert_allclose(gd, rd, rtol=1e-5, atol=1e-6)


def test_own_fit_recall_and_seed(clustered):
    items, queries = clustered
    _, exact = knn.NearestNeighbors(device=CPU, k=10).fit(items).kneighbors(queries)
    est = knn.ApproximateNearestNeighbors(device=CPU, k=10, nlist=25, nprobe=5, seed=1)
    a = est.fit(items)
    assert _recall(a.kneighbors(queries)[1], exact) >= 0.9
    b = est.fit(items)
    for name in ("centroids", "bucketItems", "bucketIds", "spillItems", "spillIds"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    # the JAX package's fit on the same rows clears the same floor
    jm = JaxANN(k=10, nlist=25, nprobe=5, seed=1).fit(items)
    assert _recall(jm.kneighbors(queries)[1], exact) >= 0.9


def test_auto_nlist_full_probe_and_ids(clustered):
    items, queries = clustered
    ids = np.arange(len(items)) * 3 + 7
    model = knn.ApproximateNearestNeighbors(
        device=CPU, k=6, nprobe=50, inputCol="features", idCol="id").fit(_with_ids(items, ids))
    assert model.centroids.shape[0] == int(np.sqrt(len(items)))
    ed, ei = knn.NearestNeighbors(device=CPU, k=6, inputCol="features", idCol="id").fit(
        _with_ids(items, ids)).kneighbors(queries)
    d, i = model.kneighbors(queries)
    np.testing.assert_array_equal(i, ei)
    np.testing.assert_allclose(d, ed, rtol=1e-4)


def _with_ids(items, ids):
    import pandas as pd

    return pd.DataFrame({"features": list(items), "id": ids})


def test_cosine_branch(clustered):
    items, queries = clustered
    k = 6
    _, exact = knn.NearestNeighbors(device=CPU, k=k, metric="cosine").fit(items) \
        .kneighbors(queries)
    model = knn.ApproximateNearestNeighbors(
        device=CPU, k=k, metric="cosine", nlist=20, nprobe=20, seed=2).fit(items)
    d, i = model.kneighbors(queries)
    assert _recall(i, exact) >= 0.9
    assert ((d >= 0) & (d <= 2)).all()
    # a zero query has no direction: it lands at 0.5 from every unit row
    dz, _ = model.kneighbors(np.zeros((1, 16), np.float32))
    np.testing.assert_allclose(dz, 0.5, rtol=1e-6)
    # unfilled slots (one probed list, k above its size) stay inf with id −1
    tiny = knn.ApproximateNearestNeighbors(
        device=CPU, k=4, metric="cosine", nlist=4, nprobe=1, seed=0).fit(items[:8])
    td, ti = tiny.kneighbors(items[:1], k=8)
    assert np.isinf(td[ti < 0]).all() and (ti < 0).any()
    jtiny = JaxANN(k=4, metric="cosine", nlist=4, nprobe=1, seed=0).fit(items[:8])
    jd, ji = _carried(jtiny).kneighbors(items[:1], k=8)
    rd, ri = jtiny.kneighbors(items[:1], k=8)
    np.testing.assert_array_equal(ji, ri)
    assert np.array_equal(np.isinf(jd), np.isinf(rd))


def test_param_checks_match_jax():
    for est in (knn.ApproximateNearestNeighbors(device=CPU), JaxANN()):
        with pytest.raises(ValueError, match="metric must be one of"):
            est.setMetric("inner_product")
    est = knn.ApproximateNearestNeighbors(device=CPU)
    for setter, bad in (("setK", 0), ("setNlist", -1), ("setNprobe", 0)):
        with pytest.raises(ValueError):
            getattr(est, setter)(bad)
    assert (est.getNlist(), est.getNprobe(), est.getOrDefault("maxIter")) == (0, 20, 10)


# -- the streamed build ------------------------------------------------------


def _chunks(x, rows):
    return [x[lo:lo + rows] for lo in range(0, len(x), rows)]


@pytest.mark.parametrize("budget", [0, 100, 5000])
def test_reservoir_sample_equals_jax(unit, budget):
    items, _ = unit
    got = pindex._reservoir_sample(iter(_chunks(items, 170)), budget, 9)
    ref = jindex._reservoir_sample(iter(_chunks(items, 170)), budget, 9)
    np.testing.assert_array_equal(got[0], ref[0])
    assert got[1] == ref[1] == len(items)


def test_sample_rows_knob(monkeypatch):
    monkeypatch.setenv("TPU_ML_ANN_SAMPLE_ROWS", "123")
    assert pindex.sample_rows_budget() == jindex.sample_rows_budget() == 123
    monkeypatch.setenv("TPU_ML_ANN_SAMPLE_ROWS", "-5")
    assert pindex.sample_rows_budget() == 0
    monkeypatch.setenv("TPU_ML_ANN_SAMPLE_ROWS", "junk")
    assert pindex.sample_rows_budget() == jindex.sample_rows_budget() == 32768


@pytest.mark.parametrize("percentile", ["100", "70"])
def test_streamed_pack_equals_build_ivf_buckets(unit, monkeypatch, percentile):
    monkeypatch.setenv("TPU_ML_ANN_CAP_PERCENTILE", percentile)
    items, _ = unit
    centers = items[np.random.default_rng(3).choice(len(items), 10, replace=False)]
    chunks = _chunks(items, 211)
    est = pindex.IVFFlatIndex(device=CPU)
    got = est._assign_and_pack(lambda: iter(chunks), centers, 10, len(items))
    labels = np.argmin(((items[:, None] - centers[None]) ** 2).sum(-1), axis=1)
    ref = IVF.build_ivf_buckets(items, labels, 10, cap_percentile=float(percentile))
    np.testing.assert_array_equal(got.bucket_ids, ref.bucket_ids)
    np.testing.assert_array_equal(got.bucket_items, ref.bucket_items)
    assert got.cap == ref.cap
    valid = got.spill_ids >= 0
    assert set(got.spill_ids[valid]) == set(ref.spill_ids[ref.spill_ids >= 0])
    np.testing.assert_array_equal(got.spill_items[valid], items[got.spill_ids[valid]])
    assert got.spill_ids.size == ref.spill_ids.size
    # and the JAX package's streamed pack, array for array
    jref = jindex.IVFFlatIndex()._assign_and_pack(lambda: iter(chunks), centers, 10, len(items))
    for a, b in zip(got, jref):
        np.testing.assert_array_equal(a, b)


def test_rebalance_cells_equals_jax(clustered):
    items, _ = clustered
    rng = np.random.default_rng(6)
    centers = items[rng.choice(len(items), 12, replace=False)].copy()
    counts = np.bincount(rng.integers(0, 12, 2000), minlength=12)
    counts[[2, 5]] = 0
    counts[7] = 900  # overfull
    got = pindex._rebalance_cells(centers, counts, items, CPU)
    ref = jindex._rebalance_cells(centers, counts, items)
    np.testing.assert_array_equal(got[0], np.asarray(ref[0]))
    assert got[1] == ref[1] == 3


def test_kmeans_parallel_init_properties(clustered):
    items, _ = clustered
    a = pindex._kmeans_parallel_init(items, 25, 5, CPU)
    b = pindex._kmeans_parallel_init(items, 25, 5, CPU)
    assert a.shape == (25, 16)
    np.testing.assert_array_equal(a, b)
    # every centre is a data row, and they are distinct
    assert all((np.abs(items - c).sum(1) == 0).any() for c in a)
    assert len(np.unique(a, axis=0)) == 25


def test_streamed_index_fit(clustered, monkeypatch):
    monkeypatch.setenv("TPU_ML_ANN_SAMPLE_ROWS", "1000")
    monkeypatch.setenv("TPU_ML_STREAM_CHUNK_ROWS", "256")
    items, queries = clustered
    source = _chunks(items, 333)
    snap = REGISTRY.snapshot()
    est = ann.IVFFlatIndex(device=CPU, k=10, nlist=25, nprobe=5, maxIter=8, seed=3)
    model = est.fit(source)
    delta = REGISTRY.snapshot().delta(snap)
    assert delta.counter("ann.build_rows", index=est.uid) == len(items)
    assert isinstance(model, ann.IVFFlatIndexModel) and model.nlist == 25
    _, exact = knn.NearestNeighbors(device=CPU, k=10).fit(items).kneighbors(queries)
    recalls = [_recall(model.search(queries, nprobe=p)[1], exact) for p in (1, 3, 5, 25)]
    assert recalls == sorted(recalls) and recalls[2] >= 0.9 and recalls[3] == 1.0
    assert model.getNprobe() == 5
    again = est.fit(np.concatenate(source))  # an ndarray source, the same rows
    np.testing.assert_array_equal(again.bucketIds, model.bucketIds)
    with pytest.raises(ValueError, match="ids has"):
        est.fit(source, ids=np.arange(3))
    with pytest.raises(ValueError, match="nprobe"):
        model.search(queries, nprobe=0)


# -- persistence -------------------------------------------------------------


def test_jax_save_loads_in_the_port(unit, tmp_path):
    items, queries = unit
    jm = JaxANN(k=5, nlist=9, nprobe=4, seed=2).fit(items)
    jm.save(str(tmp_path / "a"))
    pm = Saveable.load(str(tmp_path / "a"), device="cpu")
    assert type(pm) is knn.ApproximateNearestNeighborsModel and pm.getNprobe() == 4
    np.testing.assert_array_equal(pm.kneighbors(queries)[1], jm.kneighbors(queries)[1])


def test_port_save_arrays_load_in_jax(unit, tmp_path):
    items, queries = unit
    est = ann.IVFFlatIndex(device=CPU, k=5, nlist=9, nprobe=4, seed=2)
    pm = est.fit(items)
    pm.save(str(tmp_path / "p"))
    loaded = ann.IVFFlatIndexModel.load(str(tmp_path / "p"), device="cpu")
    np.testing.assert_array_equal(loaded.search(queries)[1], pm.search(queries)[1])
    arrays = jax_persistence.load_arrays(str(tmp_path / "p"))
    jm = JaxANNModel._fromSaved("x", arrays)
    jm._set(k=5, nprobe=4)
    jd, ji = jm.kneighbors(queries)
    pd_, pi = pm.kneighbors(queries)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_allclose(pd_, jd, rtol=1e-5)


def test_pre_spill_save_loads(unit, monkeypatch):
    monkeypatch.setenv("TPU_ML_ANN_CAP_PERCENTILE", "100")  # no spill
    items, queries = unit
    jm = JaxANN(k=5, nlist=9, nprobe=9, seed=2).fit(items)
    data = {k: v for k, v in jm._saveData().items() if not k.startswith("spill")}
    assert jm.spillIds.size == 0
    pm = model_from_arrays("ApproximateNearestNeighborsModel", data, device="cpu",
                           params={"k": 5, "nprobe": 9})
    assert pm.spillItems.shape == (0, 16)
    np.testing.assert_array_equal(pm.kneighbors(queries)[1], jm.kneighbors(queries)[1])


# -- serving -----------------------------------------------------------------


@pytest.fixture
def served(unit, tmp_path):
    items, queries = unit
    model = ann.IVFFlatIndex(device=CPU, k=6, nlist=10, nprobe=3, seed=1).fit(items)
    reg = registry_mod.ModelRegistry(device="cpu")
    entry = ann_serving.register_index("idx", model, registry=reg)
    srv = server_mod.start_serving(0, registry=reg, uds_path=str(tmp_path / "s.sock"))
    return queries, model, reg, entry, srv


def test_wire_format_equals_jax(served):
    queries, model, reg, entry, _ = served
    assert entry.family == "ann" and "ann" in registry_mod.FAMILIES
    padded, rows = buckets.pad_to_bucket(queries[:5], 8)
    raw = reg.dispatch_padded(entry, padded, 8)
    assert raw.dtype == np.float32 and raw.shape == (8, 12)
    got = entry.finalize(raw, rows)
    ref = jann_serving._make_finalize(6, "euclidean", np.asarray(model.itemIds))(raw, rows)
    np.testing.assert_array_equal(got, ref)
    for unpack in (ann_serving.unpack_query_result, jann_serving.unpack_query_result):
        d, i = unpack(got)
        sd, si = model.search(queries[:5])
        np.testing.assert_array_equal(i, si)
        np.testing.assert_allclose(d, sd, rtol=1e-6)
    with pytest.raises(ValueError, match="2k"):
        ann_serving.unpack_query_result(np.zeros((2, 3)))


def test_indexes_over_http(served):
    queries, model, reg, _, srv = served
    reg.register("plain", knn.ApproximateNearestNeighbors(device=CPU, k=2, nlist=4, seed=0)
                 .fit(queries))
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
    conn.request("GET", "/v1/indexes")
    listing = json.loads(conn.getresponse().read())["indexes"]
    assert sorted(e["name"] for e in listing) == ["idx", "plain"]
    snap = REGISTRY.snapshot()
    conn.request("POST", "/v1/indexes/idx:query",
                 body=json.dumps({"instances": queries[:4].tolist()}),
                 headers={"Content-Type": "application/json"})
    body = json.loads(conn.getresponse().read())
    sd, si = model.search(queries[:4])
    assert body["index"] == "idx" and body["rows"] == 4
    np.testing.assert_array_equal(body["ids"], si)
    np.testing.assert_allclose(body["distances"], sd, rtol=1e-6)
    x32 = np.ascontiguousarray(queries[:3], dtype="<f4")
    conn.request("POST", "/v1/indexes/idx:query", body=x32.tobytes(), headers={
        "Content-Type": server_mod.BINARY_CONTENT_TYPE,
        "Accept": server_mod.BINARY_CONTENT_TYPE, "X-Shape": "3,16"})
    resp = conn.getresponse()
    packed = np.frombuffer(resp.read(), "<f4").reshape(3, 12)
    assert resp.headers[server_mod.ANN_K_HEADER] == "6"
    np.testing.assert_array_equal(ann_serving.unpack_query_result(packed)[1],
                                  model.search(queries[:3])[1])
    delta = REGISTRY.snapshot().delta(snap)
    assert delta.counter("ann.queries", index="idx") == 7
    conn.close()


def test_query_of_a_non_index_is_404(served, unit):
    queries, _, reg, _, srv = served
    from spark_rapids_ml_tpu_torch import StandardScaler

    reg.register("sc", StandardScaler(device=CPU).fit(queries))
    for name in ("sc", "ghost"):
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
        conn.request("POST", f"/v1/indexes/{name}:query",
                     body=json.dumps({"instances": queries[:1].tolist()}),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        assert resp.status == 404, name
        conn.close()
    with pytest.raises(KeyError):
        client_mod.query("sc", queries[:1])
    with pytest.raises(TypeError, match="not ann"):
        ann_serving.query_direct("sc", queries[:1], registry=reg)


def _uds_exchange(sock, rfile, header: dict) -> dict:
    raw = json.dumps(header).encode()
    sock.sendall(len(raw).to_bytes(4, "big") + raw)
    n = int.from_bytes(rfile.read(4), "big")
    return json.loads(rfile.read(n))


def test_indexes_over_uds_and_the_fast_lane(served):
    queries, model, _, _, srv = served
    sd, si = model.search(queries[:4])
    snap = REGISTRY.snapshot()
    with socket.socket(socket.AF_UNIX) as s:
        s.connect(srv.uds_path)
        rfile = s.makefile("rb")
        resp = _uds_exchange(s, rfile, {"model": "idx", "kind": "query", "wire": "json",
                                        "instances": queries[:4].tolist()})
        assert resp["ok"] and resp["k"] == 6
        np.testing.assert_array_equal(resp["ids"], si)
        np.testing.assert_allclose(resp["distances"], sd, rtol=1e-6)
        # a query frame packed by the JAX package
        s.sendall(jfastlane.pack_request("idx", queries[:4], query=True))
        packed = jfastlane.read_response(rfile.read)
        np.testing.assert_array_equal(jann_serving.unpack_query_result(packed)[1], si)
        resp = _uds_exchange(s, rfile, {"model": "idx", "kind": "bogus", "instances": [[0.0]]})
        assert not resp["ok"] and resp["code"] == 400
    delta = REGISTRY.snapshot().delta(snap)
    assert delta.counter("ann.queries", index="idx") == 8


def test_client_query_and_query_direct(served):
    queries, model, reg, _, _ = served
    snap = REGISTRY.snapshot()
    d, i = ann.query("idx", queries[:5])
    sd, si = model.search(queries[:5])
    np.testing.assert_array_equal(i, si)
    dd, di = ann.query_direct("idx", queries[:5], nprobe=10, k=3, registry=reg)
    np.testing.assert_array_equal(di, model.search(queries[:5], nprobe=10, k=3)[1])
    delta = REGISTRY.snapshot().delta(snap)
    assert delta.counter("ann.queries", index="idx") == 10


def test_index_pages_like_any_servable(served, monkeypatch):
    queries, model, reg, entry, _ = served
    before = reg.predict("idx", queries[:2])
    entry.page_out()
    assert not entry.resident
    np.testing.assert_array_equal(reg.predict("idx", queries[:2]), before)
    assert entry.resident


@pytest.mark.cuda
def test_ann_graph_replay_matches_eager_search_at_every_rung(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the registry captures CUDA graphs only there")
    monkeypatch.setenv("TPU_ML_SERVE_MAX_BATCH_ROWS", "512")
    torch.set_float32_matmul_precision("highest")
    rng = np.random.default_rng(3)
    items = rng.normal(size=(20_000, 64)).astype(np.float32)
    model = knn.ApproximateNearestNeighbors(device="cuda", k=10, nlist=64, nprobe=8).fit(items)
    reg = registry_mod.ModelRegistry(device="cuda")
    entry = reg.register("idx", model)
    for b in buckets.bucket_ladder():
        padded = rng.normal(size=(b, 64)).astype(np.float32)
        served = reg.dispatch_padded(entry, padded, b)
        eager = entry.kernel(entry.params, torch.from_numpy(padded).cuda()).cpu().numpy()
        assert np.array_equal(served, eager), b
