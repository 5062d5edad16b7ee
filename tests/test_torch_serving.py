"""The port's serving path against the JAX package's, on the CPU.

Both packages read ``TPU_ML_SERVE_MAX_BATCH_ROWS=64`` at call time, so the
ladder is 8, 16, 32, 64. Models are fitted by the JAX package (n = 16,
k = 4, plain and standardize=True) and carried across with
``convert.pca_model_from_arrays``; the port's registry runs with
device="cpu", where no CUDA graph exists and the same kernel runs eagerly.
Answers agree with the JAX package's within max abs error ≤ 1e-5 × max
|expected| (the JAX side computes in f64 here: the test session enables
x64). The one ``cuda``-marked test holds each rung's graph replay bit for
bit against the eager projection of the same padded block. The linear
family's servable (JAX-fitted single-output GLMs carried across with
``convert.model_from_arrays``) is held against the JAX package's
``_linear_kernel`` and ``_linear_kernel_bf16`` at the same bound.
"""

from __future__ import annotations

import json
import socket
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax  # noqa: F401  (imported at the top of every port test file)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu import PCA as JaxPCA
from spark_rapids_ml_tpu.serving import buckets as jbuckets
from spark_rapids_ml_tpu.serving import fastlane as jfastlane
from spark_rapids_ml_tpu.serving import registry as jregistry
from spark_rapids_ml_tpu_torch.autotune import cache as tuning_cache
from spark_rapids_ml_tpu_torch.autotune.policy import TuningConfig
from spark_rapids_ml_tpu_torch.convert import pca_model_from_arrays
from spark_rapids_ml_tpu_torch.serving import buckets, hbm
from spark_rapids_ml_tpu_torch.serving import client as client_mod
from spark_rapids_ml_tpu_torch.serving import registry as registry_mod
from spark_rapids_ml_tpu_torch.serving import server as server_mod
from spark_rapids_ml_tpu_torch.serving.batcher import MicroBatcher
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY

N, K = 16, 4
LADDER = (8, 16, 32, 64)
REL_TOL = 1e-5
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def serve_env(monkeypatch):
    monkeypatch.setenv("TPU_ML_SERVE_MIN_BUCKET", "8")
    monkeypatch.setenv("TPU_ML_SERVE_MAX_BATCH_ROWS", "64")
    monkeypatch.delenv("TPU_ML_SERVE_HBM_BUDGET_BYTES", raising=False)
    monkeypatch.delenv("TPU_ML_TUNING_CACHE_PATH", raising=False)
    tuning_cache.reset()
    yield
    client_mod.reset_client()
    server_mod.stop_serving()
    registry_mod.reset_for_tests()
    jregistry.reset_for_tests()
    tuning_cache.reset()


@pytest.fixture(scope="module")
def jax_models():
    """Seeded data and two JAX-fitted models: plain and standardized."""
    rng = np.random.default_rng(17)
    x = (rng.normal(size=(400, N)) * rng.uniform(0.5, 3.0, size=N) + 2.0).astype(np.float32)
    plain = JaxPCA().setK(K).fit(x)
    std = JaxPCA().setK(K).setStandardize(True).fit(x)
    return x, plain, std


def _port(model):
    return pca_model_from_arrays(model._saveData(), device="cpu")


def _assert_close(got, expected):
    got, expected = np.asarray(got), np.asarray(expected)
    assert got.shape == expected.shape
    err = np.abs(got.astype(np.float64) - expected.astype(np.float64)).max()
    assert err <= REL_TOL * np.abs(expected).max(), err


# -- buckets -----------------------------------------------------------------


@pytest.mark.parametrize(
    "min_bucket,max_rows",
    [("8", "64"), ("6", "100"), ("1", "1"), ("", ""), ("bad", "x"), ("0", "4096"),
     ("16", "8"), ("3", "33")],
)
def test_buckets_match_jax(monkeypatch, min_bucket, max_rows):
    monkeypatch.setenv("TPU_ML_SERVE_MIN_BUCKET", min_bucket)
    monkeypatch.setenv("TPU_ML_SERVE_MAX_BATCH_ROWS", max_rows)
    assert buckets.min_bucket() == jbuckets.min_bucket()
    assert buckets.max_batch_rows() == jbuckets.max_batch_rows()
    assert buckets.bucket_ladder() == jbuckets.bucket_ladder()
    cap = jbuckets.max_batch_rows()
    for rows in sorted({1, 2, 3, 7, 8, 9, cap // 2 + 1, cap} & set(range(1, cap + 1))):
        assert buckets.serve_bucket(rows) == jbuckets.serve_bucket(rows)
        x = np.arange(rows * 3, dtype=np.float32).reshape(rows, 3)
        (a, ra), (b, rb) = buckets.pad_to_bucket(x), jbuckets.pad_to_bucket(x)
        assert ra == rb and a.dtype == b.dtype and np.array_equal(a, b)
    for bad in (0, cap + 1):
        with pytest.raises(ValueError) as port_err:
            buckets.serve_bucket(bad)
        with pytest.raises(ValueError) as jax_err:
            jbuckets.serve_bucket(bad)
        assert str(port_err.value) == str(jax_err.value)


def test_pad_to_bucket_honors_a_chosen_bucket():
    x = np.ones((3, 2), dtype=np.float32)
    padded, rows = buckets.pad_to_bucket(x, 16)
    assert padded.shape == (16, 2) and rows == 3 and not padded[3:].any()
    with pytest.raises(ValueError, match="do not fit"):
        buckets.pad_to_bucket(x, 2)


# -- registry ----------------------------------------------------------------


@pytest.mark.parametrize("which", ["plain", "std"])
def test_predict_matches_jax_over_every_row_count(jax_models, which):
    x, plain, std = jax_models
    jmodel = plain if which == "plain" else std
    reg = registry_mod.get_registry(device="cpu")
    reg.register("p", _port(jmodel))
    jreg = jregistry.get_registry()
    jreg.register("p", jmodel, bucket_list=LADDER)
    for rows in range(1, 65):
        _assert_close(reg.predict("p", x[:rows]), jreg.predict("p", x[:rows]))


def test_predict_is_the_eager_transform(jax_models):
    x, plain, std = jax_models
    reg = registry_mod.ModelRegistry(device="cpu")
    for name, jm in (("plain", plain), ("std", std)):
        model = _port(jm)
        reg.register(name, model)
        for rows in (1, 5, 8, 30, 64):
            # the transform pads to TPU_ML_MIN_BUCKET (128): another shape,
            # so equal within the bound, and bit for bit at equal buckets
            _assert_close(reg.predict(name, x[:rows]), model.transform(x[:rows]))


def test_bf16_variant_selected_by_the_tuning_cache_matches_jax(jax_models, tmp_path, monkeypatch):
    x, plain, _ = jax_models
    path = tmp_path / "tuning.json"
    monkeypatch.setenv("TPU_ML_TUNING_CACHE_PATH", str(path))
    key = tuning_cache.cache_key("serve.pca", n=N, device=tuning_cache.device_kind("cpu"))
    tuning_cache.store(key, TuningConfig(policy="bf16_f32acc"))
    assert path.exists()
    tuning_cache.reset()  # read back from the file
    reg = registry_mod.ModelRegistry(device="cpu")
    entry = reg.register("p", _port(plain))
    assert entry.policy == "bf16_f32acc" and entry.describe()["policy"] == "bf16_f32acc"
    pc = jnp.asarray(plain.pc)
    for rows in range(1, 65):
        padded, _ = jbuckets.pad_to_bucket(x[:rows])
        expected = np.asarray(jregistry._pca_kernel_bf16((pc,), jnp.asarray(padded)))[:rows]
        assert expected.dtype == np.float32
        got = reg.predict("p", x[:rows])
        assert got.dtype == np.float32
        _assert_close(got, expected)


def test_no_cache_entry_means_f32(jax_models):
    _, plain, _ = jax_models
    entry = registry_mod.ModelRegistry(device="cpu").register("p", _port(plain))
    assert entry.policy == "f32" and entry.kernel is registry_mod._pca_kernel


def test_float64_input_is_cast_once_to_float32(jax_models):
    """JSON input arrives as f64: it is standardized in f64, as the eager
    transform of f64 rows is, and cast to f32 once, before the device."""
    from spark_rapids_ml_tpu_torch.utils import columnar

    x, _, std = jax_models
    reg = registry_mod.ModelRegistry(device="cpu")
    model = _port(std)
    reg.register("p", model)
    x64 = x[:5].astype(np.float64) + 1e-9  # not representable in f32
    got = reg.predict("p", x64)
    assert got.dtype == np.float32
    padded = np.zeros((8, N), np.float32)
    padded[:5] = columnar.standardize_host(x64, model.mean, model.std)
    expected = (torch.from_numpy(padded) @ torch.from_numpy(model.pc.astype(np.float32)))
    assert np.array_equal(got, expected.numpy()[:5])


def test_validate_request_matches_jax():
    for x in ([[1, 2]], np.ones((2, 2), np.float32), np.ones(2), [[True, False]]):
        a = registry_mod.validate_request(x, 2, "m")
        b = jregistry.validate_request(x, 2, "m")
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for bad in (np.ones((2, 2), np.float16), np.ones((2, 3))):
        with pytest.raises(ValueError) as port_err:
            registry_mod.validate_request(bad, 2, "m")
        with pytest.raises(ValueError) as jax_err:
            jregistry.validate_request(bad, 2, "m")
        assert str(port_err.value) == str(jax_err.value)


def test_registry_errors_and_describe(jax_models):
    _, plain, _ = jax_models
    reg = registry_mod.ModelRegistry(device="cpu")
    with pytest.raises(TypeError, match="no serve contract"):
        reg.register("bad", object())
    with pytest.raises(KeyError, match="no servable model"):
        reg.predict("ghost", [[1.0] * N])
    reg.register("p", _port(plain), bucket_list=(8, 16))
    (desc,) = reg.describe()
    assert desc == {"name": "p", "family": "pca", "model_class": "PCAModel",
                    "n_features": N, "policy": "f32", "version": 1, "buckets": [8, 16]}


def test_unwarmed_bucket_books_a_cold_compile(jax_models):
    x, plain, _ = jax_models
    reg = registry_mod.ModelRegistry(device="cpu")
    model = _port(plain)
    reg.register("p", model, bucket_list=(8,))
    snap = REGISTRY.snapshot()
    reg.predict("p", x[:9])  # bucket 16, never warmed
    assert REGISTRY.snapshot().delta(snap).counter("serve.cold_compiles") == 1
    snap = REGISTRY.snapshot()
    reg.predict("p", x[:9])
    delta = REGISTRY.snapshot().delta(snap)
    assert delta.counter("serve.cold_compiles") == 0
    # no graph exists on the CPU, so nothing is captured
    assert delta.counter("compile.graph_captures") == 0


def test_registry_and_front_ends_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        registry_mod.ModelRegistry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        registry_mod.ModelRegistry(device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        server_mod.start_serving(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        client_mod.ServeClient().predict("p", [[0.0] * N])
    assert server_mod.get_serving_server() is None


def test_get_registry_refuses_another_device(monkeypatch):
    reg = registry_mod.get_registry(device="cpu")
    assert registry_mod.get_registry() is reg
    assert registry_mod.get_registry(device="cpu") is reg
    # as if a card were present: "cuda" names another device than the CPU
    monkeypatch.setattr(
        registry_mod, "resolve_device",
        lambda d: torch.device("cuda", 0) if str(d).startswith("cuda") else torch.device(d),
    )
    with pytest.raises(ValueError, match="serve registry is on cpu, not cuda"):
        registry_mod.get_registry(device="cuda")


# -- micro-batcher -------------------------------------------------------------


def test_concurrent_requests_share_one_dispatch(jax_models):
    x, plain, _ = jax_models
    reg = registry_mod.ModelRegistry(device="cpu")
    model = _port(plain)
    reg.register("p", model, bucket_list=(8, 16))
    batcher = MicroBatcher(reg, max_delay_s=0.2).start()
    try:
        snap = REGISTRY.snapshot()
        futures = [batcher.submit("p", x[i:i + 1]) for i in range(8)]
        outs = [f.result(timeout=30.0) for f in futures]
    finally:
        batcher.stop()
    delta = REGISTRY.snapshot().delta(snap)
    assert delta.counter("serve.batches") == 1
    assert delta.counter("serve.rows") == 8
    assert delta.counter("serve.joined_in_flight") == 7
    assert delta.hist("serve.queue_delay_seconds").count == 8
    expected = reg.predict("p", x[:8])
    for i, out in enumerate(outs):
        assert np.array_equal(out, expected[i:i + 1])


def test_coalescing_never_exceeds_the_warm_bucket_set(jax_models):
    x, plain, _ = jax_models
    reg = registry_mod.ModelRegistry(device="cpu")
    reg.register("p", _port(plain), bucket_list=(8, 16))
    batcher = MicroBatcher(reg, max_delay_s=0.2).start()
    try:
        snap = REGISTRY.snapshot()
        futures = [batcher.submit("p", x[8 * i:8 * i + 8]) for i in range(4)]
        for f in futures:
            f.result(timeout=30.0)
    finally:
        batcher.stop()
    delta = REGISTRY.snapshot().delta(snap)
    assert delta.counter("serve.cold_compiles") == 0
    assert delta.counter("serve.batches") == 2
    assert delta.counter("serve.rows") == 32


def test_submit_validates_before_queueing(jax_models, monkeypatch):
    x, plain, _ = jax_models
    reg = registry_mod.ModelRegistry(device="cpu")
    reg.register("p", _port(plain), bucket_list=(8,))
    batcher = MicroBatcher(reg)  # never started: every path raises at submit
    with pytest.raises(KeyError):
        batcher.submit("ghost", x[:1])
    with pytest.raises(ValueError, match="expected"):
        batcher.submit("p", np.ones((2, 4)))
    monkeypatch.setenv("TPU_ML_SERVE_MAX_BATCH_ROWS", "16")
    with pytest.raises(ValueError, match="ladder cap"):
        batcher.submit("p", np.ones((17, N)))


def test_stop_fans_the_error_out_to_waiting_requests(jax_models):
    x, plain, _ = jax_models
    reg = registry_mod.ModelRegistry(device="cpu")
    reg.register("p", _port(plain), bucket_list=(8,))
    batcher = MicroBatcher(reg, max_delay_s=60.0).start()
    futures = [batcher.submit("p", x[i:i + 1]) for i in range(3)]
    batcher.stop()
    for f in futures:
        with pytest.raises(RuntimeError, match="stopped"):
            f.result(timeout=5.0)
    with pytest.raises(RuntimeError, match="stopped"):
        batcher.submit("p", x[:1])


def test_adaptive_window_tracks_dispatch_time(jax_models):
    x, plain, _ = jax_models
    reg = registry_mod.ModelRegistry(device="cpu")
    reg.register("p", _port(plain), bucket_list=(8,))
    batcher = MicroBatcher(reg, max_delay_s=0.05, adaptive=True).start()
    try:
        assert batcher.effective_window_s("p") == 0.05
        batcher.submit("p", x[:1]).result(timeout=30.0)
        assert batcher.effective_window_s("p") < 0.05
    finally:
        batcher.stop()
    assert MicroBatcher(reg, max_delay_s=0.05, adaptive=False).effective_window_s("p") == 0.05


def test_many_threads_get_their_own_rows(jax_models):
    """A stress run: 32 threads on 4 cores, each holding its rows' answers
    to the direct predict of the same rows."""
    import sys

    x, plain, _ = jax_models
    reg = registry_mod.ModelRegistry(device="cpu")
    reg.register("p", _port(plain))
    batcher = MicroBatcher(reg, max_delay_s=0.001).start()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def one(i):
            rows = x[i % 300:i % 300 + 1 + i % 5]
            _assert_close(batcher.submit("p", rows).result(timeout=30.0), reg.predict("p", rows))
            return True

        with ThreadPoolExecutor(max_workers=32) as pool:
            assert all(pool.map(one, range(200), timeout=120))
    finally:
        sys.setswitchinterval(interval)
        batcher.stop()


# -- HBM paging ----------------------------------------------------------------


def test_lru_paging_under_a_byte_budget(jax_models, monkeypatch):
    x, plain, std = jax_models
    reg = registry_mod.ModelRegistry(device="cpu")
    a, b = _port(plain), _port(std)
    # one model's parameters fit, two do not
    monkeypatch.setenv("TPU_ML_SERVE_HBM_BUDGET_BYTES", str(int(1.5 * N * K * 4)))
    snap = REGISTRY.snapshot()
    ea = reg.register("a", a)
    assert ea.resident and hbm.param_bytes(ea.params) == N * K * 4
    eb = reg.register("b", b)
    assert eb.resident and not ea.resident and ea.host_params is not None
    for i in range(6):
        name, model = (("a", a), ("b", b))[i % 2]
        _assert_close(reg.predict(name, x[i:i + 3]), model.transform(x[i:i + 3]))
    delta = REGISTRY.snapshot().delta(snap)
    # one page-out at register("b"), then each request pages its model in
    # and the other out
    assert delta.counter("serve.page_out") == 7
    assert delta.counter("serve.page_in") == 6
    stats = hbm.get_fleet().stats()
    assert stats["budget_bytes"] == int(1.5 * N * K * 4)
    assert stats["resident_bytes"] == N * K * 4
    assert [m["resident"] for m in stats["models"].values()] == [False, True]


def test_paging_under_concurrent_requests(jax_models, monkeypatch):
    """16 threads alternate between two models under a budget that holds
    one, half through the batcher and half direct: pages go out while other
    threads dispatch, and every answer stays its model's."""
    import sys

    x, plain, std = jax_models
    reg = registry_mod.ModelRegistry(device="cpu")
    models = {"a": _port(plain), "b": _port(std)}
    monkeypatch.setenv("TPU_ML_SERVE_HBM_BUDGET_BYTES", str(int(1.5 * N * K * 4)))
    for name, model in models.items():
        reg.register(name, model)
    batcher = MicroBatcher(reg, max_delay_s=0.0005).start()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    snap = REGISTRY.snapshot()
    try:
        def one(i):
            name = "ab"[i % 2]
            rows = x[i % 390:i % 390 + 1 + i % 4]
            got = (batcher.submit(name, rows).result(timeout=30.0) if i % 3
                   else reg.predict(name, rows))
            _assert_close(got, models[name].transform(rows))
            return True

        with ThreadPoolExecutor(max_workers=16) as pool:
            assert all(pool.map(one, range(320), timeout=120))
    finally:
        sys.setswitchinterval(interval)
        batcher.stop()
    assert REGISTRY.snapshot().delta(snap).counter("serve.page_in") > 0


def test_no_budget_means_no_paging(jax_models):
    x, plain, std = jax_models
    reg = registry_mod.ModelRegistry(device="cpu")
    snap = REGISTRY.snapshot()
    reg.register("a", _port(plain))
    reg.register("b", _port(std))
    reg.predict("a", x[:2])
    delta = REGISTRY.snapshot().delta(snap)
    assert delta.counter("serve.page_out") == 0
    assert hbm.budget_bytes(CPU) is None
    assert hbm.get_fleet().stats()["budget_bytes"] is None


def test_budget_knob_matches_jax(monkeypatch):
    from spark_rapids_ml_tpu.serving import hbm as jhbm

    for raw in ("4096", "0", "-3"):
        monkeypatch.setenv("TPU_ML_SERVE_HBM_BUDGET_BYTES", raw)
        assert hbm.budget_bytes(CPU) == jhbm.budget_bytes()


# -- front ends ----------------------------------------------------------------


def _post(port: int, path: str, payload) -> tuple[int, dict]:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _serve(jax_models, tmp_path=None):
    x, plain, _ = jax_models
    reg = registry_mod.get_registry(device="cpu")
    reg.register("p", _port(plain))
    srv = server_mod.start_serving(
        0, uds_path=None if tmp_path is None else str(tmp_path / "s.sock"), device="cpu"
    )
    return x, reg, srv


def test_http_listing_json_and_binary_predict(jax_models):
    x, reg, srv = _serve(jax_models)
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/v1/models", timeout=30) as r:
        (desc,) = json.loads(r.read())["models"]
    assert desc["name"] == "p" and desc["buckets"] == list(LADDER)
    code, body = _post(srv.port, "/v1/models/p:predict", {"instances": x[:3].tolist()})
    assert code == 200 and body["rows"] == 3
    assert np.array_equal(np.asarray(body["predictions"], np.float32), reg.predict("p", x[:3]))
    x32 = np.ascontiguousarray(x[:5], dtype="<f4")
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}/v1/models/p:predict", data=x32.tobytes(),
        headers={"Content-Type": server_mod.BINARY_CONTENT_TYPE,
                 "Accept": server_mod.BINARY_CONTENT_TYPE, "X-Shape": f"5,{N}"},
    )
    snap = REGISTRY.snapshot()
    with urllib.request.urlopen(req, timeout=30) as r:
        got = np.frombuffer(r.read(), "<f4").reshape(
            [int(d) for d in r.headers["X-Shape"].split(",")]
        )
    assert np.array_equal(got, reg.predict("p", x32))
    delta = REGISTRY.snapshot().delta(snap)
    assert delta.counter("serve.transport", transport="http", wire="binary") == 1
    assert delta.counter("serve.json_codec") == 0
    with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics", timeout=30) as r:
        text = r.read().decode()
    assert "tpu_ml_serve_requests" in text and "tpu_ml_serve_latency_bucket" in text


def test_http_error_codes(jax_models, monkeypatch):
    _, _, srv = _serve(jax_models)
    code, body = _post(srv.port, "/v1/models/ghost:predict", {"instances": [[1.0] * N]})
    assert code == 404 and "ghost" in body["error"]
    code, body = _post(srv.port, "/v1/models/p:predict", {})
    assert code == 400
    code, body = _post(srv.port, "/v1/models/p:predict", {"instances": [[1.0] * 3]})
    assert code == 400 and "expected" in body["error"]
    monkeypatch.setenv("TPU_ML_SERVE_MAX_BATCH_ROWS", "16")
    code, body = _post(srv.port, "/v1/models/p:predict", {"instances": np.ones((17, N)).tolist()})
    assert code == 413 and "ladder cap" in body["error"]
    code, _ = _post(srv.port, "/v1/nonsense", {"instances": []})
    assert code == 404


def test_status_for_error_matches_jax():
    from spark_rapids_ml_tpu.serving import server as jserver

    for err in (KeyError("x"), ValueError("bad"), ValueError("over the ladder cap"),
                RuntimeError("boom")):
        assert server_mod.status_for_error(err) == jserver.status_for_error(err)
    assert server_mod.status_for_error(hbm.ServeShed("shed")) == 503


def _uds_exchange(sock, rfile, header: dict) -> dict:
    raw = json.dumps(header).encode()
    sock.sendall(len(raw).to_bytes(4, "big") + raw)
    n = int.from_bytes(rfile.read(4), "big")
    return json.loads(rfile.read(n))


def test_uds_json_and_jax_packed_fast_lane_frames(jax_models, tmp_path):
    x, reg, srv = _serve(jax_models, tmp_path)
    with socket.socket(socket.AF_UNIX) as s:
        s.connect(srv.uds_path)
        rfile = s.makefile("rb")
        resp = _uds_exchange(s, rfile, {"model": "p", "wire": "json", "instances": x[:3].tolist()})
        assert resp["ok"] and resp["rows"] == 3
        assert np.array_equal(np.asarray(resp["predictions"], np.float32), reg.predict("p", x[:3]))
        resp = _uds_exchange(s, rfile, {"model": "ghost", "wire": "json", "instances": [[0.0]]})
        assert not resp["ok"] and resp["code"] == 404
        # a request packed by the JAX package, answered on the same connection
        x32 = np.ascontiguousarray(x[:4], dtype=np.float32)
        snap = REGISTRY.snapshot()
        s.sendall(jfastlane.pack_request("p", x32))
        got = jfastlane.read_response(rfile.read)
        assert np.array_equal(got, reg.predict("p", x32))
        assert REGISTRY.snapshot().delta(snap).counter("serve.json_codec") == 0
        s.sendall(jfastlane.pack_request("ghost", x32))
        with pytest.raises(jfastlane.FastlaneError) as err:
            jfastlane.read_response(rfile.read)
        assert err.value.status == 404
    server_mod.stop_serving()
    assert not (tmp_path / "s.sock").exists()


def test_client_binds_to_the_server_batcher(jax_models):
    x, reg, srv = _serve(jax_models)
    snap = REGISTRY.snapshot()
    out = client_mod.predict("p", x[:2])
    assert np.array_equal(out, reg.predict("p", x[:2]))
    delta = REGISTRY.snapshot().delta(snap)
    assert delta.counter("serve.transport", transport="inproc", wire="array") == 1
    with pytest.raises(KeyError):
        client_mod.predict("ghost", x[:1])
    assert REGISTRY.snapshot().delta(snap).counter("serve.errors", model="ghost", code=404) == 1
    assert client_mod.get_client()._batcher() is srv.batcher


def test_client_without_a_server_starts_a_private_batcher(jax_models):
    x, plain, _ = jax_models
    reg = registry_mod.ModelRegistry(device="cpu")
    reg.register("p", _port(plain))
    client = client_mod.ServeClient(registry=reg)
    try:
        assert np.array_equal(client.predict("p", x[:3]), reg.predict("p", x[:3]))
    finally:
        client.close()


def test_serve_summary_reads_the_window(jax_models, tmp_path):
    x, _, srv = _serve(jax_models, tmp_path)
    snap = REGISTRY.snapshot()
    client_mod.predict("p", x[:2])
    summary = server_mod.serve_summary(REGISTRY.snapshot().delta(snap))
    assert summary["requests"] == 1 and summary["rows"] == 2
    assert summary["transport_mix"] == {"inproc/array": 1}
    assert summary["latency_by_transport"]["inproc/array"]["count"] == 1


@pytest.mark.cuda
def test_graph_replay_matches_eager_at_every_rung(jax_models, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the registry captures CUDA graphs only there")
    monkeypatch.setenv("TPU_ML_SERVE_MAX_BATCH_ROWS", "4096")
    torch.set_float32_matmul_precision("highest")
    rng = np.random.default_rng(3)
    model = pca_model_from_arrays(
        {"pc": np.linalg.qr(rng.normal(size=(512, 50)))[0], "explainedVariance": np.ones(50)},
        device="cuda",
    )
    reg = registry_mod.ModelRegistry(device="cuda")
    snap = REGISTRY.snapshot()
    entry = reg.register("p", model)
    ladder = buckets.bucket_ladder()
    assert REGISTRY.snapshot().delta(snap).counter("serve.aot_compiles") == len(ladder)
    for b in ladder:
        padded = rng.normal(size=(b, 512)).astype(np.float32)
        served = reg.dispatch_padded(entry, padded, b)
        eager = registry_mod._pca_kernel(entry.params, torch.from_numpy(padded).cuda()).cpu().numpy()
        assert np.array_equal(served, eager), b


def test_http_connection_is_kept_alive(jax_models):
    """One HTTP/1.1 connection carries many predicts; an error answer
    closes it (its body may be unread)."""
    import http.client

    x, reg, srv = _serve(jax_models)
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=30)
    try:
        for rows in (1, 3, 9):
            x32 = np.ascontiguousarray(x[:rows], dtype="<f4")
            conn.request("POST", "/v1/models/p:predict", body=x32.tobytes(), headers={
                "Content-Type": server_mod.BINARY_CONTENT_TYPE,
                "Accept": server_mod.BINARY_CONTENT_TYPE, "X-Shape": f"{rows},{N}"})
            resp = conn.getresponse()
            got = np.frombuffer(resp.read(), "<f4").reshape(rows, K)
            assert resp.status == 200 and not resp.will_close
            assert np.array_equal(got, reg.predict("p", x32))
        conn.request("POST", "/v1/models/ghost:predict",
                     body=json.dumps({"instances": [[0.0] * N]}).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        resp.read()
        assert resp.status == 404 and resp.will_close
    finally:
        conn.close()


# -- faults repaired: a malformed tuning cache, the HBM watermark knob ----------


def test_malformed_tuning_cache_serves_f32_in_both_packages(jax_models, tmp_path, monkeypatch):
    """A cache file whose ``entries`` is a list makes the cache lookup raise
    in both packages; both registries log it and serve f32."""
    from spark_rapids_ml_tpu.autotune import cache as jcache

    _, plain, _ = jax_models
    path = tmp_path / "tuning.json"
    path.write_text(json.dumps({"schema": 1, "entries": [["serve.pca", {}]]}))
    monkeypatch.setenv("TPU_ML_TUNING_CACHE_PATH", str(path))
    tuning_cache.reset()
    jcache.reset()
    try:
        entry = registry_mod.ModelRegistry(device="cpu").register("p", _port(plain))
        jentry = jregistry.get_registry().register("p", plain, bucket_list=LADDER)
    finally:
        jcache.reset()
    assert entry.policy == jentry.policy == "f32"


def test_hbm_budget_reads_the_watermark_knob_like_jax(monkeypatch):
    from spark_rapids_ml_tpu.serving import hbm as jhbm
    from spark_rapids_ml_tpu.telemetry import compilemon as jcompilemon
    from spark_rapids_ml_tpu_torch.telemetry import compilemon

    limit = 80 * (1 << 30)
    sample = {"cuda:0": {"bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": limit}}
    monkeypatch.setattr(compilemon, "sample_device_memory", lambda: sample)
    monkeypatch.setattr(jcompilemon, "sample_device_memory", lambda: sample)
    card = torch.device("cuda", 0)
    for raw, watermark in (("0.5", 0.5), ("", 0.92), ("junk", 0.92)):
        monkeypatch.setenv("TPU_ML_HEALTH_HBM_WATERMARK", raw)
        assert hbm.budget_bytes(card) == jhbm.budget_bytes() == int(limit * watermark)


# -- the scaler servable ------------------------------------------------------------


@pytest.mark.parametrize("with_mean,with_std", [(False, True), (True, True)])
def test_scaler_servable_matches_jax(jax_models, with_mean, with_std):
    """A StandardScalerModel fitted by the JAX package serves in both
    registries alike (f32 both sides' device dtype here), policy f32."""
    from spark_rapids_ml_tpu.models.scaler import StandardScaler as JaxStandardScaler
    from spark_rapids_ml_tpu_torch.convert import model_from_arrays

    x, _, _ = jax_models
    jmodel = JaxStandardScaler(withMean=with_mean, withStd=with_std).fit(x)
    model = model_from_arrays("StandardScalerModel", jmodel._saveData(), device="cpu",
                              params=dict(jmodel._paramMap))
    reg = registry_mod.ModelRegistry(device="cpu")
    entry = reg.register("s", model, bucket_list=LADDER)
    jreg = jregistry.get_registry()
    jreg.register("s", jmodel, bucket_list=LADDER)
    assert (entry.family, entry.policy, entry.n_features) == ("scaler", "f32", N)
    for rows in (1, 7, 8, 33, 64):
        got = reg.predict("s", x[:rows])
        _assert_close(got, jreg.predict("s", x[:rows]))
        np.testing.assert_array_equal(got, model.transform(x[:rows]))


@pytest.mark.cuda
def test_scaler_graph_replay_matches_eager_at_every_rung(monkeypatch):
    """Each rung's replay of the scaler servable equals the eager
    ``standardize`` of its padded block bit for bit, before and after the
    model pages out and back in (its graphs are recaptured)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the registry captures CUDA graphs only there")
    from spark_rapids_ml_tpu_torch.models.scaler import StandardScalerModel

    monkeypatch.setenv("TPU_ML_SERVE_MAX_BATCH_ROWS", "4096")
    rng = np.random.default_rng(4)
    model = StandardScalerModel(mean=rng.normal(size=512), std=rng.uniform(0.5, 2, size=512),
                                device="cuda")
    model._set(withMean=True)
    reg = registry_mod.ModelRegistry(device="cuda")
    entry = reg.register("s", model)
    ladder = buckets.bucket_ladder()
    for round_ in ("registered", "paged"):
        for b in ladder:
            padded = rng.normal(size=(b, 512)).astype(np.float32)
            served = reg.dispatch_padded(entry, padded, b)
            eager = registry_mod._scaler_kernel(
                entry.params, torch.from_numpy(padded).cuda(), with_mean=True, with_std=True
            ).cpu().numpy()
            assert np.array_equal(served, eager), (round_, b)
        entry.page_out()
        assert not entry.resident and not entry.rungs


# -- the linear family -----------------------------------------------------------


@pytest.fixture(scope="module")
def glm_models():
    """Seeded data and JAX-fitted single-output GLMs, and a multinomial
    logistic model (multi-output: no serve contract)."""
    from spark_rapids_ml_tpu.models import linear as JLM

    rng = np.random.default_rng(19)
    x = (rng.normal(size=(300, N)) + 0.5).astype(np.float32)
    y = (x @ rng.normal(size=N) + 1.0).astype(np.float32)
    labels = (y > np.median(y)).astype(np.float64)
    classes = np.digitize(y, np.quantile(y, [0.33, 0.66])).astype(np.float64)
    return x, {
        "LinearRegressionModel": JLM.LinearRegression().setRegParam(0.01).fit((x, y)),
        "LogisticRegressionModel": JLM.LogisticRegression().setRegParam(0.01).fit((x, labels)),
        "LinearSVCModel": JLM.LinearSVC().setRegParam(0.01).fit((x, labels)),
        "multinomial": JLM.LogisticRegression().setRegParam(0.01).fit((x, classes)),
    }


def _port_glm(jmodel):
    from spark_rapids_ml_tpu_torch.convert import model_from_arrays

    return model_from_arrays(type(jmodel).__name__, jmodel._saveData(), device="cpu")


@pytest.mark.parametrize("name", ["LinearRegressionModel", "LogisticRegressionModel",
                                  "LinearSVCModel"])
def test_linear_servable_matches_jax_linear_kernel(glm_models, name):
    x, models = glm_models
    jmodel = models[name]
    reg = registry_mod.ModelRegistry(device="cpu")
    entry = reg.register("g", _port_glm(jmodel))
    assert (entry.family, entry.model_cls, entry.policy) == ("linear", name, "f32")
    assert entry.kernel is registry_mod._linear_kernel
    params = (jnp.asarray(jmodel.coefficients, jnp.float32), jnp.asarray(jmodel.intercept, jnp.float32))
    jreg = jregistry.get_registry()
    jreg.register("g", jmodel, bucket_list=LADDER)
    for rows in range(1, 65):
        padded, _ = jbuckets.pad_to_bucket(x[:rows])
        expected = np.asarray(jregistry._linear_kernel(params, jnp.asarray(padded)))[:rows]
        got = reg.predict("g", x[:rows])
        assert got.shape == (rows,) and got.dtype == np.float32
        _assert_close(got, expected)
        _assert_close(got, jreg.predict("g", x[:rows]))


def test_linear_servable_is_the_eager_margin(glm_models):
    x, models = glm_models
    model = _port_glm(models["LinearRegressionModel"])
    reg = registry_mod.ModelRegistry(device="cpu")
    reg.register("g", model)
    for rows in (1, 7, 8, 33, 64):
        _assert_close(reg.predict("g", x[:rows]), model.transform(x[:rows]))


def test_linear_bf16_variant_from_the_tuning_cache_matches_jax(glm_models, tmp_path, monkeypatch):
    x, models = glm_models
    jmodel = models["LinearRegressionModel"]
    monkeypatch.setenv("TPU_ML_TUNING_CACHE_PATH", str(tmp_path / "tuning.json"))
    key = tuning_cache.cache_key("serve.linear", n=N, device=tuning_cache.device_kind("cpu"))
    tuning_cache.store(key, TuningConfig(policy="bf16_f32acc"))
    tuning_cache.reset()
    entry = registry_mod.ModelRegistry(device="cpu").register("g", _port_glm(jmodel))
    assert entry.policy == "bf16_f32acc" and entry.kernel is registry_mod._linear_kernel_bf16
    params = (jnp.asarray(jmodel.coefficients, jnp.float32), jnp.asarray(jmodel.intercept, jnp.float32))
    for rows in (1, 8, 40):
        padded, _ = jbuckets.pad_to_bucket(x[:rows])
        expected = np.asarray(jregistry._linear_kernel_bf16(params, jnp.asarray(padded)))[:rows]
        got = entry.kernel(entry.params, torch.from_numpy(padded)).numpy()[:rows]
        _assert_close(got, expected)


def test_multi_output_glms_are_refused_like_jax(glm_models):
    x, models = glm_models
    multi = _port_glm(models["multinomial"])
    reg = registry_mod.ModelRegistry(device="cpu")
    with pytest.raises(TypeError, match="no serve contract"):
        reg.register("m", multi)
    with pytest.raises(TypeError):
        jregistry.get_registry().register("m", models["multinomial"], bucket_list=LADDER)
    two_d = _port_glm(models["LinearRegressionModel"])
    two_d.coefficients = np.ones((2, N))
    with pytest.raises(TypeError, match="not single-output"):
        reg.register("m", two_d)


def test_linear_servable_over_http(glm_models):
    x, models = glm_models
    model = _port_glm(models["LinearRegressionModel"])
    reg = registry_mod.get_registry(device="cpu")
    reg.register("g", model)
    srv = server_mod.start_serving(0, registry=reg)
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/v1/models/g:predict",
            data=json.dumps({"instances": x[:5].tolist()}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=30) as resp:
            out = np.asarray(json.loads(resp.read())["predictions"], dtype=np.float64)
    finally:
        server_mod.stop_serving()
    _assert_close(out.reshape(-1), model.transform(x[:5]))


def _fitted_unservable(kind: str):
    """A small fitted model of a family with no serve contract."""
    from spark_rapids_ml_tpu_torch import (
        UMAP,
        FMClassifier,
        FMRegressor,
        GBTClassifier,
        GBTRegressor,
        MultilayerPerceptronClassifier,
    )

    rng = np.random.default_rng(8)
    x = rng.normal(size=(300, N)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.float64)
    if kind == "umap":
        return UMAP(device=CPU, nNeighbors=5, nEpochs=5).fit(x)
    est = {
        "gbt_classifier": GBTClassifier(device=CPU, numTrees=3, maxDepth=3),
        "gbt_regressor": GBTRegressor(device=CPU, numTrees=3, maxDepth=3),
        "mlp": MultilayerPerceptronClassifier(device=CPU, layers=[N, 4, 2], maxIter=5),
        "fm_classifier": FMClassifier(device=CPU, maxIter=5, stepSize=0.01),
        "fm_regressor": FMRegressor(device=CPU, maxIter=5, stepSize=0.01),
    }[kind]
    return est.fit((x, y))


@pytest.mark.parametrize("kind", ["gbt_classifier", "gbt_regressor", "mlp", "fm_classifier",
                                  "fm_regressor", "umap"])
def test_families_without_a_serve_contract_are_refused(kind):
    """GBT, MLP, FM and UMAP models have no serve contract (neither has the
    JAX registry one, though its forest duck-typing takes a
    GBTClassificationModel and votes its residual leaves as class counts):
    ``register`` raises TypeError and registers nothing."""
    model = _fitted_unservable(kind)
    reg = registry_mod.ModelRegistry(device="cpu")
    with pytest.raises(TypeError, match="no serve contract"):
        reg.register("m", model)
    with pytest.raises(KeyError):
        reg.get("m")


def test_jax_registry_serves_gbt_through_the_forest_vote(monkeypatch):
    """The reference fault the port does not copy: the JAX registry
    duck-types a model with ``trees`` and ``proba_and_predictions`` as a
    random forest, so it votes a GBTClassificationModel's leaves
    ([count, Σr, Σr²], not class counts) per tree. On these 600 seeded rows
    the eager model answers 31 zeros and 33 ones for the first 64; the JAX
    registry answers 0 for 61 of them and 2, no class at all, for 3 (47%
    agreement). The port's registry refuses the model instead
    (``test_families_without_a_serve_contract_are_refused``)."""
    from spark_rapids_ml_tpu.models.gbt import GBTClassifier as JaxGBTClassifier

    monkeypatch.setenv("TPU_ML_SERVE_MAX_BATCH_ROWS", "64")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(600, 6)).astype(np.float32)
    y = ((x[:, 0] + 0.5 * x[:, 1] * x[:, 2]) > 0).astype(np.float64)
    model = JaxGBTClassifier().setMaxIter(5).setMaxDepth(3).setSeed(2).fit((x, y))
    eager = model._predict_matrix(x[:64])
    reg = jregistry.get_registry()
    reg.register("gbt", model, bucket_list=LADDER)
    served = np.asarray(reg.predict("gbt", x[:64])).reshape(-1)
    assert (int((eager == 0).sum()), int((eager == 1).sum())) == (31, 33)
    assert np.mean(served == eager) < 0.5 and not set(np.unique(served)) <= {0.0, 1.0}
    from spark_rapids_ml_tpu_torch.convert import model_from_arrays

    port = model_from_arrays("GBTClassificationModel", model._saveData(), device="cpu")
    with pytest.raises(TypeError, match="no serve contract"):
        registry_mod.ModelRegistry(device="cpu").register("gbt", port)
