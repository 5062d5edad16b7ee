"""The port's multi-process serve fleet against the JAX package's, on the CPU.

Pure pieces against the JAX package's, with no tolerance: the ``HashRing``
preference order over 1,000 keys, the model spec (a spec written by either
package loads in the other; its arrays bit for bit, its predictions within
1e-5 × max |expected|), ``plan_placement`` and the fast-lane relay helpers
(byte for byte).

One module-scoped fleet of 2 CPU replicas (``device="cpu"``: each replica
runs the kernels eagerly) runs the end-to-end cases: the fast lane and the
JSON wire through the router (bit for bit against each other and against
the parent process's registry, within 1e-5 × max |expected| of the JAX
package's registry), home-replica hits, an error relayed on a live
connection, the ``stats`` frame, the exporter's sums against the
per-replica registries, and a ``swap_models`` walk under live load with no
failed request: a rolling restart of both replicas, whose trailers land in
the fleet's totals and whose respawns report models × ladder warm rungs, no
graph capture (no card) and no cold capture after READY. Four replica
spawns in all.
"""

from __future__ import annotations

import json
import socket
import threading
import urllib.error
import urllib.request

import jax  # noqa: F401  (imported at the top of every port test file)
import numpy as np
import pytest

from spark_rapids_ml_tpu.models.linear import LinearRegression as JaxLinearRegression
from spark_rapids_ml_tpu.models.pca import PCA as JaxPCA
from spark_rapids_ml_tpu.serving import fastlane as jfastlane
from spark_rapids_ml_tpu.serving import fleet as jfleet
from spark_rapids_ml_tpu.serving import registry as jregistry
from spark_rapids_ml_tpu_torch.convert import model_from_arrays
from spark_rapids_ml_tpu_torch.models.scaler import StandardScaler
from spark_rapids_ml_tpu_torch.serving import fastlane
from spark_rapids_ml_tpu_torch.serving import fleet as fleet_mod
from spark_rapids_ml_tpu_torch.serving import registry as registry_mod
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY, MetricsRegistry
from spark_rapids_ml_tpu_torch.telemetry import tracectx

N = 6
BUCKETS = (8, 16)
REL_TOL = 1e-5


def _xy(rows: int, seed: int):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, N)) * np.linspace(3.0, 0.5, N)).astype(np.float32)
    return x, (x @ np.arange(1.0, N + 1.0) + 0.5).astype(np.float32)


@pytest.fixture(scope="module")
def jax_models():
    x, y = _xy(256, 11)
    return x, JaxPCA().setK(3).fit(x), JaxLinearRegression().fit((x, y))


def _port(jmodel):
    return model_from_arrays(type(jmodel).__name__, jmodel._saveData(), device="cpu")


def _assert_close(got, expected):
    got, expected = np.asarray(got, np.float64), np.asarray(expected, np.float64)
    assert got.shape == expected.shape
    assert np.abs(got - expected).max() <= REL_TOL * np.abs(expected).max()


# -- the pure pieces -----------------------------------------------------------


@pytest.mark.parametrize("slots", [[0, 1], [0, 1, 2], [0, 1, 2, 3], [3, 5, 8]])
def test_hash_ring_order_matches_jax(slots):
    ring, ref = fleet_mod.HashRing(slots), jfleet.HashRing(slots)
    assert ring.slots == ref.slots
    for i in range(1000):
        key = fleet_mod.HashRing.key(f"model{i % 37}", 8 << (i % 6))
        assert key == jfleet.HashRing.key(f"model{i % 37}", 8 << (i % 6))
        assert ring.preference(key) == ref.preference(key)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_a_spec_written_by_either_package_loads_in_the_other(jax_models, tmp_path, writer):
    x, jpca, jlin = jax_models
    path = str(tmp_path / "spec.npz")
    if writer == "port":
        sizes = fleet_mod.write_spec(path, {"p": _port(jpca), "l": _port(jlin)})
        loaded, ref = jfleet.load_spec(path), {"p": _port(jpca), "l": _port(jlin)}
        assert sizes == jfleet.write_spec(str(tmp_path / "ref.npz"), {"p": jpca, "l": jlin})
    else:
        sizes = jfleet.write_spec(path, {"p": jpca, "l": jlin})
        loaded, ref = fleet_mod.load_spec(path, device="cpu"), {"p": jpca, "l": jlin}
    assert set(sizes) == {"p", "l"} and all(v > 0 for v in sizes.values())
    with open(path + ".json") as f:
        assert json.load(f) == {"l": {"family": "linear", "arrays": ["coefficients", "intercept"]},
                                "p": {"family": "pca", "arrays": ["explainedVariance", "pc"]}}
    assert np.array_equal(np.asarray(loaded["p"].pc), np.asarray(ref["p"].pc))
    assert np.array_equal(np.asarray(loaded["l"].coefficients), np.asarray(ref["l"].coefficients))
    assert loaded["l"].intercept == ref["l"].intercept
    for name in ("p", "l"):
        _assert_close(np.asarray(loaded[name].transform(x[:16])),
                      np.asarray(ref[name].transform(x[:16])))


def test_models_without_a_fleet_spec_are_refused_as_in_jax(tmp_path):
    x, _ = _xy(64, 1)
    scaler = StandardScaler(device="cpu").fit(x)
    for model in (object(), scaler):
        with pytest.raises(TypeError, match="no fleet spec") as err:
            fleet_mod.write_spec(str(tmp_path / "bad.npz"), {"m": model})
        assert type(model).__name__ in str(err.value)
    with pytest.raises(TypeError) as port_err:
        fleet_mod.write_spec(str(tmp_path / "a.npz"), {"m": object()})
    with pytest.raises(TypeError) as jax_err:
        jfleet.write_spec(str(tmp_path / "b.npz"), {"m": object()})
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("sizes,replicas,budget", [
    ({"a": 1000, "b": 2000}, 2, 4000),
    ({"a": 3000, "b": 2000}, 2, 4000),
    ({"a": 10**12}, 1, None),
    ({}, 3, 0),
])
def test_plan_placement_matches_jax(sizes, replicas, budget):
    assert fleet_mod.plan_placement(sizes, replicas, budget_bytes=budget) == (
        jfleet.plan_placement(sizes, replicas, budget_bytes=budget))


def test_fast_lane_relay_helpers_are_byte_equal_to_jax():
    assert fastlane.request_struct_size() == jfastlane.request_struct_size()
    assert fastlane.response_struct_size() == jfastlane.response_struct_size()
    ctx = tracectx.TraceContext(trace_id=0x1234_5678_9ABC_DEF0, span_id=77, origin_us=99)
    for rows, cols, name in ((1, 6, "lin"), (37, 512, "a-longer-model-name"), (4096, 1, "x")):
        x = np.arange(rows * cols, dtype=np.float32).reshape(rows, cols)
        for trace in (None, ctx):
            frame = fastlane.pack_request(name, x, trace=trace)
            assert frame == jfastlane.pack_request(name, x, trace=trace)
            struct = frame[4:4 + fastlane.request_struct_size()]
            assert fastlane.peek_request(struct) == jfastlane.peek_request(struct) == (
                len(name), rows, cols)
        head = fastlane.pack_response_header(200, rows, cols, rows * cols * 4)
        assert head == jfastlane.pack_response_header(200, rows, cols, rows * cols * 4)
        struct = head[4:]
        assert fastlane.peek_response_payload_len(struct) == (
            jfastlane.peek_response_payload_len(struct)) == rows * cols * 4
    bad = bytearray(fastlane.pack_request("m", np.ones((1, 1), np.float32))[4:36])
    bad[0] = 9
    with pytest.raises(ValueError, match="unsupported fastlane version"):
        fastlane.peek_request(bytes(bad))


def test_a_replica_without_a_card_refuses_to_start(jax_models, tmp_path, monkeypatch):
    _, jpca, _ = jax_models
    monkeypatch.setattr(fleet_mod.torch.cuda, "is_available", lambda: False)
    path = str(tmp_path / "spec.npz")
    fleet_mod.write_spec(path, {"p": _port(jpca)})
    with pytest.raises(RuntimeError):
        fleet_mod._replica_main(["--spec", path, "--socket", str(tmp_path / "s.sock")])
    with pytest.raises(RuntimeError):
        fleet_mod.ServeFleet({"p": _port(jpca)}, replicas=1, socket_dir=str(tmp_path))


# -- the live fleet ------------------------------------------------------------


@pytest.fixture(scope="module")
def live_fleet(jax_models, tmp_path_factory):
    """One 2-replica CPU fleet for the end-to-end cases."""
    x, jpca, jlin = jax_models
    models = {"pca": _port(jpca), "lin": _port(jlin)}
    fleet = fleet_mod.ServeFleet(
        models, replicas=2, socket_dir=str(tmp_path_factory.mktemp("fleet_sock")),
        bucket_list=BUCKETS, device="cpu",
    ).start()
    parent = registry_mod.ModelRegistry("cpu")
    for name, model in models.items():
        parent.register(name, model, bucket_list=BUCKETS)
    yield x, fleet, parent
    fleet.stop()


def _read_exact(rf, n: int) -> bytes:
    chunks = []
    while n > 0:
        chunk = rf.read(n)
        assert chunk, "peer closed mid-frame"
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def _fast_call(sock, rf, model: str, x32: np.ndarray) -> np.ndarray:
    sock.sendall(fastlane.pack_request(model, x32))
    return fastlane.read_response(lambda n: _read_exact(rf, n))


def _json_call(sock, rf, model: str, rows: np.ndarray) -> dict:
    header = json.dumps({"model": model, "wire": "json", "instances": rows.tolist()}).encode()
    sock.sendall(len(header).to_bytes(4, "big") + header)
    return json.loads(_read_exact(rf, int.from_bytes(_read_exact(rf, 4), "big")))


def _connect(fleet):
    s = socket.socket(socket.AF_UNIX)
    s.connect(fleet.router_path)
    return s, s.makefile("rb")


def test_both_wires_relay_with_parity(live_fleet, jax_models):
    x, fleet, parent = live_fleet
    _, jpca, jlin = jax_models
    jreg = jregistry.ModelRegistry()
    jreg.register("pca", jpca, bucket_list=BUCKETS)
    jreg.register("lin", jlin, bucket_list=BUCKETS)
    x32 = np.ascontiguousarray(x[:4])
    s, rf = _connect(fleet)
    with s:
        for model in ("pca", "lin"):
            fast_out = _fast_call(s, rf, model, x32)
            resp = _json_call(s, rf, model, x32)
            assert resp["ok"] and resp["rows"] == 4
            json_out = np.asarray(resp["predictions"], dtype="<f4").reshape(fast_out.shape)
            assert fast_out.tobytes() == json_out.tobytes()
            local = np.asarray(parent.predict(model, x32), "<f4").reshape(fast_out.shape)
            assert fast_out.tobytes() == local.tobytes()
            _assert_close(fast_out, np.asarray(jreg.predict(model, x32)).reshape(fast_out.shape))


def test_consistent_routing_books_home_hits(live_fleet):
    x, fleet, _ = live_fleet
    snap = REGISTRY.snapshot()
    s, rf = _connect(fleet)
    with s:
        for _ in range(6):
            _fast_call(s, rf, "pca", x[:4])
    delta = REGISTRY.snapshot().delta(snap)
    assert delta.counter("serve.route_hits", model="pca") == 6
    assert delta.counter("serve.route_misses", model="pca") == 0


def test_an_error_relays_without_killing_the_connection(live_fleet):
    x, fleet, _ = live_fleet
    s, rf = _connect(fleet)
    with s:
        with pytest.raises(fastlane.FastlaneError) as e:
            _fast_call(s, rf, "ghost", x[:2])
        assert e.value.status == 404
        assert _json_call(s, rf, "ghost", x[:2])["code"] == 404
        assert _fast_call(s, rf, "lin", x[:2]).shape == (2, 1)


def _drive(fleet, x, n_fast: int = 4, n_json: int = 2) -> None:
    s, rf = _connect(fleet)
    with s:
        for _ in range(n_fast):
            _fast_call(s, rf, "pca", x[:4])
        for _ in range(n_json):
            assert _json_call(s, rf, "lin", x[:4])["ok"]


def _scrape(fleet, slot: int):
    st = fleet.scrape_stats(slot)
    assert st is not None, f"replica {slot} not scrapable"
    reg = MetricsRegistry()
    reg.merge_wire(st["registry"])
    return st, reg.snapshot()


def test_the_stats_frame_scrapes_registry_and_events(live_fleet):
    x, fleet, _ = live_fleet
    _drive(fleet, x)
    total = 0.0
    for slot in (0, 1):
        st, snap = _scrape(fleet, slot)
        assert st["ok"] and st["kind"] == "stats" and st["pid"] > 0 and st["mono_us"] > 0
        assert isinstance(st["events"], list) and st["seq"] >= 0
        total += snap.counter("serve.requests")
    assert total >= 6
    stats = fleet.stats()
    assert stats["replicas"] == stats["live_replicas"] == 2 and stats["placement"]["fits"]
    assert sorted(stats["clock_offsets_us"]) == ["0", "1"] == sorted(stats["in_flight"])


def _by_replica(snap, name: str) -> dict:
    out: dict = {}
    for (n, labels), v in snap.counters.items():
        if n == name:
            rep = dict(labels).get("replica", "")
            out[rep] = out.get(rep, 0) + v
    return out


def test_exporter_sums_equal_the_replica_registries(live_fleet):
    x, fleet, _ = live_fleet
    _drive(fleet, x, n_fast=3, n_json=1)
    per_slot = {str(slot): _scrape(fleet, slot)[1] for slot in (0, 1)}
    harvested = fleet._final_registry.snapshot()
    merged = fleet.fleet_registry(include_router=False).snapshot()
    for name in ("serve.requests", "serve.rows", "serve.batches"):
        assert merged.counter(name) == pytest.approx(
            sum(s.counter(name) for s in per_slot.values()) + harvested.counter(name)), name
    by_rep = _by_replica(merged, "serve.requests")
    for slot, snap in per_slot.items():
        assert by_rep.get(slot, 0) == pytest.approx(snap.counter("serve.requests"))
    ex = fleet.start_exporter()
    assert fleet.start_exporter() is ex
    body = urllib.request.urlopen(ex.url("/metrics"), timeout=10).read().decode()
    assert 'replica="0"' in body and 'replica="1"' in body and 'replica="router"' in body
    health = json.loads(urllib.request.urlopen(ex.url("/healthz"), timeout=10).read())
    assert health["status"] == "ok" and health["components"]["router"] == "ok"
    relays = [e for e in fleet.fleet_events() if e.get("name") == "serve.relay"]
    assert relays, "the router recorded no relay span"
    tid = (relays[-1].get("args") or {}).get("trace_id")
    tree = json.loads(urllib.request.urlopen(ex.url(f"/traces/{tid}"), timeout=10).read())
    assert tree["trace_id"] == tid and tree["complete"] and len(tree["roots"]) == 1
    assert tree["roots"][0]["name"] == "serve.relay"
    assert "serve.request" in {c["name"] for c in tree["roots"][0]["children"]}
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(ex.url("/nope"), timeout=10)
    assert err.value.code == 404
    assert fleet.drain(1)
    try:
        health = json.loads(urllib.request.urlopen(ex.url("/healthz"), timeout=10).read())
        assert health["status"] == "degraded" and health["components"]["replica-1"] == "draining"
    finally:
        fleet.undrain(1)


def test_a_request_waits_while_every_replica_drains(live_fleet):
    """Between one restart of a walk and the next, or in a one-replica
    fleet, every live replica can be draining at once: the request waits
    for the ring to change instead of failing."""
    x, fleet, _ = live_fleet
    assert fleet.drain(0) and fleet.drain(1)
    out = {}

    def call():
        s, rf = _connect(fleet)
        with s:
            out["y"] = _fast_call(s, rf, "lin", x[:2])

    t = threading.Thread(target=call)
    t.start()
    try:
        t.join(0.3)
        assert t.is_alive() and "y" not in out
    finally:
        fleet.undrain(1)
        t.join(10)
        fleet.undrain(0)
    assert out["y"].shape == (2, 1)


def test_swap_models_under_live_load_restarts_every_replica_with_no_failure(
    live_fleet, jax_models
):
    """The rolling restart: ``swap_models`` drains and respawns both
    replicas while four clients keep sending; no request fails, every
    outgoing incarnation's trailer lands in the fleet's totals, and each
    respawn warms models × ladder rungs with no cold capture after READY.
    Runs last: it stops the fleet to read the respawns' reports."""
    x, fleet, parent = live_fleet
    _, _, jlin = jax_models
    xs, ys = _xy(256, 12)
    new_lin = _port(JaxLinearRegression().fit((xs, 2.0 * ys)))
    x32 = np.ascontiguousarray(x[:4])
    stop = threading.Event()
    failures: list[Exception] = []
    completed = [0]

    def hammer():
        s, rf = _connect(fleet)
        with s:
            while not stop.is_set():
                try:
                    _fast_call(s, rf, "lin", x32)
                    assert _json_call(s, rf, "pca", x32)["ok"]
                    completed[0] += 2
                except Exception as e:  # noqa: BLE001 - collected, asserted empty below
                    failures.append(e)
                    return

    old = {slot: fleet.replica(slot).proc.pid for slot in (0, 1)}
    before = fleet._final_registry.snapshot().counter("serve.requests")
    threads = [threading.Thread(target=hammer) for _ in range(4)]
    for t in threads:
        t.start()
    try:
        snap = REGISTRY.snapshot()
        assert fleet.swap_models({"lin": new_lin})
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
    assert not failures, f"requests failed during the rolling restart: {failures[:3]}"
    assert completed[0] > 0
    delta = REGISTRY.snapshot().delta(snap)
    assert delta.counter("serve.drain_events") == 2
    assert delta.counter("serve.replica_restarts") == 2
    assert all((slot, pid) in fleet._harvested for slot, pid in old.items())
    assert fleet._final_registry.snapshot().counter("serve.requests") > before
    expected = registry_mod.ModelRegistry("cpu")
    expected.register("lin", new_lin, bucket_list=BUCKETS)
    s, rf = _connect(fleet)
    with s:
        for _ in range(4):  # every replica now serves the new version
            got = _fast_call(s, rf, "lin", x32).ravel()
            assert got.tobytes() == np.asarray(expected.predict("lin", x32), "<f4").tobytes()
    respawns = [fleet.replica(slot) for slot in (0, 1)]
    assert all(r.ready_s is not None and r.ready_s > 0 for r in respawns)
    fleet.stop()
    for r in respawns:
        assert r.graph_captures == 0  # no card: no graph
        assert r.warm_rungs == 2 * len(BUCKETS)
        assert r.cold_compiles == 0
