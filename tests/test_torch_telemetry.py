"""The port's telemetry core against the JAX package's.

The same counter, gauge and histogram operations render the same
Prometheus text in both registries; trace-context tokens round-trip both
ways; the flight recorder's Chrome export and a stitched tree agree; the
tuning cache builds the JAX package's keys and reads its files. The
exporter serves ``/metrics`` and ``/traces``; the knobs are read at call
time.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request

import jax  # noqa: F401  (imported at the top of every port test file)
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.autotune import cache as jcache
from spark_rapids_ml_tpu.autotune.policy import TuningConfig as JaxTuningConfig
from spark_rapids_ml_tpu.telemetry import registry as jregistry
from spark_rapids_ml_tpu.telemetry import timeline as jtimeline
from spark_rapids_ml_tpu.telemetry import tracectx as jtracectx
from spark_rapids_ml_tpu_torch.autotune import cache
from spark_rapids_ml_tpu_torch.autotune.policy import TuningConfig
from spark_rapids_ml_tpu_torch.telemetry import compilemon, httpd, trace_range, tracectx
from spark_rapids_ml_tpu_torch.telemetry import registry as pregistry
from spark_rapids_ml_tpu_torch.telemetry import timeline as ptimeline
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY

# -- registry ------------------------------------------------------------------

VALUES = [0.0, 1e-6, 3.2e-5, 0.0004, 0.0021, 0.0021, 0.013, 0.5, 2.0, 77.0]


def _drive(reg) -> None:
    reg.counter_inc("serve.requests", model="pca512", code=200)
    reg.counter_inc("serve.requests", 3, model="pca512", code=200)
    reg.counter_inc("serve.errors", model='we"ird\\name\n', code=404)
    reg.counter_inc("serve.json_codec", op="encode")
    reg.gauge_set("serve.models", 3)
    reg.gauge_set("serve.hbm_bytes", 102400.0)
    for v in VALUES:
        reg.histogram_record("serve.latency", v, model="pca512", transport="uds", wire="fast")
    reg.histogram_record("serve.queue_delay_us", 250.0, exemplar="00ab", model="m")
    reg.histogram_record("serve.batch_rows", 8)


def test_metrics_text_is_the_jax_packages():
    port, ref = pregistry.MetricsRegistry(), jregistry.MetricsRegistry()
    _drive(port)
    _drive(ref)
    text = port.snapshot().to_prometheus()
    assert text == ref.to_prometheus()
    assert 'tpu_ml_serve_latency_bucket{model="pca512",transport="uds",wire="fast",le="+Inf"} 10' in text
    assert pregistry.MetricsRegistry().snapshot().to_prometheus() == ""


def test_snapshot_delta_and_histograms_match():
    port, ref = pregistry.MetricsRegistry(), jregistry.MetricsRegistry()
    _drive(port)
    _drive(ref)
    ps, rs = port.snapshot(), ref.snapshot()
    _drive(port)
    _drive(ref)
    pd, rd = port.snapshot().delta(ps), ref.snapshot().delta(rs)
    assert pd.counters == rd.counters
    assert pd.to_prometheus() == rd.to_prometheus()
    assert pd.counter("serve.requests") == 4 == rd.counter("serve.requests")
    assert pd.counter("serve.requests", model="pca512", code=200) == 4
    ph, rh = pd.hist("serve.latency"), rd.hist("serve.latency", transport="uds")
    assert ph.to_dict() == rh.to_dict()
    for q in (0, 1, 50, 90, 99, 100):
        assert ph.percentile(q) == rh.percentile(q)
    assert pd.exemplars_for("serve.queue_delay_us") == rd.exemplars_for("serve.queue_delay_us")


def test_histogram_edges_match():
    for v in (0.0, -1.0, 1e-9, 1.0, 1.19, 1e6):
        assert pregistry.Histogram.bucket_index(v) == jregistry.Histogram.bucket_index(v)
    assert pregistry.GROWTH == jregistry.GROWTH


def test_exemplars_keep_the_slowest(monkeypatch):
    monkeypatch.setenv("TPU_ML_TRACE_EXEMPLARS", "2")
    reg = pregistry.MetricsRegistry()
    for v, t in ((1.0, "a"), (5.0, "b"), (3.0, "c"), (0.5, "d")):
        reg.histogram_record("serve.latency", v, exemplar=t)
    assert reg.snapshot().exemplars_for("serve.latency") == [(5.0, "b"), (3.0, "c")]
    monkeypatch.setenv("TPU_ML_TRACE_EXEMPLARS", "0")
    reg.histogram_record("serve.other", 1.0, exemplar="e")
    assert reg.snapshot().exemplars_for("serve.other") == []


def test_registry_is_thread_safe():
    import sys
    import threading

    reg = pregistry.MetricsRegistry()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def work():
            for _ in range(2000):
                reg.counter_inc("c")
                reg.histogram_record("h", 1.0)

        threads = [threading.Thread(target=work) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    snap = reg.snapshot()
    assert snap.counter("c") == 32_000 and snap.hist("h").count == 32_000


# -- tracectx ------------------------------------------------------------------


def test_header_tokens_round_trip_both_ways():
    port = tracectx.TraceContext(0xFEDCBA9876543210, 0x1234ABCD, 987654321)
    jax_ctx = jtracectx.from_header(port.to_header())
    assert (jax_ctx.trace_id, jax_ctx.span_id, jax_ctx.origin_us) == (
        port.trace_id, port.span_id, port.origin_us
    )
    assert jax_ctx.to_header() == port.to_header()
    ref = jtracectx.TraceContext(7, 9, 11)
    back = tracectx.from_header(ref.to_header())
    assert back == tracectx.TraceContext(7, 9, 11) and back.to_header() == ref.to_header()
    assert tracectx.TRACE_HEADER == jtracectx.TRACE_HEADER
    assert tracectx.TRACE_STRUCT.format == jtracectx.TRACE_STRUCT.format


@pytest.mark.parametrize("raw", [
    "", "zz-1-2", "1-2", "0-1-2", "1-0-2", "1-2--3", f"{1 << 64:x}-1-1", f"1-{1 << 32:x}-1",
    "0000000000000001-00000001-5",
])
def test_malformed_headers_degrade_alike(raw):
    port, ref = tracectx.from_header(raw), jtracectx.from_header(raw)
    assert (port is None) == (ref is None)
    if port is not None:
        assert port.to_header() == ref.to_header()


def test_from_wire_and_mint(monkeypatch):
    assert tracectx.from_wire(0, 5, 6) is None
    ctx = tracectx.from_wire(3, 4, 5)
    assert (ctx.trace_id, ctx.span_id, ctx.origin_us) == (3, 4, 5)
    assert tracectx.from_wire(3, 0, -1).span_id != 0
    monkeypatch.setenv("TPU_ML_TRACE_SAMPLE", "0")
    assert tracectx.mint() is None
    monkeypatch.setenv("TPU_ML_TRACE_SAMPLE", "1")
    snap = REGISTRY.snapshot()
    minted = tracectx.mint(origin="http")
    assert minted.trace_id and minted.span_id
    assert REGISTRY.snapshot().delta(snap).counter("serve.traces", origin="http") == 1
    child = minted.child()
    assert child.trace_id == minted.trace_id and child.span_id != minted.span_id
    token = tracectx.set_current_trace(minted)
    try:
        assert tracectx.current_trace() is minted
    finally:
        tracectx.reset_current_trace(token)
    assert tracectx.current_trace() is None


def _events(timeline_mod, tracectx_mod):
    tl = timeline_mod.Timeline(capacity=64)
    root = tracectx_mod.TraceContext(0xAB, 0x01, 100)
    child = tracectx_mod.TraceContext(0xAB, 0x02, 100)
    tl.record_span("serve.request", 1.0, 1.5, model="m", **tracectx_mod.span_labels(root))
    tl.record_span("serve.queue", 1.1, 1.2, model="m",
                   **tracectx_mod.span_labels(child, parent=root))
    tl.record_span("serve.dispatch", 1.2, 1.3, links=tracectx_mod.link_token(child))
    tl.record_instant("serve.swap", model="m")
    events = tl.events()
    for e in events:
        e["pid"], e["tid"] = 1, 1
        if e["ph"] == "i":
            e["ts"] = 0
    return events


def test_stitch_and_coverage_match():
    port = _events(ptimeline, tracectx)
    ref = _events(jtimeline, jtracectx)
    assert port == ref
    tid = f"{0xAB:016x}"
    assert tracectx.stitch(port, tid) == jtracectx.stitch(ref, tid)
    tree = tracectx.stitch(port, tid)
    assert tree["complete"] and tree["roots"][0]["children"][0]["name"] == "serve.queue"
    assert tracectx.coverage(port) == jtracectx.coverage(ref)
    assert tracectx.stitch(port, "f" * 16) is None


# -- timeline ------------------------------------------------------------------


def test_timeline_is_bounded_and_exports_chrome_trace(monkeypatch):
    monkeypatch.setenv("TPU_ML_TIMELINE_EVENTS", "3")
    tl = ptimeline.Timeline()
    assert tl.capacity == 3
    for i in range(5):
        tl.record_span("s", i, i + 0.5, i=str(i))
    assert len(tl) == 3 and tl.seq() == 5
    assert [e["args"]["i"] for e in tl.events(since_seq=3)] == ["3", "4"]
    events = tl.events()
    assert ptimeline.chrome_trace(events) == jtimeline.chrome_trace(events)
    monkeypatch.setenv("TPU_ML_TIMELINE_EVENTS", "0")
    off = ptimeline.Timeline()
    off.record_span("s", 0, 1)
    assert len(off) == 0
    monkeypatch.setenv("TPU_ML_TIMELINE_EVENTS", "-1")
    with pytest.raises(ValueError, match=">= 0"):
        ptimeline.timeline_capacity()
    monkeypatch.setenv("TPU_ML_TIMELINE_EVENTS", "many")
    with pytest.raises(ValueError, match="not an integer"):
        ptimeline.timeline_capacity()


# -- compilemon ----------------------------------------------------------------


def test_graph_captures_are_booked():
    snap = REGISTRY.snapshot()
    compilemon.record_graph_capture(0.002, "register")
    compilemon.record_graph_capture(0.003, "page_in")
    delta = REGISTRY.snapshot().delta(snap)
    assert delta.counter("compile.graph_captures") == 2
    assert delta.counter("compile.graph_captures", reason="page_in") == 1
    assert delta.hist("compile.graph_capture_seconds").total == pytest.approx(0.005)
    with pytest.raises(ValueError, match="capture reason"):
        compilemon.record_graph_capture(0.1, "xla")


def test_device_memory_is_empty_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert compilemon.sample_device_memory() == {}


# -- exporter ------------------------------------------------------------------


def _get(url: str):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_exporter_serves_metrics_and_traces():
    from spark_rapids_ml_tpu_torch.telemetry.timeline import TIMELINE

    srv = httpd.HealthHTTPServer(0).start()
    url = f"http://127.0.0.1:{srv.port}"
    try:
        REGISTRY.counter_inc("serve.requests", model="exporter-test", code=200)
        code, body = _get(f"{url}/metrics")
        assert code == 200 and b'tpu_ml_serve_requests{code="200",model="exporter-test"}' in body
        ctx = tracectx.TraceContext(0xC0FFEE, 0x42, 1)
        TIMELINE.record_span("serve.request", 1.0, 2.0, **tracectx.span_labels(ctx))
        code, body = _get(f"{url}/traces")
        assert code == 200 and json.loads(body)["traces"] >= 1
        code, body = _get(f"{url}/traces/{ctx.trace_hex}")
        assert code == 200 and json.loads(body)["complete"]
        code, _ = _get(f"{url}/traces/{'0' * 15}1")
        assert code == 404
        # no health monitor runs: /healthz says UNKNOWN, /slo is empty
        code, body = _get(f"{url}/healthz")
        assert code == 200 and json.loads(body)["state"] == "UNKNOWN"
        code, body = _get(f"{url}/slo")
        assert code == 200 and json.loads(body) == {}
        code, body = _get(f"{url}/report")
        assert code == 200 and isinstance(json.loads(body)["reports"], list)
        assert _get(f"{url}/nope")[0] == 404
    finally:
        srv.stop()


# -- tuning cache ----------------------------------------------------------------


def test_cache_keys_are_the_jax_packages():
    assert cache.device_kind("cpu") == jcache.device_kind() == "cpu/cpu"
    for kw in ({"n": 512}, {"n": 16, "rows": 1000}, {"n": 3, "rows": 0, "dtype": "float32"}):
        assert cache.cache_key("serve.pca", **kw) == jcache.cache_key("serve.pca", **kw)
    assert cache.shape_bucket(7, 100) == jcache.shape_bucket(7, 100)


def test_a_file_blessed_by_the_jax_package_is_read(tmp_path, monkeypatch):
    path = tmp_path / "tuning.json"
    key = jcache.cache_key("serve.pca", n=16)
    jcache.write_cache(str(path), {key: {"config": JaxTuningConfig(policy="bf16_f32acc").to_dict()}})
    monkeypatch.setenv("TPU_ML_TUNING_CACHE_PATH", str(path))
    cache.reset()
    try:
        snap = REGISTRY.snapshot()
        assert cache.lookup(cache.cache_key("serve.pca", n=16, device="cpu/cpu")) == TuningConfig(
            policy="bf16_f32acc"
        )
        assert cache.lookup("missing") is None
        delta = REGISTRY.snapshot().delta(snap)
        assert delta.counter("autotune.cache_hits") == 1
        assert delta.counter("autotune.cache_misses") == 1
        cache.store("other", TuningConfig(chunk_rows=1024), measured_s=0.5, trials=3)
        doc = json.loads(path.read_text())
        assert set(doc["entries"]) == {key, "other"} and doc["schema"] == jcache.CACHE_SCHEMA
        assert doc["entries"]["other"]["trials"] == 3
    finally:
        cache.reset()


def test_tuning_config_validates():
    assert TuningConfig.from_dict(TuningConfig(chunk_rows=8, layout="col").to_dict()) == \
        TuningConfig(chunk_rows=8, layout="col")
    with pytest.raises(ValueError, match="layout"):
        TuningConfig(layout="diagonal")
    with pytest.raises(ValueError, match="precision policy"):
        TuningConfig(policy="fp4")
    with pytest.raises(ValueError, match="chunk_rows"):
        TuningConfig(chunk_rows=0)


# -- the package ----------------------------------------------------------------


def test_trace_range_is_a_no_op_on_the_cpu():
    with trace_range("phase", torch.device("cpu")):
        pass


def test_serving_knobs_are_read_at_call_time(monkeypatch):
    from spark_rapids_ml_tpu_torch.serving import batcher, buckets

    monkeypatch.setenv("TPU_ML_SERVE_MAX_DELAY_US", "500")
    monkeypatch.setenv("TPU_ML_SERVE_ADAPTIVE_WINDOW", "0")
    monkeypatch.setenv("TPU_ML_SERVE_MIN_BUCKET", "4")
    assert batcher.coalesce_window_s() == 5e-4 and not batcher.adaptive_window_enabled()
    assert buckets.min_bucket() == 4
    monkeypatch.setenv("TPU_ML_SERVE_MAX_DELAY_US", "oops")
    monkeypatch.setenv("TPU_ML_SERVE_ADAPTIVE_WINDOW", "1")
    assert batcher.coalesce_window_s() == 2e-3 and batcher.adaptive_window_enabled()
    monkeypatch.setenv("TPU_ML_TRACE_SAMPLE", "7")
    assert tracectx.trace_sample_rate() == 1.0 == jtracectx.trace_sample_rate()
    assert np.isclose(batcher.coalesce_window_s(), 2e-3)
