"""Fit telemetry and health of the port against the JAX package's, on the
CPU: FitReport and TransformReport, spans, the JSONL sinks, the SLO
engine, the health monitor, admission control for fits and SLO shedding
for serving, and the exporter's ``/healthz``, ``/slo`` and ``/report``.

- The reports' ``to_dict`` keys, and those of their nested maps, equal the
  JAX package's for the same fit and transform.
- The SLO engines of both packages, fed the same samples into their own
  registries and evaluated at the same instants, take the same decisions
  (value, breach, streak, breach count): percentiles are equal (the same
  log buckets), throughput rates within 1e-3 (each engine's window starts
  at its own construction, microseconds apart).
- Admission control and shedding decide alike in both packages under
  ``refuse``, ``degrade`` and ``off``.
- No monitor thread, probe or report is the first to touch CUDA: with a
  card reported present but not initialized, nothing reads it.

The two ``cuda``-marked tests (the FitReport's device memory on the card)
skip here.
"""

from __future__ import annotations

import json
import logging
import time
import urllib.error
import urllib.request

import jax  # noqa: F401  (imported at the top of every port test file)
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu import PCA as JaxPCA
from spark_rapids_ml_tpu.models.pipeline import Pipeline as JaxPipeline
from spark_rapids_ml_tpu.models.scaler import StandardScaler as JaxStandardScaler
from spark_rapids_ml_tpu.serving import hbm as jhbm
from spark_rapids_ml_tpu.telemetry import export as jexport
from spark_rapids_ml_tpu.telemetry import health as jhealth
from spark_rapids_ml_tpu.telemetry import registry as jregistry
from spark_rapids_ml_tpu.telemetry import slo as jslo
from spark_rapids_ml_tpu.utils.config import get_config as jax_config
from spark_rapids_ml_tpu.utils.config import set_config as set_jax_config
from spark_rapids_ml_tpu_torch import PCA, Pipeline, StandardScaler, telemetry
from spark_rapids_ml_tpu_torch.serving import hbm
from spark_rapids_ml_tpu_torch.telemetry import export, health, httpd, report, slo, spans
from spark_rapids_ml_tpu_torch.telemetry import registry as pregistry
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY

ROWS, N, K = 400, 12, 3


@pytest.fixture(scope="module")
def x():
    rng = np.random.default_rng(5)
    return (rng.normal(size=(ROWS, 6)) @ rng.normal(size=(6, N))).astype(np.float32)


@pytest.fixture(autouse=True)
def no_monitors(monkeypatch):
    """Every test starts and ends without a monitor or an exporter in
    either package, and with admission control at its default."""
    monkeypatch.delenv("TPU_ML_ADMISSION_POLICY", raising=False)
    monkeypatch.delenv("TPU_ML_HTTP_PORT", raising=False)
    yield
    httpd.stop_http_server()
    health.stop_monitor()
    jhealth.stop_monitor()


# -- reports ---------------------------------------------------------------------------------


def _keys(d: dict) -> dict:
    """The key tree of a report dict (nested maps by their keys)."""
    return {k: sorted(v) if k in ("compile", "collectives") else None for k, v in d.items()}


def test_fit_and_transform_report_keys_equal_jax(x):
    port = PCA(device="cpu").setK(K).fit(x)
    ref = JaxPCA().setK(K).fit(x)
    assert _keys(port.fit_report.to_dict()) == _keys(ref.fit_report.to_dict())
    assert port.fit_report.schema == ref.fit_report.schema
    port.transform(x)
    ref.transform(x)
    assert port.transform_report.to_dict().keys() == ref.transform_report.to_dict().keys()
    d = port.fit_report.to_dict()
    assert d["cost_model"] == {} and d["tuning"] == {}  # not ported: keys only
    assert report.FitReport.from_dict(d).to_dict() == d
    t = port.transform_report.to_dict()
    assert report.TransformReport.from_dict(t).to_dict() == t
    assert t["rows"] == ROWS and t["bytes"] == x.nbytes


def test_fit_report_phases_rows_and_ids(x, caplog):
    model = PCA(device="cpu").setK(K).fit(x, num_partitions=2)
    rep = model.fit_report
    assert rep.estimator == "PCA" and rep.uid == model.uid
    assert rep.rows_ingested == ROWS and rep.bytes_ingested == x.nbytes
    assert set(rep.phases) == {"compute cov", "eigh"}
    assert rep.phases["eigh"]["count"] == 1 and rep.wall_seconds > 0
    assert rep.overlap_fraction is None and rep.device_memory == {}
    assert rep.admission["action"] == "admit" and rep.health == {}
    # the fit id rides the log records and the timeline of the fit's window
    spans.install_fit_id_filter()
    logger = logging.getLogger("spark_rapids_ml_tpu_torch")  # the filter's logger
    with caplog.at_level(logging.INFO, logger="spark_rapids_ml_tpu_torch"):
        token = spans.set_current_fit_id("f00d")
        try:
            logger.info("inside")
        finally:
            spans.reset_current_fit_id(token)
    assert [getattr(r, "fit_id", None) for r in caplog.records] == ["f00d"]
    events = [e for e in telemetry.TIMELINE.events() if e["args"].get("fit_id") == rep.fit_id]
    assert {e["name"] for e in events} == {"compute cov", "eigh"}
    assert all(e["args"]["estimator"] == "PCA" for e in events)


def test_streamed_fit_report_reads_the_folds_counters(x, monkeypatch):
    monkeypatch.setenv("TPU_ML_STREAM_FIT_MAX_RESIDENT_BYTES", "1")
    snap = REGISTRY.snapshot()
    model = StandardScaler(device="cpu").fit(x)
    rep = model.fit_report
    delta = REGISTRY.snapshot().delta(snap)
    assert model.stream_report is not None
    assert rep.overlap_fraction == 0.0  # the CPU: nothing runs beside the host
    assert rep.rows_ingested == ROWS and delta.counter("ingest.rows") == ROWS
    assert delta.counter("ingest.bytes") == x.nbytes
    assert rep.h2d_bytes == 0 and {"scaler moments", "ingest.chunk", "fold.dispatch",
                                   "fold.wait"} <= set(rep.phases)
    # the heartbeat gauges the health monitor reads: inactive again
    assert delta.gauges[("stream.active", ())] == 0


@pytest.mark.parametrize("fit,jax_passes", [("resident", 1), ("streamed", 1), ("pipeline", 4)])
def test_rows_ingested_against_jax(x, monkeypatch, fit, jax_passes):
    """A deliberate difference from the JAX package: the port's report
    counts the caller's dataset once, the JAX report every extraction of
    it. They agree for one estimator, resident or streamed; for
    ``Pipeline([StandardScaler, PCA])`` the JAX package extracts the rows
    four times (each stage's fit and its transform for the next stage)."""
    if fit == "streamed":
        monkeypatch.setenv("TPU_ML_STREAM_FIT_MAX_RESIDENT_BYTES", "1")
        old = jax_config().stream_fit_max_resident_bytes
        set_jax_config(stream_fit_max_resident_bytes=1)
    try:
        if fit == "pipeline":
            port = Pipeline(stages=[StandardScaler(device="cpu"), PCA(device="cpu").setK(K)]).fit(x)
            ref = JaxPipeline(stages=[JaxStandardScaler(), JaxPCA().setK(K)]).fit(x)
        else:
            port = StandardScaler(device="cpu").fit(x)
            ref = JaxStandardScaler().fit(x)
            assert (port.stream_report is not None) == (fit == "streamed")
    finally:
        if fit == "streamed":
            set_jax_config(stream_fit_max_resident_bytes=old)
    p, j = port.fit_report, ref.fit_report
    assert (p.rows_ingested, p.bytes_ingested) == (ROWS, x.nbytes)
    assert (j.rows_ingested, j.bytes_ingested) == (jax_passes * ROWS, jax_passes * x.nbytes)


def test_only_the_outermost_fit_exports(x, tmp_path, monkeypatch):
    sink, timeline = tmp_path / "r.jsonl", tmp_path / "t.jsonl"
    monkeypatch.setenv("TPU_ML_TELEMETRY_PATH", str(sink))
    monkeypatch.setenv("TPU_ML_TIMELINE_PATH", str(timeline))
    model = Pipeline(stages=[StandardScaler(device="cpu"), PCA(device="cpu").setK(K)]).fit(x)
    fits = [r for r in export.read_jsonl(str(sink)) if r["type"] == "fit_report"]
    assert [r["fit_id"] for r in fits] == [model.fit_report.fit_id]
    (tl,) = [r for r in export.read_jsonl(str(timeline)) if r.get("fit_id")]
    assert tl["type"] == "timeline" and tl["estimator"] == "Pipeline"
    names = {e["name"] for e in tl["events"]}
    assert {"scaler moments", "compute cov", "eigh"} <= names
    # a torn line is skipped alike by both packages' readers
    with open(sink, "a", encoding="utf-8") as f:
        f.write('{"type": "fit_rep\n')
    assert export.read_jsonl(str(sink)) == jexport.read_jsonl(str(sink))


def test_a_failed_fit_restores_the_span_context(x):
    with pytest.raises(ValueError, match="k=99"):
        PCA(device="cpu").setK(99).fit(x)
    assert spans.current_estimator() is None and spans.current_fit_id() is None
    # the depth did not leak: the next fit is outermost and resets nothing
    assert PCA(device="cpu").setK(K).fit(x).fit_report.estimator == "PCA"


def test_trace_range_books_span_seconds_on_the_cpu():
    snap = REGISTRY.snapshot()
    with pytest.raises(RuntimeError):
        with telemetry.trace_range("eigh", torch.device("cpu")):
            raise RuntimeError("boom")
    with telemetry.trace_range("compute cov"):
        pass
    table = REGISTRY.snapshot().delta(snap).phase_table()
    assert table["eigh"]["count"] == 1 and table["compute cov"]["count"] == 1


# -- SLO engine ----------------------------------------------------------------------------------


OBJECTIVES = "serve.latency:p99:0.004,fold.wait:p50:1.0,ingest.rows:min_rate:1000"


def test_parse_objectives_matches_jax():
    assert [o.key for o in slo.parse_objectives(OBJECTIVES)] == [
        o.key for o in jslo.parse_objectives(OBJECTIVES)]
    for bad in ("a:b", "x:p0:1", "x:q5:1", "x:p50:fast"):
        with pytest.raises(ValueError) as port_err:
            slo.parse_objectives(bad)
        with pytest.raises(ValueError) as jax_err:
            jslo.parse_objectives(bad)
        assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("burn", [1, 2, 3])
def test_slo_engine_decisions_match_jax(burn):
    preg, jreg = pregistry.MetricsRegistry(), jregistry.MetricsRegistry()
    pe = slo.SloEngine(slo.parse_objectives(OBJECTIVES), window_s=3.5, burn=burn, registry=preg)
    je = jslo.SloEngine(jslo.parse_objectives(OBJECTIVES), window_s=3.5, burn=burn, registry=jreg)
    t0 = time.monotonic()
    rng = np.random.default_rng(9)
    for step in range(8):
        slow = step in (1, 2, 3, 5)
        for reg in (preg, jreg):
            reg.counter_inc("ingest.rows", 5000 if step < 4 else 0)
        for v in rng.uniform(0.001, 0.01 if slow else 0.003, size=20):
            for reg in (preg, jreg):
                reg.histogram_record("serve.latency", v, model="m")
                reg.histogram_record("span.seconds", v * 300, phase="fold.wait", estimator="")
        now = t0 + step + 1.0
        p, j = pe.evaluate(now), je.evaluate(now)
        assert p["total_breaches"] == j["total_breaches"]
        assert p["rolling"] == j["rolling"]
        for po, jo in zip(p["objectives"], j["objectives"]):
            assert {k: po[k] for k in ("objective", "breached", "streak", "breaches")} == {
                k: jo[k] for k in ("objective", "breached", "streak", "breaches")}
            if po["value"] is None or jo["value"] is None:
                assert po["value"] is jo["value"] is None
            else:
                assert po["value"] == pytest.approx(jo["value"], rel=1e-3)
    assert pe.total_breaches() == je.total_breaches() > 0


# -- health monitor and admission control --------------------------------------------------


def _failing_monitor(module, **kw):
    """A monitor of ``module`` whose transport probe fails: FAILING after
    one poll."""
    mon = module.HealthMonitor(
        probe_fn=lambda: (False, "device unreachable"), failing_after=1, interval_s=60.0,
        slo_engine=module.slo_mod.SloEngine(()), **kw,
    )
    mon.poll_once()
    return mon


@pytest.mark.parametrize("policy", ["refuse", "degrade", "off"])
def test_admission_check_matches_jax(monkeypatch, policy):
    monkeypatch.setenv("TPU_ML_ADMISSION_POLICY", policy)
    monkeypatch.setattr(health, "_MONITOR", _failing_monitor(health))
    monkeypatch.setattr(jhealth, "_MONITOR", _failing_monitor(jhealth))
    p, j = health.admission_check(), jhealth.admission_check()
    assert {k: p[k] for k in ("policy", "action", "health_state")} == {
        k: j[k] for k in ("policy", "action", "health_state")}
    assert p["reason"].split(" — ")[0] == j["reason"].split(" — ")[0]
    assert p["action"] == ("admit" if policy == "off" else policy)


def test_admission_without_a_polled_monitor_admits():
    assert health.admission_check()["reason"] == jhealth.admission_check()["reason"]
    mon = health.HealthMonitor(interval_s=60.0)
    health._MONITOR = mon
    try:
        assert health.admission_check()["action"] == "admit"
    finally:
        health._MONITOR = None


def test_refused_fit_raises_and_a_degraded_fit_runs_only_on_the_cpu(x, monkeypatch):
    monkeypatch.setattr(health, "_MONITOR", _failing_monitor(health))
    with pytest.raises(health.AdmissionRefused, match="refused by admission control"):
        PCA(device="cpu").setK(K).fit(x)
    monkeypatch.setenv("TPU_ML_ADMISSION_POLICY", "degrade")
    inside = []
    gram_stats = PCA._resident_gram_stats

    def spy(self, *a, **kw):
        inside.append(health.admission_degrade_active())
        return gram_stats(self, *a, **kw)

    monkeypatch.setattr(PCA, "_resident_gram_stats", spy)
    fitted = PCA(device="cpu").setK(K).fit(x)
    assert inside == [True] and not health.admission_degrade_active()
    assert fitted.fit_report.admission["action"] == "degrade"
    # on a card the port cannot pin the fit to the CPU: it refuses, naming why
    with pytest.raises(health.AdmissionRefused, match="no degraded path for a fit on the card"):
        report.begin_fit("PCA", device=torch.device("cuda", 0))
    with pytest.raises(health.AdmissionRefused, match="cannot be degraded"):
        Pipeline(stages=[PCA(device="cpu").setK(K)]).fit(x)
    assert not health.admission_degrade_active()


def test_health_components_and_transitions_match_jax():
    p, j = _failing_monitor(health).rollup(), _failing_monitor(jhealth).rollup()
    assert p["state"] == j["state"] == "FAILING"
    # ``resilience`` reads each package's process-wide registry, where what
    # other tests booked (retries, injected faults) may have moved it off OK
    shared = [c for c in health.COMPONENTS if c != "resilience"]
    assert {c: p["components"][c]["state"] for c in shared} == {
        c: j["components"][c]["state"] for c in shared}
    # the JAX package's other components watch subsystems the port lacks
    # (its local Spark session), read from that same registry: one
    # transition each that moved
    jax_only = set(j["components"]) - set(health.COMPONENTS)
    assert jax_only == {"workers", "scheduler"}
    moved_p = p["components"]["resilience"]["state"] != "OK"
    moved_j = sum(j["components"][c]["state"] != "OK" for c in [*jax_only, "resilience"])
    assert p["transitions"] - moved_p == j["transitions"] - moved_j == 1
    assert set(_failing_monitor(health).fit_summary()) == set(
        _failing_monitor(jhealth).fit_summary())


def test_unported_probe_mode_is_refused():
    # every mode of the JAX monitor is ported; any other is refused by both
    assert health.PROBE_MODES == jhealth.PROBE_MODES
    assert health.HealthMonitor(probe_mode="subprocess").probe_mode == "subprocess"
    with pytest.raises(ValueError, match="must be one of"):
        health.HealthMonitor(probe_mode="grpc")
    with pytest.raises(ValueError, match="must be one of"):
        jhealth.HealthMonitor(probe_mode="grpc")


def test_no_probe_or_report_initializes_cuda(x, monkeypatch):
    """A card is reported but not initialized: the monitor's threads, the
    probe and a fit's report read nothing of it."""

    def touched(*_a, **_kw):
        raise AssertionError("CUDA was touched")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    for name in ("memory_stats", "mem_get_info", "reset_peak_memory_stats", "device_count",
                 "current_device", "init", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, touched)
    mon = health.start_monitor(interval_s=0.01)
    deadline = time.monotonic() + 10
    while mon.polls < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    model = PCA(device="cpu").setK(K).fit(x)
    health.stop_monitor()
    assert mon.polls >= 3 and not mon.running
    rollup = mon.rollup()
    assert rollup["components"]["transport"]["state"] == "OK"
    assert rollup["components"]["device"]["detail"] == "no device memory stats"
    assert model.fit_report.device_memory == {}
    assert model.fit_report.health["state"] == "OK"


# -- serving: SLO shedding ---------------------------------------------------------------------


def _burning_monitor(module, registry):
    """A monitor of ``module`` whose one objective (p50 of ``shed.test`` ≤
    1 ns) breaches at every poll."""
    engine = module.slo_mod.SloEngine(
        module.slo_mod.parse_objectives("shed.test:p50:1e-9"), burn=1, window_s=60.0,
    )
    mon = module.HealthMonitor(probe_mode="off", interval_s=60.0, slo_engine=engine)
    registry.histogram_record("shed.test", 1.0)
    mon.poll_once()
    return mon


@pytest.mark.parametrize("policy", ["refuse", "degrade", "off"])
def test_check_admission_sheds_like_jax(monkeypatch, policy):
    monkeypatch.setenv("TPU_ML_ADMISSION_POLICY", policy)
    monkeypatch.setattr(health, "_MONITOR", _burning_monitor(health, REGISTRY))
    monkeypatch.setattr(jhealth, "_MONITOR", _burning_monitor(jhealth, jregistry.REGISTRY))
    outcomes = []
    for fleet, shed_error, reg in ((hbm.HbmFleetManager(), hbm.ServeShed, REGISTRY),
                                   (jhbm.HbmFleetManager(), jhbm.ServeShed,
                                    jregistry.REGISTRY)):
        snap = reg.snapshot()
        raised = []
        for _ in range(3):  # one new breach: one request shed
            try:
                fleet.check_admission("m")
            except shed_error:
                raised.append(True)
        outcomes.append((len(raised), reg.snapshot().delta(snap).counter("serve.shed")))
    assert outcomes[0] == outcomes[1]
    assert outcomes[0] == {"refuse": (1, 1), "degrade": (0, 1), "off": (0, 0)}[policy]


def _post_json(port: int, path: str, payload) -> int:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


@pytest.mark.parametrize("policy", ["refuse", "off"])
def test_shed_request_answers_503_over_http(x, monkeypatch, policy):
    from spark_rapids_ml_tpu_torch.convert import pca_model_from_arrays
    from spark_rapids_ml_tpu_torch.serving import registry as registry_mod
    from spark_rapids_ml_tpu_torch.serving import server as server_mod

    monkeypatch.setenv("TPU_ML_SERVE_MAX_BATCH_ROWS", "64")
    monkeypatch.setenv("TPU_ML_ADMISSION_POLICY", policy)
    model = PCA(device="cpu").setK(K).fit(x)
    reg = registry_mod.ModelRegistry(device="cpu")
    reg.register("p", pca_model_from_arrays(model._saveData(), device="cpu"))
    srv = server_mod.start_serving(0, registry=reg)
    try:
        mon = health.start_monitor(probe_mode="off", interval_s=0.02, slo_engine=slo.SloEngine(
            slo.parse_objectives("serve.latency:p50:1e-9"), burn=1, window_s=60.0))
        codes = []
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline and len(codes) < 400:
            codes.append(_post_json(srv.port, "/v1/models/p:predict", {"instances": [x[0].tolist()]}))
            if policy == "refuse" and 503 in codes:
                break
            time.sleep(0.005)
        assert mon.slo.total_breaches() > 0
    finally:
        server_mod.stop_serving()
        registry_mod.reset_for_tests()
    if policy == "refuse":
        assert 503 in codes and set(codes) <= {200, 503}
    else:
        assert set(codes) == {200}


# -- the exporter ------------------------------------------------------------------------------


def _get(url: str):
    try:
        with urllib.request.urlopen(url, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_exporter_serves_healthz_slo_and_report(x, monkeypatch):
    monkeypatch.setenv("TPU_ML_HTTP_PORT", "0")
    model = PCA(device="cpu").setK(K).fit(x)  # the fit brings the exporter up
    srv = httpd.get_http_server()
    assert srv is not None and health.get_monitor() is not None
    url = f"http://127.0.0.1:{srv.port}"
    code, body = _get(f"{url}/healthz")
    assert code == 200 and body["state"] in ("OK", "DEGRADED")
    assert set(body["components"]) == set(health.COMPONENTS)
    code, body = _get(f"{url}/slo")
    assert code == 200 and body["objectives"] == [] and "rolling" in body
    code, body = _get(f"{url}/report")
    assert code == 200
    assert model.fit_report.fit_id in [r.get("fit_id") for r in body["reports"]]
    # a FAILING component: 503, the rollup in the body
    monkeypatch.setattr(health, "_MONITOR", _failing_monitor(health))
    code, body = _get(f"{url}/healthz")
    assert code == 503 and body["state"] == "FAILING"
    with pytest.raises(ValueError, match="TPU_ML_HTTP_PORT"):
        monkeypatch.delenv("TPU_ML_HTTP_PORT")
        httpd.stop_http_server()
        httpd.start_http_server()
    assert httpd.ensure_started() is None


# -- on the card ---------------------------------------------------------------------------------


@pytest.mark.cuda
def test_fit_report_device_memory_on_the_card(x):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: device memory is read from torch.cuda")
    big = np.random.default_rng(0).normal(size=(200_000, 64)).astype(np.float32)
    model = Pipeline(stages=[StandardScaler(withMean=True), PCA().setK(K)]).fit(big)
    rep = model.fit_report
    total = torch.cuda.get_device_properties(0).total_memory
    assert rep.rows_ingested == len(big)
    assert big.nbytes <= rep.peak_device_bytes < total
    assert rep.h2d_bytes >= 2 * big.nbytes  # the scaler's and the PCA's copies at least
    (dev,) = rep.device_memory
    assert rep.device_memory[dev]["bytes_limit"] == total
    # the outermost fit resets the peak: a smaller fit after it peaks lower
    small = PCA().setK(K).fit(big[:1000]).fit_report
    assert small.peak_device_bytes < rep.peak_device_bytes
