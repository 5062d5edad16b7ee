"""The port's spans: a profiler range on every device, the card's seconds of
the spans opened on it inside a fit or transform window, one registry of
span names, and the KMeans fit's spans at its layer boundaries.

The CPU tests stand a fake event class in for ``torch.cuda.Event`` where a
card would time the span. The ``cuda``-marked test fits KMeans on the card
under ``torch.profiler`` and holds ``device_phases`` to the trace. This file
imports no JAX, so that the card's run collects it.
"""

from __future__ import annotations

import ast
import contextlib
from pathlib import Path

import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu_torch import KMeans
from spark_rapids_ml_tpu_torch.models import kmeans as kmeans_model
from spark_rapids_ml_tpu_torch.telemetry import names, report, slo, spans, trace_range
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY, MetricsRegistry

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
CARD = torch.device("cuda", 0)  # never touched: the fake events stand in for the card
ROWS_ON_CARD = 8_000_000  # 4.1 GB of f32 rows, Lloyd iterations of ≈ 0.23 s on an H100
KMEANS_PHASES = {"kmeans ingest", "kmeans init", "kmeans lloyd", "kmeans lloyd iteration"}


# -- the profiler range ---------------------------------------------------------


def test_a_span_is_a_function_scope_range_nested_in_its_parent():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace_range("kmeans lloyd", CPU):
            with trace_range("kmeans lloyd iteration", CPU):
                torch.ones(64).sum()
    by_name = {e.name: e for e in prof.events()}
    outer, inner = by_name["kmeans lloyd"], by_name["kmeans lloyd iteration"]
    assert not outer.is_user_annotation and not inner.is_user_annotation
    assert inner.cpu_parent is not None and inner.cpu_parent.name == "kmeans lloyd"
    assert outer.time_range.start <= inner.time_range.start
    assert inner.time_range.end <= outer.time_range.end
    # one range each, on the host's timeline only: no mirror on a device
    kinds = [(e.name(), e.device_type()) for e in prof.profiler.kineto_results.events()
             if e.name().startswith("kmeans")]
    assert sorted(kinds) == [("kmeans lloyd", torch.autograd.DeviceType.CPU),
                             ("kmeans lloyd iteration", torch.autograd.DeviceType.CPU)]


def test_span_seconds_are_booked_when_the_body_raises():
    snap = REGISTRY.snapshot()
    with pytest.raises(RuntimeError, match="planted"):
        with trace_range("kmeans init", CPU):
            raise RuntimeError("planted")
    table = REGISTRY.snapshot().delta(snap).phase_table()
    assert table["kmeans init"]["count"] == 1


# -- the card's seconds ------------------------------------------------------------


class FakeEvent:
    """``torch.cuda.Event`` on a fake clock: each record is 5 ms after the
    last; ``made`` counts the events."""

    made = 0
    clock = 0.0

    def __init__(self, enable_timing=False):
        assert enable_timing
        FakeEvent.made += 1
        self.t = None
        self.waited = False

    def record(self, stream=None):
        FakeEvent.clock += 5.0
        self.t = FakeEvent.clock

    def synchronize(self):
        self.waited = True

    def elapsed_time(self, end):
        assert end.waited, "elapsed_time before the end event was waited on"
        return end.t - self.t


@pytest.fixture
def fake_card(monkeypatch):
    """The card's events, graph capture and NVTX ranges, faked: returns the
    capture switch and the names of the NVTX ranges pushed."""
    FakeEvent.made, FakeEvent.clock = 0, 0.0
    capturing = {"on": False, "nvtx": []}

    @contextlib.contextmanager
    def nvtx_range(msg):
        capturing["nvtx"].append(msg)
        yield

    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: capturing["on"])
    monkeypatch.setattr(torch.cuda.nvtx, "range", nvtx_range)
    return capturing


def test_a_span_on_the_card_pushes_an_nvtx_range_of_its_name(fake_card):
    with trace_range("kmeans lloyd", CARD):
        with trace_range("kmeans lloyd iteration", CARD):
            pass
    with trace_range("kmeans init", CPU):
        pass
    with trace_range("kmeans ingest", None):
        pass
    assert fake_card["nvtx"] == ["kmeans lloyd", "kmeans lloyd iteration"]


def test_no_event_on_the_cpu_or_outside_a_window(fake_card):
    with trace_range("kmeans lloyd", CARD):  # no window open
        pass
    cap = report.begin_fit("KMeans", device=CPU)
    try:
        with trace_range("kmeans lloyd", CPU):
            pass
        with trace_range("kmeans lloyd", None):
            pass
    finally:
        rep = report.end_fit(cap)
    assert FakeEvent.made == 0 and rep.device_phases == {}
    assert rep.phases["kmeans lloyd"]["count"] == 2


def test_no_event_during_a_graph_capture(fake_card):
    fake_card["on"] = True
    cap = report.begin_fit("KMeans", device=CPU)
    try:
        with trace_range("kmeans lloyd", CARD):
            pass
    finally:
        rep = report.end_fit(cap)
    assert FakeEvent.made == 0 and rep.device_phases == {}


def test_a_windows_spans_are_timed_on_the_card_and_booked_at_its_close(fake_card):
    cap = report.begin_fit("KMeans", device=CPU)
    try:
        with trace_range("kmeans lloyd", CARD):
            for _ in range(3):
                with trace_range("kmeans lloyd iteration", CARD):
                    pass
        # a nested window books its own spans; the enclosing one's delta
        # holds them too
        inner = report.begin_fit("Inner", device=CPU, outermost=False)
        try:
            with trace_range("kmeans init", CARD):
                pass
        finally:
            inner_rep = report.end_fit(inner)
        with pytest.raises(RuntimeError):
            with trace_range("kmeans ingest", CARD):
                raise RuntimeError("a failed span books host seconds only")
        assert cap.device_spans and len(cap.device_spans) == 4  # not booked yet
    finally:
        rep = report.end_fit(cap)
    # records at 5-ms steps: the outer span holds its three iterations
    assert rep.device_phases["kmeans lloyd iteration"]["count"] == 3
    assert rep.device_phases["kmeans lloyd iteration"]["sum"] == pytest.approx(0.015)
    assert rep.device_phases["kmeans lloyd"]["sum"] == pytest.approx(0.035)
    assert set(inner_rep.device_phases) == {"kmeans init"}
    assert rep.device_phases["kmeans init"]["count"] == 1
    assert "kmeans ingest" not in rep.device_phases and "kmeans ingest" in rep.phases
    assert cap.device_spans == [] and spans._device_spans.get() is None
    assert report.FitReport.from_dict(rep.to_dict()).device_phases == rep.device_phases
    assert report.FitReport.from_dict({}).device_phases == {}
    assert report.TransformReport.from_dict({}).device_phases == {}


def test_a_span_without_device_time_records_no_event(fake_card):
    cap = report.begin_fit("PCA", device=CPU)
    try:
        with trace_range("compute cov", CARD):
            for _ in range(3):
                with trace_range("ingest.chunk", CARD, device_time=False):
                    pass
                with trace_range("fold.dispatch", CARD, device_time=False):
                    pass
    finally:
        rep = report.end_fit(cap)
    assert FakeEvent.made == 2 and set(rep.device_phases) == {"compute cov"}
    assert rep.phases["fold.dispatch"]["count"] == 3 and rep.phases["ingest.chunk"]["count"] == 3
    assert fake_card["nvtx"].count("fold.dispatch") == 3  # Nsight still sees every chunk


def test_a_transform_window_times_its_spans_too(fake_card):
    cap = report.begin_transform("KMeansModel")
    with trace_range("kmeans transform", CARD):
        pass
    rep = report.end_transform(cap)
    assert rep.device_phases["kmeans transform"]["count"] == 1
    assert report.TransformReport.from_dict(rep.to_dict()).device_phases == rep.device_phases


# -- one registry of span names ---------------------------------------------------------


@pytest.mark.parametrize("phase", ["linreg solve", "transform.dispatch", "logreg newton",
                                   "tsvd decompose", "kmeans lloyd iteration"])
def test_slo_resolves_every_registered_phase_through_span_seconds(phase):
    reg = MetricsRegistry()
    engine = slo.SloEngine(slo.parse_objectives(f"{phase}:p50:1e-9"), burn=1, window_s=60.0,
                           registry=reg)
    reg.histogram_record("span.seconds", 0.25, phase=phase, estimator="E")
    (result,) = engine.evaluate()["objectives"]
    assert result["value"] == pytest.approx(0.25, rel=0.1) and result["breached"]
    assert phase in names.SPAN_PHASES


def test_the_stale_registries_are_gone():
    with pytest.raises(ImportError):
        from spark_rapids_ml_tpu_torch.telemetry.spans import SPAN_PHASES  # noqa: F401
    with pytest.raises(ImportError):
        from spark_rapids_ml_tpu_torch.telemetry.spans import TUNING_METRICS  # noqa: F401
    assert slo.SPAN_PHASES is names.SPAN_PHASES
    sources = sorted((REPO / "spark_rapids_ml_tpu_torch").rglob("*.py"))
    sources += [REPO / "chip_smoke.py", *sorted((REPO / "h100bench").rglob("*.py"))]
    for path in sources:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and (node.module or "").endswith("spans"):
                assert not {a.name for a in node.names} & {"SPAN_PHASES", "TUNING_METRICS"}, path
            if isinstance(node, ast.Attribute) and node.attr == "TUNING_METRICS":
                raise AssertionError(f"{path} reads TUNING_METRICS")
            if (isinstance(node, ast.Attribute) and node.attr == "SPAN_PHASES"
                    and isinstance(node.value, ast.Name) and node.value.id == "spans"):
                raise AssertionError(f"{path} reads spans.SPAN_PHASES")


# -- the KMeans fit's spans ----------------------------------------------------------


def test_kmeans_fit_books_its_layer_spans_and_the_same_answer():
    # uniform rows: Lloyd still moves the centres after five iterations
    x = np.random.default_rng(4).random((2_000, 8), dtype=np.float32)
    est = dict(k=20, seed=2, tol=0.0, maxIter=5, device=CPU)
    model = KMeans(**est).fit(x, num_partitions=3)
    phases = model.fit_report.phases
    assert KMEANS_PHASES <= set(phases)
    assert phases["kmeans ingest"]["count"] == 1 and phases["kmeans init"]["count"] == 1
    assert phases["kmeans lloyd iteration"]["count"] == 5
    assert model.fit_report.device_phases == {}
    # the spans change no result: bit for bit the fit without them
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(kmeans_model, "trace_range", lambda name, device=None:
                   contextlib.nullcontext())
        bare = KMeans(**est).fit(x, num_partitions=3)
    assert "kmeans lloyd iteration" not in bare.fit_report.phases
    np.testing.assert_array_equal(model.clusterCenters, bare.clusterCenters)
    assert model.trainingCost == bare.trainingCost


# -- on the card ---------------------------------------------------------------------


@pytest.mark.cuda
def test_device_phases_agree_with_the_trace_on_the_card():
    """A KMeans fit on the card under ``torch.profiler``: ``device_phases``
    holds the fit's four phases and no device event carries a span's name.
    The card's seconds of ``kmeans lloyd`` are within 1% of the trace's
    span from the first kernel in the range to the last one's end, and no
    fewer than the seconds a kernel was in flight there: the events time
    the card's whole span, its gaps included. Under the profiler the host
    launches a block's kernels barely ahead of the card, so the gaps are
    about 2% of the range at any size (2.8% at 8,000,000 rows, 2.1% at
    24,000,000 on an H100)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the spans' events are CUDA events")
    from torch.profiler import ProfilerActivity, profile

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=CARD).manual_seed(11)
    centres = torch.randn(1000, 128, device=CARD, generator=gen) * 4.0
    pick = torch.randint(0, 1000, (ROWS_ON_CARD,), device=CARD, generator=gen)
    x = (centres[pick] + torch.randn(ROWS_ON_CARD, 128, device=CARD, generator=gen)).cpu().numpy()
    del centres, pick
    est = dict(k=1000, seed=3, tol=0.0, maxIter=5, device=CARD)
    KMeans(**est).fit(x[:200_000], num_partitions=2)  # warm-up: cuBLAS, allocator
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model = KMeans(**est).fit(x, num_partitions=4)
    device = model.fit_report.device_phases
    assert KMEANS_PHASES <= set(device)
    assert device["kmeans lloyd iteration"]["count"] == 5 and device["kmeans ingest"]["count"] == 1
    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.profiler.kineto_results.events())
    assert not {e.name() for e in events if e.device_type() == cuda} & KMEANS_PHASES
    (lloyd,) = [e for e in events if e.name() == "kmeans lloyd" and e.device_type() != cuda]
    lo, hi = lloyd.start_ns(), lloyd.start_ns() + lloyd.duration_ns()
    kernels = sorted((max(lo, e.start_ns()), min(hi, e.start_ns() + e.duration_ns()))
                     for e in events if e.device_type() == cuda
                     and not e.name().startswith(("Memcpy", "Memset")))
    busy, at = 0, lo
    for a, b in kernels:
        a = max(a, at)
        if b > a:
            busy, at = busy + b - a, b
    inside = [(a, b) for a, b in kernels if b > a]
    span = max(b for _, b in inside) - min(a for a, _ in inside)
    seconds = device["kmeans lloyd"]["sum"]
    print(f"kmeans lloyd: events {seconds:.6f} s, kernels busy {busy / 1e9:.6f} s, "
          f"device span {span / 1e9:.6f} s, host {model.fit_report.phases['kmeans lloyd']['sum']:.6f} s; "
          + ", ".join(f"{k} {v['sum']:.6f} s" for k, v in sorted(device.items())))
    assert seconds == pytest.approx(span / 1e9, rel=0.01)
    assert busy / 1e9 <= seconds * (1 + 1e-3)
    # a CUDA graph captured inside a window records no event
    cap = report.begin_fit("KMeans", device=CARD)
    try:
        static = torch.ones(1024, device=CARD)
        (static * 2).sum()  # the kernels loaded outside the capture
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            with trace_range("kmeans lloyd", CARD):
                (static * 2).sum()
        graph.replay()
        torch.cuda.synchronize()
        assert cap.device_spans == []
    finally:
        report.end_fit(cap)
