"""The readers of the program's spans, driven with synthetic events: the
program's ranges are host operators of the trace named by their phase, on
the clock of the device's events (µs since the Unix epoch)."""

from __future__ import annotations

import pytest

from conftest import CHECKOUT  # noqa: F401  (puts the checkout on the path)
from h100bench import program_spans, run, spec, trace, work

CONFIG = {"rows": 5_000_000, "n": 128, "params": {"k": 1000, "maxIter": 2}}
T0 = 1.7e15  # µs since the epoch: a traced fit in 2023


def E(kind, name, start, end):
    return trace.Event(kind, name, T0 + start, T0 + end)


def traced_fit():
    """One traced fit of 1 s: ingest 0–200 ms (a 150 ms copy), seeding
    200–300 ms (a draw's kernel from 290 to 340 ms, past the range's end),
    Lloyd 300–1,000 ms in two iterations with 200 + 100 ms of kernels, and
    a kernel before the Lloyd range that overlaps it by 5 ms."""
    return [
        E("op", trace.OP_RANGE, 0, 1_000_000),
        E("op", "kmeans ingest", 0, 200_000),
        E("h2d", "Memcpy HtoD (Pageable -> Device)", 20_000, 170_000),
        E("op", "kmeans init", 200_000, 300_000),
        E("kernel", "draw", 210_000, 250_000),
        E("kernel", "draw", 290_000, 340_000),
        E("op", "kmeans lloyd", 300_000, 1_000_000),
        E("op", "kmeans lloyd iteration", 300_000, 650_000),
        E("op", "kmeans lloyd iteration", 650_000, 1_000_000),
        E("kernel", "gemm", 400_000, 600_000),
        E("kernel", "gemm", 700_000, 800_000),
        E("kernel", "argmin", 750_000, 780_000),  # overlaps the GEMM: counted once
        E("kernel", "after the fit", 1_000_500, 1_000_900),
    ]


def ctx_for(events, config=CONFIG):
    return run.Context(config, setup_s=1.0, records=[], events=events)


def test_lloyd_pass_roofline_leaves_out_kernels_outside_the_lloyd_range():
    # seeding's draws (the one overlapping 300–340 ms counts 40 ms inside)
    # and the kernel after the fit are out: 40 + 200 + 100 ms of kernels
    bound = work.lloyd_bound_s(5_000_000, 128, 1000, 2)
    value = spec.metric_reader("lloyd_pass_roofline")(ctx_for(traced_fit()))
    assert value == pytest.approx(100 * bound / 0.34)
    # against every kernel of the window, as lloyd_roofline counts them
    every = trace.busy_s(traced_fit(), kinds=("kernel",))
    assert every == pytest.approx(0.39) and value > 100 * bound / every


def test_a_device_event_that_began_inside_init_extends_the_seeding():
    assert spec.metric_reader("seeding_s.kmeans_fit")(ctx_for(traced_fit())) == pytest.approx(
        0.14)
    # without it the range's own length
    ev = [e for e in traced_fit() if not (e.name == "draw" and e.start > T0 + 280_000)]
    assert spec.metric_reader("seeding_s.kmeans_fit")(ctx_for(ev)) == pytest.approx(0.1)
    # work the card starts after the range ends is not the seeding's, even
    # if it was launched inside it: the events carry no launch correlation
    late = traced_fit() + [E("kernel", "draw", 305_000, 360_000)]
    assert spec.metric_reader("seeding_s.kmeans_fit")(ctx_for(late)) == pytest.approx(0.14)


def _report(t_unix, h2d):
    return {"type": "fit_report", "timestamp_unix": t_unix, "h2d_bytes": h2d}


def test_ingest_reads_the_traced_fits_report_by_its_unix_time():
    start_s = T0 / 1e6
    reports = [
        _report(start_s - 60.0, 10**12),   # the warm-up, before the trace
        {"type": "transform_report", "timestamp_unix": start_s + 0.5},
        _report(start_s + 1e-4, 3 * 10**9),  # the traced fit
        _report(start_s + 0.5, 10**12),    # a fit nested in it: not counted again
        _report(start_s + 5.0, 10**12),    # the next fit, after the trace
    ]
    read = spec.metric_reader("ingest_gbps.kmeans_fit")
    assert program_spans.traced_fit_reports(traced_fit(), reports) == [reports[2]]
    assert read(ctx_for(traced_fit()), reports) == pytest.approx(3.0 / 0.2)
    assert read(ctx_for(traced_fit()), reports[:2]) is None  # no report in the trace


@pytest.mark.parametrize("metric,phase", [("lloyd_pass_roofline", "kmeans lloyd"),
                                          ("lloyd_pass_roofline", "kmeans lloyd iteration"),
                                          ("ingest_gbps.kmeans_fit", "kmeans ingest"),
                                          ("seeding_s.kmeans_fit", "kmeans init")])
def test_a_missing_range_gives_nothing(metric, phase):
    ev = [e for e in traced_fit() if e.name != phase]
    reports = [_report(T0 / 1e6 + 1e-4, 3 * 10**9)]
    args = (reports,) if metric.startswith("ingest") else ()
    read = spec.metric_reader(metric)
    assert read(ctx_for(traced_fit()), *args) is not None
    assert read(ctx_for(ev), *args) is None
    assert read(ctx_for(None), *args) is None


def test_ranges_outside_a_traced_operation_are_not_the_programs_traced_fit():
    ev = [e for e in traced_fit() if e.name != trace.OP_RANGE]
    assert program_spans.ranges(ev, "kmeans lloyd") == []
    assert spec.metric_reader("seeding_s.kmeans_fit")(ctx_for(ev)) is None
