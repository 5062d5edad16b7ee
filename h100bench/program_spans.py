"""The program's spans in a traced run. The port's ``trace_range`` opens a
profiler range named by its phase (``telemetry/spans.py``): in the trace it
is a host operator (kind ``op``) on the clock of the device's events, with
no mirror on the device's timeline. The program's reports carry the
wall-clock second each fit began (``timestamp_unix``), the clock the trace's
events are on (µs since the Unix epoch). A program without these spans or
reports gives empty lists here, and the metrics that read them nothing."""

from __future__ import annotations

from h100bench import trace


def traced_ops(events) -> list[tuple[float, float]]:
    """(start, end) µs of each operation the harness traced."""
    return [(e.start, e.end) for e in events if e.kind == "op" and e.name == trace.OP_RANGE]


def ranges(events, phase: str) -> list:
    """The program's ranges named ``phase`` inside a traced operation."""
    ops = traced_ops(events)
    return [e for e in events if e.kind == "op" and e.name == phase
            and any(lo <= e.start and e.end <= hi for lo, hi in ops)]


def traced_fit_reports(events, reports) -> list[dict]:
    """For each traced operation, the first fit report that began inside it
    (an outer fit begins before the fits nested in it)."""
    fits = sorted((r for r in reports if r.get("type") == "fit_report"),
                  key=lambda r: r.get("timestamp_unix", 0.0))
    out = []
    for lo, hi in traced_ops(events):
        inside = [r for r in fits if lo <= r.get("timestamp_unix", 0.0) * 1e6 <= hi]
        if inside:
            out.append(inside[0])
    return out
