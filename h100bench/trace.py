"""The traced run: ``torch.profiler`` over whole operations, reduced to plain
events and to the shares the per-layer metrics read.

An event is (kind, name, start µs, end µs). Kinds:
``kernel``, ``h2d``/``d2h``/``copy`` (device copies), ``memset`` (device
activity), ``runtime`` (a CUDA runtime or driver call on the host), ``op``
(a host operator or a ``record_function`` range), ``annotation`` (the
device-side mirror of the harness's own range, left out of every sum). Every reduction below
takes a list of events, so the tests drive it with synthetic ones.
"""

from __future__ import annotations

import re
from contextlib import contextmanager
from dataclasses import dataclass

import torch

#: the ``record_function`` range the harness puts around each traced operation
OP_RANGE = "h100bench.op"
DEVICE_KINDS = ("kernel", "h2d", "d2h", "copy", "memset")
_RUNTIME = re.compile(r"^cu[A-Z]|^cuda[A-Z]")


@dataclass(frozen=True)
class Event:
    kind: str
    name: str
    start: float  # µs
    end: float    # µs


def _device_kind(name: str) -> str:
    if name.startswith("Memcpy"):
        if "HtoD" in name:
            return "h2d"
        return "d2h" if "DtoH" in name else "copy"
    return "memset" if name.startswith("Memset") else "kernel"


def events_from(prof) -> list[Event]:
    """Plain events of a finished ``torch.profiler.profile``, from its raw
    kineto events."""
    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        out.append(_event(e.name(), e.device_type(), start, start + e.duration_ns() / 1e3))
    return out


def _event(name, device_type, start, end) -> Event:
    if device_type == torch.autograd.DeviceType.CUDA:
        # the profiler mirrors a host range onto the device's timeline; it
        # is no device work
        kind = "annotation" if name == OP_RANGE else _device_kind(name)
    elif _RUNTIME.match(name):
        kind = "runtime"
    else:
        kind = "op"
    return Event(kind, name, float(start), float(end))


class Tracer:
    """Starts and stops the profiler around traced operations."""

    def __init__(self):
        self.events: list[Event] = []
        self._prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()

    def stop(self) -> None:
        if self._prof is None:
            return
        self._prof.__exit__(None, None, None)
        self.events = events_from(self._prof)
        self._prof = None

    @staticmethod
    @contextmanager
    def op_range():
        with torch.profiler.record_function(OP_RANGE):
            yield


# -- reductions ---------------------------------------------------------------

def merge(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals, as disjoint sorted intervals."""
    out: list[list[float]] = []
    for lo, hi in sorted(intervals):
        if hi <= lo:
            continue
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def clip(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    return [(max(a, lo), min(b, hi)) for a, b in intervals if min(b, hi) > max(a, lo)]


def length(intervals) -> float:
    return sum(b - a for a, b in merge(intervals))


def window(events: list[Event]) -> tuple[float, float] | None:
    """From the first traced operation's start to the last one's end."""
    spans = [(e.start, e.end) for e in events if e.kind == "op" and e.name == OP_RANGE]
    if not spans:
        return None
    return min(s for s, _ in spans), max(e for _, e in spans)


def device_intervals(events: list[Event], kinds=DEVICE_KINDS) -> list[tuple[float, float]]:
    return [(e.start, e.end) for e in events if e.kind in kinds]


def busy_s(events: list[Event], kinds=DEVICE_KINDS) -> float:
    """Seconds of the traced window in which a device event of ``kinds`` was
    in flight (0 without a window)."""
    w = window(events)
    return 0.0 if w is None else length(clip(device_intervals(events, kinds), *w)) / 1e6


def busy_share(events: list[Event], kinds=DEVICE_KINDS) -> float | None:
    """Share of the traced window (0–1) in which a device event of ``kinds``
    was in flight; None without a window or without any device event."""
    w = window(events)
    spans = device_intervals(events, kinds)
    if w is None or not spans or w[1] <= w[0]:
        return None
    return length(clip(spans, *w)) / (w[1] - w[0])


def idle_gaps(events: list[Event]) -> list[tuple[float, float]]:
    """The stretches of the traced window with no device event in flight."""
    w = window(events)
    if w is None:
        return []
    gaps, at = [], w[0]
    for lo, hi in merge(clip(device_intervals(events), *w)):
        if lo > at:
            gaps.append((at, lo))
        at = max(at, hi)
    if w[1] > at:
        gaps.append((at, w[1]))
    return gaps


def host_labels(events: list[Event], times: list[float]) -> list[str]:
    """For each of ``times``, the innermost host operator in flight then (on
    any thread), or ``host python`` where none is: one sweep over the
    operators sorted by start."""
    ops = sorted((e for e in events if e.kind == "op" and e.name != OP_RANGE),
                 key=lambda e: e.start)
    labels, active, i = {}, [], 0
    for t in sorted(set(times)):
        while i < len(ops) and ops[i].start <= t:
            active.append(ops[i])
            i += 1
        active = [e for e in active if e.end > t]
        labels[t] = min(active, key=lambda e: e.end - e.start).name if active else "host python"
    return [labels[t] for t in times]


def idle_by_host(events: list[Event], top: int = 10) -> list[list]:
    """Idle seconds of the traced window by what the host was doing (each
    gap labelled at its midpoint), largest first."""
    gaps = idle_gaps(events)
    totals: dict[str, float] = {}
    for (lo, hi), label in zip(gaps, host_labels(events, [(a + b) / 2 for a, b in gaps])):
        totals[label] = totals.get(label, 0.0) + (hi - lo) / 1e6
    return [[k, v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:top]]


def device_ops(events: list[Event], top: int | None = 10) -> list[list]:
    """Device seconds in the traced window by kernel or copy name, largest
    first."""
    w = window(events)
    if w is None:
        return []
    totals: dict[str, float] = {}
    for e in events:
        if e.kind in DEVICE_KINDS:
            for a, b in clip([(e.start, e.end)], *w):
                totals[e.name] = totals.get(e.name, 0.0) + (b - a) / 1e6
    return [[k[:160], v] for k, v in sorted(totals.items(), key=lambda kv: -kv[1])[:top]]


def summary(events: list[Event]) -> dict:
    """``busy_s``, ``window_s`` and the breakdown of a traced run."""
    w = window(events)
    if w is None:
        return {}
    return {
        "busy_s": busy_s(events),
        "window_s": (w[1] - w[0]) / 1e6,
        "breakdown": {"device_ops": device_ops(events), "idle_gaps": idle_by_host(events)},
    }
