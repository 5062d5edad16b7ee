"""Thread-safe metrics registry: counters, gauges, log-scale histograms.

Port of ``spark_rapids_ml_tpu/telemetry/registry.py`` (``Histogram``,
``MetricsRegistry``, ``RegistrySnapshot`` and the Prometheus text
rendering), the same series names, label keys, bucket edges and text, so a
scrape of either package reads the same. Every serve request books into the
one process-wide ``REGISTRY``; ``/metrics`` renders it.

- **Lock-guarded**: the batcher's thread, the HTTP and UDS handler threads
  and direct ``predict`` callers all record into one registry; one
  ``RLock`` around tiny dict updates.
- **Log-scale histograms**: buckets grow by ``2**0.25`` (4 per octave), so
  percentiles over any latency range cost O(1) memory. Count, sum, min and
  max are exact; interior quantiles are within half a bucket (~9.5%).
- **Snapshot/delta algebra**: a measured window is the difference of two
  snapshots (``REGISTRY.snapshot().delta(before)``).
- **Exemplars**: each histogram series keeps its ``TPU_ML_TRACE_EXEMPLARS``
  slowest (value, trace id) pairs, so a p99 stays attributable to traces.

- **Span tables**: ``phase_table`` rolls the ``span.seconds`` (host) or
  ``span.device_seconds`` (card) series that ``telemetry.spans.trace_range``
  books into the per-phase percentiles a ``FitReport`` carries.

- **Wire form**: a worker's registry delta travels to the driver as
  ``RegistrySnapshot.to_wire`` (JSON-safe, buckets kept) and is replayed
  there by ``MetricsRegistry.merge_wire`` with a ``partition`` label
  (``localspark/``'s telemetry trailer); the JAX package's format.
"""

from __future__ import annotations

import math
import threading

from spark_rapids_ml_tpu_torch.utils.config import (
    DEFAULT_TRACE_EXEMPLARS,
    TRACE_EXEMPLARS_VAR,
    lenient_int,
)


def _exemplar_budget() -> int:
    """Slowest-sample exemplars retained per histogram series; read only on
    records that carry an exemplar."""
    return max(lenient_int(TRACE_EXEMPLARS_VAR, DEFAULT_TRACE_EXEMPLARS), 0)


# Bucket boundaries at GROWTH**i, 4 per power of two
GROWTH = 2.0 ** 0.25
_LOG_GROWTH = math.log(GROWTH)
# values <= 0 land in a bucket of their own, so 0.0 never reaches math.log
_ZERO_BUCKET = -(1 << 30)


class Histogram:
    """Log-scale histogram with exact count/sum/min/max. Not locked itself:
    the registry serializes access."""

    __slots__ = ("count", "total", "vmin", "vmax", "buckets")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.buckets: dict[int, int] = {}

    @staticmethod
    def bucket_index(value: float) -> int:
        if value <= 0.0:
            return _ZERO_BUCKET
        return math.floor(math.log(value) / _LOG_GROWTH)

    def record(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.total += value
        if value < self.vmin:
            self.vmin = value
        if value > self.vmax:
            self.vmax = value
        idx = self.bucket_index(value)
        self.buckets[idx] = self.buckets.get(idx, 0) + 1

    def percentile(self, q: float) -> float:
        """The q-th percentile (0..100): the geometric midpoint of the bucket
        holding that rank, clamped to the exact [min, max]."""
        if self.count == 0:
            return 0.0
        rank = max(1, math.ceil(q / 100.0 * self.count))
        cum = 0
        for idx in sorted(self.buckets):
            cum += self.buckets[idx]
            if cum >= rank:
                if idx == _ZERO_BUCKET:
                    return 0.0
                mid = math.exp((idx + 0.5) * _LOG_GROWTH)
                return min(max(mid, self.vmin), self.vmax)
        return self.vmax

    def merge(self, other: "Histogram") -> None:
        """Add ``other``'s samples into this histogram."""
        self.count += other.count
        self.total += other.total
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        for k, v in other.buckets.items():
            self.buckets[k] = self.buckets.get(k, 0) + v

    def copy(self) -> "Histogram":
        h = Histogram()
        h.count = self.count
        h.total = self.total
        h.vmin = self.vmin
        h.vmax = self.vmax
        h.buckets = dict(self.buckets)
        return h

    def delta(self, prev: "Histogram | None") -> "Histogram":
        """This histogram minus an earlier snapshot of the same series; the
        extremes stay the current ones (min/max cannot be un-merged)."""
        if prev is None:
            return self.copy()
        h = Histogram()
        h.count = self.count - prev.count
        h.total = self.total - prev.total
        h.vmin = self.vmin
        h.vmax = self.vmax
        h.buckets = {
            k: v - prev.buckets.get(k, 0)
            for k, v in self.buckets.items()
            if v - prev.buckets.get(k, 0)
        }
        if h.count <= 0:
            return Histogram()
        return h

    def to_wire(self) -> dict:
        """JSON-safe full state, buckets included (the extremes only when
        there are samples)."""
        out: dict = {
            "count": self.count,
            "total": self.total,
            "buckets": {str(k): v for k, v in self.buckets.items()},
        }
        if self.count:
            out["vmin"] = self.vmin
            out["vmax"] = self.vmax
        return out

    def merge_wire(self, wire: dict) -> None:
        """Fold a ``to_wire`` payload into this histogram."""
        self.count += int(wire.get("count", 0))
        self.total += float(wire.get("total", 0.0))
        if "vmin" in wire:
            self.vmin = min(self.vmin, float(wire["vmin"]))
        if "vmax" in wire:
            self.vmax = max(self.vmax, float(wire["vmax"]))
        for k, v in (wire.get("buckets") or {}).items():
            idx = int(k)
            self.buckets[idx] = self.buckets.get(idx, 0) + int(v)

    def to_dict(self, percentiles=(50, 90, 99)) -> dict[str, float]:
        if self.count == 0:
            return {"count": 0, "sum": 0.0}
        out = {
            "count": self.count,
            "sum": self.total,
            "min": self.vmin,
            "max": self.vmax,
        }
        for q in percentiles:
            out[f"p{q}"] = self.percentile(q)
        return out


def _key(name: str, labels: dict) -> tuple:
    return (name, tuple(sorted((k, v) for k, v in labels.items() if v)))


def render_key(key: tuple) -> str:
    """``name{label=value,...}``: the flat string form reports export."""
    name, labels = key
    if not labels:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"


def _prom_escape(v) -> str:
    """Prometheus label-value escaping (backslash, quote, newline)."""
    return (
        str(v)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


class MetricsRegistry:
    """The process-local metric store. All mutation goes through a lock."""

    def __init__(self):
        self._lock = threading.RLock()
        self._counters: dict[tuple, float] = {}
        self._gauges: dict[tuple, float] = {}
        self._hists: dict[tuple, Histogram] = {}
        # per series: [(value, trace_id)] descending, TPU_ML_TRACE_EXEMPLARS long
        self._exemplars: dict[tuple, list] = {}

    def counter_inc(self, name: str, value: float = 1, **labels) -> None:
        k = _key(name, labels)
        with self._lock:
            self._counters[k] = self._counters.get(k, 0) + value

    def gauge_set(self, name: str, value: float, **labels) -> None:
        with self._lock:
            self._gauges[_key(name, labels)] = value

    def histogram_record(
        self, name: str, value: float, exemplar: str = "", **labels
    ) -> None:
        k = _key(name, labels)
        with self._lock:
            h = self._hists.get(k)
            if h is None:
                h = self._hists[k] = Histogram()
            h.record(value)
            if exemplar:
                self._exemplar_add(k, float(value), exemplar)

    def _exemplar_add(self, k: tuple, value: float, exemplar: str) -> None:
        """Keep the top-K slowest (value, trace_id) pairs of a series. The
        caller holds the lock."""
        budget = _exemplar_budget()
        if budget <= 0:
            return
        ex = self._exemplars.setdefault(k, [])
        if len(ex) >= budget and value <= ex[-1][0]:
            return
        ex.append((value, exemplar))
        ex.sort(key=lambda pair: -pair[0])
        del ex[budget:]

    def merge_wire(self, wire: dict, **extra_labels) -> None:
        """Fold a ``RegistrySnapshot.to_wire`` payload (a worker's delta)
        into this registry, with ``extra_labels`` (``partition="3"``) on
        every merged series."""
        extra = {k: v for k, v in extra_labels.items() if v}
        with self._lock:
            for name, labels, value in wire.get("counters", ()):
                k = _key(name, {**labels, **extra})
                self._counters[k] = self._counters.get(k, 0) + value
            for name, labels, value in wire.get("gauges", ()):
                self._gauges[_key(name, {**labels, **extra})] = value
            for name, labels, hwire in wire.get("hists", ()):
                k = _key(name, {**labels, **extra})
                h = self._hists.get(k)
                if h is None:
                    h = self._hists[k] = Histogram()
                h.merge_wire(hwire)
            for name, labels, pairs in wire.get("exemplars", ()):
                k = _key(name, {**labels, **extra})
                for value, trace_id in pairs:
                    self._exemplar_add(k, float(value), str(trace_id))

    def snapshot(self) -> "RegistrySnapshot":
        with self._lock:
            return RegistrySnapshot(
                counters=dict(self._counters),
                gauges=dict(self._gauges),
                hists={k: h.copy() for k, h in self._hists.items()},
                exemplars={k: list(v) for k, v in self._exemplars.items()},
            )


class RegistrySnapshot:
    """A copy of the registry's state; supports delta and rendering."""

    def __init__(self, counters, gauges, hists, exemplars=None):
        self.counters = counters
        self.gauges = gauges
        self.hists = hists
        self.exemplars = exemplars or {}

    def delta(self, prev: "RegistrySnapshot | None") -> "RegistrySnapshot":
        if prev is None:
            return self
        counters = {
            k: v - prev.counters.get(k, 0)
            for k, v in self.counters.items()
            if v - prev.counters.get(k, 0)
        }
        hists = {}
        for k, h in self.hists.items():
            d = h.delta(prev.hists.get(k))
            if d.count:
                hists[k] = d
        # exemplars are a top-K sample, not cumulative: the window keeps the
        # current ones of every series live in it
        exemplars = {k: v for k, v in self.exemplars.items() if k in hists}
        return RegistrySnapshot(
            counters=counters, gauges=dict(self.gauges), hists=hists,
            exemplars=exemplars,
        )

    def to_wire(self) -> dict:
        """JSON-safe lossless form (labels structured, buckets kept), which
        ``MetricsRegistry.merge_wire`` replays."""
        return {
            "counters": [[name, dict(labels), v]
                         for (name, labels), v in sorted(self.counters.items())],
            "gauges": [[name, dict(labels), v]
                       for (name, labels), v in sorted(self.gauges.items())],
            "hists": [[name, dict(labels), h.to_wire()]
                      for (name, labels), h in sorted(self.hists.items())],
            "exemplars": [[name, dict(labels), [[v, t] for v, t in pairs]]
                          for (name, labels), pairs in sorted(self.exemplars.items())],
        }

    def counter(self, name: str, **labels) -> float:
        """Sum of a counter across label sets; with labels given, the exact
        series only."""
        if labels:
            return self.counters.get(_key(name, labels), 0)
        return sum(v for (n, _), v in self.counters.items() if n == name)

    def exemplars_for(self, name: str, **labels) -> list:
        """Merged slowest-sample exemplars of ``name`` across matching label
        sets, ``[(value, trace_id), ...]`` descending."""
        want = tuple(sorted((k, v) for k, v in labels.items() if v))
        merged: list = []
        for (n, lbl), pairs in self.exemplars.items():
            if n != name:
                continue
            if want and not set(want).issubset(set(lbl)):
                continue
            merged.extend(pairs)
        merged.sort(key=lambda pair: -pair[0])
        return merged

    def hist(self, name: str, **labels) -> Histogram:
        """Merged histogram of ``name`` across matching label sets."""
        merged = Histogram()
        want = tuple(sorted((k, v) for k, v in labels.items() if v))
        for (n, lbl), h in self.hists.items():
            if n != name:
                continue
            if want and not set(want).issubset(set(lbl)):
                continue
            merged.merge(h)
        return merged

    def phase_table(
        self, percentiles=(50, 90, 99), name: str = "span.seconds"
    ) -> dict[str, dict[str, float]]:
        """Per-phase span statistics of the histogram ``name``
        (``span.seconds`` or ``span.device_seconds``), ``{phase: {count,
        sum, min, max, p50, p90, p99}}``, merged over the estimator label."""
        phases: dict[str, Histogram] = {}
        for (series, labels), h in self.hists.items():
            if series != name:
                continue
            phases.setdefault(dict(labels).get("phase", ""), Histogram()).merge(h)
        return {p: h.to_dict(percentiles) for p, h in sorted(phases.items())}

    def to_prometheus(self) -> str:
        """The snapshot in the Prometheus text exposition format: counters
        and gauges verbatim, histograms as cumulative ``_bucket{le=...}``
        series (upper bound = the log bucket's right edge) plus ``_sum`` and
        ``_count``, names sanitized under a ``tpu_ml_`` prefix."""
        lines: list[str] = []

        def prom_name(name: str) -> str:
            return "tpu_ml_" + "".join(
                c if c.isalnum() or c == "_" else "_" for c in name
            )

        def prom_labels(labels, extra: str = "") -> str:
            parts = [f'{k}="{_prom_escape(v)}"' for k, v in labels]
            if extra:
                parts.append(extra)
            return "{" + ",".join(parts) + "}" if parts else ""

        for kind, store in (("counter", self.counters), ("gauge", self.gauges)):
            by_name: dict[str, list] = {}
            for (name, labels), v in sorted(store.items()):
                by_name.setdefault(name, []).append((labels, v))
            for name, series in by_name.items():
                pn = prom_name(name)
                lines.append(f"# TYPE {pn} {kind}")
                for labels, v in series:
                    lines.append(f"{pn}{prom_labels(labels)} {v:g}")

        by_name = {}
        for (name, labels), h in sorted(self.hists.items()):
            by_name.setdefault(name, []).append((labels, h))
        for name, series in by_name.items():
            pn = prom_name(name)
            lines.append(f"# TYPE {pn} histogram")
            for labels, h in series:
                cum = 0
                for idx in sorted(h.buckets):
                    cum += h.buckets[idx]
                    le = 0.0 if idx == _ZERO_BUCKET else GROWTH ** (idx + 1)
                    le_label = 'le="%g"' % le
                    lines.append(f"{pn}_bucket{prom_labels(labels, le_label)} {cum}")
                inf_label = 'le="+Inf"'
                lines.append(f"{pn}_bucket{prom_labels(labels, inf_label)} {h.count}")
                lines.append(f"{pn}_sum{prom_labels(labels)} {h.total:g}")
                lines.append(f"{pn}_count{prom_labels(labels)} {h.count}")
        return "\n".join(lines) + ("\n" if lines else "")


# The one process-wide registry every serve path records into; tests take
# snapshots and deltas around what they measure.
REGISTRY = MetricsRegistry()
