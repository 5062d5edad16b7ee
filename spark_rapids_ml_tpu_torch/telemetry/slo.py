"""Sliding-window service-level objectives over the metrics registry.

Port of ``spark_rapids_ml_tpu/telemetry/slo.py``. The engine keeps a short
ring of timestamped registry snapshots; the newest minus the one just
outside the window is the window's histogram (the registry's delta
algebra), so rolling percentiles cost a few snapshots and no raw samples.
An evaluation publishes:

- rolling p50/p95/p99 gauges (``slo.rolling{series,q}``) of a default
  watchlist and of every series an objective names;
- breaches of the ``TPU_ML_SLO`` objectives with a burn filter: a target
  breached in ``TPU_ML_SLO_BURN`` consecutive evaluations fires
  ``slo.breach{objective}`` (a counter and a timeline instant), once per
  evaluation while it stays breached.

Objective grammar (comma list)::

    TPU_ML_SLO="fold.wait:p99:2.0,serve.latency:p95:0.005"
    TPU_ML_SLO="ingest.rows:min_rate:50000"

``series:pNN:ceiling_s`` bounds a rolling percentile: a span phase
(``telemetry.names.SPAN_PHASES``) resolves through
``span.seconds{phase=...}``, any other name is a histogram.
``counter:min_rate:floor_per_s`` is a throughput floor, judged only while
the counter moves. The health monitor drives ``evaluate`` at its poll
rate; tests call it directly.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from dataclasses import dataclass

from spark_rapids_ml_tpu_torch.telemetry.names import SPAN_PHASES
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY, Histogram
from spark_rapids_ml_tpu_torch.telemetry.timeline import TIMELINE
from spark_rapids_ml_tpu_torch.utils.config import (
    DEFAULT_SLO_BURN,
    DEFAULT_SLO_WINDOW_S,
    SLO_BURN_VAR,
    SLO_VAR,
    SLO_WINDOW_S_VAR,
)

#: Series whose rolling percentiles are published with no objective set.
DEFAULT_ROLLING: tuple[str, ...] = ("transform.partition_seconds", "fold.wait", "ingest.chunk")
ROLLING_QUANTILES: tuple[int, ...] = (50, 95, 99)


@dataclass(frozen=True)
class Objective:
    """One declarative target of ``TPU_ML_SLO``."""

    series: str   # histogram series, span phase or counter name
    kind: str     # "p<NN>" latency ceiling | "min_rate" throughput floor
    target: float

    @property
    def key(self) -> str:
        """The label value of the objective's gauges and counters."""
        return f"{self.series}:{self.kind}"


def parse_objectives(raw: str) -> tuple[Objective, ...]:
    """Parse the ``TPU_ML_SLO`` grammar; '' gives no objectives."""
    out: list[Objective] = []
    for entry in raw.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) != 3:
            raise ValueError(f"{SLO_VAR} entry {entry!r}: expected series:kind:target")
        series, kind, target_raw = parts[0].strip(), parts[1].strip(), parts[2]
        if kind != "min_rate" and not (
            kind.startswith("p") and kind[1:].isdigit() and 0 < int(kind[1:]) <= 100
        ):
            raise ValueError(
                f"{SLO_VAR} entry {entry!r}: kind {kind!r} is neither pNN (1..100) nor min_rate"
            )
        try:
            target = float(target_raw)
        except ValueError:
            raise ValueError(
                f"{SLO_VAR} entry {entry!r}: target {target_raw!r} is not a number"
            ) from None
        out.append(Objective(series, kind, target))
    return tuple(out)


def _resolve_hist(snap, series: str) -> Histogram:
    """A latency series is a span phase (``span.seconds{phase=...}``) or a
    histogram of its own."""
    if series in SPAN_PHASES:
        return snap.hist("span.seconds", phase=series)
    return snap.hist(series)


class SloEngine:
    """Windowed objective evaluation over registry snapshot deltas;
    thread-safe. ``registry`` is injectable for tests."""

    def __init__(
        self,
        objectives: tuple[Objective, ...] | None = None,
        *,
        window_s: float | None = None,
        burn: int | None = None,
        registry=None,
    ):
        if objectives is None:
            objectives = parse_objectives(os.environ.get(SLO_VAR, ""))
        if window_s is None:
            window_s = float(os.environ.get(SLO_WINDOW_S_VAR, str(DEFAULT_SLO_WINDOW_S)))
        if burn is None:
            burn = int(os.environ.get(SLO_BURN_VAR, str(DEFAULT_SLO_BURN)))
        self.objectives = objectives
        self.window_s = max(1e-3, float(window_s))
        self.burn = max(1, int(burn))
        self._registry = registry if registry is not None else REGISTRY
        self._lock = threading.Lock()
        # (monotonic t, snapshot); the newest entry older than the window
        # stays as the delta's base. Seeded now, so the first evaluation
        # covers "since the engine started".
        self._snaps: collections.deque = collections.deque()
        self._snaps.append((time.monotonic(), self._registry.snapshot()))
        self._streak: dict[str, int] = {}
        self._breaches: dict[str, int] = {}

    def evaluate(self, now: float | None = None) -> dict:
        """Snapshot, roll the window, publish gauges, detect burns; returns
        the ``/slo`` payload."""
        t = time.monotonic() if now is None else now
        snap = self._registry.snapshot()
        with self._lock:
            self._snaps.append((t, snap))
            cutoff = t - self.window_s
            while len(self._snaps) >= 2 and self._snaps[1][0] <= cutoff:
                self._snaps.popleft()
            base_t, base = self._snaps[0]
            streaks = dict(self._streak)
        elapsed = max(1e-9, t - base_t)
        delta = snap.delta(base) if base is not snap else snap.delta(snap)

        rolling_series = dict.fromkeys(
            DEFAULT_ROLLING + tuple(o.series for o in self.objectives if o.kind != "min_rate")
        )
        rolling: dict[str, dict[str, float]] = {}
        for series in rolling_series:
            h = _resolve_hist(delta, series)
            if not h.count:
                continue
            qs = {}
            for q in ROLLING_QUANTILES:
                v = h.percentile(q)
                qs[f"p{q}"] = v
                self._registry.gauge_set("slo.rolling", v, series=series, q=f"p{q}")
            rolling[series] = qs

        results: list[dict] = []
        fired: list[Objective] = []
        for obj in self.objectives:
            value = self._objective_value(obj, delta, elapsed)
            breached = value is not None and (
                value < obj.target if obj.kind == "min_rate" else value > obj.target
            )
            if value is not None:
                self._registry.gauge_set("slo.value", value, objective=obj.key)
            self._registry.gauge_set("slo.target", obj.target, objective=obj.key)
            streak = streaks.get(obj.key, 0) + 1 if breached else 0
            streaks[obj.key] = streak
            if breached and streak >= self.burn:
                fired.append(obj)
            results.append({
                "objective": obj.key,
                "series": obj.series,
                "kind": obj.kind,
                "target": obj.target,
                "value": value,
                "breached": breached,
                "streak": streak,
            })
        with self._lock:
            self._streak = streaks
            for obj in fired:
                self._breaches[obj.key] = self._breaches.get(obj.key, 0) + 1
            breaches = dict(self._breaches)
        for obj in fired:
            self._registry.counter_inc("slo.breach", objective=obj.key)
            TIMELINE.record_instant("slo.breach", objective=obj.key)
        for r in results:
            r["breaches"] = breaches.get(r["objective"], 0)
        return {
            "window_s": self.window_s,
            "burn": self.burn,
            "elapsed_s": elapsed,
            "objectives": results,
            "rolling": rolling,
            "total_breaches": sum(breaches.values()),
        }

    def _objective_value(self, obj: Objective, delta, elapsed: float):
        if obj.kind == "min_rate":
            moved = delta.counter(obj.series)
            if not moved:
                return None  # an idle counter: a floor needs traffic to judge
            return moved / elapsed
        h = _resolve_hist(delta, obj.series)
        if not h.count:
            return None
        return h.percentile(int(obj.kind[1:]))

    def total_breaches(self) -> int:
        with self._lock:
            return sum(self._breaches.values())
