"""Flight recorder: a bounded ring of raw span and instant events.

Port of ``spark_rapids_ml_tpu/telemetry/timeline.py`` (``Timeline`` and
``chrome_trace``). The registry answers *how long*; this ring answers
*when*: which request waited in which batch, which dispatch carried it.
The serving front ends record one ``serve.request`` span per traced
request, the batcher a ``serve.queue`` span per rider and a
``serve.dispatch`` span per batch; ``telemetry.tracectx.stitch`` rebuilds a
request's tree from them, and ``chrome_trace`` exports them as Chrome
trace-event JSON (Perfetto).

- **Bounded**: a ``deque(maxlen=TPU_ML_TIMELINE_EVENTS)`` (default 4096; 0
  disables recording). Old events fall off; aggregate truth stays in the
  registry.
- **Thread-safe**: one lock around a deque append.
- **One clock**: timestamps are ``time.perf_counter()`` microseconds
  (CLOCK_MONOTONIC on Linux), so events of processes on one host interleave.

Events are plain dicts: ``{"name", "ph": "X"|"i", "ts": µs, "dur": µs (X
only), "pid", "tid", "cat", "args": {labels...}, "seq"}``; ``seq`` is a
monotone counter for ``events(since_seq=...)`` and is dropped at export.
"""

from __future__ import annotations

import collections
import os
import threading
import time

from spark_rapids_ml_tpu_torch.utils.config import (
    DEFAULT_TIMELINE_EVENTS,
    TIMELINE_EVENTS_VAR,
)


def timeline_capacity() -> int:
    """Ring capacity from ``TPU_ML_TIMELINE_EVENTS`` (0 disables); a
    malformed or negative value raises."""
    raw = os.environ.get(TIMELINE_EVENTS_VAR, str(DEFAULT_TIMELINE_EVENTS))
    try:
        cap = int(raw)
    except ValueError:
        raise ValueError(f"{TIMELINE_EVENTS_VAR}={raw!r} is not an integer") from None
    if cap < 0:
        raise ValueError(f"{TIMELINE_EVENTS_VAR}={cap} must be >= 0")
    return cap


class Timeline:
    """One process's bounded event recorder."""

    def __init__(self, capacity: int | None = None):
        self._capacity = timeline_capacity() if capacity is None else capacity
        self._lock = threading.Lock()
        self._events: collections.deque = collections.deque(
            maxlen=self._capacity or None
        )
        self._seq = 0
        self._enabled = self._capacity > 0

    @property
    def capacity(self) -> int:
        return self._capacity

    def seq(self) -> int:
        """Current sequence watermark, to pair with ``events(since_seq=)``."""
        with self._lock:
            return self._seq

    def _append(self, event: dict) -> None:
        with self._lock:
            self._seq += 1
            event["seq"] = self._seq
            self._events.append(event)

    def record_span(self, name: str, t0_s: float, t1_s: float, **labels) -> None:
        """One completed span; ``t0_s``/``t1_s`` are ``time.perf_counter()``
        readings."""
        if not self._enabled:
            return
        self._append(
            {
                "name": name,
                "ph": "X",
                "ts": int(t0_s * 1e6),
                "dur": max(0, int((t1_s - t0_s) * 1e6)),
                "pid": os.getpid(),
                "tid": threading.get_native_id(),
                "cat": "span",
                "args": {k: v for k, v in labels.items() if v},
            }
        )

    def record_instant(self, name: str, **labels) -> None:
        """A point event."""
        if not self._enabled:
            return
        self._append(
            {
                "name": name,
                "ph": "i",
                "ts": int(time.perf_counter() * 1e6),
                "pid": os.getpid(),
                "tid": threading.get_native_id(),
                "cat": "instant",
                "s": "t",  # thread-scoped instant (a Perfetto render hint)
                "args": {k: v for k, v in labels.items() if v},
            }
        )

    def events(self, since_seq: int = 0) -> list[dict]:
        """Copies of the events with ``seq > since_seq``, in record order."""
        with self._lock:
            return [
                dict(e, args=dict(e["args"]))
                for e in self._events
                if e["seq"] > since_seq
            ]

    def clear(self) -> None:
        with self._lock:
            self._events.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


def chrome_trace(events: list[dict]) -> dict:
    """Events → a Chrome trace-event JSON object (Perfetto-loadable), with
    ``M``-phase process_name metadata per pid and ``seq`` stripped."""
    pids = []
    out = []
    for e in events:
        e = {k: v for k, v in e.items() if k != "seq"}
        pid = e.get("pid", 0)
        if pid not in pids:
            pids.append(pid)
        out.append(e)
    meta = []
    for pid in pids:
        # a partition label on any of the pid's events names the track
        part = next(
            (
                e["args"]["partition"]
                for e in out
                if e.get("pid") == pid and (e.get("args") or {}).get("partition")
            ),
            None,
        )
        name = (
            f"worker partition {part}"
            if part is not None
            else f"driver (pid {pid})" if pid == os.getpid() else f"pid {pid}"
        )
        meta.append(
            {"name": "process_name", "ph": "M", "pid": pid, "tid": 0, "args": {"name": name}}
        )
    return {"traceEvents": meta + out, "displayTimeUnit": "ms"}


# The one process-wide recorder the serving paths record into; tests make
# private Timeline instances.
TIMELINE = Timeline()
