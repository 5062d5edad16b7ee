"""Distributed trace context of the serving plane.

Port of ``spark_rapids_ml_tpu/telemetry/tracectx.py``, byte for byte on
the wire. A request admitted anywhere (HTTP handler, UDS listener,
fast-lane frame, in-process client) mints a compact context: a random
64-bit ``trace_id``, the admission span's 32-bit ``span_id``, and the
admission time in monotonic microseconds. Every hop carries it: the
``X-TPU-ML-Trace`` HTTP header, a ``trace`` field in the UDS JSON header,
and the 20-byte tail of the fast lane's request struct (zero JSON on that
path). Each hop records its span into the flight recorder with
``trace_id``/``span_id``/``parent_id`` labels; ``stitch`` rebuilds the tree.

Header token::

    <trace_id:016x>-<span_id:08x>-<origin_us:decimal>

Sampling is decided once, at admission, by ``TPU_ML_TRACE_SAMPLE``: an
unsampled request carries no context (``trace_id`` 0 on the fast-lane
struct, no header elsewhere) and records no spans.
"""

from __future__ import annotations

import contextvars
import dataclasses
import os
import random
import struct
import time

from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY
from spark_rapids_ml_tpu_torch.utils.config import (
    DEFAULT_TRACE_SAMPLE,
    TRACE_SAMPLE_VAR,
    lenient_float,
)

TRACE_HEADER = "X-TPU-ML-Trace"

# fast-lane struct tail: trace_id u64, span_id u32, origin_us u64, packed
# after (version, flags, name_len, rows, cols)
TRACE_STRUCT = struct.Struct(">QIQ")


def trace_sample_rate() -> float:
    return min(max(lenient_float(TRACE_SAMPLE_VAR, DEFAULT_TRACE_SAMPLE), 0.0), 1.0)


@dataclasses.dataclass(frozen=True)
class TraceContext:
    """One hop's view of a request trace: which trace, which span is the
    parent of whatever the holder does next, and when the request was
    admitted (monotonic µs, shared epoch across processes on Linux)."""

    trace_id: int   # u64, never 0 (0 is the untraced sentinel on the wire)
    span_id: int    # u32, this hop's span
    origin_us: int  # u64, admission time.perf_counter() in µs

    @property
    def trace_hex(self) -> str:
        return f"{self.trace_id:016x}"

    @property
    def span_hex(self) -> str:
        return f"{self.span_id:08x}"

    def to_header(self) -> str:
        return f"{self.trace_hex}-{self.span_hex}-{self.origin_us:d}"

    def child(self) -> "TraceContext":
        """Same trace, a fresh span id — the context a downstream hop
        should parent its own span to after recording one here."""
        return TraceContext(self.trace_id, _new_span_id(), self.origin_us)


def _new_trace_id() -> int:
    while True:
        tid = int.from_bytes(os.urandom(8), "big")
        if tid:
            return tid


def _new_span_id() -> int:
    while True:
        sid = int.from_bytes(os.urandom(4), "big")
        if sid:
            return sid


def mint(origin: str = "server") -> TraceContext | None:
    """Admission-point sampling decision: a context for the sampled
    fraction, ``None`` (request stays untraced) otherwise. Books one
    ``serve.traces{origin}`` counter tick per minted trace."""
    rate = trace_sample_rate()
    if rate <= 0.0 or (rate < 1.0 and random.random() >= rate):
        return None
    ctx = TraceContext(
        _new_trace_id(),
        _new_span_id(),
        int(time.perf_counter() * 1e6),
    )
    REGISTRY.counter_inc("serve.traces", 1, origin=origin)
    return ctx


def from_header(raw: str) -> TraceContext | None:
    """Parse the wire token; None on anything malformed (a bad header
    must degrade to untraced, never to a 500)."""
    if not raw:
        return None
    parts = raw.strip().split("-")
    if len(parts) != 3:
        return None
    try:
        trace_id = int(parts[0], 16)
        span_id = int(parts[1], 16)
        origin_us = int(parts[2], 10)
    except ValueError:
        return None
    if not trace_id or not span_id or origin_us < 0:
        return None
    if trace_id >= 1 << 64 or span_id >= 1 << 32:
        return None
    return TraceContext(trace_id, span_id, origin_us)


def from_wire(trace_id: int, span_id: int, origin_us: int):
    """Rebuild a context from the fastlane struct fields; trace_id 0 is
    the untraced sentinel."""
    if not trace_id:
        return None
    return TraceContext(
        trace_id & ((1 << 64) - 1),
        (span_id & ((1 << 32) - 1)) or _new_span_id(),
        max(int(origin_us), 0),
    )


# -- ambient context (in-process hops: client -> batcher) -------------------

_current_trace: contextvars.ContextVar[TraceContext | None] = (
    contextvars.ContextVar("tpu_ml_current_trace", default=None)
)


def current_trace() -> TraceContext | None:
    return _current_trace.get()


def set_current_trace(ctx: TraceContext | None):
    return _current_trace.set(ctx)


def reset_current_trace(token) -> None:
    _current_trace.reset(token)


def span_labels(
    ctx: TraceContext, *, parent: TraceContext | None = None
) -> dict:
    """Label kwargs for ``TIMELINE.record_span``: this hop's identity plus
    its parent edge (absent on the admission/root span)."""
    labels = {"trace_id": ctx.trace_hex, "span_id": ctx.span_hex}
    if parent is not None:
        labels["parent_id"] = parent.span_hex
    return labels


def link_token(ctx: TraceContext) -> str:
    """One ``trace:span`` link element (dispatch spans fan in N of these,
    space-joined, instead of belonging to any single trace)."""
    return f"{ctx.trace_hex}:{ctx.span_hex}"


# -- stitching --------------------------------------------------------------


def _span_args(ev: dict) -> dict:
    args = ev.get("args")
    return args if isinstance(args, dict) else {}


def stitch_all(events: list[dict]) -> dict[str, dict]:
    """Group merged flight-recorder events into per-trace span trees.

    Returns ``{trace_id_hex: trace}`` where each trace carries ``spans``
    (X-phase events labeled with the trace id), ``instants`` (i-phase,
    e.g. the router's silent-retry marker), ``links`` (spans from OTHER
    traces — batch dispatch spans — whose ``links`` arg references this
    trace), ``roots`` (spans with no parent edge), ``orphans`` (spans
    whose parent span is missing from the merged stream), and
    ``complete`` — exactly one root, zero orphans.
    """
    traces: dict[str, dict] = {}

    def bucket(tid: str) -> dict:
        t = traces.get(tid)
        if t is None:
            t = traces[tid] = {
                "trace_id": tid,
                "spans": [],
                "instants": [],
                "links": [],
            }
        return t

    for ev in events:
        args = _span_args(ev)
        tid = args.get("trace_id", "")
        ph = ev.get("ph")
        if tid:
            if ph == "X":
                bucket(tid)["spans"].append(ev)
            elif ph == "i":
                bucket(tid)["instants"].append(ev)
        links = args.get("links", "")
        if links and ph == "X":
            for token in str(links).split():
                ltid, _, lsid = token.partition(":")
                if ltid:
                    bucket(ltid)["links"].append(
                        {"span_id": lsid, "event": ev}
                    )

    for t in traces.values():
        by_id = {
            _span_args(s).get("span_id", ""): s for s in t["spans"]
        }
        roots, orphans = [], []
        for s in t["spans"]:
            parent = _span_args(s).get("parent_id", "")
            if not parent:
                roots.append(s)
            elif parent not in by_id:
                orphans.append(s)
        t["roots"] = roots
        t["orphans"] = orphans
        t["complete"] = bool(
            len(roots) == 1 and not orphans and t["spans"]
        )
    return traces


def stitch(events: list[dict], trace_id_hex: str) -> dict | None:
    """One trace's stitched tree out of a merged event stream, children
    nested under their parents (the `/traces/<id>` response body)."""
    trace = stitch_all(events).get(trace_id_hex)
    if trace is None:
        return None
    by_id: dict[str, dict] = {}
    nodes = []
    for s in sorted(trace["spans"], key=lambda e: e.get("ts", 0)):
        args = _span_args(s)
        node = {
            "name": s.get("name", ""),
            "span_id": args.get("span_id", ""),
            "parent_id": args.get("parent_id", ""),
            "ts_us": s.get("ts", 0),
            "dur_us": s.get("dur", 0),
            "pid": s.get("pid"),
            "args": {
                k: v for k, v in args.items()
                if k not in ("trace_id", "span_id", "parent_id")
            },
            "children": [],
        }
        by_id[node["span_id"]] = node
        nodes.append(node)
    roots = []
    for node in nodes:
        parent = by_id.get(node["parent_id"])
        if parent is not None and parent is not node:
            parent["children"].append(node)
        else:
            roots.append(node)
    return {
        "trace_id": trace_id_hex,
        "complete": trace["complete"],
        "roots": roots,
        "orphans": [
            _span_args(s).get("span_id", "") for s in trace["orphans"]
        ],
        "instants": [
            {
                "name": i.get("name", ""),
                "ts_us": i.get("ts", 0),
                "args": _span_args(i),
            }
            for i in sorted(
                trace["instants"], key=lambda e: e.get("ts", 0)
            )
        ],
        "links": [
            {
                "span_id": l["span_id"],
                "name": l["event"].get("name", ""),
                "ts_us": l["event"].get("ts", 0),
                "dur_us": l["event"].get("dur", 0),
                "pid": l["event"].get("pid"),
            }
            for l in trace["links"]
        ],
    }


def coverage(events: list[dict]) -> dict:
    """Stitching coverage over a merged event stream: how many traces were
    observed, how many stitched completely, and the fraction — the
    ``trace_coverage`` number bench stamps on the perf ledger."""
    traces = stitch_all(events)
    complete = sum(1 for t in traces.values() if t["complete"])
    orphan_spans = sum(len(t["orphans"]) for t in traces.values())
    multi_root = sum(1 for t in traces.values() if len(t["roots"]) > 1)
    return {
        "traces": len(traces),
        "complete": complete,
        "orphan_spans": orphan_spans,
        "multi_root": multi_root,
        "coverage": (complete / len(traces)) if traces else 1.0,
    }
