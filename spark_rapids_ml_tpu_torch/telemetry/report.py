"""Per-fit and per-transform telemetry: the ``FitReport`` on every fitted
model and the ``TransformReport`` of every transform.

Port of ``spark_rapids_ml_tpu/telemetry/report.py``, with its schema and
its ``to_dict`` keys. ``begin_fit``/``end_fit`` bracket one
``Estimator.fit`` (wired once in ``models/base.py``, so every estimator
gets it): snapshot the registry, stamp the estimator name and a fresh
``fit_id`` into the span context, and at the end build the report from the
registry's delta (per-phase span percentiles, H2D bytes, stream overlap,
health, the admission decision) and a device memory sample.

Where the port's report differs from the JAX package's:

- ``rows_ingested``/``bytes_ingested`` deviate from the reference. They are
  the rows and bytes of the dataset the caller handed this fit, counted by
  the fit wrapper from the container's shape
  (``utils.columnar.dataset_size``); where that is not known without
  extracting, the streamed fold's ``ingest.rows``/``ingest.bytes``. The
  JAX package sums its ``ingest.rows`` counter, every extraction of every
  stage. One estimator's fit, resident or streamed, counts the same in
  both; ``Pipeline([StandardScaler, PCA]).fit`` counts its caller's rows
  once here and four times there
  (``tests/test_torch_health_report.py::test_rows_ingested_against_jax``).
- ``h2d_bytes`` is the ``h2d.bytes`` counter, booked wherever the port
  copies host rows to the card: ``utils/device.py::to_device`` (every
  estimator's resident path) and ``spark/ingest.py::stream_fold``.
- ``device_memory`` is ``torch.cuda.memory_stats`` per initialized card
  (``telemetry.compilemon.sample_device_memory``):
  ``allocated_bytes.all.peak`` is ``peak_bytes_in_use``. The outermost fit
  resets the peak at ``begin_fit`` (``torch.cuda.reset_peak_memory_stats``),
  so the peak is the fit's own, where the JAX package's is the process's
  (an upper bound for the fit). A nested fit does not reset it, so its
  peak is that of its enclosing fit so far, an upper bound for its own.
- ``compile`` reads the CUDA graph captures (``compile.graph_captures``);
  the XLA keys it shares with the JAX package stay 0.
- ``cost_model`` is ``telemetry/costmodel.py``'s ``window_summary`` of the
  window's ``costmodel.*`` counters (fits and transforms), and ``tuning``
  the tuner's decisions journaled inside the fit (``autotune/cache.py``),
  as in the JAX package; the cost model's numbers are the port's analytical
  counts and the card's peak.
- A transform's report closes when ``transform`` returns, except for a lazy
  plan (a ``localspark`` DataFrame): there the window's context is restored
  at return (``release_transform_context``) and the report closes when the
  plan first materializes (``models/base.py``). Its ``partitions`` then
  hold each partition's ``transform.*`` counters, which the workers' partition
  functions book and the telemetry trailer brings back labelled by partition.

Nested fits (a pipeline's stages) each get a report, a sub-window of the
outer one; only the outermost fit is exported (``models/base.py``).
"""

from __future__ import annotations

import collections
import threading
import time
import uuid
from dataclasses import dataclass, field
from typing import Any

import torch

from spark_rapids_ml_tpu_torch.telemetry import compilemon, costmodel, spans
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY, render_key
from spark_rapids_ml_tpu_torch.telemetry.timeline import TIMELINE

# the JAX package's schema versions: v6 adds the admission decision
SCHEMA_VERSION = 6
TRANSFORM_SCHEMA_VERSION = 1

# counters folded into dedicated report fields; other counters land in
# ``counters`` verbatim
_FOLDED_COUNTERS = ("ingest.rows", "ingest.bytes", "columnar.rows", "columnar.bytes")
_FOLDED_PREFIXES = ("compile.", "collective.", "h2d.", "costmodel.")


@dataclass
class FitReport:
    """Everything observed during one ``fit()`` call. ``phases`` maps span
    name → ``{count, sum, min, max, p50, p90, p99}`` seconds."""

    estimator: str
    uid: str
    wall_seconds: float
    phases: dict[str, dict[str, float]] = field(default_factory=dict)
    rows_ingested: int = 0
    bytes_ingested: int = 0
    h2d_bytes: int = 0
    collectives: dict[str, float] = field(default_factory=dict)
    compile: dict[str, float] = field(default_factory=dict)
    device_memory: dict[str, dict[str, int]] = field(default_factory=dict)
    counters: dict[str, float] = field(default_factory=dict)
    timestamp_unix: float = 0.0
    fit_id: str = ""
    # mean streamed-fold overlap (overlapped dispatches / chunks) over the
    # fit's stream_fold calls; None when nothing streamed
    overlap_fraction: float | None = None
    cost_model: dict = field(default_factory=dict)
    tuning: dict = field(default_factory=dict)
    health: dict = field(default_factory=dict)
    admission: dict = field(default_factory=dict)
    schema: int = SCHEMA_VERSION

    @property
    def peak_device_bytes(self) -> int:
        """The largest ``peak_bytes_in_use`` across cards (0 without one)."""
        return max(
            (m.get("peak_bytes_in_use", 0) for m in self.device_memory.values()), default=0
        )

    def to_dict(self) -> dict:
        return {
            "type": "fit_report",
            "schema": self.schema,
            "estimator": self.estimator,
            "uid": self.uid,
            "fit_id": self.fit_id,
            "overlap_fraction": self.overlap_fraction,
            "timestamp_unix": self.timestamp_unix,
            "wall_seconds": self.wall_seconds,
            "phases": self.phases,
            "rows_ingested": self.rows_ingested,
            "bytes_ingested": self.bytes_ingested,
            "h2d_bytes": self.h2d_bytes,
            "collectives": self.collectives,
            "compile": self.compile,
            "device_memory": self.device_memory,
            "peak_device_bytes": self.peak_device_bytes,
            "counters": self.counters,
            "cost_model": self.cost_model,
            "tuning": self.tuning,
            "health": self.health,
            "admission": self.admission,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FitReport":
        return cls(
            estimator=d.get("estimator", ""),
            uid=d.get("uid", ""),
            wall_seconds=float(d.get("wall_seconds", 0.0)),
            phases=d.get("phases", {}),
            rows_ingested=int(d.get("rows_ingested", 0)),
            bytes_ingested=int(d.get("bytes_ingested", 0)),
            h2d_bytes=int(d.get("h2d_bytes", 0)),
            collectives=d.get("collectives", {}),
            compile=d.get("compile", {}),
            device_memory=d.get("device_memory", {}),
            counters=d.get("counters", {}),
            timestamp_unix=float(d.get("timestamp_unix", 0.0)),
            fit_id=d.get("fit_id", ""),
            overlap_fraction=d.get("overlap_fraction"),
            cost_model=d.get("cost_model", {}) or {},
            tuning=d.get("tuning", {}) or {},
            health=d.get("health", {}) or {},
            admission=d.get("admission", {}) or {},
            schema=int(d.get("schema", SCHEMA_VERSION)),
        )


@dataclass
class TransformReport:
    """Everything observed during one ``transform()`` call. ``partitions``
    maps a partition label (``"0"``, ``"1"``, … from local Spark workers,
    ``"driver"`` for a partition function run in this process) to its
    ``{rows, bytes, seconds, batches}``; ``partition_latency`` is the merged
    ``transform.partition_seconds`` histogram. Both are empty for an eager
    transform, which runs no partition function."""

    transformer: str
    uid: str
    wall_seconds: float
    phases: dict[str, dict[str, float]] = field(default_factory=dict)
    rows: int = 0
    bytes: int = 0
    partitions: dict[str, dict[str, float]] = field(default_factory=dict)
    partition_latency: dict[str, float] = field(default_factory=dict)
    cost_model: dict = field(default_factory=dict)
    counters: dict[str, float] = field(default_factory=dict)
    timestamp_unix: float = 0.0
    transform_id: str = ""
    schema: int = TRANSFORM_SCHEMA_VERSION

    def to_dict(self) -> dict:
        return {
            "type": "transform_report",
            "schema": self.schema,
            "transformer": self.transformer,
            "uid": self.uid,
            "transform_id": self.transform_id,
            "timestamp_unix": self.timestamp_unix,
            "wall_seconds": self.wall_seconds,
            "phases": self.phases,
            "rows": self.rows,
            "bytes": self.bytes,
            "partitions": self.partitions,
            "partition_latency": self.partition_latency,
            "cost_model": self.cost_model,
            "counters": self.counters,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "TransformReport":
        return cls(
            transformer=d.get("transformer", ""),
            uid=d.get("uid", ""),
            wall_seconds=float(d.get("wall_seconds", 0.0)),
            phases=d.get("phases", {}),
            rows=int(d.get("rows", 0)),
            bytes=int(d.get("bytes", 0)),
            partitions=d.get("partitions", {}),
            partition_latency=d.get("partition_latency", {}),
            cost_model=d.get("cost_model", {}) or {},
            counters=d.get("counters", {}),
            timestamp_unix=float(d.get("timestamp_unix", 0.0)),
            transform_id=d.get("transform_id", ""),
            schema=int(d.get("schema", TRANSFORM_SCHEMA_VERSION)),
        )


@dataclass
class _Capture:
    """One open fit or transform window."""

    name: str
    uid: str
    window_id: str
    rows: int | None
    nbytes: int | None
    token: Any
    id_token: Any
    snap: Any
    tl_seq: int
    tuning_seq: int = 0
    admission: dict = field(default_factory=dict)
    released: bool = False
    t0: float = field(default_factory=time.perf_counter)
    t_unix: float = field(default_factory=time.time)


def _reset_peak_memory() -> None:
    """Start the cards' peak-memory window; never initializes CUDA."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        for i in range(torch.cuda.device_count()):
            torch.cuda.reset_peak_memory_stats(i)


def begin_fit(
    estimator: str,
    uid: str = "",
    *,
    rows: int | None = None,
    nbytes: int | None = None,
    device: torch.device | None = None,
    outermost: bool = True,
) -> _Capture:
    """Open a fit window: bring up the exporter when ``TPU_ML_HTTP_PORT``
    asks for it, take the admission decision, reset the cards' peak memory
    (the outermost fit only), snapshot the registry and the timeline, mint a
    fit id and label later spans with the estimator. ``rows``/``nbytes``
    are the caller's dataset size when known. Raises ``AdmissionRefused``
    when admission control refuses the fit, and under ``degrade`` for a fit
    whose ``device`` is not the CPU (the port has no degraded path for a
    fit on the card yet)."""
    from spark_rapids_ml_tpu_torch.telemetry import health, httpd

    spans.install_fit_id_filter()
    httpd.ensure_started()
    admission = health.admission_check()
    if admission["action"] == "refuse":
        raise health.AdmissionRefused(
            f"fit of {estimator} refused by admission control: {admission['reason']} "
            f"(set {health.ADMISSION_POLICY_VAR}=off to override)"
        )
    if admission["action"] == "degrade":
        if device is None or device.type != "cpu":
            where = device if device is not None else "its stages' devices"
            raise health.AdmissionRefused(
                f"fit of {estimator} on {where} cannot be degraded: "
                f"{admission['reason']}. In the JAX package {health.ADMISSION_POLICY_VAR}"
                "=degrade moves only a Spark estimator's mesh-local fit off the mesh "
                "(spark/estimators.py::_mesh_or_fallback); the port's mesh-local fit "
                "and that fallback wait for ROADMAP Queue A item 6, so it has no "
                "degraded path for a fit on the card. Fit on device='cpu' or set the "
                "policy to 'refuse' or 'off'"
            )
        health.begin_degrade_window()
    if outermost:
        _reset_peak_memory()
    # lazy: autotune/cache.py imports the telemetry registry
    from spark_rapids_ml_tpu_torch.autotune import cache as autotune_cache

    fit_id = uuid.uuid4().hex[:12]
    return _Capture(
        name=estimator,
        uid=uid,
        window_id=fit_id,
        rows=rows,
        nbytes=nbytes,
        token=spans.set_current_estimator(estimator),
        id_token=spans.set_current_fit_id(fit_id),
        snap=REGISTRY.snapshot(),
        tl_seq=TIMELINE.seq(),
        tuning_seq=autotune_cache.decision_seq(),
        admission=admission,
    )


# the most recent report dicts (fit and transform), served by /report
_REPORTS_LOCK = threading.Lock()
_RECENT_REPORTS: collections.deque = collections.deque(maxlen=16)


def _remember_report(d: dict) -> None:
    with _REPORTS_LOCK:
        _RECENT_REPORTS.append(d)


def recent_reports() -> list[dict]:
    """The latest report dicts, oldest first (the ``/report`` payload)."""
    with _REPORTS_LOCK:
        return list(_RECENT_REPORTS)


def _other_counters(delta, *prefixes: str) -> dict[str, float]:
    return {
        render_key(k): v
        for k, v in sorted(delta.counters.items())
        if k[0] not in _FOLDED_COUNTERS and not k[0].startswith(_FOLDED_PREFIXES + prefixes)
    }


def end_fit(cap: _Capture) -> FitReport:
    """Close a fit window and build its report. Always called (the fit
    wrapper's ``finally``), so the span labels are restored even when the
    fit raised."""
    from spark_rapids_ml_tpu_torch.autotune import cache as autotune_cache
    from spark_rapids_ml_tpu_torch.telemetry import health

    wall = time.perf_counter() - cap.t0
    spans.reset_current_estimator(cap.token)
    spans.reset_current_fit_id(cap.id_token)
    decisions = autotune_cache.decisions_since(cap.tuning_seq)
    tuning: dict = {}
    if decisions:
        last = decisions[-1]
        tuning = {
            "decisions": decisions,
            "source": last["source"],
            "cache_hit": last["cache_hit"],
            "config": last["config"],
        }
    if cap.admission.get("action") == "degrade":
        health.end_degrade_window()
    device_memory = compilemon.sample_device_memory()
    delta = REGISTRY.snapshot().delta(cap.snap)
    ov = delta.hist("stream.overlap_fraction")
    captures = delta.hist("compile.graph_capture_seconds")
    report = FitReport(
        estimator=cap.name,
        uid=cap.uid,
        wall_seconds=wall,
        phases=delta.phase_table(),
        rows_ingested=int(cap.rows if cap.rows is not None else delta.counter("ingest.rows")),
        bytes_ingested=int(
            cap.nbytes if cap.nbytes is not None else delta.counter("ingest.bytes")
        ),
        h2d_bytes=int(delta.counter("h2d.bytes")),
        collectives={
            "count": delta.counter("collective.count"),
            "bytes": delta.counter("collective.bytes"),
            "tree_combines": delta.counter("collective.tree_combines"),
        },
        compile={
            "count": captures.count,
            "seconds": captures.total,
            "trace_seconds": 0.0,
            "lower_seconds": 0.0,
            "cache_hits": 0.0,
            "cache_misses": 0.0,
            "cache_time_saved_s": 0.0,
        },
        device_memory=device_memory,
        counters=_other_counters(delta),
        timestamp_unix=cap.t_unix,
        fit_id=cap.window_id,
        overlap_fraction=(ov.total / ov.count) if ov.count else None,
        cost_model=costmodel.window_summary(delta, wall),
        tuning=tuning,
        health=health.current_summary(),
        admission=cap.admission,
    )
    _remember_report(report.to_dict())
    return report


def begin_transform(
    transformer: str, uid: str = "", *, rows: int | None = None, nbytes: int | None = None
) -> _Capture:
    """Open a transform window: the mirror of ``begin_fit`` with a
    ``transform_id`` and no admission decision."""
    spans.install_fit_id_filter()
    transform_id = uuid.uuid4().hex[:12]
    return _Capture(
        name=transformer,
        uid=uid,
        window_id=transform_id,
        rows=rows,
        nbytes=nbytes,
        token=spans.set_current_estimator(transformer),
        id_token=spans.set_current_transform_id(transform_id),
        snap=REGISTRY.snapshot(),
        tl_seq=TIMELINE.seq(),
    )


def release_transform_context(cap: _Capture) -> None:
    """Restore the estimator and transform-id context variables (once).

    Split from ``end_transform`` because a lazy plan's report is built
    later, from its materialization, where the tokens of this context are
    unusable."""
    if cap.released:
        return
    cap.released = True
    try:
        spans.reset_current_estimator(cap.token)
        spans.reset_current_transform_id(cap.id_token)
    except ValueError:  # reset from another context
        spans.set_current_estimator(None)
        spans.set_current_transform_id(None)


_TRANSFORM_FIELDS = {
    "transform.rows": "rows",
    "transform.bytes": "bytes",
    "transform.batches": "batches",
}


def end_transform(cap: _Capture) -> TransformReport:
    """Close a transform window and build its report. Rows and bytes are
    the caller's dataset's where its size is known, else what the
    partition functions booked (``transform.rows``/``transform.bytes``)."""
    wall = time.perf_counter() - cap.t0
    release_transform_context(cap)
    delta = REGISTRY.snapshot().delta(cap.snap)
    partitions: dict[str, dict[str, float]] = {}

    def bucket(labels) -> dict[str, float]:
        part = dict(labels).get("partition", "") or "driver"
        return partitions.setdefault(part, {"rows": 0, "bytes": 0, "seconds": 0.0, "batches": 0})

    for (name, labels), v in delta.counters.items():
        if name in _TRANSFORM_FIELDS:
            bucket(labels)[_TRANSFORM_FIELDS[name]] += int(v)
    for (name, labels), h in delta.hists.items():
        if name == "transform.partition_seconds":
            bucket(labels)["seconds"] += h.total
    rows = cap.rows if cap.rows is not None else delta.counter("transform.rows")
    nbytes = cap.nbytes if cap.nbytes is not None else delta.counter("transform.bytes")
    report = TransformReport(
        transformer=cap.name,
        uid=cap.uid,
        wall_seconds=wall,
        phases=delta.phase_table(),
        rows=int(rows),
        bytes=int(nbytes),
        partitions=partitions,
        partition_latency=delta.hist("transform.partition_seconds").to_dict(),
        cost_model=costmodel.window_summary(delta, wall),
        counters=_other_counters(delta, "transform."),
        timestamp_unix=cap.t_unix,
        transform_id=cap.window_id,
    )
    _remember_report(report.to_dict())
    return report


def attach_report(model: Any, report: FitReport) -> None:
    """``model.fit_report = report``, where the model allows it."""
    try:
        model.fit_report = report
    except (AttributeError, TypeError):  # a slotted or frozen model
        pass


def attach_transform_report(model: Any, report: TransformReport) -> None:
    """``model.transform_report = report``, where the model allows it."""
    try:
        model.transform_report = report
    except (AttributeError, TypeError):  # a slotted or frozen model
        pass
