"""JSONL sinks for fit and transform reports and the timeline.

Port of ``spark_rapids_ml_tpu/telemetry/export.py``, under its knobs:
``TPU_ML_TELEMETRY_PATH`` (fit and transform reports, one line each) and
``TPU_ML_TIMELINE_PATH`` (one ``timeline`` record per outermost fit or
transform), both read at each export; unset or empty disables the sink.
A line is one ``os.write`` on an ``O_APPEND`` descriptor, so appends from
several processes land whole. Export failures are logged and swallowed:
telemetry is never why a fit fails.
"""

from __future__ import annotations

import json
import logging
import os

from spark_rapids_ml_tpu_torch.utils.config import TELEMETRY_PATH_VAR, TIMELINE_PATH_VAR

logger = logging.getLogger("spark_rapids_ml_tpu_torch")


def telemetry_path() -> str:
    """The report sink's path ('' = disabled)."""
    return os.environ.get(TELEMETRY_PATH_VAR, "")


def timeline_path() -> str:
    """The timeline sink's path ('' = disabled); may equal
    ``telemetry_path``, readers filter on the record ``type``."""
    return os.environ.get(TIMELINE_PATH_VAR, "")


def _append_line(path: str, record: dict) -> bool:
    data = (json.dumps(record, separators=(",", ":"), sort_keys=True) + "\n").encode()
    fd = os.open(path, os.O_APPEND | os.O_CREAT | os.O_WRONLY, 0o644)
    try:
        os.write(fd, data)
    finally:
        os.close(fd)
    return True


def _export(record: dict, path: str | None, default_path, what: str) -> bool:
    if path is None:
        path = default_path()
    if not path:
        return False
    try:
        return _append_line(path, record)
    except Exception:  # noqa: BLE001 - an export must never break a fit
        logger.warning("%s export to %s failed", what, path, exc_info=True)
        return False


def export_timeline(
    events: list[dict],
    *,
    fit_id: str = "",
    transform_id: str = "",
    estimator: str = "",
    uid: str = "",
    overlap_fraction: float | None = None,
    path: str | None = None,
) -> bool:
    """Append one ``timeline`` record (the flight-recorder events of one
    window and its identity); True if written. A no-op without events or a
    sink."""
    if not events:
        return False
    record = {
        "type": "timeline",
        "schema": 1,
        "fit_id": fit_id,
        "estimator": estimator,
        "uid": uid,
        "overlap_fraction": overlap_fraction,
        "events": events,
    }
    if transform_id:
        record["transform_id"] = transform_id
    return _export(record, path, timeline_path, "timeline")


def export_fit_report(report, path: str | None = None) -> bool:
    """Append ``report.to_dict()`` as one ``fit_report`` line; True if
    written, a no-op without a sink."""
    return _export(report.to_dict(), path, telemetry_path, "telemetry")


def export_transform_report(report, path: str | None = None) -> bool:
    """Append one ``transform_report`` line (the fit reports' sink)."""
    return _export(report.to_dict(), path, telemetry_path, "telemetry")


def read_jsonl(path: str) -> list[dict]:
    """The records of a telemetry JSONL file, skipping blank and torn
    lines."""
    records: list[dict] = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                logger.debug("skipping a corrupt telemetry line in %s", path)
    return records
