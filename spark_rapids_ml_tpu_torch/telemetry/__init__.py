"""Telemetry of the port: spans, fit and transform reports, their JSONL
sinks, SLOs, health and the HTTP exporter.

Counterpart of ``spark_rapids_ml_tpu/telemetry``:

- ``trace_range`` (``spans``): an NVTX range on the card, booked into the
  ``span.seconds`` histogram and the flight recorder on every device;
- ``FitReport`` / ``TransformReport`` and their capture windows
  (``report``), opened by the ``models/base.py`` wrappers around every
  ``fit`` and ``transform``;
- the analytical cost model (``costmodel``), whose counters the reports'
  ``cost_model`` rolls up;
- the JSONL sinks (``export``), the SLO engine (``slo``), the health
  monitor and admission control (``health``), the exporter (``httpd``).
"""

from spark_rapids_ml_tpu_torch.telemetry import costmodel
from spark_rapids_ml_tpu_torch.telemetry.export import (
    export_fit_report,
    export_timeline,
    export_transform_report,
    read_jsonl,
)
from spark_rapids_ml_tpu_torch.telemetry.report import (
    FitReport,
    TransformReport,
    attach_report,
    attach_transform_report,
    begin_fit,
    begin_transform,
    end_fit,
    end_transform,
    recent_reports,
    release_transform_context,
)
from spark_rapids_ml_tpu_torch.telemetry.spans import trace_range
from spark_rapids_ml_tpu_torch.telemetry.timeline import TIMELINE

__all__ = [
    "TIMELINE",
    "FitReport",
    "TransformReport",
    "attach_report",
    "attach_transform_report",
    "costmodel",
    "begin_fit",
    "begin_transform",
    "end_fit",
    "end_transform",
    "export_fit_report",
    "export_timeline",
    "export_transform_report",
    "read_jsonl",
    "recent_reports",
    "release_transform_context",
    "trace_range",
]
