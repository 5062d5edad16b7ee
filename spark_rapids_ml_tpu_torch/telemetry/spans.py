"""Trace spans of the port: a profiler range on every device, device time
on the card, booked into the registry and the flight recorder.

Port of ``spark_rapids_ml_tpu/telemetry/spans.py``. ``trace_range`` is the
analog of the reference's ``NvtxRange`` and of the JAX package's
``trace_range``. On every device it opens a FUNCTION-scope profiler range
(``torch._C._profiler._RecordFunctionFast``): a ``torch.profiler`` trace
shows it as a host operator named by the phase, on the clock of the
trace's kernel and copy events, with no mirror on the device's timeline.
With no profiler running it costs under a microsecond. On a CUDA device
it also pushes an NVTX range of the same name, which Nsight shows with no
set-up and ``torch.profiler`` does not record. On every device it books
the span's host seconds into the ``span.seconds`` histogram, labelled with
the phase and the estimator currently fitting, and records a timeline span
stamped with the fit or transform id. The booking is in a ``finally``
block, so a body that raises still books its time. The host's seconds are
those of the enqueue: nothing here synchronizes the card, so a span that
only enqueues work ends before that work does.

The device's seconds: a span opened on a CUDA device inside an open fit or
transform window (``telemetry/report.py``) records a pair of timing events
on the current stream at entry and exit and appends it to the window's
list; the window books each pair's elapsed time into
``span.device_seconds{phase, estimator}`` when it closes
(``book_device_spans``), after waiting on the events. A pair costs 30–50 µs
of host time to record and about 15 µs to book (an H100), so a span that wraps host
work only, or one step of a per-chunk loop whose enclosing phase is timed
already, passes ``device_time=False``. Outside a window, during a CUDA
graph capture and on the CPU no event is recorded.

The context variables carry which estimator is fitting, the ids of the
current fit and transform windows and the window's device spans (set by
``telemetry/report.py`` through the ``models/base.py`` wrappers);
``_FitIdFilter`` stamps the ids on every record of the package logger, so
``%(fit_id)s`` in a log format joins the log with the exported report.
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import time

import torch

from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY
from spark_rapids_ml_tpu_torch.telemetry.timeline import TIMELINE

try:
    from torch._C._profiler import _RecordFunctionFast as _profiler_range
except ImportError:  # a torch without it: the spans reach no profiler

    def _profiler_range(name: str):
        return contextlib.nullcontext()


logger = logging.getLogger("spark_rapids_ml_tpu_torch")

_current_estimator: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "tpu_ml_torch_current_estimator", default=None
)
_current_fit_id: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "tpu_ml_torch_current_fit_id", default=None
)
_current_transform_id: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "tpu_ml_torch_current_transform_id", default=None
)
#: the open window's device spans, (phase, start event, end event), or None
#: outside a window
_device_spans: contextvars.ContextVar[list | None] = contextvars.ContextVar(
    "tpu_ml_torch_device_spans", default=None
)


def current_estimator() -> str | None:
    return _current_estimator.get()


def set_current_estimator(name: str | None):
    """Returns the reset token (contextvars protocol)."""
    return _current_estimator.set(name)


def reset_current_estimator(token) -> None:
    _current_estimator.reset(token)


def current_fit_id() -> str | None:
    return _current_fit_id.get()


def set_current_fit_id(fit_id: str | None):
    """Returns the reset token (contextvars protocol)."""
    return _current_fit_id.set(fit_id)


def reset_current_fit_id(token) -> None:
    _current_fit_id.reset(token)


def current_transform_id() -> str | None:
    return _current_transform_id.get()


def set_current_transform_id(transform_id: str | None):
    """Returns the reset token (contextvars protocol)."""
    return _current_transform_id.set(transform_id)


def reset_current_transform_id(token) -> None:
    _current_transform_id.reset(token)


class _FitIdFilter(logging.Filter):
    """Stamps ``record.fit_id`` and ``record.transform_id`` (the current
    window ids, or ``"-"``) on every record of the package logger."""

    def filter(self, record: logging.LogRecord) -> bool:
        record.fit_id = _current_fit_id.get() or "-"
        record.transform_id = _current_transform_id.get() or "-"
        return True


def install_fit_id_filter() -> None:
    """Attach the fit-id filter to the package logger (idempotent)."""
    pkg = logging.getLogger("spark_rapids_ml_tpu_torch")
    if not any(isinstance(f, _FitIdFilter) for f in pkg.filters):
        pkg.addFilter(_FitIdFilter())


def open_device_spans() -> tuple[list, contextvars.Token]:
    """A window's list of device spans, made current; returns it and the
    reset token."""
    pairs: list = []
    return pairs, _device_spans.set(pairs)


def close_device_spans(token) -> None:
    """Restore the device spans of the enclosing window (or none)."""
    try:
        _device_spans.reset(token)
    except ValueError:  # reset from another context
        _device_spans.set(None)


def book_device_spans(pairs: list, estimator: str) -> None:
    """Book each pair's device seconds into
    ``span.device_seconds{phase, estimator}``, waiting on its end event, and
    empty ``pairs``. A pair whose events the card cannot read (it failed
    inside the window, whose own error is the one raised) books nothing."""
    for phase, begin, end in pairs:
        try:
            end.synchronize()
            seconds = begin.elapsed_time(end) / 1e3
        except RuntimeError:
            continue
        REGISTRY.histogram_record(
            "span.device_seconds", seconds, phase=phase, estimator=estimator
        )
    pairs.clear()


def _stream_event(device: torch.device) -> torch.cuda.Event:
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(device))
    return event


@contextlib.contextmanager
def trace_range(name: str, device: torch.device | None = None, *, device_time: bool = True):
    """A span named ``name``: a profiler range on every device and an NVTX
    range on a CUDA device, its host seconds booked into
    ``span.seconds{phase, estimator}`` and the flight recorder, and, unless
    ``device_time`` is False, on a CUDA device inside a fit or transform
    window a pair of timing events for ``span.device_seconds``."""
    cuda = device is not None and device.type == "cuda"
    pairs = _device_spans.get()
    begin = None
    if (device_time and cuda and pairs is not None
            and not torch.cuda.is_current_stream_capturing()):
        begin = _stream_event(device)
    start = time.perf_counter()
    try:
        with _profiler_range(name), (torch.cuda.nvtx.range(name) if cuda
                                     else contextlib.nullcontext()):
            yield
        if begin is not None:
            pairs.append((name, begin, _stream_event(device)))
    finally:
        end = time.perf_counter()
        estimator = _current_estimator.get() or ""
        REGISTRY.histogram_record("span.seconds", end - start, phase=name, estimator=estimator)
        TIMELINE.record_span(
            name,
            start,
            end,
            estimator=estimator,
            fit_id=_current_fit_id.get() or "",
            transform_id=_current_transform_id.get() or "",
        )
