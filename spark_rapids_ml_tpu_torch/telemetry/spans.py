"""Trace spans of the port: an NVTX range on the card, booked into the
registry and the flight recorder.

Port of ``spark_rapids_ml_tpu/telemetry/spans.py``. ``trace_range`` is the
analog of the reference's ``NvtxRange`` and of the JAX package's
``trace_range``: on the card it opens an NVTX range, which profilers show
on the timeline (on the CPU there is none); on every device it books the
span's host seconds into the ``span.seconds`` histogram, labelled with the
phase and the estimator currently fitting, and records a timeline span
stamped with the fit or transform id. The booking is in a ``finally``
block, so a body that raises still books its time. The span's time is the
host's: nothing here synchronizes the card, so a span that only enqueues
work ends before that work does.

The context variables carry which estimator is fitting and the ids of the
current fit and transform windows (set by ``telemetry/report.py`` through
the ``models/base.py`` wrappers); ``_FitIdFilter`` stamps the ids on every
record of the package logger, so ``%(fit_id)s`` in a log format joins the
log with the exported report.
"""

from __future__ import annotations

import contextlib
import contextvars
import logging
import time

import torch

from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY
from spark_rapids_ml_tpu_torch.telemetry.timeline import TIMELINE

logger = logging.getLogger("spark_rapids_ml_tpu_torch")

#: The port's ``trace_range`` phases, under the JAX package's names: the
#: latency series an SLO objective resolves through ``span.seconds{phase}``
#: (``telemetry/slo.py``).
SPAN_PHASES: frozenset[str] = frozenset({
    # streamed fit
    "fold.dispatch",
    "fold.wait",
    "ingest.chunk",
    # PCA
    "compute cov",
    "eigh",
    "pca transform",
    # scalers and preprocessing
    "scaler moments",
    "scaler range stats",
    "scaler transform",
    "robust scaler histogram",
    "robust transform",
    "maxabs transform",
    "minmax transform",
    "normalize",
    "binarize",
    "bucketize",
    "quantile bucketize",
    "quantile discretizer histogram",
    "impute",
    "imputer fit",
    "polynomial expansion",
    "elementwise product",
    "vector slicer",
    "dct",
    "variance selector fit",
    "variance selector transform",
    # clustering and neighbours
    "kmeans init",
    "kmeans lloyd",
    "kmeans transform",
    "dbscan cluster",
    "knn kneighbors",
    "ivf build",
    "ivf kneighbors",
    "ann build",
    "ann pack",
    "ann query",
    # the IVF builds' passes (the port's own)
    "ivf assign",
    "ivf pack",
    "ann sample",
    "ann init",
    "ann lloyd",
    "ann assign",
    # trees and naive Bayes
    "forest build",
    "naive bayes stats",
    "naive bayes variance pass",
    # boosting, the networks, UMAP and the host meta-estimators
    "gbt boost",
    "mlp train",
    "fm train",
    "umap knn graph",
    "umap fuzzy graph",
    "umap init",
    "umap layout",
    "umap transform",
    "one-vs-rest fit",
    "one-vs-rest transform",
    "isotonic pav",
})

_current_estimator: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "tpu_ml_torch_current_estimator", default=None
)
_current_fit_id: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "tpu_ml_torch_current_fit_id", default=None
)
_current_transform_id: contextvars.ContextVar[str | None] = contextvars.ContextVar(
    "tpu_ml_torch_current_transform_id", default=None
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


@contextlib.contextmanager
def trace_range(name: str, device: torch.device | None = None):
    """A span named ``name``: an NVTX range when ``device`` is a CUDA
    device, and on every device its host seconds booked into
    ``span.seconds{phase, estimator}`` and the flight recorder."""
    start = time.perf_counter()
    try:
        if device is not None and device.type == "cuda":
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield
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
