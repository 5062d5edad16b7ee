"""Streamed (out-of-core) fit: host chunks folded into a carry on the card.

Counterpart of the streamed-fit part of ``spark_rapids_ml_tpu/spark/ingest.py``
(``use_streamed_fit``, ``stream_chunk_rows``, ``StreamFold``, ``stream_fold``)
for a source that is an iterable of host matrices. The full [rows, n] array
is never assembled, host or device: device memory stays O(chunk + carry).

JAX's async dispatch and donated carry become explicit CUDA streams and
events:

- rows are copied from the source into one of two pinned f32 host staging
  buffers of ``chunk_rows`` rows, filled across partition boundaries as the
  JAX loop fills its chunk buffers, so ⌈rows / chunk_rows⌉ chunks fold and
  the ragged tail is the last one;
- a side stream copies each full (or final) staging buffer into one of two
  device chunk buffers, and the fold, on the current stream, waits for that
  copy's event, so the next chunk is staged while this one is copied and
  folded;
- a staging buffer is refilled only after its copy's event has completed,
  and a device buffer is overwritten only after the fold that read it has
  completed (the side stream waits for that fold's event);
- the fold sees only the chunk's ``fill`` true rows (a view of the device
  buffer), so a ragged chunk's stale tail never reaches the kernel; the unit
  weights stay on the host (``linalg.gram_stats_weighted``).

On the CPU the fold reads the staging buffer directly.

The fold books the JAX package's series: ``ingest.rows``/``ingest.bytes``
per source chunk taken, ``h2d.bytes{path=stream}`` per copy to the card,
the ``stream.active``/``stream.last_beat`` heartbeat gauges the health
monitor watches, and ``stream.overlap_fraction`` (overlapped dispatches
over chunks) once per fold, which ``FitReport.overlap_fraction`` reads.

With ``label_col`` the source yields ``(x, y)`` or ``(x, y, w)`` tuples
(the supervised fits' labeled partitions): the labels and the instance
weights (1 where none are given) ride in two more f32 columns of the same
staging rows, so one copy takes all three to the card, and the fold is
``fold_fn(carry, x, y, w)`` on column views of the device buffer. Then
``h2d.bytes`` counts x, y and w: (n + 2) · 4 bytes a row. A non-finite
label or weight drops or raises its row as a non-finite feature does, and
each chunk's weights pass ``columnar.validate_weights``.

Not ported yet (``ROADMAP.md``): the autotuner, checkpoint and resume, retry
and fault-injection sites, OOM bisection, the stderr heartbeat, the bounded
wait, and the augmented intercept column.
"""

from __future__ import annotations

import math
import time
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Iterable

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.telemetry import trace_range
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY
from spark_rapids_ml_tpu_torch.utils import columnar
from spark_rapids_ml_tpu_torch.utils.config import (
    STREAM_CHUNK_VAR,
    VALID_NONFINITE_POLICIES,
    get_config,
    wire_dtype,
)


def use_streamed_fit(rows: int, n: int) -> bool:
    """Stream when the resident array (rows × n at the wire dtype) would
    exceed ``TPU_ML_STREAM_FIT_MAX_RESIDENT_BYTES``."""
    return rows * n * wire_dtype().itemsize > get_config().stream_fit_max_resident_bytes


def stream_chunk_rows() -> int:
    """Rows per fold chunk (``TPU_ML_STREAM_CHUNK_ROWS``), bucketed to a
    power of two as in the JAX package."""
    rows = get_config().stream_chunk_rows
    if rows < 1:
        raise ValueError(f"{STREAM_CHUNK_VAR}={rows} must be >= 1")
    return columnar.bucket_rows(rows)


@dataclass
class StreamFold:
    """Result of a streamed fold: the final carry and what the pipeline did.

    ``overlapped`` counts dispatches issued while the previous chunk's fold
    (its copy to the card and its kernels) was still running: the
    counterpart of the JAX loop's ``is_ready()`` test. It is above 0 only
    where the card, not the host, is the slower side. ``copy_overlapped``
    counts chunks whose copy to the card was still in flight when the host
    went on to stage the next one: above 0, the staging is pinned and the
    copy runs beside the host's work. ``max_put_bytes`` is the largest
    single chunk handed to the fold, O(chunk) and never O(rows);
    ``skipped_rows`` counts non-finite rows dropped under the ``skip``
    policy."""

    carry: Any
    rows: int
    chunks: int
    overlapped: int
    max_put_bytes: int
    skipped_rows: int = 0
    copy_overlapped: int = 0


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor over ``a``'s memory, read-only arrays included (nothing
    here writes through it)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*not writable.*")
        return torch.from_numpy(np.ascontiguousarray(a))


def _nonfinite_rows(x: np.ndarray) -> np.ndarray | None:
    """Mask of the rows holding a NaN or an infinity, or None when all are
    finite. A finite sum proves every value finite, so the common case costs
    one multi-threaded read; only a non-finite sum (a bad value, or an
    overflow of large finite ones) pays for the per-row scan."""
    if math.isfinite(_host_tensor(x).sum().item()):
        return None
    bad = ~np.isfinite(x).all(axis=1)
    return bad if bad.any() else None


def _split_item(item: Any) -> tuple[np.ndarray, np.ndarray | None, np.ndarray | None]:
    """(x, y or None, w or None) of one source item: a bare matrix or an
    ``(x,)``/``(x, y)``/``(x, y, w)`` tuple."""
    if not isinstance(item, tuple):
        return np.asarray(item), None, None
    x = np.asarray(item[0])
    y = np.asarray(item[1]) if len(item) > 1 and item[1] is not None else None
    w = np.asarray(item[2]) if len(item) > 2 and item[2] is not None else None
    return x, y, w


def stream_fold(
    source: Iterable[Any],
    fold_fn: Callable,
    *,
    n: int,
    init,
    device: torch.device,
    chunk_rows: int | None = None,
    nonfinite: str | None = None,
    label_col: str | None = None,
) -> StreamFold:
    """Fold ``source``, an iterable of host [rows, n] matrices, chunk by
    chunk through ``fold_fn(carry, x, w) -> carry`` (``linalg.gram_fold_step``),
    which gets the device view of each chunk's true rows and their unit
    weights on the host. With ``label_col`` (any name: an iterable source
    has no columns, it only says that labels flow) the items are
    ``(x, y)``/``(x, y, w)`` tuples and the fold is
    ``fold_fn(carry, x, y, w) -> carry`` (``linear.linear_fold_step``) on
    device views of all three. ``init`` is the zero carry on ``device`` or a
    callable that makes it. Non-finite rows follow ``nonfinite``
    (``TPU_ML_NONFINITE_POLICY``): ``raise`` (default), ``skip`` (drop and
    count them) or ``allow`` (no scan). Spans: ``ingest.chunk``,
    ``fold.dispatch``, ``fold.wait``."""
    chunk_rows = stream_chunk_rows() if chunk_rows is None else chunk_rows
    nonfinite = nonfinite or get_config().nonfinite_policy
    if nonfinite not in VALID_NONFINITE_POLICIES:
        raise ValueError(
            f"nonfinite={nonfinite!r} must be one of {VALID_NONFINITE_POLICIES}"
        )
    cuda = device.type == "cuda"
    labeled = label_col is not None
    carry = init() if callable(init) else init

    # one staging row holds x, then y and w when labels flow; pin_memory
    # raises on a build without CUDA, so only pin for the card
    width = n + 2 if labeled else n
    staging = [
        torch.empty((chunk_rows, width), dtype=torch.float32, pin_memory=cuda)
        for _ in range(2)
    ]
    unit_w = torch.ones((chunk_rows,), dtype=torch.float32, pin_memory=cuda)
    if cuda:
        on_card = [
            torch.empty((chunk_rows, width), dtype=torch.float32, device=device)
            for _ in range(2)
        ]
        copy_stream = torch.cuda.Stream(device)
        fold_stream = torch.cuda.current_stream(device)
    copied: list[Any] = [None, None]  # staging[s] → on_card[s] copy ended
    folded: list[Any] = [None, None]  # the fold that read on_card[s] ended
    slot = fill = 0
    seen = skipped = n_chunks = overlapped = copy_overlapped = max_put = 0

    def dispatch() -> None:
        nonlocal carry, slot, fill, n_chunks, overlapped, copy_overlapped, max_put
        with trace_range("fold.dispatch", device):
            if cuda:
                previous = folded[1 - slot]
                if previous is not None and not previous.query():
                    overlapped += 1
                with torch.cuda.stream(copy_stream):
                    if folded[slot] is not None:
                        copy_stream.wait_event(folded[slot])
                    on_card[slot][:fill].copy_(staging[slot][:fill], non_blocking=True)
                    copied[slot] = copy_stream.record_event()
                REGISTRY.counter_inc("h2d.bytes", fill * width * 4, path="stream")
                fold_stream.wait_event(copied[slot])
                block = on_card[slot][:fill]
            else:
                block = staging[slot][:fill]
            if labeled:
                carry = fold_fn(carry, block[:, :n], block[:, n], block[:, n + 1])
            else:
                carry = fold_fn(carry, block, unit_w[:fill])
            if cuda:
                folded[slot] = fold_stream.record_event()
                if not copied[slot].query():
                    copy_overlapped += 1
        n_chunks += 1
        REGISTRY.gauge_set("stream.last_beat", time.monotonic())
        max_put = max(max_put, fill * width * 4)
        slot, fill = 1 - slot, 0
        if copied[slot] is not None:
            copied[slot].synchronize()  # before this staging buffer refills

    it = iter(source)
    REGISTRY.gauge_set("stream.active", 1)
    REGISTRY.gauge_set("stream.last_beat", time.monotonic())
    try:
        while True:
            with trace_range("ingest.chunk", device):
                try:
                    item = next(it)
                except StopIteration:
                    break
            xc, yc, wc = _split_item(item)
            REGISTRY.counter_inc("ingest.rows", len(xc))
            REGISTRY.counter_inc("ingest.bytes", xc.nbytes)
            if xc.ndim != 2 or xc.shape[1] != n:
                raise ValueError(
                    f"feature dimension changed mid-stream: expected {n}, "
                    f"got {xc.shape[1:]}"
                )
            if labeled and yc is None:
                raise ValueError("label column missing from a streamed chunk")
            if nonfinite != "allow":
                bad = _nonfinite_rows(xc)
                for side in (yc, wc):
                    if side is not None and not np.isfinite(side).all():
                        side_bad = ~np.isfinite(side)
                        bad = side_bad if bad is None else bad | side_bad
                if bad is not None:
                    n_bad = int(bad.sum())
                    if nonfinite == "raise":
                        raise ValueError(
                            f"{n_bad} non-finite input row(s) in a streamed "
                            "chunk; set TPU_ML_NONFINITE_POLICY=skip to drop "
                            "and count them instead"
                        )
                    keep = ~bad
                    xc = xc[keep]
                    yc = yc[keep] if yc is not None else None
                    wc = wc[keep] if wc is not None else None
                    skipped += n_bad
            if wc is not None:
                wc = columnar.validate_weights(wc, len(xc), allow_all_zero=True)
            at = 0
            while at < len(xc):
                take = min(chunk_rows - fill, len(xc) - at)
                rows_at = staging[slot][fill : fill + take]
                rows_at[:, :n].copy_(_host_tensor(xc[at : at + take]))
                if labeled:
                    rows_at[:, n].copy_(_host_tensor(yc[at : at + take]))
                    if wc is None:
                        rows_at[:, n + 1] = 1.0
                    else:
                        rows_at[:, n + 1].copy_(_host_tensor(wc[at : at + take]))
                fill += take
                at += take
                seen += take
                if fill == chunk_rows:
                    dispatch()
        if fill:
            dispatch()  # the ragged tail
        if seen == 0:
            raise ValueError("empty dataset")
        with trace_range("fold.wait", device):
            if cuda:
                folded[1 - slot].synchronize()
    finally:
        # cleared on every exit: the monitor reads an inactive stream as OK
        REGISTRY.gauge_set("stream.active", 0)
        if cuda:
            # no copy may still write a device buffer once it is freed
            copy_stream.synchronize()
    REGISTRY.histogram_record("stream.overlap_fraction", overlapped / n_chunks)
    return StreamFold(
        carry=carry,
        rows=seen,
        chunks=n_chunks,
        overlapped=overlapped,
        max_put_bytes=max_put,
        skipped_rows=skipped,
        copy_overlapped=copy_overlapped,
    )
