"""Micro-batcher: coalesce concurrent requests into one device dispatch.

Port of ``spark_rapids_ml_tpu/serving/batcher.py`` (``ServeFuture``,
``MicroBatcher``). One-row scoring at high concurrency wastes the card:
each request would pay its own copies and graph launch for a product that
costs next to nothing at bucket width. The batcher holds a queue per
``(model, bucket)``; the first request of a group opens a coalescing
window, and what arrives for the same key before the batch leaves rides
the same dispatch: the prepared blocks are stacked, padded to the combined
bucket, run through the registry's graph once, and the output rows go back
to their futures. The combined rows are capped at the model's largest warm
bucket (at most ``TPU_ML_SERVE_MAX_BATCH_ROWS``), so coalescing always
lands on a captured rung and never causes a capture.

- A full bucket leaves at once; the window is a ceiling, not a tax.
- A late request joins the forming dispatch up to the moment its block is
  built, riding the pad slack of the chosen bucket
  (``serve.joined_in_flight``).
- The window is adaptive (``TPU_ML_SERVE_ADAPTIVE_WINDOW``): it tracks an
  EWMA of the model's dispatch time, clamped to [25 µs,
  ``TPU_ML_SERVE_MAX_DELAY_US``], so a loaded batcher drains at device
  speed. Every dispatch books the window it used
  (``serve.window_effective_seconds``), every request its queue time
  (``serve.queue_delay_seconds`` and the µs-resolution
  ``serve.queue_delay_us``).

- Hedged dispatch (``_device_dispatch``): a dispatch still running after
  ``max(TPU_ML_SERVE_HEDGE_FLOOR_US, TPU_ML_HEDGE_FACTOR × EWMA)`` is
  resent (``serve.hedges``) through the registry's hedge rung set
  (``hedge_dispatch_padded``: the second card, or a stream and buffers of
  its own on the same card), under the discipline of every hedger in the
  repo (``resilience.supervisor.hedge_threshold_s``): the first result wins
  (``serve.hedge_wins{winner}``) and only the winner's time feeds the EWMA;
  the loser leaves a ``hedge_lost`` dispatch span. No EWMA yet, factor 0,
  or a bucket with no warm hedge rung means no hedge: a resend on the
  primary's own rung would queue behind it.

Input keeps its dtype until ``prepare`` has run; the one conversion to the
device dtype, float32, happens at submission.
"""

from __future__ import annotations

import concurrent.futures
import logging
import os
import threading
import time

import numpy as np

from spark_rapids_ml_tpu_torch.resilience import supervisor
from spark_rapids_ml_tpu_torch.serving import buckets, hbm
from spark_rapids_ml_tpu_torch.serving.registry import (
    X_DTYPE,
    ModelRegistry,
    get_registry,
    validate_request,
)
from spark_rapids_ml_tpu_torch.telemetry import tracectx
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY
from spark_rapids_ml_tpu_torch.telemetry.timeline import TIMELINE
from spark_rapids_ml_tpu_torch.utils.config import (
    DEFAULT_SERVE_ADAPTIVE_WINDOW,
    DEFAULT_SERVE_HEDGE_FLOOR_US,
    DEFAULT_SERVE_MAX_DELAY_US,
    SERVE_ADAPTIVE_WINDOW_VAR,
    SERVE_HEDGE_FLOOR_US_VAR,
    SERVE_MAX_DELAY_US_VAR,
    lenient_float,
)

logger = logging.getLogger("spark_rapids_ml_tpu_torch.serving")

#: Floor of the adaptive window: below it, shrinking only buys scheduler
#: churn.
_WINDOW_FLOOR_S = 25e-6


def coalesce_window_s() -> float:
    """The coalescing window's ceiling (``TPU_ML_SERVE_MAX_DELAY_US``)."""
    return max(0.0, lenient_float(SERVE_MAX_DELAY_US_VAR, DEFAULT_SERVE_MAX_DELAY_US)) / 1e6


def serve_hedge_floor_s() -> float:
    """The serve-scale hedge floor (``TPU_ML_SERVE_HEDGE_FLOOR_US``) in
    seconds: the stage-scale ``TPU_ML_HEDGE_FLOOR_S`` (1 s) is three orders
    of magnitude above a serve objective, so serving carries its own."""
    return max(0.0, lenient_float(SERVE_HEDGE_FLOOR_US_VAR, DEFAULT_SERVE_HEDGE_FLOOR_US)) / 1e6


def adaptive_window_enabled() -> bool:
    raw = os.environ.get(SERVE_ADAPTIVE_WINDOW_VAR, DEFAULT_SERVE_ADAPTIVE_WINDOW)
    return raw.strip().lower() not in ("0", "false", "off", "")


class ServeFuture:
    """The per-request rendezvous: the batcher's thread fills it, the
    serving thread blocks on ``result``."""

    def __init__(self):
        self._done = threading.Event()
        self._result: np.ndarray | None = None
        self._error: BaseException | None = None

    def set_result(self, value: np.ndarray) -> None:
        self._result = value
        self._done.set()

    def set_error(self, err: BaseException) -> None:
        self._error = err
        self._done.set()

    def result(self, timeout: float | None = None) -> np.ndarray:
        if not self._done.wait(timeout):
            raise TimeoutError("serve dispatch did not complete in time")
        if self._error is not None:
            raise self._error
        return self._result


class _Pending:
    __slots__ = ("mat", "rows", "future", "t_submit", "trace")

    def __init__(self, mat: np.ndarray, trace=None):
        self.mat = mat
        self.rows = mat.shape[0]
        self.future = ServeFuture()
        self.t_submit = time.perf_counter()
        self.trace = trace  # the request's TraceContext, or None


class MicroBatcher:
    """Bounded continuous-batching queue in front of the model registry."""

    def __init__(
        self,
        registry: ModelRegistry | None = None,
        *,
        max_delay_s: float | None = None,
        adaptive: bool | None = None,
    ):
        self.registry = registry if registry is not None else get_registry()
        self.max_delay_s = max_delay_s if max_delay_s is not None else coalesce_window_s()
        self.adaptive = adaptive if adaptive is not None else adaptive_window_enabled()
        self._groups: dict[tuple[str, int], list[_Pending]] = {}
        self._cond = threading.Condition()
        self._device_ewma: dict[str, float] = {}
        self._thread: threading.Thread | None = None
        self._stopping = False
        # the two-worker pool of hedged dispatch (primary and one resend),
        # made at the first hedged dispatch and joined in stop()
        self._hedge_pool: concurrent.futures.ThreadPoolExecutor | None = None

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "MicroBatcher":
        with self._cond:
            if self._thread is None or not self._thread.is_alive():
                self._stopping = False
                self._thread = threading.Thread(
                    target=self._loop, name="tpu-ml-serve-batcher", daemon=True
                )
                self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        with self._cond:
            self._stopping = True
            drained = [p for g in self._groups.values() for p in g]
            self._groups.clear()
            self._cond.notify_all()
        for p in drained:
            p.future.set_error(RuntimeError("micro-batcher stopped"))
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                logger.warning("micro-batcher worker did not join within %.1fs", timeout)
            self._thread = None
        pool, self._hedge_pool = self._hedge_pool, None
        if pool is not None:
            # deterministic teardown: the hedge workers are joined, not left
            pool.shutdown(wait=True)

    # -- submission -----------------------------------------------------------

    def submit(self, model: str, x, trace=None) -> ServeFuture:
        """Queue one request; returns its future. Validation and ``prepare``
        run on the caller's thread; the dispatch on the batcher's.
        ``trace`` is the request's ``TraceContext`` (default: the ambient
        one); a traced request gets a ``serve.queue`` span and rides the
        dispatch span's links."""
        entry = self.registry.get(model)
        hbm.get_fleet().check_admission(model)
        mat = validate_request(x, entry.n_features, model)
        prepared = entry.prepare(mat)
        if prepared.dtype != X_DTYPE:
            prepared = prepared.astype(X_DTYPE)
        bucket = buckets.serve_bucket(prepared.shape[0])  # admission check
        if trace is None:
            trace = tracectx.current_trace()
        pending = _Pending(prepared, trace)
        with self._cond:
            if self._stopping:
                raise RuntimeError("micro-batcher is stopped")
            self._groups.setdefault((model, bucket), []).append(pending)
            self._cond.notify_all()
        return pending.future

    # -- worker ---------------------------------------------------------------

    def _coalesce_cap(self, model: str) -> int:
        """Largest row count of one coalesced dispatch for a model: its
        largest warm bucket, never above the ladder cap (two warm-sized
        requests must not combine into a bucket that was never captured)."""
        cap = buckets.max_batch_rows()
        try:
            warm = self.registry.get(model).warm_buckets
        except KeyError:
            return cap
        return min(cap, max(warm)) if warm else cap

    def effective_window_s(self, model: str) -> float:
        """The window in force for a model: the ceiling, or (adaptive) the
        EWMA of its dispatch time clamped to [floor, ceiling]."""
        if not self.adaptive:
            return self.max_delay_s
        ewma = self._device_ewma.get(model)
        if ewma is None:
            return self.max_delay_s
        return min(self.max_delay_s, max(_WINDOW_FLOOR_S, ewma))

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._stopping and not self._groups:
                    self._cond.wait()
                if self._stopping:
                    return
                now = time.perf_counter()
                key, deadline, window = min(
                    (
                        (k, g[0].t_submit + w, w)
                        for k, g in self._groups.items()
                        for w in (self.effective_window_s(k[0]),)
                    ),
                    key=lambda kv: kv[1],
                )
                cap = self._coalesce_cap(key[0])
                group = self._groups[key]
                full = sum(p.rows for p in group) >= cap
                if now < deadline and not full:
                    # hold the group open until its window elapses (a full
                    # bucket leaves at once: submit's notify wakes this wait)
                    self._cond.wait(deadline - now)
                    continue
                # take requests up to the cap; the rest opens the next window
                taken, total = [], 0
                while group and total + group[0].rows <= cap:
                    total += group[0].rows
                    taken.append(group.pop(0))
                if not taken:
                    # one request larger than the warm set: dispatched alone
                    taken.append(group.pop(0))
                if not group:
                    del self._groups[key]
            self._dispatch(key, taken, window)

    def _late_join(self, key: tuple[str, int], taken: list[_Pending], bucket: int) -> int:
        """Pull requests that arrived after this batch was taken into it, as
        far as the chosen bucket's pad slack holds them."""
        total = sum(p.rows for p in taken)
        joined = 0
        with self._cond:
            group = self._groups.get(key)
            while group and total + group[0].rows <= bucket:
                p = group.pop(0)
                taken.append(p)
                total += p.rows
                joined += 1
            if group is not None and not group:
                del self._groups[key]
        return joined

    def _ensure_hedge_pool(self) -> concurrent.futures.ThreadPoolExecutor:
        if self._hedge_pool is None:
            self._hedge_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=2, thread_name_prefix="tpu-ml-serve-hedge"
            )
        return self._hedge_pool

    def _device_dispatch(self, entry, model: str, padded: np.ndarray, bucket: int,
                         links: str = "") -> tuple[np.ndarray, float]:
        """One dispatch under the hedging discipline; returns the raw output
        and the winner's seconds. Past the threshold (see the module note)
        the block is resent through the hedge rung set; the first result
        fulfills the batch, and the loser's time is dropped."""
        threshold = supervisor.hedge_threshold_s(
            self._device_ewma.get(model, 0.0), floor_s=serve_hedge_floor_s()
        )

        def timed(dispatch) -> tuple[np.ndarray, float]:
            t = time.perf_counter()
            out = dispatch(entry, padded, bucket)
            return out, time.perf_counter() - t

        if threshold is None or bucket not in entry.hedge_buckets:
            return timed(self.registry.dispatch_padded)
        pool = self._ensure_hedge_pool()
        t_primary = time.perf_counter()
        primary = pool.submit(timed, self.registry.dispatch_padded)
        try:
            return primary.result(timeout=threshold)
        except concurrent.futures.TimeoutError:
            pass
        REGISTRY.counter_inc("serve.hedges", model=model)
        t_hedge = time.perf_counter()
        hedge = pool.submit(timed, self.registry.hedge_dispatch_padded)
        done, _ = concurrent.futures.wait(
            {primary, hedge}, return_when=concurrent.futures.FIRST_COMPLETED
        )
        winner = primary if primary in done else hedge
        raw, dev_s = winner.result()
        REGISTRY.counter_inc(
            "serve.hedge_wins", model=model, winner="primary" if winner is primary else "hedge"
        )
        if links:
            # the loser's time is dropped, but its trace edge stays: a
            # hedge_lost dispatch span closed at the decision, linked to the
            # same requests
            TIMELINE.record_span(
                "serve.dispatch", t_hedge if winner is primary else t_primary,
                time.perf_counter(), model=model, links=links, hedge_lost="1",
            )
        return raw, dev_s

    def _dispatch(self, key: tuple[str, int], taken: list[_Pending], window_s: float) -> None:
        model = key[0]
        t0 = time.perf_counter()
        try:
            entry = self.registry.get(model)
            bucket = buckets.serve_bucket(sum(p.rows for p in taken))
            self._late_join(key, taken, bucket)
            # one dispatch fans in N request spans: it belongs to no single
            # trace and links to every traced rider
            links = " ".join(
                tracectx.link_token(p.trace) for p in taken if p.trace is not None
            )
            for p in taken:
                delay_s = t0 - p.t_submit
                exemplar = p.trace.trace_hex if p.trace is not None else ""
                REGISTRY.histogram_record(
                    "serve.queue_delay_seconds", delay_s, exemplar=exemplar, model=model
                )
                REGISTRY.histogram_record(
                    "serve.queue_delay_us", delay_s * 1e6, exemplar=exemplar, model=model
                )
                if p.trace is not None:
                    TIMELINE.record_span(
                        "serve.queue", p.t_submit, t0, model=model,
                        **tracectx.span_labels(p.trace.child(), parent=p.trace),
                    )
            REGISTRY.histogram_record("serve.window_effective_seconds", window_s, model=model)
            riders = len(taken) - 1
            if riders > 0:
                REGISTRY.counter_inc("serve.joined_in_flight", riders, model=model)
            total = sum(p.rows for p in taken)
            combined = (
                taken[0].mat if len(taken) == 1
                else np.concatenate([p.mat for p in taken], axis=0)
            )
            REGISTRY.counter_inc("serve.bucket_hits", model=model, bucket=bucket)
            padded, _ = buckets.pad_to_bucket(combined, bucket)
            t_disp = time.perf_counter()
            raw, dev_s = self._device_dispatch(entry, model, padded, bucket, links=links)
            if links:
                TIMELINE.record_span(
                    "serve.dispatch", t_disp, time.perf_counter(),
                    model=model, bucket=str(bucket), links=links,
                )
            prev = self._device_ewma.get(model)
            self._device_ewma[model] = dev_s if prev is None else 0.5 * prev + 0.5 * dev_s
            REGISTRY.counter_inc("serve.batches", model=model)
            REGISTRY.histogram_record("serve.batch_rows", total, model=model)
            REGISTRY.counter_inc("serve.rows", total, model=model)
            offset = 0
            for p in taken:
                p.future.set_result(entry.finalize(raw[offset:offset + p.rows], p.rows))
                offset += p.rows
        except Exception as e:  # noqa: BLE001 - fan the error out; the worker survives
            logger.exception("micro-batch dispatch failed for %s", model)
            for p in taken:
                p.future.set_error(e)
