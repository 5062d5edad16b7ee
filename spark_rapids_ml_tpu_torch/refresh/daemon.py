"""The refresh daemon: one registry slot's fold → swap → probation loop.

Port of ``spark_rapids_ml_tpu/refresh/daemon.py``, verb for verb:

- **Off the hot path.** ``feed`` only queues; the device work (the
  estimator's ``partial_fit`` folds, the candidate's graph captures, the
  shadow scoring) happens in ``run_once``: on the daemon's thread once
  ``start`` ran, or on the caller's when driven synchronously. With
  ``IncrementalPCA`` at precision ``"high"`` each fold is one launch of the
  port's ``symmetric_gram_moments`` kernel.
- **Restart survival.** ``checkpoint`` writes the estimator's exact
  sufficient statistics (``to_state``) through the atomic
  ``TrainingCheckpointer``, with the held-back shadow sample riding inside
  (``daemon_shadow``); ``resume`` restores them bit for bit, so a daemon
  killed between folds finalizes the candidate it would have. A corrupt or
  truncated checkpoint is skipped by ``latest()``'s walk: the daemon comes
  back with fewer pending rows and the old version keeps serving.
- **Guarded promotion.** The swap is ``ModelRegistry.swap`` (shadow gate,
  the candidate's rungs captured before the publish, an atomic publish),
  then a probation window watched by a fresh ``SloEngine`` seeded at the
  swap (burn 1: one confirmed burn rolls back). A rollback restores the
  resident prior and, with a fleet, carries it to every replica
  (``ServeFleet.swap_models``); a clean probation prunes the prior.

Its fault sites are ``refresh.fold`` (before the fold consumes the batch)
and ``refresh.checkpoint`` (before the write); its counters
``refresh.folds``, ``refresh.rows``, ``refresh.checkpoints``,
``refresh.resumes``, ``refresh.finalizes`` and the ``refresh.lag_seconds``
gauge; one sampled trace chains ``refresh.fold`` → ``refresh.swap`` →
``refresh.probation`` spans per cycle.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.resilience import faults, sites
from spark_rapids_ml_tpu_torch.serving.registry import SwapRefused, get_registry
from spark_rapids_ml_tpu_torch.telemetry import tracectx
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY
from spark_rapids_ml_tpu_torch.telemetry.slo import Objective, SloEngine, parse_objectives
from spark_rapids_ml_tpu_torch.telemetry.timeline import TIMELINE
from spark_rapids_ml_tpu_torch.utils.checkpoint import TrainingCheckpointer
from spark_rapids_ml_tpu_torch.utils.config import (
    DEFAULT_REFRESH_INTERVAL_S,
    DEFAULT_REFRESH_MIN_ROWS,
    DEFAULT_SWAP_PROBATION_S,
    DEFAULT_SWAP_SHADOW_ROWS,
    REFRESH_CHECKPOINT_DIR_VAR,
    REFRESH_INTERVAL_S_VAR,
    REFRESH_MIN_ROWS_VAR,
    SLO_VAR,
    SWAP_PROBATION_S_VAR,
    SWAP_SHADOW_ROWS_VAR,
    lenient_float,
    lenient_int,
)

logger = logging.getLogger("spark_rapids_ml_tpu_torch.refresh")

#: The key the held-back shadow sample rides under inside the estimator's
#: checkpoint (``from_state`` ignores keys it does not know).
_SHADOW_KEY = "daemon_shadow"


@dataclass
class _Probation:
    """One post-swap probation window: its own SLO engine (seeded at the
    swap, so its window covers the post-swap traffic alone) and the
    deadline after which the swap is promoted."""

    engine: SloEngine
    deadline: float
    version: int
    evaluations: int = 0


class RefreshDaemon:
    """Folds data deltas into an incremental estimator and hot-swaps the
    finalized candidate into the serving registry under guard.

    >>> daemon = RefreshDaemon("lr", IncrementalLinearRegression(device="cpu"), device="cpu")
    >>> daemon.fold((x0, y0)); daemon.try_swap()   # the first version
    >>> daemon.fold((x1, y1))                      # a delta arrives
    >>> daemon.try_swap()                          # gate → swap → probation
    >>> daemon.probation_check()                   # promoted or rolled back

    ``registry`` defaults to the process's registry on ``device`` (the card
    unless the caller names the CPU). ``feed``/``run_once``/``start`` wrap
    the same verbs for background work; every verb can be driven
    synchronously.
    """

    def __init__(
        self,
        name: str,
        estimator: Any,
        *,
        registry=None,
        fleet=None,
        checkpoint_dir: str | None = None,
        keep: int = 2,
        min_rows: int | None = None,
        shadow_rows: int | None = None,
        tolerance: float | None = None,
        probation_s: float | None = None,
        probation_burn: int = 1,
        probation_slo: str | None = None,
        device: str | torch.device | None = None,
    ):
        self.name = name
        self.estimator = estimator
        self.registry = registry if registry is not None else get_registry(device)
        self.fleet = fleet
        if checkpoint_dir is None:
            checkpoint_dir = os.environ.get(REFRESH_CHECKPOINT_DIR_VAR, "").strip() or None
        self.checkpointer = (
            TrainingCheckpointer(checkpoint_dir, keep=keep) if checkpoint_dir else None
        )
        self.min_rows = (
            min_rows if min_rows is not None
            else lenient_int(REFRESH_MIN_ROWS_VAR, DEFAULT_REFRESH_MIN_ROWS)
        )
        self.shadow_rows = (
            shadow_rows if shadow_rows is not None
            else lenient_int(SWAP_SHADOW_ROWS_VAR, DEFAULT_SWAP_SHADOW_ROWS)
        )
        self.tolerance = tolerance
        self.probation_s = (
            probation_s if probation_s is not None
            else lenient_float(SWAP_PROBATION_S_VAR, DEFAULT_SWAP_PROBATION_S)
        )
        self.probation_burn = max(1, int(probation_burn))
        self._probation_objectives: tuple[Objective, ...] = parse_objectives(
            probation_slo if probation_slo is not None else os.environ.get(SLO_VAR, "")
        )
        self.refresh_lag_s: float | None = None
        self._rows_pending = 0
        self._last_fold_t: float | None = None
        self._shadow: np.ndarray | None = None
        self._step = 0
        self._probation: _Probation | None = None
        self._queue: list[Any] = []
        self._lock = threading.Lock()
        self._thread: threading.Thread | None = None
        self._stop = threading.Event()
        # the refresh cycle's trace: one sampled chain of refresh.fold →
        # refresh.swap → refresh.probation spans a cycle; _trace_last is the
        # span the next hop parents to (None: an untraced cycle)
        self._trace_last: tracectx.TraceContext | None = None

    def _trace_span(self, name: str, t0: float, **labels) -> None:
        """Record one hop of the cycle's chain: the first hop mints the
        trace (sampling decides) and is the root, later hops its children."""
        parent = self._trace_last
        ctx = parent.child() if parent is not None else tracectx.mint(origin="refresh")
        if ctx is None:
            return
        TIMELINE.record_span(
            name, t0, time.perf_counter(), model=self.name,
            **labels, **tracectx.span_labels(ctx, parent=parent),
        )
        self._trace_last = ctx

    # -- delta intake ---------------------------------------------------------

    @staticmethod
    def _split(batch: Any) -> tuple[np.ndarray, tuple | None]:
        if isinstance(batch, tuple):
            return np.asarray(batch[0]), tuple(batch[1:])
        return np.asarray(batch), None

    def fold(self, batch: Any) -> "RefreshDaemon":
        """Fold one delta batch into the carry. The ``refresh.fold`` gate
        fires first, before the fold consumes anything, so an injected
        failure leaves the fold retryable."""
        t0 = time.perf_counter()
        x, rest = self._split(batch)
        x = faults.inject(sites.REFRESH_FOLD, x)
        self.estimator.partial_fit((x, *rest) if rest is not None else x)
        rows = int(len(x))
        self._rows_pending += rows
        self._last_fold_t = time.monotonic()
        REGISTRY.counter_inc("refresh.folds")
        REGISTRY.counter_inc("refresh.rows", rows)
        self._trace_span("refresh.fold", t0, rows=str(rows))
        if self.shadow_rows > 0:
            held = x[-self.shadow_rows:]
            if self._shadow is None or len(held) >= self.shadow_rows:
                self._shadow = np.array(held, copy=True)
            else:
                self._shadow = np.concatenate([self._shadow, held])[-self.shadow_rows:]
        return self

    @property
    def rows_pending(self) -> int:
        return self._rows_pending

    # -- durable state --------------------------------------------------------

    def checkpoint(self) -> int | None:
        """Write the carry atomically; returns the step written (None
        without a checkpoint directory). The ``refresh.checkpoint`` gate
        fires before the write: an injected failure leaves the previous
        durable step intact."""
        if self.checkpointer is None:
            return None
        faults.inject(sites.REFRESH_CHECKPOINT)
        self._step += 1
        arrays, state = self.estimator.to_state()
        state["rows_pending"] = self._rows_pending
        if self._shadow is not None:
            arrays = {**arrays, _SHADOW_KEY: self._shadow}
        self.checkpointer.save(self._step, arrays, state)
        REGISTRY.counter_inc("refresh.checkpoints")
        return self._step

    def resume(self) -> bool:
        """Restore the newest readable checkpoint, bit for bit. False when
        nothing durable can be read: the daemon then starts empty, and the
        min-rows floor keeps the old version serving."""
        if self.checkpointer is None:
            return False
        latest = self.checkpointer.latest()
        if latest is None:
            return False
        step, arrays, state = latest
        shadow = arrays.pop(_SHADOW_KEY, None)
        try:
            self.estimator.from_state(arrays, state)
        except Exception:  # noqa: BLE001 - a schema drift starts empty, not a crash
            logger.exception("refresh checkpoint step %d unusable; starting empty", step)
            return False
        self._step = step
        self._rows_pending = int(state.get("rows_pending", 0))
        if shadow is not None:
            self._shadow = np.asarray(shadow)
        REGISTRY.counter_inc("refresh.resumes")
        return True

    # -- swap and probation ---------------------------------------------------

    def try_swap(self) -> dict:
        """Finalize a candidate from the pending deltas and hot-swap it:
        shadow gate, atomic publish, the fleet, then probation. Returns a
        status dict; ``refused`` and ``waiting`` leave the old version
        serving untouched."""
        if self._probation is not None:
            return self.probation_check()
        if self._rows_pending < self.min_rows:
            return {
                "status": "waiting",
                "rows_pending": self._rows_pending,
                "min_rows": self.min_rows,
            }
        model = self.estimator.finalize()
        REGISTRY.counter_inc("refresh.finalizes")
        shadow = self._shadow if self.shadow_rows > 0 else None
        t_swap = time.perf_counter()
        try:
            entry = self.registry.swap(
                self.name, model, shadow_sample=shadow, tolerance=self.tolerance
            )
        except KeyError:
            # nothing live yet: the first finalize registers the slot
            entry = self.registry.register(self.name, model)
            self._rows_pending = 0
            self._trace_last = None
            return {"status": "registered", "version": entry.version}
        except SwapRefused as e:
            logger.warning("swap of %s refused: %s", self.name, e)
            self._trace_span("refresh.swap", t_swap, status="refused")
            return {"status": "refused", "reason": str(e)}
        lag = time.monotonic() - self._last_fold_t if self._last_fold_t is not None else 0.0
        self.refresh_lag_s = lag
        REGISTRY.gauge_set("refresh.lag_seconds", lag, model=self.name)
        self._rows_pending = 0
        if self.fleet is not None:
            self.fleet.swap_models({self.name: model})
        self._trace_span("refresh.swap", t_swap, version=str(entry.version))
        self._probation = _Probation(
            engine=SloEngine(
                self._probation_objectives,
                window_s=max(1.0, self.probation_s),
                burn=self.probation_burn,
            ),
            deadline=time.monotonic() + self.probation_s,
            version=entry.version,
        )
        return {"status": "swapped", "version": entry.version, "refresh_lag_s": lag}

    def probation_check(self) -> dict:
        """One probation evaluation: a burn since the swap rolls back to the
        retained prior (fleet-wide); a passed deadline promotes the
        candidate and prunes the prior."""
        p = self._probation
        if p is None:
            return {"status": "idle"}
        t0 = time.perf_counter()
        p.engine.evaluate()
        p.evaluations += 1
        if p.engine.total_breaches() > 0:
            prior = self.registry.rollback(self.name)
            if self.fleet is not None and prior.model is not None:
                self.fleet.swap_models({self.name: prior.model})
            self._probation = None
            # the cycle's last hop; the next fold starts a new trace
            self._trace_span("refresh.probation", t0, status="rolled_back")
            self._trace_last = None
            return {"status": "rolled_back", "version": prior.version, "from_version": p.version}
        if time.monotonic() >= p.deadline:
            self.registry.prune_prior(self.name)
            self._probation = None
            self._trace_span("refresh.probation", t0, status="promoted")
            self._trace_last = None
            return {"status": "promoted", "version": p.version}
        return {"status": "probation", "version": p.version, "evaluations": p.evaluations}

    @property
    def in_probation(self) -> bool:
        return self._probation is not None

    # -- background operation -------------------------------------------------

    def feed(self, batch: Any) -> None:
        """Queue a delta without touching the device (safe on the hot path)."""
        with self._lock:
            self._queue.append(batch)

    def run_once(self) -> dict:
        """One cycle: drain the queued deltas, fold, checkpoint, then advance
        probation or try a swap."""
        with self._lock:
            drained, self._queue = self._queue, []
        for batch in drained:
            self.fold(batch)
        if drained and self.checkpointer is not None:
            self.checkpoint()
        if self._probation is not None:
            return self.probation_check()
        return self.try_swap()

    def start(self, interval_s: float | None = None) -> "RefreshDaemon":
        if self._thread is not None:
            return self
        if interval_s is None:
            interval_s = lenient_float(REFRESH_INTERVAL_S_VAR, DEFAULT_REFRESH_INTERVAL_S)
        self._stop.clear()

        def _loop():
            while not self._stop.wait(interval_s):
                try:
                    self.run_once()
                except Exception:  # noqa: BLE001 - the loop survives a bad cycle
                    logger.exception("refresh cycle failed for %s", self.name)

        self._thread = threading.Thread(
            target=_loop, name=f"tpu-ml-refresh-{self.name}", daemon=True
        )
        self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout)
        self._thread = None
