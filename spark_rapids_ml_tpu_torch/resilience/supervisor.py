"""Worker-slot supervision: leases, bounded respawn, a per-slot circuit
breaker.

Port of ``spark_rapids_ml_tpu/resilience/supervisor.py``, call for call:

- every worker holds a numbered slot and a lease (spawn time, tasks done,
  the last success's time) that the health rollup shows;
- a crashed slot respawns after an exponential backoff
  (``TPU_ML_WORKER_RESPAWN_BACKOFF_S`` doubled per consecutive crash,
  capped at 2 s);
- ``TPU_ML_WORKER_BREAKER_THRESHOLD`` consecutive crashes open the slot's
  breaker: it is quarantined (``worker.quarantine``) and the stage goes on
  with the others;
- when every slot is quarantined, the next stage half-opens the longest
  quarantined one for one probe respawn.

It publishes the ``worker.slots``/``worker.quarantined`` gauges and keeps a
registry of live supervisors, whose merged summary (``active_summary``) the
health monitor's rollup shows as ``scheduler``. Its consumer is the local
Spark session (``localspark/session.py``); ``hedge_config`` and
``hedge_threshold_s`` serve ``parallel/executor.py`` too.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Callable

from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY
from spark_rapids_ml_tpu_torch.telemetry.timeline import TIMELINE
from spark_rapids_ml_tpu_torch.utils.config import (
    DEFAULT_HEDGE_FACTOR,
    DEFAULT_HEDGE_FLOOR_S,
    DEFAULT_WORKER_BREAKER_THRESHOLD,
    DEFAULT_WORKER_RESPAWN_BACKOFF_S,
    HEDGE_FACTOR_VAR,
    HEDGE_FLOOR_S_VAR,
    WORKER_BREAKER_THRESHOLD_VAR,
    WORKER_RESPAWN_BACKOFF_S_VAR,
    WORKER_SLOT_VAR,
    lenient_float,
    lenient_int,
)

logger = logging.getLogger("spark_rapids_ml_tpu_torch")

# backoff is bounded: a quarantine decision, not a sleep, is how a
# crash-looping slot stops consuming the stage's wall clock
_MAX_BACKOFF_S = 2.0


def hedge_config() -> tuple[float, float]:
    """(factor, floor_s) for straggler hedging; factor 0 disables."""
    return (
        max(0.0, lenient_float(HEDGE_FACTOR_VAR, DEFAULT_HEDGE_FACTOR)),
        max(0.0, lenient_float(HEDGE_FLOOR_S_VAR, DEFAULT_HEDGE_FLOOR_S)),
    )


def hedge_threshold_s(observed_s: float, *, floor_s: float | None = None):
    """Seconds a dispatch may run before a hedge is issued, or ``None``
    when hedging is off.

    One discipline for every hedger in the repo: the threshold is
    ``max(floor, TPU_ML_HEDGE_FACTOR x observed)``, where ``observed`` is
    the caller's running estimate of a healthy attempt (partition EWMA for
    localspark, device-dispatch EWMA for the serve batcher). ``floor_s``
    defaults to the stage-scale ``TPU_ML_HEDGE_FLOOR_S``; latency-scale
    callers pass their own floor. No estimate yet (``observed <= 0``)
    or ``TPU_ML_HEDGE_FACTOR=0`` means no hedge — never hedge blind.
    """
    factor, default_floor = hedge_config()
    if factor <= 0.0 or observed_s <= 0.0:
        return None
    return max(default_floor if floor_s is None else floor_s,
               factor * observed_s)


@dataclass
class SlotLease:
    """The supervised state of one worker slot."""

    slot: int
    worker: object | None = None          # live _Worker (or None)
    spawned_at: float = 0.0               # monotonic spawn stamp
    tasks_done: int = 0
    last_trailer: float = 0.0             # monotonic last-success stamp
    consecutive_crashes: int = 0
    total_crashes: int = 0
    respawns: int = 0
    quarantined: bool = False
    quarantined_at: float = 0.0
    next_spawn_at: float = 0.0            # backoff gate (monotonic)
    last_error: str = ""

    def summary(self, now: float) -> dict:
        return {
            "live": self.worker is not None,
            "age_s": round(now - self.spawned_at, 3) if self.worker else None,
            "tasks_done": self.tasks_done,
            "last_trailer_age_s": (
                round(now - self.last_trailer, 3) if self.last_trailer else None
            ),
            "consecutive_crashes": self.consecutive_crashes,
            "total_crashes": self.total_crashes,
            "respawns": self.respawns,
            "quarantined": self.quarantined,
            "last_error": self.last_error[:160],
        }


class WorkerSupervisor:
    """Supervise ``num_slots`` worker processes built by ``spawn_fn``.

    ``spawn_fn(extra_env)`` must return an object with ``dead``/``proc``/
    ``close()`` (the session's ``_Worker``); ``extra_env`` carries the
    slot stamp (``TPU_ML_WORKER_SLOT``) so diagnostics — and slot-targeted
    chaos plans — can tell slots apart.
    """

    def __init__(
        self,
        spawn_fn: Callable[[dict], object],
        num_slots: int,
        *,
        breaker_threshold: int | None = None,
        backoff_s: float | None = None,
    ):
        if num_slots < 1:
            raise ValueError("num_slots must be >= 1")
        self._spawn_fn = spawn_fn
        self.num_slots = num_slots
        self.breaker_threshold = max(
            1,
            lenient_int(WORKER_BREAKER_THRESHOLD_VAR, DEFAULT_WORKER_BREAKER_THRESHOLD)
            if breaker_threshold is None
            else breaker_threshold,
        )
        self.backoff_s = max(
            0.0,
            lenient_float(WORKER_RESPAWN_BACKOFF_S_VAR, DEFAULT_WORKER_RESPAWN_BACKOFF_S)
            if backoff_s is None
            else backoff_s,
        )
        self._lock = threading.Lock()
        self._slots = [SlotLease(slot=i) for i in range(num_slots)]
        self._closed = False
        REGISTRY.gauge_set("worker.slots", num_slots)
        REGISTRY.gauge_set("worker.quarantined", 0)
        _register(self)

    # -- stage boundary ------------------------------------------------------

    def begin_stage(self) -> None:
        """Called at every stage start. If the breaker is open on EVERY
        slot, half-open the longest-quarantined one: a single probe respawn
        gets one task to prove the condition cleared (its breaker re-opens
        on the very next crash)."""
        with self._lock:
            if self._closed or not all(s.quarantined for s in self._slots):
                return
            probe = min(self._slots, key=lambda s: s.quarantined_at)
            probe.quarantined = False
            probe.consecutive_crashes = self.breaker_threshold - 1
            probe.next_spawn_at = 0.0
        logger.warning(
            "all %d worker slot(s) quarantined; half-opening slot %d for a "
            "probe respawn", self.num_slots, probe.slot,
        )
        self._publish_quarantine_gauge()

    # -- checkout / report ---------------------------------------------------

    def checkout(self, slot: int):
        """The live worker for ``slot``, respawning (after any backoff due)
        when needed. Returns ``None`` when the slot is quarantined."""
        with self._lock:
            lease = self._slots[slot]
            if self._closed or lease.quarantined:
                return None
            w = lease.worker
            if w is not None and not w.dead and w.proc.poll() is None:
                return w
            # the previous incumbent (if any) is gone; pay the backoff
            # OUTSIDE the lock, then spawn
            wait = max(0.0, lease.next_spawn_at - time.monotonic())
            stale, lease.worker = lease.worker, None
        if stale is not None:
            stale.close()
        if wait:
            # not a retry loop: this paces the respawn of an already-dead
            # worker — there is no callable to re-attempt under the shared
            # policy, and the breaker (not a deadline) bounds the spend
            time.sleep(min(wait, _MAX_BACKOFF_S))
        worker = self._spawn_fn({WORKER_SLOT_VAR: str(slot)})
        with self._lock:
            lease = self._slots[slot]
            if lease.quarantined or self._closed:  # raced with a quarantine
                pass
            elif lease.worker is None:
                first = lease.spawned_at == 0.0
                lease.worker = worker
                lease.spawned_at = time.monotonic()
                if not first:
                    lease.respawns += 1
                    REGISTRY.counter_inc("worker.respawn", slot=str(slot))
                return worker
            else:
                worker, lease.worker = lease.worker, worker  # lost a race
                return worker
        worker.close()
        return None

    def report_success(self, slot: int) -> None:
        """A task completed on ``slot``: refresh the lease, close the
        breaker's crash streak."""
        with self._lock:
            lease = self._slots[slot]
            lease.tasks_done += 1
            lease.last_trailer = time.monotonic()
            lease.consecutive_crashes = 0
            lease.next_spawn_at = 0.0

    def report_crash(self, slot: int, error: BaseException | str = "") -> bool:
        """A worker on ``slot`` died. Close it, advance the breaker, arm
        the respawn backoff. Returns True when the slot is now quarantined."""
        with self._lock:
            lease = self._slots[slot]
            stale, lease.worker = lease.worker, None
            lease.consecutive_crashes += 1
            lease.total_crashes += 1
            lease.last_error = str(error)
            crashes = lease.consecutive_crashes
            opened = (not lease.quarantined
                      and crashes >= self.breaker_threshold)
            if opened:
                lease.quarantined = True
                lease.quarantined_at = time.monotonic()
            else:
                lease.next_spawn_at = time.monotonic() + min(
                    _MAX_BACKOFF_S,
                    self.backoff_s * (2.0 ** (crashes - 1)),
                )
        if stale is not None:
            stale.close()
        if opened:
            REGISTRY.counter_inc("worker.quarantine", slot=str(slot))
            TIMELINE.record_instant(
                "worker.quarantine", slot=str(slot), crashes=crashes,
            )
            logger.warning(
                "DEGRADED: worker slot %d quarantined after %d consecutive "
                "crash(es) (circuit breaker open; last error: %s)",
                slot, crashes, str(error)[:200],
            )
            self._publish_quarantine_gauge()
        return opened

    # -- introspection -------------------------------------------------------

    def live_workers(self) -> list:
        """Live worker objects, slot order (the session's ``_workers``)."""
        with self._lock:
            return [
                s.worker for s in self._slots
                if s.worker is not None and not s.worker.dead
            ]

    def available_slots(self) -> list[int]:
        with self._lock:
            return [s.slot for s in self._slots if not s.quarantined]

    def quarantined_slots(self) -> list[int]:
        with self._lock:
            return [s.slot for s in self._slots if s.quarantined]

    def summary(self) -> dict:
        """Lease/quarantine state for ``/healthz``."""
        now = time.monotonic()
        with self._lock:
            leases = {str(s.slot): s.summary(now) for s in self._slots}
            quarantined = [s.slot for s in self._slots if s.quarantined]
        return {
            "slots": self.num_slots,
            "quarantined": quarantined,
            "breaker_threshold": self.breaker_threshold,
            "leases": leases,
        }

    def _publish_quarantine_gauge(self) -> None:
        with self._lock:
            n = sum(1 for s in self._slots if s.quarantined)
        REGISTRY.gauge_set("worker.quarantined", n)

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            workers = [s.worker for s in self._slots if s.worker is not None]
            for s in self._slots:
                s.worker = None
        for w in workers:
            w.close()
        _unregister(self)
        # republish the gauges from the survivors: a quarantine stamped by
        # a now-closed session must not haunt the health monitor forever
        with _REG_LOCK:
            sups = list(_ACTIVE)
        REGISTRY.gauge_set("worker.slots", sum(s.num_slots for s in sups))
        REGISTRY.gauge_set(
            "worker.quarantined",
            sum(len(s.quarantined_slots()) for s in sups),
        )


# -- module registry (what /healthz stamps) ---------------------------------

_REG_LOCK = threading.Lock()
_ACTIVE: list[WorkerSupervisor] = []


def _register(sup: WorkerSupervisor) -> None:
    with _REG_LOCK:
        _ACTIVE.append(sup)


def _unregister(sup: WorkerSupervisor) -> None:
    with _REG_LOCK:
        try:
            _ACTIVE.remove(sup)
        except ValueError:
            pass


def active_summary() -> dict:
    """Merged lease/quarantine state of every live supervisor (the
    ``scheduler`` section of the ``/healthz`` payload); ``{}`` when no
    session is supervising workers."""
    with _REG_LOCK:
        sups = list(_ACTIVE)
    if not sups:
        return {}
    if len(sups) == 1:
        return sups[0].summary()
    return {"supervisors": [s.summary() for s in sups]}
