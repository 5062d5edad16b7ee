"""Live component health: a background monitor, admission control for fits.

Port of ``spark_rapids_ml_tpu/telemetry/health.py``. A daemon
``HealthMonitor`` thread polls the components every
``TPU_ML_HEALTH_INTERVAL_S`` seconds into OK (0) → DEGRADED (1) →
FAILING (2):

- ``device``: the card's memory in use over its size, from
  ``telemetry.compilemon.sample_device_memory`` (``torch.cuda.memory_stats``
  and ``mem_get_info``); DEGRADED above ``TPU_ML_HEALTH_HBM_WATERMARK``;
- ``transport``: a deadline-bounded liveness probe: ``inline`` (the
  default) on a throwaway thread, ``subprocess``
  (``utils/devicepolicy.py::probe_transport_subprocess``, a child that
  touches the card, repeatable when a probe wedges) or ``off``;
  consecutive failures escalate to FAILING after
  ``TPU_ML_HEALTH_FAILING_AFTER`` polls. The inline probe first passes the
  ``device.init`` fault gate, so a plan can fail or wedge it;
- ``stream``: the streamed fold's heartbeat (``stream.active``,
  ``stream.last_beat``, booked by ``spark/ingest.py::stream_fold``), stale
  after ``TPU_ML_HEALTH_STALE_S``;
- ``workers``: the local Spark engine's workers, DEGRADED when the newest
  task telemetry trailer (``worker.last_trailer``, booked by
  ``localspark/session.py`` as each task's trailer merges) is older than
  ``TPU_ML_HEALTH_STALE_S``;
- ``resilience``: DEGRADED for a poll window with at least
  ``TPU_ML_HEALTH_RETRY_STORM`` retries (``retry.attempts``) or a fault
  injected (``fault.injected``);
- ``scheduler``: the worker supervisors' slots (``worker.slots``,
  ``worker.quarantined``, booked by ``resilience/supervisor.py``):
  DEGRADED while some slot is quarantined, FAILING when all are.

The rollup also carries ``scheduler``'s detail, the live supervisors'
leases and quarantines (``resilience/supervisor.py::active_summary``),
when there are any. ``resilience`` also reads ``degraded.cpu_fallback``,
which a Spark estimator's mesh-local fit counts when it falls back to the
one-device fold (``spark/estimators.py::_mesh_or_fallback``).

**No probe creates a CUDA context in this process.** Every device read
goes through ``sample_device_memory``, which returns nothing until CUDA is
initialized by the program itself; the ``subprocess`` probe touches the
card in its child only.

**Admission control.** ``admission_check`` consults the rollup before a
fit (``telemetry/report.py::begin_fit``): under
``TPU_ML_ADMISSION_POLICY=refuse`` (default) a fit is refused while a
component is FAILING. Under ``degrade`` the fit runs inside a degrade
window, which only the Spark estimators read, as in the JAX package
(``spark/estimators.py::_mesh_or_fallback`` folds a mesh-local fit on the
estimator's one device instead of the mesh and counts
``degraded.cpu_fallback``); ``begin_fit`` refuses any other degraded fit
whose device is not the CPU rather than run it unchanged on the card.

State changes set ``health.state{component}``, count
``health.transitions{component,to}`` and record a ``health.transition``
instant. Each poll also runs the SLO engine (``telemetry/slo.py``). The
process-wide monitor (``start_monitor``/``get_monitor``/``stop_monitor``)
backs ``/healthz`` and the report's ``health`` field.
"""

from __future__ import annotations

import logging
import os
import threading
import time

from spark_rapids_ml_tpu_torch.resilience import faults, sites, supervisor
from spark_rapids_ml_tpu_torch.telemetry import compilemon
from spark_rapids_ml_tpu_torch.telemetry import slo as slo_mod
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY
from spark_rapids_ml_tpu_torch.telemetry.timeline import TIMELINE
from spark_rapids_ml_tpu_torch.utils.config import (
    ADMISSION_POLICY_VAR,
    DEFAULT_ADMISSION_POLICY,
    DEFAULT_HBM_WATERMARK,
    DEFAULT_HEALTH_FAILING_AFTER,
    DEFAULT_HEALTH_INTERVAL_S,
    DEFAULT_HEALTH_PROBE,
    DEFAULT_HEALTH_PROBE_TIMEOUT_S,
    DEFAULT_HEALTH_RETRY_STORM,
    DEFAULT_HEALTH_STALE_S,
    HEALTH_FAILING_AFTER_VAR,
    HEALTH_HBM_WATERMARK_VAR,
    HEALTH_INTERVAL_S_VAR,
    HEALTH_PROBE_TIMEOUT_S_VAR,
    HEALTH_PROBE_VAR,
    HEALTH_RETRY_STORM_VAR,
    HEALTH_STALE_S_VAR,
    lenient_float,
    lenient_int,
)

logger = logging.getLogger("spark_rapids_ml_tpu_torch.health")

OK, DEGRADED, FAILING = 0, 1, 2
STATE_NAMES = {OK: "OK", DEGRADED: "DEGRADED", FAILING: "FAILING"}

COMPONENTS = ("device", "transport", "stream", "workers", "resilience", "scheduler")

PROBE_MODES = ("off", "inline", "subprocess")

ADMISSION_POLICIES = ("off", "refuse", "degrade")


class AdmissionRefused(RuntimeError):
    """A fit refused by admission control: a component is FAILING under
    ``TPU_ML_ADMISSION_POLICY=refuse``, or the policy is ``degrade`` and
    the fit's device is not the CPU (the port has no degraded path for a
    fit on the card but a Spark estimator's mesh-local fit)."""


def _device_init_gate() -> None:
    """The probe's ``device.init`` fault site."""
    faults.inject(sites.DEVICE_INIT)


def default_inline_probe() -> tuple[bool, str]:
    """The in-process liveness check: the device-init seam, then a device
    memory sample, which reads an initialized card and never initializes
    one."""
    _device_init_gate()
    stats = compilemon.sample_device_memory()
    return True, f"sampled {len(stats)} device(s)"


class HealthMonitor:
    """Periodic component health polling with an OK/DEGRADED/FAILING
    rollup. Construction reads the ``TPU_ML_HEALTH_*`` knobs; each is also
    an argument. ``probe_fn`` replaces the inline probe's body (still
    deadline-bounded). Not started until ``start``."""

    def __init__(
        self,
        *,
        interval_s: float | None = None,
        probe_mode: str | None = None,
        probe_timeout_s: float | None = None,
        hbm_watermark: float | None = None,
        stale_s: float | None = None,
        failing_after: int | None = None,
        retry_storm: int | None = None,
        probe_fn=None,
        slo_engine: slo_mod.SloEngine | None = None,
    ):
        def knob(value, read):
            return read() if value is None else value

        self.interval_s = knob(
            interval_s, lambda: lenient_float(HEALTH_INTERVAL_S_VAR, DEFAULT_HEALTH_INTERVAL_S)
        )
        mode = knob(probe_mode, lambda: os.environ.get(HEALTH_PROBE_VAR) or DEFAULT_HEALTH_PROBE)
        if mode not in PROBE_MODES:
            raise ValueError(
                f"{HEALTH_PROBE_VAR}={mode!r} must be one of {PROBE_MODES}"
            )
        self.probe_mode = mode
        self.probe_timeout_s = knob(
            probe_timeout_s,
            lambda: lenient_float(HEALTH_PROBE_TIMEOUT_S_VAR, DEFAULT_HEALTH_PROBE_TIMEOUT_S),
        )
        self.hbm_watermark = knob(
            hbm_watermark, lambda: lenient_float(HEALTH_HBM_WATERMARK_VAR, DEFAULT_HBM_WATERMARK)
        )
        self.stale_s = knob(
            stale_s, lambda: lenient_float(HEALTH_STALE_S_VAR, DEFAULT_HEALTH_STALE_S)
        )
        self.failing_after = max(1, knob(
            failing_after,
            lambda: lenient_int(HEALTH_FAILING_AFTER_VAR, DEFAULT_HEALTH_FAILING_AFTER),
        ))
        self.retry_storm = max(1, knob(
            retry_storm,
            lambda: lenient_int(HEALTH_RETRY_STORM_VAR, DEFAULT_HEALTH_RETRY_STORM),
        ))
        self._probe_fn = probe_fn
        self.slo = slo_engine if slo_engine is not None else slo_mod.SloEngine()

        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._probe_thread: threading.Thread | None = None
        self._states = {c: OK for c in COMPONENTS}
        self._details = {c: "" for c in COMPONENTS}
        self._streaks = {c: 0 for c in COMPONENTS}
        self._polls = 0
        self._transitions = 0
        self._prev_snap = None
        self._last_slo: dict = {}

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "HealthMonitor":
        """Start the daemon poll thread (idempotent)."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="tpu-ml-health-monitor", daemon=True
            )
            self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        """Stop the poll loop and join it and any straggling probe thread
        within ``timeout``."""
        self._stop.set()
        with self._lock:
            t, self._thread = self._thread, None
            pt, self._probe_thread = self._probe_thread, None
        deadline = time.monotonic() + timeout
        for thread in (t, pt):
            if thread is not None:
                thread.join(max(0.0, deadline - time.monotonic()))

    @property
    def running(self) -> bool:
        with self._lock:
            return self._thread is not None and self._thread.is_alive()

    @property
    def polls(self) -> int:
        with self._lock:
            return self._polls

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 - the monitor outlives a bad poll
                logger.exception("health poll failed")
            self._stop.wait(self.interval_s)

    # -- one poll ------------------------------------------------------------

    def poll_once(self) -> dict:
        """Evaluate every component once, publish gauges and transitions,
        run the SLO engine; returns the rollup."""
        now = time.monotonic()
        snap = REGISTRY.snapshot()
        self._eval_device()
        self._eval_transport()
        self._eval_stream(snap, now)
        self._eval_workers(snap, now)
        self._eval_resilience(snap)
        self._eval_scheduler(snap)
        last_slo = self.slo.evaluate(now)
        with self._lock:
            self._prev_snap = snap
            self._last_slo = last_slo
            self._polls += 1
            overall = max(self._states.values())
        REGISTRY.gauge_set("health.state", overall, component="overall")
        return self.rollup()

    def _set_state(self, component: str, state: int, detail: str) -> None:
        with self._lock:
            old = self._states[component]
            self._states[component] = state
            self._details[component] = detail
            changed = state != old
            if changed:
                self._transitions += 1
        if changed:
            REGISTRY.gauge_set("health.state", state, component=component)
            REGISTRY.counter_inc("health.transitions", component=component, to=STATE_NAMES[state])
            TIMELINE.record_instant(
                "health.transition", component=component, frm=STATE_NAMES[old],
                to=STATE_NAMES[state], detail=detail[:160],
            )
            log = logger.warning if state > old else logger.info
            log("health: %s %s -> %s (%s)", component, STATE_NAMES[old],
                STATE_NAMES[state], detail)
        elif state == OK:
            # keep every component's gauge present in a scrape
            REGISTRY.gauge_set("health.state", state, component=component)

    def _escalate(self, component: str, bad: bool) -> int:
        """A consecutive-bad streak: DEGRADED, then FAILING."""
        with self._lock:
            streak = self._streaks[component] + 1 if bad else 0
            self._streaks[component] = streak
        if not bad:
            return OK
        return FAILING if streak >= self.failing_after else DEGRADED

    def _eval_device(self) -> None:
        stats = compilemon.sample_device_memory()
        if not stats:
            self._set_state("device", OK, "no device memory stats")
            return
        worst, worst_dev = 0.0, ""
        for dev, s in stats.items():
            limit = s.get("bytes_limit", 0)
            if limit:
                frac = s.get("bytes_in_use", 0) / limit
                if frac > worst:
                    worst, worst_dev = frac, dev
        if worst > self.hbm_watermark:
            self._set_state(
                "device", DEGRADED,
                f"HBM watermark {worst:.0%} > {self.hbm_watermark:.0%} on {worst_dev}",
            )
        else:
            self._set_state("device", OK, f"HBM watermark {worst:.0%}")

    def _eval_transport(self) -> None:
        if self.probe_mode == "off":
            self._set_state("transport", OK, "probe off")
            return
        ok, detail, took = self._run_probe()
        REGISTRY.histogram_record("health.probe_seconds", took)
        state = self._escalate("transport", not ok)
        self._set_state(
            "transport", state, detail if ok else f"probe failed ({took:.2f}s): {detail}"
        )

    def _run_probe(self) -> tuple[bool, str, float]:
        """The subprocess probe, or the inline probe on a throwaway daemon
        thread, so a wedged call cannot stall the monitor past the
        deadline."""
        t0 = time.monotonic()
        if self.probe_mode == "subprocess":
            from spark_rapids_ml_tpu_torch.utils import devicepolicy

            ok, detail = devicepolicy.probe_transport_subprocess(timeout=self.probe_timeout_s)
            return ok, detail, time.monotonic() - t0
        result: dict = {}
        done = threading.Event()

        def _probe() -> None:
            try:
                ok, detail = (self._probe_fn or default_inline_probe)()
                result["ok"], result["detail"] = bool(ok), str(detail)
            except Exception as e:  # noqa: BLE001 - reported as a failed probe
                result["ok"] = False
                result["detail"] = f"{type(e).__name__}: {e}"
            finally:
                done.set()

        t = threading.Thread(target=_probe, name="tpu-ml-health-probe", daemon=True)
        t.start()
        done.wait(self.probe_timeout_s)
        took = time.monotonic() - t0
        if not done.is_set():
            with self._lock:
                self._probe_thread = t  # joined, bounded, by stop()
            return False, f"probe did not complete within {self.probe_timeout_s}s", took
        return result["ok"], result["detail"], took

    def _eval_stream(self, snap, now: float) -> None:
        active = _gauge_max(snap, "stream.active")
        beat = _gauge_max(snap, "stream.last_beat")
        if not active or beat is None:
            with self._lock:
                self._streaks["stream"] = 0
            self._set_state("stream", OK, "no active stream")
            return
        age = now - beat
        state = self._escalate("stream", age > self.stale_s)
        self._set_state(
            "stream", state,
            f"heartbeat {age:.1f}s old" + ("" if state == OK else f" (> {self.stale_s:.0f}s stale)"),
        )

    def _eval_workers(self, snap, now: float) -> None:
        last = _gauge_max(snap, "worker.last_trailer")
        if last is None:
            self._set_state("workers", OK, "no worker trailers yet")
            return
        age = now - last
        state = DEGRADED if age > self.stale_s else OK
        self._set_state("workers", state, f"last trailer {age:.1f}s old")

    def _eval_scheduler(self, snap) -> None:
        slots = _gauge_max(snap, "worker.slots")
        quarantined = _gauge_max(snap, "worker.quarantined") or 0
        if slots is None:
            self._set_state("scheduler", OK, "no supervised workers")
        elif slots and quarantined >= slots:
            self._set_state("scheduler", FAILING,
                            f"all {int(slots)} worker slot(s) quarantined "
                            "(circuit breaker open everywhere)")
        elif quarantined > 0:
            self._set_state("scheduler", DEGRADED,
                            f"{int(quarantined)}/{int(slots)} worker slot(s) quarantined")
        else:
            self._set_state("scheduler", OK, f"{int(slots)} worker slot(s) healthy")

    def _eval_resilience(self, snap) -> None:
        with self._lock:
            prev = self._prev_snap
        window = snap.delta(prev) if prev is not None else snap
        reasons = []
        retries = window.counter("retry.attempts")
        if retries >= self.retry_storm:
            reasons.append(f"retry storm: {retries:g} attempts in one poll window")
        if snap.counter("degraded.cpu_fallback"):
            reasons.append("running on degraded cpu fallback")
        if window.counter("fault.injected"):
            reasons.append("fault injection active")
        if reasons:
            self._set_state("resilience", DEGRADED, "; ".join(reasons))
        else:
            self._set_state("resilience", OK, "quiet")

    # -- rollup --------------------------------------------------------------

    def rollup(self) -> dict:
        """The current health picture (the ``/healthz`` payload)."""
        with self._lock:
            states = dict(self._states)
            details = dict(self._details)
            polls = self._polls
            transitions = self._transitions
            last_slo = dict(self._last_slo)
        overall = max(states.values()) if states else OK
        out = {
            "state": STATE_NAMES[overall],
            "components": {
                c: {"state": STATE_NAMES[states[c]], "detail": details[c]} for c in COMPONENTS
            },
            "polls": polls,
            "transitions": transitions,
            "slo": last_slo,
        }
        sched = supervisor.active_summary()
        if sched:
            out["scheduler"] = sched
        return out

    def fit_summary(self) -> dict:
        """The compact rollup a FitReport carries."""
        r = self.rollup()
        return {
            "state": r["state"],
            "components": {c: v["state"] for c, v in r["components"].items()},
            "polls": r["polls"],
            "transitions": r["transitions"],
            "slo_breaches": self.slo.total_breaches(),
        }


def _gauge_max(snap, name: str) -> float | None:
    """A gauge's largest value across label sets; None when never set."""
    vals = [v for (n, _), v in snap.gauges.items() if n == name]
    return max(vals) if vals else None


# -- the process-wide monitor ------------------------------------------------

_LOCK = threading.Lock()
_MONITOR: HealthMonitor | None = None


def start_monitor(**kwargs) -> HealthMonitor:
    """Start (or return) the process-wide monitor."""
    global _MONITOR
    with _LOCK:
        if _MONITOR is None:
            _MONITOR = HealthMonitor(**kwargs)
        _MONITOR.start()
        return _MONITOR


def get_monitor() -> HealthMonitor | None:
    with _LOCK:
        return _MONITOR


def stop_monitor(timeout: float = 5.0) -> None:
    """Stop and forget the process-wide monitor (a no-op when absent)."""
    global _MONITOR
    with _LOCK:
        mon, _MONITOR = _MONITOR, None
    if mon is not None:
        mon.stop(timeout)


def current_summary() -> dict:
    """The running monitor's ``fit_summary``, or ``{}`` without one."""
    mon = get_monitor()
    if mon is None:
        return {}
    try:
        return mon.fit_summary()
    except Exception:  # noqa: BLE001 - stamping a report never breaks a fit
        logger.exception("health summary failed")
        return {}


# -- admission control ---------------------------------------------------------


def admission_policy() -> str:
    """``TPU_ML_ADMISSION_POLICY`` (``refuse`` by default)."""
    v = os.environ.get(ADMISSION_POLICY_VAR) or DEFAULT_ADMISSION_POLICY
    if v not in ADMISSION_POLICIES:
        raise ValueError(f"{ADMISSION_POLICY_VAR}={v!r} must be one of {ADMISSION_POLICIES}")
    return v


def admission_check() -> dict:
    """Consult the live monitor before admitting a fit: ``{"policy",
    "action", "health_state", "reason"}``, ``action`` being ``admit``,
    ``refuse`` or ``degrade``. Decisions other than ``admit`` are counted
    (``scheduler.admission{action}``) and recorded on the timeline;
    enforcing them is ``telemetry/report.py::begin_fit``'s job. Without a
    monitor, or before its first poll, the fit is admitted."""
    policy = admission_policy()
    decision = {"policy": policy, "action": "admit", "health_state": "UNKNOWN", "reason": ""}
    if policy == "off":
        decision["reason"] = "admission control off"
        return decision
    mon = get_monitor()
    if mon is None or mon.polls == 0:
        decision["reason"] = "no health evidence (monitor absent or unpolled)"
        return decision
    r = mon.rollup()
    decision["health_state"] = r["state"]
    if r["state"] != STATE_NAMES[FAILING]:
        decision["reason"] = f"health {r['state']}"
        return decision
    failing = [c for c, v in r["components"].items() if v["state"] == STATE_NAMES[FAILING]]
    detail = "; ".join(f"{c}: {r['components'][c]['detail']}" for c in failing)
    decision["action"] = policy  # "refuse" or "degrade"
    decision["reason"] = f"component(s) {', '.join(failing)} FAILING — {detail}"[:300]
    REGISTRY.counter_inc("scheduler.admission", action=policy)
    TIMELINE.record_instant("scheduler.admission", action=policy, components=",".join(failing))
    logger.warning("admission control: %s fit (%s)", policy, decision["reason"])
    return decision


# The degrade window: open while a fit admitted under ``degrade`` runs on
# the CPU (``begin_fit`` refuses one on any other device). Thread-local, as
# fits are.
_DEGRADE = threading.local()


def begin_degrade_window() -> None:
    _DEGRADE.depth = getattr(_DEGRADE, "depth", 0) + 1


def end_degrade_window() -> None:
    _DEGRADE.depth = max(0, getattr(_DEGRADE, "depth", 0) - 1)


def admission_degrade_active() -> bool:
    """True inside a fit that admission control degraded."""
    return getattr(_DEGRADE, "depth", 0) > 0
