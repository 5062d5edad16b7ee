"""Multi-model HBM fleet manager: resident parameter accounting and LRU
paging.

Port of ``spark_rapids_ml_tpu/serving/hbm.py``. A registry that captures
every model it is handed promises the card can hold every model's
parameters forever; this module keeps the serving side within a budget:

- **Byte accounting.** Each registered servable's parameters are measured
  (``param_bytes``) and booked against the budget:
  ``TPU_ML_SERVE_HBM_BUDGET_BYTES`` when set, else the card's total memory
  × ``TPU_ML_HEALTH_HBM_WATERMARK`` (default 0.92). The resident total is
  the ``serve.hbm_bytes`` gauge. A CPU registry has no budget unless the
  knob sets one.
- **LRU paging.** Admitting a model past the budget pages the
  least-recently-used resident models out (``serve.page_out``); a request
  for a paged-out model pages it back in before dispatch
  (``serve.page_in``), evicting colder ones.
- **Hot swap.** ``account(entry, key=...)`` books a swapped-out prior
  version under ``<name>@prior``; the LRU walk never pages such a booking
  out, so a rollback restores it without a page-in. ``forget`` drops a
  booking when probation prunes the prior.

**Paging and CUDA graphs.** JAX's executables are shape-keyed and survive
paging untouched. A CUDA graph instead holds the device addresses of the
parameters it read at capture. So ``ServableEntry.page_out`` first drops
the model's graphs, each under its rung's lock (an in-flight replay
finishes before its graph goes), then copies the parameters to pinned host
memory and frees them on the card; ``page_in`` copies them back to new
device memory and recaptures every warm rung, booked as
``serve.graph_recaptures{reason=page_in}`` and
``compile.graph_captures{reason=page_in}``. No graph ever outlives the
memory it reads.

**Admission.** ``check_admission`` is the SLO-burn load-shedding hook:
while the health monitor (``telemetry/health.py``) runs, each new breach
of a declared objective (``TPU_ML_SLO``) sheds one incoming request under
``TPU_ML_ADMISSION_POLICY``: ``refuse`` raises ``ServeShed`` (HTTP 503 on
every transport), ``degrade`` admits it, and both book ``serve.shed``;
``off`` checks nothing. Without a monitor every request is admitted.
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Any

import torch

from spark_rapids_ml_tpu_torch.telemetry import compilemon, health
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY
from spark_rapids_ml_tpu_torch.utils.config import (
    DEFAULT_HBM_WATERMARK,
    HEALTH_HBM_WATERMARK_VAR,
    SERVE_HBM_BUDGET_BYTES_VAR,
    lenient_float,
)

logger = logging.getLogger("spark_rapids_ml_tpu_torch.serving")


#: The booking key suffix of a hot-swapped slot's retained prior version.
PRIOR_SUFFIX = "@prior"


class ServeShed(RuntimeError):
    """A serve request shed by the admission policy (HTTP 503)."""


def param_bytes(params: Any) -> int:
    """Total bytes of a tuple of parameter tensors."""
    return int(sum(t.numel() * t.element_size() for t in params))


def budget_bytes(device: torch.device | None = None) -> int | None:
    """The fleet's resident-parameter budget: ``TPU_ML_SERVE_HBM_BUDGET_BYTES``
    when set, else the total memory of ``device`` (a CUDA device) ×
    ``TPU_ML_HEALTH_HBM_WATERMARK`` (0.92 when unset or malformed); None (no
    accounting) for the CPU without the knob."""
    raw = os.environ.get(SERVE_HBM_BUDGET_BYTES_VAR, "").strip()
    if raw:
        try:
            return max(0, int(raw))
        except ValueError:
            logger.warning("ignoring non-integer %s=%r", SERVE_HBM_BUDGET_BYTES_VAR, raw)
    if device is None or device.type != "cuda":
        return None
    stats = compilemon.sample_device_memory().get(f"cuda:{device.index}")
    if not stats or not stats.get("bytes_limit"):
        return None
    watermark = lenient_float(HEALTH_HBM_WATERMARK_VAR, DEFAULT_HBM_WATERMARK)
    return int(stats["bytes_limit"] * watermark)


class _Resident:
    __slots__ = ("entry", "nbytes", "seq")

    def __init__(self, entry: Any, nbytes: int, seq: int):
        self.entry = entry
        self.nbytes = nbytes
        self.seq = seq

    @property
    def resident(self) -> bool:
        return self.entry.resident


class HbmFleetManager:
    """Tracks every registered servable's parameter bytes against the budget
    and pages cold models to host."""

    def __init__(self):
        self._lock = threading.RLock()
        self._models: dict[str, _Resident] = {}
        self._seq = 0
        self._last_breaches = 0

    def account(self, entry: Any, *, key: str | None = None) -> None:
        """Admit a (re-)registered servable: measure its parameters, mark it
        most recently used, and page colder models out until the fleet fits
        the budget again. ``key`` overrides the booking key: a hot swap
        books the prior version under ``<name>@prior``, where it stays
        resident (never paged out: a rollback must not page) until
        probation clears."""
        key = key or entry.name
        with self._lock:
            self._seq += 1
            self._models[key] = _Resident(entry, param_bytes(entry.params), self._seq)
            self._evict_to_fit(protect=key)
            self._publish()

    def forget(self, name: str) -> None:
        """Drop a booking (a pruned prior, a demoted candidate)."""
        with self._lock:
            self._models.pop(name, None)
            self._publish()

    def _publish(self) -> None:
        REGISTRY.gauge_set(
            "serve.hbm_bytes",
            sum(r.nbytes for r in self._models.values() if r.resident),
        )

    def ensure_resident(self, entry: Any) -> None:
        """Dispatch-path hook: touch the model's LRU clock and page its
        parameters back in if a colder model's pressure evicted them. An
        entry the fleet no longer books (a replaced version) pages itself
        in without accounting."""
        with self._lock:
            rec = self._models.get(entry.name)
            if rec is None or rec.entry is not entry:
                if not entry.resident:
                    self._page_in(entry)
                return
            self._seq += 1
            rec.seq = self._seq
            if rec.resident:
                return
            self._page_in(entry)
            self._evict_to_fit(protect=entry.name)
            self._publish()

    def _page_in(self, entry: Any) -> None:
        entry.page_in()
        REGISTRY.counter_inc("serve.page_in", model=entry.name)
        logger.info("paged in servable %s", entry.name)

    def _page_out(self, rec: _Resident) -> None:
        rec.entry.page_out()
        REGISTRY.counter_inc("serve.page_out", model=rec.entry.name)
        logger.info("paged out servable %s (%d bytes)", rec.entry.name, rec.nbytes)

    def _evict_to_fit(self, protect: str) -> None:
        """Page out least-recently-used residents (never ``protect``, never
        a retained prior) until the resident total fits the budget."""
        budget = budget_bytes(self._models[protect].entry.device)
        if budget is None:
            return
        used = sum(r.nbytes for r in self._models.values() if r.resident)
        victims = sorted(
            (r for k, r in self._models.items()
             if r.resident and k != protect and not k.endswith(PRIOR_SUFFIX)),
            key=lambda r: r.seq,
        )
        for rec in victims:
            if used <= budget:
                break
            self._page_out(rec)
            used -= rec.nbytes
        if used > budget:
            logger.warning(
                "HBM fleet over budget even after paging: %d > %d bytes "
                "(the active model alone exceeds the budget)", used, budget
            )

    def check_admission(self, model: str) -> None:
        """Shed one incoming request per newly observed SLO breach while the
        declared objectives burn: under ``refuse`` raise ``ServeShed``
        (HTTP 503), under ``degrade`` admit it, both booking ``serve.shed``;
        ``off`` disables the check (a malformed policy reads as
        ``refuse``)."""
        try:
            policy = health.admission_policy()
        except ValueError:
            policy = "refuse"
        if policy == "off":
            return
        monitor = health.get_monitor()
        if monitor is None:
            return
        breaches = int(monitor.slo.total_breaches())
        with self._lock:
            burned = breaches - self._last_breaches
            self._last_breaches = breaches
        if burned <= 0:
            return
        REGISTRY.counter_inc("serve.shed", model=model, policy=policy)
        if policy == "refuse":
            raise ServeShed(
                f"request for {model!r} shed: serve SLO burning ({burned} new breach(es)) "
                "and TPU_ML_ADMISSION_POLICY=refuse"
            )

    def stats(self) -> dict:
        with self._lock:
            devices = {r.entry.device for r in self._models.values()}
            return {
                "budget_bytes": budget_bytes(next(iter(devices)) if len(devices) == 1 else None),
                "resident_bytes": sum(r.nbytes for r in self._models.values() if r.resident),
                "models": {
                    name: {"bytes": r.nbytes, "resident": r.resident, "lru_seq": r.seq}
                    for name, r in sorted(self._models.items())
                },
            }


_FLEET_LOCK = threading.Lock()
_FLEET: HbmFleetManager | None = None


def get_fleet() -> HbmFleetManager:
    """The process-wide fleet manager the registry consults."""
    global _FLEET
    with _FLEET_LOCK:
        if _FLEET is None:
            _FLEET = HbmFleetManager()
        return _FLEET


def reset_fleet() -> None:
    """Drop the singleton (tests)."""
    global _FLEET
    with _FLEET_LOCK:
        _FLEET = None
