"""Deterministic fault injection at named sites, driven by a plan in the
environment.

Port of ``spark_rapids_ml_tpu/resilience/faults.py``, with the same plan
grammar, kinds and exception classes. A plan is a comma-separated list of
``site:kind:nth[:arg]`` entries in ``TPU_ML_FAULT_PLAN``; ``nth`` is the
1-based occurrence of that site in this process:

    TPU_ML_FAULT_PLAN="fold.dispatch:oom:3"        # the 3rd dispatch OOMs
    TPU_ML_FAULT_PLAN="ingest.chunk:io:2,fold.wait:hang:1:0.5"

Kinds:

- ``oom``: raise ``InjectedResourceExhausted``, classified as a device OOM
  (``retry.ErrorClass.RESOURCE_EXHAUSTED``, as ``torch.OutOfMemoryError``);
- ``io``: raise ``InjectedTransientIOError`` (an ``OSError``), retryable;
- ``hang``: sleep ``arg`` seconds (default 0.25);
- ``nonfinite``: hand back the data passing the site with its first
  element set to NaN;
- ``preempt``: raise ``InjectedPreemption``, FATAL: a real preemption kills
  the process, so the recovery is a checkpoint and a resume;
- ``kill``: ``os._exit(KILL_EXIT_CODE)``.

A retry re-enters the site, its occurrence count moves past ``nth``, and
the call succeeds: one mechanism makes a transient fault clear and a plan
deterministic. Every injection that fires is counted
(``fault.injected{site,kind}``) and recorded on the timeline. With no plan
a site costs one environment read.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Any

import numpy as np

from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY
from spark_rapids_ml_tpu_torch.telemetry.timeline import TIMELINE
from spark_rapids_ml_tpu_torch.utils.config import FAULT_PLAN_VAR

KINDS = ("oom", "io", "hang", "nonfinite", "preempt", "kill")

# told apart in a worker's exit from a failed device probe (17)
KILL_EXIT_CODE = 113

DEFAULT_HANG_SECONDS = 0.25


class FaultInjected(RuntimeError):
    """Base of the injected faults. ``error_class`` names the
    ``retry.ErrorClass`` member the fault imitates (a string, so that this
    module does not import the classifier)."""

    error_class = "FATAL"


class InjectedResourceExhausted(FaultInjected):
    """An injected device OOM."""

    error_class = "RESOURCE_EXHAUSTED"


class InjectedTransientIOError(FaultInjected, IOError):
    """An injected transient I/O failure: it clears on retry."""

    error_class = "TRANSIENT"


class InjectedPreemption(FaultInjected):
    """An injected preemption: the process would have died here. FATAL, so
    no retry in the process survives it; a checkpoint and a resume do."""

    error_class = "FATAL"


@dataclass(frozen=True)
class FaultSpec:
    site: str
    kind: str
    nth: int
    arg: float | None = None


def parse_plan(raw: str) -> tuple[FaultSpec, ...]:
    """The entries of a ``site:kind:nth[:arg]`` comma list; '' → none."""
    specs: list[FaultSpec] = []
    for entry in raw.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) not in (3, 4):
            raise ValueError(f"{FAULT_PLAN_VAR} entry {entry!r}: expected site:kind:nth[:arg]")
        site, kind, nth_raw = parts[0], parts[1], parts[2]
        if kind not in KINDS:
            raise ValueError(f"{FAULT_PLAN_VAR} entry {entry!r}: kind {kind!r} not one of {KINDS}")
        try:
            nth = int(nth_raw)
        except ValueError:
            raise ValueError(
                f"{FAULT_PLAN_VAR} entry {entry!r}: nth {nth_raw!r} is not an int"
            ) from None
        if nth < 1:
            raise ValueError(f"{FAULT_PLAN_VAR} entry {entry!r}: nth must be >= 1 (1-based)")
        arg = float(parts[3]) if len(parts) == 4 else None
        specs.append(FaultSpec(site, kind, nth, arg))
    return tuple(specs)


# the plan, cached by its raw string (a test that changes the environment
# gets it parsed again), and each site's occurrences, under one lock
_lock = threading.Lock()
_cached_raw: str | None = None
_cached_plan: tuple[FaultSpec, ...] = ()
_site_calls: dict[str, int] = {}


def _plan() -> tuple[FaultSpec, ...]:
    global _cached_raw, _cached_plan
    raw = os.environ.get(FAULT_PLAN_VAR, "")
    if raw != _cached_raw:
        _cached_plan = parse_plan(raw)
        _cached_raw = raw
    return _cached_plan


def reset_faults() -> None:
    """Forget the sites' occurrence counts and the cached plan."""
    global _cached_raw, _cached_plan
    with _lock:
        _site_calls.clear()
        _cached_raw = None
        _cached_plan = ()


def inject(site: str, data: Any = None) -> Any:
    """The gate of ``site``: count this occurrence and fire the plan's
    entries for it. Returns ``data`` (corrupted by a ``nonfinite`` entry);
    the raising kinds raise. Call it before the operation changes any
    state it cannot roll back, so that a retry re-runs it cleanly."""
    with _lock:
        plan = _plan()
        if not plan:
            return data
        n = _site_calls.get(site, 0) + 1
        _site_calls[site] = n
        hits = [s for s in plan if s.site == site and s.nth == n]
    for spec in hits:
        REGISTRY.counter_inc("fault.injected", site=site, kind=spec.kind)
        TIMELINE.record_instant("fault.injected", site=site, kind=spec.kind)
        if spec.kind == "oom":
            raise InjectedResourceExhausted(
                f"RESOURCE_EXHAUSTED: injected device OOM at {site!r} (occurrence {n})"
            )
        if spec.kind == "io":
            raise InjectedTransientIOError(
                f"injected transient I/O failure at {site!r} (occurrence {n})"
            )
        if spec.kind == "preempt":
            raise InjectedPreemption(
                f"injected preemption at {site!r} (occurrence {n}): the process "
                "would have been killed here"
            )
        if spec.kind == "kill":
            os._exit(KILL_EXIT_CODE)
        if spec.kind == "hang":
            time.sleep(spec.arg if spec.arg is not None else DEFAULT_HANG_SECONDS)
        elif spec.kind == "nonfinite" and data is not None:
            data = np.array(data, copy=True)
            data.reshape(-1)[0] = np.nan
    return data
