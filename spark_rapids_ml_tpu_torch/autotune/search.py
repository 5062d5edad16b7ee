"""Bounded, measured search over tuning candidates.

Port of ``spark_rapids_ml_tpu/autotune/search.py``: ``mode``,
``trial_budget``, ``candidate_grid``, ``successive_halving``, ``search``,
``resolve`` and ``stream_fold_measure``, with the JAX package's modes,
budget, counters, spans and fault site.

Successive halving: every surviving candidate gets one timing trial a
round, the slower half is dropped, and rounds repeat until one candidate
survives or the budget (``TPU_ML_AUTOTUNE_TRIALS``) is spent; the best mean
among the survivors wins. Each trial is an ``autotune.trial`` span behind
the ``autotune.trial`` fault site, timed around the caller's
``measure(config)``, which may report its own seconds (``stream_fold_measure``
reports seconds per row). A trial that raises drops its candidate only
(``autotune.trial_failures``); when every candidate dies the search returns
``None`` and the caller keeps its static knobs, and nothing is cached.

``resolve`` is the one entry point of the hot paths: ``off`` returns
``None`` and journals nothing; ``cache`` (the default) consults the tuning
cache; ``search`` also searches an unseen shape bucket when the caller
gives ``measure`` and ``candidates``. Every resolution but ``off`` is
journaled (``cache.record_decision``) for ``FitReport.tuning``.

Where the port differs:

- ``candidate_grid``'s layouts default to ``("row",)``, where the JAX grid
  searches ``("row", "col")``. The port's Gram kernels read row-major rows
  (TMA needs a 16-byte row stride, ``ops/gram_moments.py::load_route``), so
  a column-major staging buffer would only time a transpose before the same
  kernel. The chunk sizes are the JAX grid's.
- ``stream_fold_measure`` stages its synthetic chunk in pinned host memory,
  copies it to the fold's device once, and times ``reps`` folds between two
  ``torch.cuda.synchronize()`` calls (no synchronize on the CPU).
- ``resolve`` takes the cache key's ``device`` (default: the card when one
  is present), which the JAX function reads from its backend.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.autotune import cache
from spark_rapids_ml_tpu_torch.autotune.policy import TuningConfig
from spark_rapids_ml_tpu_torch.resilience import faults
from spark_rapids_ml_tpu_torch.resilience.sites import AUTOTUNE_TRIAL
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY
from spark_rapids_ml_tpu_torch.telemetry.spans import trace_range
from spark_rapids_ml_tpu_torch.utils.config import (
    AUTOTUNE_TRIALS_VAR,
    AUTOTUNE_VAR,
    DEFAULT_AUTOTUNE,
    DEFAULT_AUTOTUNE_TRIALS,
)

logger = logging.getLogger("spark_rapids_ml_tpu_torch")

MODES = ("off", "cache", "search")


def mode() -> str:
    """The tuner's mode from ``TPU_ML_AUTOTUNE`` (an unknown value: the
    default, with a warning)."""
    m = os.environ.get(AUTOTUNE_VAR, DEFAULT_AUTOTUNE)
    if m not in MODES:
        logger.warning("%s=%r is not one of %s; using %r",
                       AUTOTUNE_VAR, m, MODES, DEFAULT_AUTOTUNE)
        return DEFAULT_AUTOTUNE
    return m


def trial_budget() -> int:
    """The timing-trial budget of one search (at least 1)."""
    try:
        return max(1, int(os.environ.get(AUTOTUNE_TRIALS_VAR, DEFAULT_AUTOTUNE_TRIALS)))
    except ValueError:
        return DEFAULT_AUTOTUNE_TRIALS


def candidate_grid(base_chunk_rows: int, *, floor: int = 8, policy: str = "f32",
                   layouts: tuple[str, ...] = ("row",)) -> list[TuningConfig]:
    """The streamed fold's candidates: chunk rows at {½×, 1×, 2×} the static
    base (at least ``floor``, duplicates dropped) × ``layouts``. The policy
    is not searched: trading accuracy for speed is the caller's choice."""
    sizes: list[int] = []
    for mult in (0.5, 1.0, 2.0):
        rows = max(floor, int(base_chunk_rows * mult))
        if rows not in sizes:
            sizes.append(rows)
    return [
        TuningConfig(chunk_rows=rows, layout=layout, policy=policy)
        for rows in sizes
        for layout in layouts
    ]


def _trial(config: TuningConfig, measure) -> float:
    """One timing trial: the fault site, the span, the seconds of
    ``measure(config)`` (its own report where it gives one)."""
    REGISTRY.counter_inc("autotune.trials")
    with trace_range("autotune.trial"):
        faults.inject(AUTOTUNE_TRIAL)
        t0 = time.monotonic()
        reported = measure(config)
        wall = time.monotonic() - t0
    return float(reported) if reported is not None else wall


def successive_halving(candidates, measure, *, budget: int | None = None,
                       ) -> tuple[TuningConfig | None, int]:
    """``(winner, trials used)``. Deterministic for deterministic timings:
    candidate order breaks ties, each round measures every survivor once
    (budget permitting) and keeps the faster half by mean seconds."""
    if budget is None:
        budget = trial_budget()
    alive: list[tuple[TuningConfig, list[float]]] = [
        (c, []) for c in list(candidates)[:max(1, budget)]
    ]
    trials = 0
    while alive and trials < budget:
        survivors: list[tuple[TuningConfig, list[float]]] = []
        for config, seen in alive:
            if trials >= budget:
                survivors.append((config, seen))
                continue
            trials += 1
            try:
                seen.append(_trial(config, measure))
            except Exception:  # noqa: BLE001 - a dead trial drops only itself
                REGISTRY.counter_inc("autotune.trial_failures")
                logger.warning("autotune trial failed for %s; dropping the candidate",
                               config.to_dict(), exc_info=True)
                continue
            survivors.append((config, seen))
        alive = survivors
        if len(alive) <= 1:
            break
        measured = [(c, s) for c, s in alive if s]
        if not measured:
            break
        measured.sort(key=lambda cs: sum(cs[1]) / len(cs[1]))
        keep = max(1, (len(measured) + 1) // 2)
        if keep == len(measured):
            break  # the field cannot shrink: the winner is decided
        alive = measured[:keep]
    scored = [(c, sum(s) / len(s)) for c, s in alive if s]
    if not scored:
        return None, trials
    return min(scored, key=lambda cs: cs[1])[0], trials


def search(kernel: str, key: str, candidates, measure, *, budget: int | None = None,
           ) -> TuningConfig | None:
    """One search for one cache key: span, counters, and the winner stored
    in the cache."""
    REGISTRY.counter_inc("autotune.search_runs")
    with trace_range("autotune.search"):
        winner, trials = successive_halving(candidates, measure, budget=budget)
    if winner is None:
        logger.warning("autotune search for %s produced no winner; keeping the static knobs",
                       key)
        return None
    cache.store(key, winner, trials=trials)
    return winner


def resolve(kernel: str, *, n: int, rows: int | None = None, dtype=None,
            device: str | None = None, measure=None, candidates=None,
            budget: int | None = None) -> TuningConfig | None:
    """The ``TuningConfig`` for ``kernel`` at this shape, or ``None`` for
    "keep the static knobs". ``device`` is the cache key's device kind
    (``cache.device_kind``)."""
    m = mode()
    if m == "off":
        return None
    key = cache.cache_key(kernel, n=n, rows=rows, dtype=dtype, device=device)
    config = cache.lookup(key)
    if config is not None:
        cache.record_decision(kernel=kernel, key=key, source="cache", config=config)
        return config
    if m == "search" and measure is not None and candidates is not None:
        config = search(kernel, key, candidates, measure, budget=budget)
        if config is not None:
            cache.record_decision(kernel=kernel, key=key, source="search", config=config)
            return config
    cache.record_decision(kernel=kernel, key=key, source="default", config=None)
    return None


def _zeros_like(carry):
    """A zero carry of ``carry``'s structure: a tensor or a tuple of them."""
    if isinstance(carry, torch.Tensor):
        return torch.zeros_like(carry)
    zeros = [_zeros_like(c) for c in carry]
    return type(carry)(*zeros) if hasattr(carry, "_fields") else type(carry)(zeros)


def stream_fold_measure(fold_fn, carry, n: int, device: torch.device, *,
                        want_y: bool = False, reps: int = 1, seed: int = 0):
    """A ``measure(config)`` for the streamed fold. Each trial stages one
    synthetic f32 chunk of the candidate's rows in pinned host memory (for a
    card), copies it to ``device`` once, folds it once into a throwaway zero
    carry (the warm-up), then times ``reps`` folds between two
    synchronizations, and reports seconds per row, so that chunk sizes
    compare. The fold is called as ``stream_fold`` calls it: ``(carry, x,
    w)`` with the unit weights on the host, or ``(carry, x, y, w)`` on the
    device with ``want_y``. The caller's carry is never touched."""
    cuda = device.type == "cuda"

    def sync() -> None:
        if cuda:
            torch.cuda.synchronize(device)

    def measure(config: TuningConfig) -> float:
        rows = max(1, int(config.chunk_rows or 1))
        rng = np.random.default_rng(seed)
        host = torch.from_numpy(rng.standard_normal((rows, n), dtype=np.float32))
        if cuda:
            host = host.pin_memory()
        x = host.to(device, non_blocking=True)
        ones = torch.ones((rows,), dtype=torch.float32)
        if want_y:
            y = torch.from_numpy(rng.standard_normal(rows, dtype=np.float32)).to(device)
            args = (x, y, ones.to(device))
        else:
            args = (x, ones)
        trial_carry = fold_fn(_zeros_like(carry), *args)  # warm-up
        sync()
        t0 = time.perf_counter()
        for _ in range(max(1, reps)):
            trial_carry = fold_fn(trial_carry, *args)
        sync()
        return (time.perf_counter() - t0) / (max(1, reps) * rows)

    return measure
