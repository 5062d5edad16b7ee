"""Error classification and the one shared retry policy.

Port of ``spark_rapids_ml_tpu/resilience/retry.py``. The JAX package reads
jaxlib's ``XlaRuntimeError`` status strings; the port reads torch's errors:

- ``RESOURCE_EXHAUSTED``: ``torch.cuda.OutOfMemoryError`` (which
  ``torch.OutOfMemoryError`` names too), a ``RuntimeError`` whose message
  says ``CUDA out of memory`` or ``CUBLAS_STATUS_ALLOC_FAILED``, and
  ``MemoryError``. The same call again usually fails; a smaller one works
  (``spark/ingest.py::stream_fold`` bisects its chunk);
- ``POISONED``: a sticky CUDA error (an illegal memory access, an
  unspecified launch failure, an ECC error, a device-side assert), after
  which the process's CUDA context is unusable, and ``FoldHangTimeout``.
  Only a fresh process helps (``utils/devicepolicy.py``);
- ``TRANSIENT``: ``OSError`` and its kin (connection errors, timeouts,
  ``EOFError``). Retried in place;
- ``FATAL``: everything else, injected preemptions included. Never retried.

An injected fault declares the class it imitates (``error_class``), so it
classifies as the real error would.

``call_with_retry`` is the one backoff loop: exponential with
deterministic jitter, capped, under an optional deadline, counting each
retry as ``retry.attempts{site}`` and recording it on the timeline. It
sleeps only when another attempt follows, never after the last one.
"""

from __future__ import annotations

import enum
import logging
import random
import time
from dataclasses import dataclass
from typing import Callable, FrozenSet

import torch

from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY
from spark_rapids_ml_tpu_torch.telemetry.timeline import TIMELINE

logger = logging.getLogger("spark_rapids_ml_tpu_torch")


class ErrorClass(enum.Enum):
    TRANSIENT = "transient"
    RESOURCE_EXHAUSTED = "resource_exhausted"
    POISONED = "poisoned"
    FATAL = "fatal"


class FoldHangTimeout(RuntimeError):
    """A bounded device wait expired: the fold is hung, not slow.
    POISONED: the card's work it waited for may never end, so this process
    cannot simply issue it again."""


# matched against the lower-cased message of a RuntimeError
_CUDA_OOM = ("cuda out of memory", "cublas_status_alloc_failed")
_CUDA_STICKY = (
    "illegal memory access",
    "unspecified launch failure",
    "ecc error",
    "device-side assert",
)


def classify(exc: BaseException) -> ErrorClass:
    """The ``ErrorClass`` of an exception."""
    declared = getattr(exc, "error_class", None)
    if isinstance(declared, str):
        try:
            return ErrorClass[declared]
        except KeyError:
            pass
    if isinstance(exc, (MemoryError, torch.cuda.OutOfMemoryError)):
        return ErrorClass.RESOURCE_EXHAUSTED
    if isinstance(exc, FoldHangTimeout):
        return ErrorClass.POISONED
    if isinstance(exc, RuntimeError):
        msg = str(exc).lower()
        if any(m in msg for m in _CUDA_OOM):
            return ErrorClass.RESOURCE_EXHAUSTED
        if any(m in msg for m in _CUDA_STICKY):
            return ErrorClass.POISONED
    if isinstance(exc, (OSError, ConnectionError, TimeoutError, EOFError)):
        return ErrorClass.TRANSIENT
    return ErrorClass.FATAL


# the default retry set: transient faults and OOM (the caller may be
# retrying a smaller unit of work, as the fold's bisection does)
RETRYABLE_DEFAULT: FrozenSet[ErrorClass] = frozenset(
    {ErrorClass.TRANSIENT, ErrorClass.RESOURCE_EXHAUSTED}
)
# Spark's task semantics: any failure takes one of the attempts
RETRY_ANY: FrozenSet[ErrorClass] = frozenset(ErrorClass)


@dataclass
class RetryPolicy:
    """Exponential backoff with deterministic jitter under a deadline.

    ``sleep_s(k)`` is the pause after the k-th failed attempt (1-based):
    ``backoff_s * multiplier**(k-1)`` capped at ``max_backoff_s``, then
    moved by up to ±``jitter`` of itself, drawn from a generator seeded by
    (seed, attempt), so replays sleep alike."""

    max_attempts: int = 4
    backoff_s: float = 0.05
    multiplier: float = 2.0
    max_backoff_s: float = 2.0
    jitter: float = 0.1
    deadline_s: float | None = 300.0
    seed: int = 0

    @classmethod
    def from_config(cls, **overrides) -> "RetryPolicy":
        """The policy of ``TPU_ML_RETRY_MAX_ATTEMPTS`` and
        ``TPU_ML_RETRY_DEADLINE_S`` (a deadline of 0 is none)."""
        from spark_rapids_ml_tpu_torch.utils.config import get_config

        cfg = get_config()
        kw: dict = {
            "max_attempts": cfg.retry_max_attempts,
            "deadline_s": float(cfg.retry_deadline_s) or None,
        }
        kw.update(overrides)
        return cls(**kw)

    def sleep_s(self, attempt: int) -> float:
        base = min(self.backoff_s * self.multiplier ** (attempt - 1), self.max_backoff_s)
        if not self.jitter:
            return base
        r = random.Random(self.seed * 1_000_003 + attempt)
        return base * (1.0 + self.jitter * (2.0 * r.random() - 1.0))


def call_with_retry(
    fn: Callable,
    *,
    site: str = "",
    policy: RetryPolicy | None = None,
    retry_on: FrozenSet[ErrorClass] = RETRYABLE_DEFAULT,
    classify_fn: Callable[[BaseException], ErrorClass] = classify,
    on_failure: Callable[[int, BaseException, bool], None] | None = None,
    sleep: Callable[[float], None] | None = None,
) -> object:
    """``fn()`` under the retry policy: retried only for the classes in
    ``retry_on``, while attempts and the deadline last. ``on_failure(attempt,
    exc, will_retry)`` sees every failed attempt (default: a warning)."""
    pol = policy if policy is not None else RetryPolicy.from_config()
    start = time.monotonic()
    attempt = 0
    while True:
        attempt += 1
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 - classified below
            cls = classify_fn(e)
            within_deadline = pol.deadline_s is None or time.monotonic() - start < pol.deadline_s
            will_retry = cls in retry_on and attempt < pol.max_attempts and within_deadline
            if on_failure is not None:
                on_failure(attempt, e, will_retry)
            else:
                logger.warning(
                    "%s attempt %d/%d failed (%s): %s",
                    site or "retryable call", attempt, pol.max_attempts, cls.value, e,
                )
            if not will_retry:
                raise
            REGISTRY.counter_inc("retry.attempts", site=site or "unlabeled")
            TIMELINE.record_instant(
                "retry", site=site or "unlabeled", attempt=attempt, error_class=cls.value,
            )
            # looked up at call time, so a test that patches time.sleep sees it
            (sleep if sleep is not None else time.sleep)(pol.sleep_s(attempt))
