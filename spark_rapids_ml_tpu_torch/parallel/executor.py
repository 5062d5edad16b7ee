"""Per-partition tasks on a bounded thread pool, with retries and straggler
hedging.

Port of ``spark_rapids_ml_tpu/parallel/executor.py``, Spark's task
semantics without Spark:

- each task passes the ``worker.task`` fault site before its body, so an
  injected fault costs an attempt and no work;
- any failure takes one of ``1 + TPU_ML_TASK_RETRIES`` attempts
  (``retry.RETRY_ANY``), with an exponential backoff and no deadline, under
  the shared ``resilience.retry.call_with_retry``; a task out of attempts
  raises ``TaskFailedError``;
- on the pool, a task still running after
  ``max(TPU_ML_HEDGE_FLOOR_S, TPU_ML_HEDGE_FACTOR × p50)`` of the finished
  attempts' times gets one duplicate attempt (``scheduler.hedge``), and the
  first success wins. A retry answers a failure; a hedge answers a call
  that never ends.

Results come back in input order whatever the completion order, so a
reduction over them is stable. Threads overlap one partition's host work
(extraction, padding, the copy to the card) with another's kernels; each
launches on its own current stream, the device's default stream unless the
caller set another. A hedged task's body runs twice and the loser's
kernels are launched all the same: the kernel wrappers count every launch
under a lock, and the pool waits for the loser before it returns.
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from typing import Callable, Sequence, TypeVar

from spark_rapids_ml_tpu_torch.resilience import faults, sites
from spark_rapids_ml_tpu_torch.resilience import retry as _retry
from spark_rapids_ml_tpu_torch.resilience.supervisor import hedge_config
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY
from spark_rapids_ml_tpu_torch.telemetry.timeline import TIMELINE
from spark_rapids_ml_tpu_torch.utils.config import get_config

logger = logging.getLogger("spark_rapids_ml_tpu_torch")

T = TypeVar("T")
R = TypeVar("R")


class TaskFailedError(RuntimeError):
    """A partition task used up its attempts."""


def run_partition_tasks(
    fn: Callable[[T], R],
    items: Sequence[T],
    *,
    max_retries: int | None = None,
    max_workers: int | None = None,
    retry_backoff_s: float = 0.05,
) -> list[R]:
    """``fn`` applied to every item on up to ``TPU_ML_MAX_WORKERS`` threads,
    with up to ``TPU_ML_TASK_RETRIES`` retries a task; results in input
    order."""
    cfg = get_config()
    if max_retries is None:
        max_retries = cfg.task_retries
    if max_workers is None:
        max_workers = cfg.max_workers
    items = list(items)
    if not items:
        return []

    policy = _retry.RetryPolicy(
        max_attempts=1 + max_retries,
        backoff_s=retry_backoff_s,
        multiplier=2.0,
        max_backoff_s=60.0,
        jitter=0.0,
        deadline_s=None,
    )

    def attempt(idx_item):
        idx, item = idx_item

        def run():
            faults.inject(sites.WORKER_TASK)
            return fn(item)

        def log_failure(att, e, will_retry):
            logger.warning(
                "partition task %d attempt %d/%d failed: %s", idx, att, 1 + max_retries, e,
            )

        try:
            return _retry.call_with_retry(
                run,
                site=sites.WORKER_TASK,
                policy=policy,
                retry_on=_retry.RETRY_ANY,
                on_failure=log_failure,
            )
        except Exception as e:  # noqa: BLE001 - attempts used up
            raise TaskFailedError(
                f"partition task {idx} failed after {1 + max_retries} attempts"
            ) from e

    if len(items) == 1 or max_workers <= 1:
        return [attempt((i, it)) for i, it in enumerate(items)]

    hedge_factor, hedge_floor = hedge_config()
    n = len(items)
    lk = threading.Lock()
    t_start: dict[int, float] = {}  # task → when its first attempt began to run
    completed: list[float] = []  # durations of the finished attempts (for p50)

    def timed_attempt(idx_item):
        idx, _ = idx_item
        t0 = time.monotonic()
        with lk:
            t_start.setdefault(idx, t0)
        out = attempt(idx_item)
        with lk:
            completed.append(time.monotonic() - t0)
        return out

    results: dict[int, R] = {}
    with ThreadPoolExecutor(max_workers=min(max_workers, n)) as pool:
        futs = {i: [pool.submit(timed_attempt, (i, it))] for i, it in enumerate(items)}
        pending = set(range(n))
        while pending:
            wait([f for i in pending for f in futs[i]], timeout=0.05, return_when=FIRST_COMPLETED)
            now = time.monotonic()
            for i in list(pending):
                fs = futs[i]
                done_fs = [f for f in fs if f.done()]
                ok = next((f for f in done_fs if f.exception() is None), None)
                if ok is not None:
                    # the first success wins; a queued twin is cancelled, a
                    # running one finishes and its result is dropped
                    results[i] = ok.result()
                    pending.discard(i)
                    for f in fs:
                        f.cancel()
                elif len(done_fs) == len(fs):
                    raise done_fs[0].exception()
            if hedge_factor <= 0 or not pending:
                continue
            with lk:
                med = sorted(completed)[len(completed) // 2] if completed else None
                starts = dict(t_start)
            if med is None:
                continue
            limit = max(hedge_floor, hedge_factor * med)
            for i in list(pending):
                t0 = starts.get(i)
                if len(futs[i]) == 1 and t0 is not None and now - t0 > limit:
                    REGISTRY.counter_inc("scheduler.hedge", task=str(i))
                    TIMELINE.record_instant("scheduler.hedge", task=str(i))
                    logger.info(
                        "hedging straggler partition task %d (%.2fs > %.2fs)", i, now - t0, limit,
                    )
                    futs[i].append(pool.submit(timed_attempt, (i, items[i])))
    return [results[i] for i in range(n)]
