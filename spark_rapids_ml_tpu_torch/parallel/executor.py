"""Per-partition tasks on a bounded thread pool.

Counterpart of ``spark_rapids_ml_tpu/parallel/executor.py`` without its
retries and straggler hedging, which wait for a later slice. Threads overlap
one partition's host work (extraction, padding, the copy to the card) with
another's kernels. Each thread launches on its own current stream, which is
the device's default stream unless the caller set another; the kernel
wrappers count their launches under a lock.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence, TypeVar

from spark_rapids_ml_tpu_torch.utils.config import get_config

T = TypeVar("T")
R = TypeVar("R")


def run_partition_tasks(fn: Callable[[T], R], items: Sequence[T]) -> list[R]:
    """``fn`` applied to every item on up to ``TPU_ML_MAX_WORKERS`` threads,
    results in input order; the first task's exception is raised."""
    items = list(items)
    max_workers = get_config().max_workers
    if len(items) <= 1 or max_workers <= 1:
        return [fn(item) for item in items]
    with ThreadPoolExecutor(max_workers=min(max_workers, len(items))) as pool:
        futures = [pool.submit(fn, item) for item in items]
        return [f.result() for f in futures]
