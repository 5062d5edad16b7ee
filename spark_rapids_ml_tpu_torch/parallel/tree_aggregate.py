"""Balanced pairwise reduction of per-partition partials.

Counterpart of ``spark_rapids_ml_tpu/parallel/tree_aggregate.py``. A tree
bounds the f32 error chain at O(log n) combines, and its order is fixed, so
the same partials always give the same sum.
"""

from __future__ import annotations

from typing import Callable, Sequence, TypeVar

T = TypeVar("T")


def tree_reduce(items: Sequence[T], combine: Callable[[T, T], T]) -> T:
    """Balanced pairwise reduction of a non-empty sequence."""
    items = list(items)
    if not items:
        raise ValueError("cannot reduce an empty sequence")
    while len(items) > 1:
        nxt = [combine(items[i], items[i + 1]) for i in range(0, len(items) - 1, 2)]
        if len(items) % 2:
            nxt.append(items[-1])
        items = nxt
    return items[0]
