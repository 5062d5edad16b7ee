"""Column expressions — the ``pyspark.sql.functions`` subset the estimators
plan with (``col``, ``lit``, ``rand``), evaluated per Arrow batch with
``pyarrow.compute`` at materialization time.

Copy of ``spark_rapids_ml_tpu/localspark/functions.py``: ``rand(seed)``
draws the JAX engine's stream, so a seeded plan selects the same rows in
both engines."""

from __future__ import annotations

from typing import Any

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc


class Column:
    """A lazily evaluated expression over an Arrow RecordBatch.

    ``evaluate(batch, partition_id, row_offset)`` returns a pyarrow Array of
    batch length. Comparison operators build boolean-valued Columns, so
    ``F.col("w") > 0`` works as a ``where`` predicate.
    """

    def __init__(self, fn, name: str):
        self._fn = fn
        self._name = name

    def evaluate(self, batch: pa.RecordBatch, partition_id: int, row_offset: int):
        return self._fn(batch, partition_id, row_offset)

    def __repr__(self) -> str:
        return f"Column<{self._name}>"

    def _binop(self, other: Any, op, sym: str) -> "Column":
        other_col = other if isinstance(other, Column) else lit(other)

        def fn(batch, pid, off):
            return op(
                self.evaluate(batch, pid, off), other_col.evaluate(batch, pid, off)
            )

        return Column(fn, f"({self._name} {sym} {other_col._name})")

    def __gt__(self, other):
        return self._binop(other, pc.greater, ">")

    def __ge__(self, other):
        return self._binop(other, pc.greater_equal, ">=")

    def __lt__(self, other):
        return self._binop(other, pc.less, "<")

    def __le__(self, other):
        return self._binop(other, pc.less_equal, "<=")

    def __eq__(self, other):  # noqa: D105 - Spark semantics: == builds an expr
        return self._binop(other, pc.equal, "=")

    def __ne__(self, other):
        return self._binop(other, pc.not_equal, "!=")

    def __and__(self, other):
        return self._binop(other, pc.and_kleene, "AND")

    def __or__(self, other):
        return self._binop(other, pc.or_kleene, "OR")

    def __hash__(self):
        return id(self)


def col(name: str) -> Column:
    def fn(batch: pa.RecordBatch, pid: int, off: int):
        idx = batch.schema.get_field_index(name)
        if idx < 0:
            raise KeyError(f"no such column: {name!r}")
        return batch.column(idx)

    return Column(fn, name)


def lit(value: Any) -> Column:
    def fn(batch: pa.RecordBatch, pid: int, off: int):
        return pa.scalar(value)

    return Column(fn, repr(value))


def rand(seed: int = 0) -> Column:
    """Uniform [0, 1) per row, deterministic given (seed, partition, row) —
    the contract Spark's ``rand`` documents (stable under re-execution of a
    partition, different across partitions)."""

    def fn(batch: pa.RecordBatch, pid: int, off: int):
        rng = np.random.default_rng((seed, pid))
        # jump the stream to this batch's offset instead of regenerating the
        # prefix (PCG64 consumes one 64-bit draw per double, so advance(off)
        # lands exactly where `off` prior rows would have left the stream)
        rng.bit_generator.advance(off)
        return pa.array(rng.random(batch.num_rows))

    return Column(fn, f"rand({seed})")
