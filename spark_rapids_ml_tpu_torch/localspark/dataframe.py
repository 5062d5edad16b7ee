"""localspark DataFrame: a lazily planned, partitioned Arrow dataset with
the ``pyspark.sql.DataFrame`` surface the estimators drive.

A DataFrame is (schema, plan); the plan yields partitions — each a list of
``pyarrow.RecordBatch`` — on demand. Narrow ops (select / where / sample /
limit) evaluate inline on the driver; ``mapInArrow`` is the execution
boundary, dispatched to the session's worker processes (see ``worker.py``
for the fidelity contract). Actions (``collect``/``count``/``toArrow``/
``first``) materialize.

Copy of ``spark_rapids_ml_tpu/localspark/dataframe.py``. The driver-side
operations (``sample``, ``randomSplit``, ``repartition``, ``where`` with
``rand``) draw the same numpy streams, so the same seed gives the same rows
in both engines.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterator

import numpy as np
import pyarrow as pa

from spark_rapids_ml_tpu_torch.localspark import types as T
from spark_rapids_ml_tpu_torch.localspark.functions import Column


class Row(tuple):
    """Positional + by-name + attribute row access, like ``pyspark.sql.Row``."""

    __fields__: tuple

    def __new__(cls, values, names):
        row = super().__new__(cls, values)
        row.__fields__ = tuple(names)
        return row

    def __getitem__(self, key):
        if isinstance(key, str):
            try:
                key = self.__fields__.index(key)
            except ValueError:
                raise KeyError(key) from None
        return super().__getitem__(key)

    def __getattr__(self, name):
        try:
            return self[self.__fields__.index(name)]
        except ValueError:
            raise AttributeError(name) from None

    def asDict(self) -> dict:
        return dict(zip(self.__fields__, self))

    def __repr__(self) -> str:
        body = ", ".join(f"{n}={v!r}" for n, v in zip(self.__fields__, self))
        return f"Row({body})"


def _value_to_python(v):
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, (list, np.ndarray)):
        return [_value_to_python(x) for x in v]
    return v


class DataFrame:
    def __init__(
        self,
        session,
        schema: T.StructType,
        parts: Callable[[], Iterator[list[pa.RecordBatch]]],
        num_partitions: int,
    ):
        self._session = session
        self._schema = schema
        self._parts = parts
        self._num_partitions = num_partitions

    # -- metadata -----------------------------------------------------------

    @property
    def schema(self) -> T.StructType:
        return self._schema

    @property
    def columns(self) -> list[str]:
        return self._schema.names

    @property
    def rdd(self):  # only getNumPartitions, for parity probes in tests
        df = self

        class _RddShim:
            def getNumPartitions(self) -> int:
                return df._num_partitions

        return _RddShim()

    def __repr__(self) -> str:
        cols = ", ".join(
            f"{f.name}: {f.dataType.simpleString()}" for f in self._schema.fields
        )
        return f"LocalDataFrame[{cols}]"

    # -- narrow transformations (driver-inline) -----------------------------

    def _derive(self, schema, parts, num_partitions=None) -> "DataFrame":
        return DataFrame(
            self._session,
            schema,
            parts,
            self._num_partitions if num_partitions is None else num_partitions,
        )

    def select(self, *cols: str) -> "DataFrame":
        names = [c if isinstance(c, str) else str(c) for c in cols]
        fields = [self._schema[n] for n in names]  # KeyError on bad name, eagerly

        def parts():
            for part in self._parts():
                yield [b.select(names) for b in part]

        return self._derive(T.StructType(fields), parts)

    def where(self, condition: Column) -> "DataFrame":
        if not isinstance(condition, Column):
            raise TypeError(
                "localspark where() takes a Column expression "
                "(use functions.col); string predicates are not supported"
            )

        def parts():
            for pid, part in enumerate(self._parts()):
                out, off = [], 0
                for b in part:
                    mask = condition.evaluate(b, pid, off)
                    off += b.num_rows
                    out.append(b.filter(mask))
                yield out

        return self._derive(self._schema, parts)

    filter = where

    def sample(self, withReplacement=None, fraction=None, seed=None) -> "DataFrame":
        # pyspark allows sample(fraction=f, seed=s) or sample(False, f, s);
        # it also forgives sample(f) and sample(f, s) positionally
        if isinstance(withReplacement, float):
            withReplacement, fraction, seed = False, withReplacement, fraction
        if withReplacement:
            raise NotImplementedError("localspark sample: withReplacement=False only")
        if not 0.0 <= fraction <= 1.0:
            raise ValueError(f"fraction must be in [0, 1], got {fraction}")
        seed = 0 if seed is None else int(seed)

        def parts():
            for pid, part in enumerate(self._parts()):
                rng = np.random.default_rng((seed, pid))
                out = []
                for b in part:
                    mask = rng.random(b.num_rows) < fraction  # Bernoulli per row
                    out.append(b.filter(pa.array(mask)))
                yield out

        return self._derive(self._schema, parts)

    def randomSplit(self, weights: list[float], seed: int | None = None) -> list["DataFrame"]:
        if any(w <= 0 for w in weights):
            raise ValueError("randomSplit weights must be positive")
        total = float(sum(weights))
        bounds = np.cumsum([w / total for w in weights])
        seed = 0 if seed is None else int(seed)

        def parts_for(lo: float, hi: float):
            def parts():
                for pid, part in enumerate(self._parts()):
                    rng = np.random.default_rng((seed, pid))
                    out = []
                    for b in part:
                        u = rng.random(b.num_rows)
                        out.append(b.filter(pa.array((u >= lo) & (u < hi))))
                    yield out

            return parts

        lows = [0.0] + list(bounds[:-1])
        return [
            self._derive(self._schema, parts_for(lo, hi))
            for lo, hi in zip(lows, bounds)
        ]

    def union(self, other: "DataFrame") -> "DataFrame":
        """Concatenate rows POSITIONALLY (pyspark ``union`` semantics):
        ``other``'s i-th column becomes this DataFrame's i-th column
        regardless of its name, so the result's batches all carry THIS
        schema's names and later name-based ops stay aligned."""
        if len(self._schema.fields) != len(other._schema.fields):
            raise ValueError(
                f"union requires the same number of columns: "
                f"{len(self._schema.fields)} vs {len(other._schema.fields)}"
            )
        names = [f.name for f in self._schema.fields]

        def parts():
            yield from self._parts()
            for part in other._parts():
                yield [
                    pa.RecordBatch.from_arrays(list(b.columns), names=names)
                    for b in part
                ]

        return self._derive(
            self._schema, parts, self.rdd.getNumPartitions() + other.rdd.getNumPartitions()
        )

    unionAll = union  # pyspark alias

    def limit(self, n: int) -> "DataFrame":
        def parts():
            remaining = n
            for part in self._parts():
                if remaining <= 0:
                    yield []
                    continue
                out = []
                for b in part:
                    if remaining <= 0:
                        break
                    take = min(remaining, b.num_rows)
                    out.append(b.slice(0, take))
                    remaining -= take
                yield out

        return self._derive(self._schema, parts)

    def repartition(self, numPartitions: int) -> "DataFrame":
        if numPartitions < 1:
            raise ValueError("numPartitions must be >= 1")

        def parts():
            table = self._to_table()
            n_rows = table.num_rows
            # contiguous near-equal slices, like a round-robin shuffle's result
            cuts = np.linspace(0, n_rows, numPartitions + 1).astype(int)
            for lo, hi in zip(cuts[:-1], cuts[1:]):
                yield table.slice(lo, hi - lo).to_batches() if hi > lo else []

        return self._derive(self._schema, parts, num_partitions=numPartitions)

    # -- the execution boundary --------------------------------------------

    def mapInArrow(self, func, schema, barrier: bool = False) -> "DataFrame":
        """pyspark 3.5 signature incl. ``barrier``: when True all partition
        tasks launch simultaneously with a BarrierTaskContext (the surface an
        SPMD bootstrap of a process group needs — see the session's docstring)."""
        if isinstance(schema, str):
            raise TypeError(
                "localspark mapInArrow takes a StructType schema, not a DDL string"
            )
        out_schema: T.StructType = schema
        arrow_target = out_schema.to_arrow()
        session = self._session

        def parts():
            task_parts = [
                session._chunk_batches(part, self._arrow_schema())
                for part in self._parts()
            ]
            runner = (
                session._run_map_in_arrow_barrier
                if barrier
                else session._run_map_in_arrow
            )
            yield from runner(func, task_parts, arrow_target)

        return self._derive(out_schema, parts)

    # -- actions ------------------------------------------------------------

    def _arrow_schema(self) -> pa.Schema:
        return self._schema.to_arrow()

    def _to_table(self) -> pa.Table:
        batches = [b for part in self._parts() for b in part if b.num_rows]
        if not batches:
            return pa.Table.from_batches([], schema=self._arrow_schema())
        return pa.Table.from_batches(batches)

    def toArrow(self) -> pa.Table:
        return self._to_table()

    def toPandas(self):
        return self._to_table().to_pandas()

    def collect(self) -> list[Row]:
        names = self._schema.names
        rows: list[Row] = []
        for part in self._parts():
            for b in part:
                cols = [c.to_pylist() for c in b.columns]
                for vals in zip(*cols):
                    rows.append(Row([_value_to_python(v) for v in vals], names))
        return rows

    def first(self) -> Row | None:
        head = self.head(1)
        return head[0] if head else None

    def head(self, n: int = 1) -> list[Row]:
        names = self._schema.names
        rows: list[Row] = []
        for part in self._parts():
            for b in part:
                if not b.num_rows:
                    continue
                # slice BEFORE to_pylist — converting a whole multi-thousand
                # row batch to Python objects to peek at one row dominates
                # fit() setup time (nCols inference does head(1))
                sl = b.slice(0, n - len(rows))
                cols = [c.to_pylist() for c in sl.columns]
                for vals in zip(*cols):
                    rows.append(Row([_value_to_python(v) for v in vals], names))
                if len(rows) >= n:
                    return rows
        return rows

    def count(self) -> int:
        return sum(b.num_rows for part in self._parts() for b in part)

    def cache(self) -> "DataFrame":
        materialized = [list(part) for part in self._parts()]

        def parts():
            return iter(materialized)

        return self._derive(self._schema, parts, num_partitions=len(materialized))

    persist = cache

    def unpersist(self) -> "DataFrame":
        return self

    def show(self, n: int = 20) -> None:
        for row in itertools.islice(self.collect(), n):
            print(row)


def dataframe_from_partitions(
    session, schema: T.StructType, partitions: list[list[pa.RecordBatch]]
) -> DataFrame:
    def parts():
        return iter(partitions)

    return DataFrame(session, schema, parts, len(partitions))


def _infer_type(value: Any) -> T.DataType:
    if isinstance(value, bool):
        return T.BooleanType()
    if isinstance(value, (int, np.integer)):
        return T.LongType()
    if isinstance(value, (float, np.floating)):
        return T.DoubleType()
    if isinstance(value, str):
        return T.StringType()
    if isinstance(value, (list, tuple, np.ndarray)):
        if len(value) == 0:
            return T.ArrayType(T.DoubleType())
        return T.ArrayType(_infer_type(value[0]))
    raise TypeError(f"cannot infer localspark type for {type(value).__name__}")
