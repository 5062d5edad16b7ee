"""Executor-side Arrow plan functions of the Spark glue, the PCA subset.

Port of the PCA part of ``spark_rapids_ml_tpu/spark/arrow_fns.py``: the
functions that run inside a Spark (or local Spark) Python worker as
``mapInArrow`` bodies, free of pyspark, and the driver's codecs of their
one-row statistics batches.

- ``FitPartitionFn``: a partition's ``GramStats``, one Gram per incoming
  batch at the function's ``precision`` (``"high"`` launches
  ``fused_gram_moments`` on the card), summed on the device;
- ``QRPartitionFn``: a partition's R factor (the direct fit), merged on the
  driver by a ``combine_r`` tree (``r_from_batches``);
- ``MomentsPartitionFn``: a partition's ``MomentStats`` (the direct fit's
  global mean for ``meanCentering``);
- ``TransformPartitionFn``: each batch projected on the device, the output
  list column appended; it books the ``transform.*`` series per partition
  (``_InstrumentedTransformFn``), which the worker's telemetry trailer
  brings to the driver's ``TransformReport``.

**Serialization.** Each plan function is a class instance whose state is
plain data: column names, the precision, the device as a string, host
ndarrays. Tensors are made inside the worker, and a function's device copy
of the components is never pickled. ``device`` is resolved in the worker:
one that asks for ``"cuda"`` in a worker started under
``worker_platform="cpu"`` (which hides the cards) raises there, naming
both settings; nothing falls back to the CPU.

**The stats batches** are the JAX package's layout: one row, each field a
flattened float64 list column (``arrays_to_batch``), so a batch made by
either package decodes in the other. Each stats function's array body is
``partition_stats(batches)``, which ``__call__`` wraps with the codec; it
reads any batch that ``utils.columnar.extract_matrix`` reads (an Arrow
``RecordBatch`` in a worker, or a frame of named columns), so it runs on
the card without pyarrow. pyarrow is imported only by the functions that
build or read Arrow batches.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.ops import linalg as L
from spark_rapids_ml_tpu_torch.ops import scaler as S
from spark_rapids_ml_tpu_torch.parallel.tree_aggregate import tree_reduce
from spark_rapids_ml_tpu_torch.telemetry import costmodel
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY
from spark_rapids_ml_tpu_torch.telemetry.timeline import TIMELINE
from spark_rapids_ml_tpu_torch.utils import columnar, devicepolicy
from spark_rapids_ml_tpu_torch.utils.device import resolve_device, to_device


def worker_device(device: str | torch.device) -> torch.device:
    """The ``torch.device`` a plan function computes on, resolved where it
    runs. Asking for CUDA in a process whose cards the worker policy hid
    raises a message naming both settings; asking for it where there is no
    card raises as every entry point does."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available() and (
        os.environ.get(devicepolicy.PLATFORM_VAR) == "cpu"
    ):
        raise RuntimeError(
            f"this plan function computes on device={str(device)!r}, but its worker "
            "was started under worker_platform='cpu' "
            f"({devicepolicy.CUDA_VISIBLE_DEVICES_VAR}=''), which hides the cards: "
            "start the session with worker_platform='cuda', or give the estimator "
            "device='cpu'"
        )
    return resolve_device(dev)


def _num_rows(batch) -> int:
    rows = getattr(batch, "num_rows", None)
    return len(batch) if rows is None else int(rows)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def _list_column(values: np.ndarray, row_len: int):
    """A flat float64 buffer as a list column of equal rows: variable-size
    lists, the Arrow type Spark's ArrayType maps to at mapInArrow."""
    import pyarrow as pa

    offsets = pa.array(np.arange(0, values.size + 1, row_len, dtype=np.int32))
    return pa.ListArray.from_arrays(offsets, pa.array(values))


def _gram_shapes(n: int) -> dict[str, tuple]:
    return {"xtx": (n, n), "col_sum": (n,), "count": ()}


def _table(batch):
    import pyarrow as pa

    return pa.Table.from_batches([batch]) if isinstance(batch, pa.RecordBatch) else batch


# -- the statistics codecs ----------------------------------------------------


def arrays_schema(fields: list[str]):
    import pyarrow as pa

    return pa.schema([pa.field(f, pa.list_(pa.float64())) for f in fields])


def arrays_to_batch(arrays: dict):
    """Named arrays (ndarrays or tensors) → a one-row RecordBatch of
    flattened float64 list columns."""
    import pyarrow as pa

    cols = []
    for a in arrays.values():
        flat = _host(a).reshape(-1)
        cols.append(_list_column(flat, flat.size))
    return pa.RecordBatch.from_arrays(cols, schema=arrays_schema(list(arrays)))


def arrays_from_batches(batches: Iterable, shapes: dict[str, tuple],
                        combine: dict[str, Callable] | None = None) -> dict[str, np.ndarray]:
    """Fold stats rows back into f64 arrays of ``shapes``: per field by
    ``np.add``, unless ``combine`` names another fold."""
    acc: dict[str, np.ndarray | None] = {name: None for name in shapes}
    fold = combine or {}
    for batch in batches:
        t = _table(batch)
        for i in range(t.num_rows):
            for name, shape in shapes.items():
                cur = np.asarray(
                    t.column(name)[i].values.to_numpy(zero_copy_only=False)
                ).reshape(shape)
                prev = acc[name]
                acc[name] = cur.copy() if prev is None else fold.get(name, np.add)(prev, cur)
    if any(v is None for v in acc.values()):
        raise ValueError("no partition statistics received")
    return acc


def arrays_from_rows(rows: Iterable, shapes: dict[str, tuple],
                     combine: dict[str, Callable] | None = None) -> dict[str, np.ndarray]:
    """``arrays_from_batches`` over collected row objects (pyspark < 4.0)."""
    acc: dict[str, np.ndarray | None] = {name: None for name in shapes}
    fold = combine or {}
    for r in rows:
        for name, shape in shapes.items():
            cur = np.asarray(r[name], dtype=np.float64).reshape(shape)
            prev = acc[name]
            acc[name] = cur.copy() if prev is None else fold.get(name, np.add)(prev, cur)
    if any(v is None for v in acc.values()):
        raise ValueError("no partition statistics received")
    return acc


def stats_to_batch(stats: L.GramStats):
    """``GramStats`` → its one-row stats batch."""
    return arrays_to_batch(dict(zip(stats._fields, stats)))


def stats_from_batches(batches: Iterable) -> L.GramStats:
    """The driver's merge of the partitions' stats rows: one ``GramStats``
    of f64 host arrays (the reference's ``cov.reduce(_ + _)``)."""
    tables = [_table(b) for b in batches]
    n = next((len(t.column("col_sum")[0]) for t in tables if t.num_rows), None)
    if n is None:
        raise ValueError("no partition statistics received")
    arr = arrays_from_batches(tables, _gram_shapes(n))
    return L.GramStats(arr["xtx"], arr["col_sum"], np.float64(arr["count"]))


def stats_from_rows(rows: Iterable) -> L.GramStats:
    """``stats_from_batches`` over collected rows with ``xtx``/``col_sum``/
    ``count`` (pyspark < 4.0, which has no ``toArrow``)."""
    rows = list(rows)
    if not rows:
        raise ValueError("no partition statistics received")
    n = len(np.asarray(rows[0]["col_sum"]).reshape(-1))
    arr = arrays_from_rows(rows, _gram_shapes(n))
    return L.GramStats(arr["xtx"], arr["col_sum"], np.float64(arr["count"]))


# -- the statistics plan functions ---------------------------------------------


class _StatsAccumulatorFn:
    """A plan function that folds a partition into one stats row.

    Subclasses give ``_batch_stats(batch, device)`` and ``_combine(a, b)``;
    ``partition_stats`` is the array body and ``__call__`` the mapInArrow
    body. An empty partition yields no row."""

    device: str = "cuda"

    def partition_stats(self, batches: Iterable):
        """The partition's statistics (tensors on the function's device),
        or None when it holds no rows."""
        device = None
        acc = None
        for batch in batches:
            if _num_rows(batch) == 0:
                continue
            if device is None:
                device = worker_device(self.device)
            stats = self._batch_stats(batch, device)
            acc = stats if acc is None else self._combine(acc, stats)
        return acc

    def __call__(self, batches: Iterator) -> Iterator:
        acc = self.partition_stats(batches)
        if acc is not None:
            yield arrays_to_batch(dict(zip(acc._fields, acc)))

    def _batch_stats(self, batch, device: torch.device):
        raise NotImplementedError

    def _combine(self, a, b):
        raise NotImplementedError


class FitPartitionFn(_StatsAccumulatorFn):
    """The fit pass's body: a partition's ``GramStats``, one bucket-padded
    Gram per batch on the device, booked as ``linalg.gram_stats`` against
    the cost model (RapidsRowMatrix.scala:122-137)."""

    def __init__(self, input_col: str, precision: str = "highest", device: str = "cuda"):
        self.input_col = input_col
        self.precision = precision
        self.device = str(device)

    def _batch_stats(self, batch, device):
        padded, true_rows = columnar.pad_rows(columnar.extract_matrix(batch, self.input_col))
        xd = to_device(padded, device)
        costmodel.capture("linalg.gram_stats", L.gram_stats, xd, precision=self.precision)
        stats = L.gram_stats(xd, precision=self.precision)
        # padding adds zero rows: fix only the count
        return L.GramStats(stats.xtx, stats.col_sum, torch.full_like(stats.count, true_rows))

    def _combine(self, a, b):
        return L.combine_gram_stats(a, b)


class MomentsPartitionFn(_StatsAccumulatorFn):
    """A partition's ``MomentStats`` (count, Σx, Σx²), the direct fit's
    global mean for ``meanCentering``."""

    def __init__(self, input_col: str, device: str = "cuda"):
        self.input_col = input_col
        self.device = str(device)

    def _batch_stats(self, batch, device):
        padded, true_rows = columnar.pad_rows(columnar.extract_matrix(batch, self.input_col))
        stats = S.moment_stats(to_device(padded, device))
        return S.MomentStats(torch.full_like(stats.count, true_rows), stats.total,
                             stats.total_sq)

    def _combine(self, a, b):
        return S.combine_moment_stats(a, b)


class QRPartitionFn:
    """The direct fit's body: a partition's rows folded into one [n, n] R
    factor (``qr_r``, then ``combine_r`` per batch; RᵀR = XᵀX at cond(X)).
    ``mean`` (from the moments pass) centers the rows before padding, so
    pad rows stay zero."""

    def __init__(self, input_col: str, mean: np.ndarray | None = None, device: str = "cuda"):
        self.input_col = input_col
        self.mean = None if mean is None else np.asarray(mean, dtype=np.float64)
        self.device = str(device)

    def partition_r(self, batches: Iterable) -> torch.Tensor | None:
        """The partition's R on the device, or None when it holds no rows."""
        device = None
        r = None
        for batch in batches:
            if _num_rows(batch) == 0:
                continue
            if device is None:
                device = worker_device(self.device)
            mat = columnar.extract_matrix(batch, self.input_col)
            if self.mean is not None:
                mat = mat - self.mean.astype(mat.dtype)[None, :]
            padded, _ = columnar.pad_rows(mat)
            rb = L.qr_r(to_device(padded, device))
            r = rb if r is None else L.combine_r(r, rb)
        return r

    def __call__(self, batches: Iterator) -> Iterator:
        r = self.partition_r(batches)
        if r is not None:
            yield arrays_to_batch({"r": r})


def _reduce_r(flats: list[np.ndarray], n: int, device) -> torch.Tensor:
    if not flats:
        raise ValueError("no partition R factors received")
    dev = resolve_device(device)
    rs = [torch.from_numpy(np.array(f, dtype=np.float32).reshape(n, n)).to(dev) for f in flats]
    return tree_reduce(rs, L.combine_r)


def r_from_batches(batches: Iterable, n: int, device: str | torch.device = "cuda"
                   ) -> torch.Tensor:
    """The driver's merge of the partitions' R rows: a balanced
    ``combine_r`` tree (QR of stacked pairs, not a sum) on ``device``."""
    flats = []
    for b in batches:
        t = _table(b)
        flats += [np.asarray(t.column("r")[i].values.to_numpy(zero_copy_only=False))
                  for i in range(t.num_rows)]
    return _reduce_r(flats, n, device)


def r_from_rows(rows: Iterable, n: int, device: str | torch.device = "cuda") -> torch.Tensor:
    """``r_from_batches`` over collected rows (pyspark < 4.0)."""
    return _reduce_r([np.asarray(r["r"], dtype=np.float64) for r in rows], n, device)


# -- the transform -------------------------------------------------------------

_transform_nesting = threading.local()


class _InstrumentedTransformFn:
    """Per-partition accounting shared by the transform bodies: ``__call__``
    wraps ``_run`` with the ``transform.rows``/``transform.bytes``/
    ``transform.batches`` counters, a ``transform.partition_seconds`` sample
    and a ``transform.partition`` timeline span, labelled ``fn=<class>``,
    booked in a ``finally`` so a partition that dies still reports what it
    read. Only the outermost of chained bodies books the volume counters
    (a thread-local depth), so a row is counted once."""

    def __call__(self, batches: Iterator) -> Iterator:
        fn = type(self).__name__
        rows = nbytes = nbatches = 0

        def counted(src):
            nonlocal rows, nbytes, nbatches
            for b in src:
                rows += b.num_rows
                nbytes += b.nbytes
                nbatches += 1
                yield b

        entry_depth = getattr(_transform_nesting, "depth", 0)
        _transform_nesting.depth = entry_depth + 1
        t0 = time.perf_counter()
        try:
            yield from self._run(counted(batches))
        finally:
            _transform_nesting.depth = entry_depth
            t1 = time.perf_counter()
            if entry_depth == 0:
                REGISTRY.counter_inc("transform.rows", rows, fn=fn)
                REGISTRY.counter_inc("transform.bytes", nbytes, fn=fn)
                REGISTRY.counter_inc("transform.batches", nbatches, fn=fn)
            REGISTRY.histogram_record("transform.partition_seconds", t1 - t0, fn=fn)
            TIMELINE.record_span("transform.partition", t0, t1, fn=fn, rows=rows)

    def _run(self, batches: Iterator) -> Iterator:
        raise NotImplementedError


class TransformPartitionFn(_InstrumentedTransformFn):
    """The batched projection (the reference's columnar UDF,
    RapidsPCA.scala:130-155): each batch standardized where the model is,
    padded, projected on the device, and re-emitted with the float64
    ArrayType output column appended. ``pc`` travels as a host ndarray and
    is copied to the device once per worker."""

    def __init__(self, input_col: str, output_col: str, pc: np.ndarray,
                 mean: np.ndarray | None = None, std: np.ndarray | None = None,
                 device: str = "cuda"):
        self.input_col = input_col
        self.output_col = output_col
        self.pc = np.asarray(pc)
        self.mean = None if mean is None else np.asarray(mean)
        self.std = None if std is None else np.asarray(std)
        self.device = str(device)
        self._pc_dev = None  # this process's device copy; never pickled

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_pc_dev"] = None
        return state

    def project_matrix(self, mat: np.ndarray) -> np.ndarray:
        """The array body: [rows, n] host rows → [rows, k] projections."""
        padded, true_rows = columnar.pad_rows(columnar.standardize_host(mat, self.mean, self.std))
        if self._pc_dev is None:
            self._pc_dev = to_device(self.pc, worker_device(self.device))
        xd = to_device(padded, self._pc_dev.device)
        costmodel.capture("linalg.project", L.project, xd, self._pc_dev)
        return L.project(xd, self._pc_dev)[:true_rows].cpu().numpy()

    def _run(self, batches):
        import pyarrow as pa

        for batch in batches:
            if batch.num_rows == 0:
                continue
            out = self.project_matrix(columnar.extract_matrix(batch, self.input_col))
            col = _list_column(out.astype(np.float64).reshape(-1), out.shape[1])
            yield pa.RecordBatch.from_arrays(
                [*batch.columns, col],
                schema=batch.schema.append(pa.field(self.output_col, col.type)),
            )


# -- the factories ---------------------------------------------------------------


def make_fit_partition_fn(input_col: str, *, precision: str = "highest",
                          device: str = "cuda") -> FitPartitionFn:
    return FitPartitionFn(input_col, precision, device)


def make_moments_partition_fn(input_col: str, *, device: str = "cuda") -> MomentsPartitionFn:
    return MomentsPartitionFn(input_col, device)


def make_transform_partition_fn(input_col: str, output_col: str, pc: np.ndarray,
                                mean: np.ndarray | None = None,
                                std: np.ndarray | None = None, *,
                                device: str = "cuda") -> TransformPartitionFn:
    return TransformPartitionFn(input_col, output_col, pc, mean, std, device)


def transform_output_schema(input_schema, output_col: str):
    """The transform's Arrow schema: the input's columns and the float64
    list output (``transformSchema``, RapidsPCA.scala:168-175)."""
    import pyarrow as pa

    return input_schema.append(pa.field(output_col, pa.list_(pa.float64())))
