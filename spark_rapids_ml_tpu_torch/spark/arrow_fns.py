"""Executor-side Arrow plan functions of the Spark glue.

Port of ``spark_rapids_ml_tpu/spark/arrow_fns.py``: the functions that run
inside a Spark (or local Spark) Python worker as ``mapInArrow`` bodies,
free of pyspark, and the driver's codecs of their one-row statistics
batches.

- the PCA and TruncatedSVD fit: ``FitPartitionFn`` (a partition's
  ``GramStats``, one Gram per batch at the function's ``precision``;
  ``"high"`` launches ``fused_gram_moments`` on the card),
  ``QRPartitionFn`` (a partition's R factor, merged by a ``combine_r``
  tree, ``r_from_batches``) and ``MomentsPartitionFn`` (``MomentStats``,
  also StandardScaler's and the variance selector's);
- the linear family: ``LinRegPartitionFn`` (``LinearStats``),
  ``LogRegNewtonPartitionFn`` and ``SoftmaxNewtonPartitionFn`` (one Newton
  iteration's statistics at the parameters in the task state),
  ``LabelScanPartitionFn`` (distinct labels, merged by union);
- KMeans: ``KMeansPartitionFn`` (one Lloyd iteration's ``KMeansStats``),
  ``KMeansAssignStatsFn`` (k-means‖'s cost and weighting passes) and
  ``KMeansParallelSampleFn`` (its Bernoulli oversampling, whose output is
  rows, not statistics);
- the feature statistics: ``RangeStatsPartitionFn``,
  ``HistogramPartitionFn``, ``NanMomentsPartitionFn`` and
  ``NanRangePartitionFn``;
- the transforms: ``TransformPartitionFn`` (the PCA projection),
  ``MatrixMapPartitionFn``, ``MultiOutputPartitionFn`` and
  ``ProbaPredictionPartitionFn`` (a model's bound matrix method, one or
  more appended columns). Each books the ``transform.*`` series per
  partition (``_InstrumentedTransformFn``), which the worker's telemetry
  trailer brings to the driver's ``TransformReport``.

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
the card without pyarrow. A labeled body reads its label and weight
columns through ``columnar.extract_vector``, which reads both containers
too. The transform bodies' array body is ``map_matrix``. pyarrow is
imported only by the functions that build or read Arrow batches.

The linear, KMeans and NaN-moments bodies widen each batch's f32
statistics to f64 before they sum them (the linear core fit's partitions
do the same), and the driver merges every body's partitions in f64.
"""

from __future__ import annotations

import os
import threading
import time
import zlib
from typing import Callable, Iterable, Iterator, NamedTuple

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.ops import kmeans as KM
from spark_rapids_ml_tpu_torch.ops import linalg as L
from spark_rapids_ml_tpu_torch.ops import linear as LIN
from spark_rapids_ml_tpu_torch.ops import scaler as S
from spark_rapids_ml_tpu_torch.parallel.tree_aggregate import tree_reduce
from spark_rapids_ml_tpu_torch.telemetry import costmodel
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY
from spark_rapids_ml_tpu_torch.telemetry.timeline import TIMELINE
from spark_rapids_ml_tpu_torch.utils import columnar, devicepolicy
from spark_rapids_ml_tpu_torch.utils.device import (
    block_rows_for,
    resolve_device,
    to_device,
    to_device_augmented,
)


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

    def __init__(self, input_col: str, precision: str = "highest", device: str = "cuda",
                 exact_diagonal: bool = True):
        self.input_col = input_col
        self.precision = precision
        self.device = str(device)
        self.exact_diagonal = exact_diagonal  # linalg's rule at "default"

    def _batch_stats(self, batch, device):
        padded, true_rows = columnar.pad_rows(columnar.extract_matrix(batch, self.input_col))
        xd = to_device(padded, device)
        costmodel.capture("linalg.gram_stats", L.gram_stats, xd, precision=self.precision)
        stats = L.gram_stats(xd, precision=self.precision,
                             exact_diagonal=self.exact_diagonal)
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


# -- the labeled and KMeans bodies --------------------------------------------


def _labeled_from_batch(batch, features_col: str, label_col: str, weight_col: str | None,
                        *, binary: bool = False):
    """(x, y f64, instance weights f64 or None) of one batch: an Arrow
    ``RecordBatch`` or a frame of named columns (``columnar.extract_vector``
    reads both), so the labeled bodies run without pyarrow."""
    mat = columnar.extract_matrix(batch, features_col)
    y = columnar.extract_vector(batch, label_col)
    if binary and not np.all(np.isin(y, (0.0, 1.0))):
        raise ValueError(
            f"binary logistic regression requires 0/1 labels, got {np.unique(y)[:8]}"
        )
    sw = None
    if weight_col:
        sw = columnar.validate_weights(
            columnar.extract_vector(batch, weight_col), len(mat), allow_all_zero=True
        )
    return mat, y, sw


def _row_weights(batch, weight_col: str | None, rows: int) -> np.ndarray:
    """The batch's instance weights (f64), 1 where the function has none."""
    if not weight_col:
        return np.ones(rows)
    return columnar.validate_weights(
        columnar.extract_vector(batch, weight_col), rows, allow_all_zero=True
    )


def _weights_on(sw: np.ndarray | None, device: torch.device) -> torch.Tensor | None:
    return None if sw is None else to_device(sw, device)


class LinRegPartitionFn(_StatsAccumulatorFn):
    """A partition's ``LinearStats`` (weighted), each batch's f32 products
    widened to f64 before the sum, as the core fit's partitions are."""

    def __init__(self, features_col: str, label_col: str, weight_col: str | None = None,
                 device: str = "cuda"):
        self.features_col = features_col
        self.label_col = label_col
        self.weight_col = weight_col
        self.device = str(device)

    def _batch_stats(self, batch, device):
        mat, y, sw = _labeled_from_batch(batch, self.features_col, self.label_col,
                                         self.weight_col)
        return LIN.as_f64(LIN.linear_stats(
            to_device(mat, device), to_device(y, device), _weights_on(sw, device)))

    def _combine(self, a, b):
        return LIN.combine_linear_stats(a, b)


class LogRegNewtonPartitionFn(_StatsAccumulatorFn):
    """One binary Newton iteration's ``NewtonStats`` over a partition: the
    driver runs one job per iteration with the current parameters in the
    task state. ``w_full`` is a host f64 ndarray, made a tensor in the
    worker."""

    def __init__(self, features_col: str, label_col: str, w_full: np.ndarray, *,
                 fit_intercept: bool = True, weight_col: str | None = None,
                 device: str = "cuda"):
        self.features_col = features_col
        self.label_col = label_col
        self.w_full = np.asarray(w_full, dtype=np.float64)
        self.fit_intercept = fit_intercept
        self.weight_col = weight_col
        self.device = str(device)

    def _rows(self, mat: np.ndarray, device) -> torch.Tensor:
        return to_device_augmented(mat, device) if self.fit_intercept else to_device(mat, device)

    def _batch_stats(self, batch, device):
        mat, y, sw = _labeled_from_batch(batch, self.features_col, self.label_col,
                                         self.weight_col, binary=True)
        return LIN.logistic_newton_stats(
            self._rows(mat, device), to_device(y, device),
            torch.as_tensor(self.w_full, device=device), _weights_on(sw, device),
        )

    def _combine(self, a, b):
        return LIN.combine_newton_stats(a, b)


class SoftmaxNewtonPartitionFn(LogRegNewtonPartitionFn):
    """One multinomial Newton iteration's ``SoftmaxStats`` (the full
    [C·d, C·d] Fisher information) over a partition; ``w_flat`` is the
    flattened [C·d] parameter on the host, ``n_classes`` from the driver's
    label scan."""

    def __init__(self, features_col: str, label_col: str, w_flat: np.ndarray,
                 n_classes: int, *, fit_intercept: bool = True,
                 weight_col: str | None = None, device: str = "cuda"):
        super().__init__(features_col, label_col, w_flat, fit_intercept=fit_intercept,
                         weight_col=weight_col, device=device)
        self.n_classes = int(n_classes)

    def _batch_stats(self, batch, device):
        mat, y, sw = _labeled_from_batch(batch, self.features_col, self.label_col,
                                         self.weight_col)
        if not np.all((y == np.round(y)) & (y >= 0) & (y < self.n_classes)):
            raise ValueError(
                f"multinomial labels must be integers in [0, {self.n_classes}), "
                f"got {np.unique(y)[:8]}"
            )
        return LIN.softmax_newton_stats(
            self._rows(mat, device), torch.as_tensor(y.astype(np.int64), device=device),
            torch.as_tensor(self.w_full, device=device), self.n_classes,
            _weights_on(sw, device),
        )

    def _combine(self, a, b):
        return LIN.combine_softmax_stats(a, b)


class LabelScanPartitionFn:
    """A partition's distinct label values, the class count of the
    multinomial fit; merged on the driver by set union
    (``labels_from_batches``), not by sum. Host only."""

    def __init__(self, label_col: str):
        self.label_col = label_col

    def partition_labels(self, batches: Iterable) -> np.ndarray | None:
        uniq = None
        for batch in batches:
            if _num_rows(batch) == 0:
                continue
            y = np.unique(columnar.extract_vector(batch, self.label_col))
            uniq = y if uniq is None else np.union1d(uniq, y)
        return uniq

    def __call__(self, batches: Iterator) -> Iterator:
        uniq = self.partition_labels(batches)
        if uniq is not None:
            yield arrays_to_batch({"labels": uniq})


def _union_labels(values: Iterable[np.ndarray]) -> np.ndarray:
    out = None
    for vals in values:
        out = vals if out is None else np.union1d(out, vals)
    if out is None:
        raise ValueError("no labels received (empty dataset?)")
    return out


def labels_from_batches(batches: Iterable) -> np.ndarray:
    """Union of the partitions' distinct-label rows."""
    return _union_labels(
        np.asarray(t.column("labels")[i].values.to_numpy(zero_copy_only=False))
        for t in map(_table, batches) for i in range(t.num_rows)
    )


def labels_from_rows(rows: Iterable) -> np.ndarray:
    """``labels_from_batches`` over collected rows (pyspark < 4.0)."""
    return _union_labels(np.asarray(r["labels"], dtype=np.float64) for r in rows)


class _CentersFn(_StatsAccumulatorFn):
    """A body that holds host centres (f64) and copies them to its device
    once per call."""

    def __init__(self, input_col: str, centers: np.ndarray, weight_col: str | None = None,
                 device: str = "cuda"):
        self.input_col = input_col
        self.centers = np.asarray(centers, dtype=np.float64)
        self.weight_col = weight_col
        self.device = str(device)
        self._centers_dev = None  # this process's device copy; never pickled

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_centers_dev"] = None
        return state

    def _centers_on(self, device) -> torch.Tensor:
        if self._centers_dev is None:
            self._centers_dev = to_device(self.centers, device)
        return self._centers_dev

    def _block(self, device) -> int:
        return block_rows_for(device, KM.DEFAULT_BLOCK_ROWS, len(self.centers))


class KMeansPartitionFn(_CentersFn):
    """One Lloyd iteration's ``KMeansStats`` over a partition (one job per
    iteration, the centres in the task state), each batch's f32 sums
    widened to f64 before the sum."""

    def _batch_stats(self, batch, device):
        mat = columnar.extract_matrix(batch, self.input_col)
        w = _row_weights(batch, self.weight_col, len(mat))
        return LIN.as_f64(KM.kmeans_stats(
            to_device(mat, device), self._centers_on(device), _weights_on(w, device),
            block_rows=self._block(device),
        ))

    def _combine(self, a, b):
        return KM.combine_kmeans_stats(a, b)


class AssignStats(NamedTuple):
    counts: torch.Tensor  # [k] instance-weighted rows owned per centre
    cost: torch.Tensor    # [] Σ w·d²(x, C)


class KMeansAssignStatsFn(_CentersFn):
    """The k-means‖ assignment passes: per-candidate weighted row counts and
    the total Σ w·d², without the [k, n] sums the Lloyd body ships. The φ
    cost pass reads ``cost``, the candidate-weighting pass ``counts``."""

    def _batch_stats(self, batch, device):
        mat = columnar.extract_matrix(batch, self.input_col)
        w = torch.from_numpy(np.array(_row_weights(batch, self.weight_col, len(mat)))).to(device)
        labels, d2 = KM.assign_blocks(to_device(mat, device), self._centers_on(device),
                                      block_rows=self._block(device))
        counts = torch.zeros(len(self.centers), dtype=torch.float64, device=device)
        counts.index_add_(0, labels.long(), w)
        return AssignStats(counts, torch.dot(d2.double(), w))

    def _combine(self, a, b):
        return AssignStats(a.counts + b.counts, a.cost + b.cost)


class KMeansParallelSampleFn(_CentersFn):
    """One k-means‖ oversampling round: every row an independent Bernoulli
    trial with p = min(1, ℓ·w·d²/φ); the rows drawn come back as data, a
    ``candidate`` list column. Each batch's generator is seeded from
    (seed, crc32 of its first row's f64 bytes ^ its row count), the JAX
    package's rule, so both packages draw the same uniforms for the same
    rows; d² is the f32 distance on the device."""

    def __init__(self, input_col: str, centers: np.ndarray, ell_over_phi: float, seed: int,
                 weight_col: str | None = None, device: str = "cuda"):
        super().__init__(input_col, centers, weight_col, device)
        self.ell_over_phi = float(ell_over_phi)
        self.seed = int(seed)

    def sample_mask(self, batch, device) -> tuple[np.ndarray, np.ndarray]:
        """(the batch's rows, the [rows] bool mask of the trials that drew
        them)."""
        mat = columnar.extract_matrix(batch, self.input_col)
        w = _row_weights(batch, self.weight_col, len(mat))
        d2 = KM.assign_blocks(to_device(mat, device), self._centers_on(device),
                              block_rows=self._block(device))[1].double().cpu().numpy()
        p = np.minimum(1.0, self.ell_over_phi * w * d2)
        h = zlib.crc32(np.ascontiguousarray(mat[0], dtype=np.float64).tobytes()) ^ len(mat)
        return mat, np.random.default_rng([self.seed, h]).random(len(mat)) < p

    def sample_batch(self, batch, device) -> np.ndarray:
        """The batch's drawn rows, [m, n] f64 (m may be 0)."""
        mat, sel = self.sample_mask(batch, device)
        return np.ascontiguousarray(mat[sel], dtype=np.float64)

    def _samples(self, batches: Iterable) -> Iterator[np.ndarray]:
        device = None
        for batch in batches:
            if _num_rows(batch) == 0:
                continue
            if device is None:
                device = worker_device(self.device)
            out = self.sample_batch(batch, device)
            if len(out):
                yield out

    def partition_candidates(self, batches: Iterable) -> np.ndarray:
        """The array body: every batch's drawn rows, [m, n] f64."""
        outs = list(self._samples(batches))
        return np.concatenate(outs) if outs else np.zeros((0, self.centers.shape[1]))

    def __call__(self, batches: Iterator) -> Iterator:
        import pyarrow as pa

        for out in self._samples(batches):
            yield pa.RecordBatch.from_arrays(
                [_list_column(out.reshape(-1), out.shape[1])],
                schema=pa.schema([pa.field("candidate", pa.list_(pa.float64()))]),
            )


def candidates_from_batches(batches: Iterable) -> np.ndarray:
    """The sampled candidate rows as one [m, n] f64 matrix ([0, 0] when
    none)."""
    mats = [columnar.extract_matrix(t, "candidate") for t in map(_table, batches)
            if t.num_rows]
    if not mats:
        return np.zeros((0, 0))
    return np.concatenate(mats, axis=0).astype(np.float64)


def candidates_from_rows(rows: Iterable) -> np.ndarray:
    """``candidates_from_batches`` over collected rows (pyspark < 4.0)."""
    mats = [np.asarray(r["candidate"], dtype=np.float64) for r in rows]
    return np.stack(mats) if mats else np.zeros((0, 0))


# -- the feature-statistics bodies ---------------------------------------------


class _MatrixStatsFn(_StatsAccumulatorFn):
    """A body over the input column alone: ``_stats(x, rows)`` on the
    batch's rows on the device (no bucket padding: nothing here compiles
    per shape)."""

    def __init__(self, input_col: str, device: str = "cuda"):
        self.input_col = input_col
        self.device = str(device)

    def _batch_stats(self, batch, device):
        mat = columnar.extract_matrix(batch, self.input_col)
        return self._stats(to_device(mat, device), len(mat))

    def _stats(self, x: torch.Tensor, rows: int):
        raise NotImplementedError


class RangeStatsPartitionFn(_MatrixStatsFn):
    """A partition's per-feature min / max / max |x| (``RangeStats``), the
    range scalers' and the quantile sketch's first pass; merged by
    ``RANGE_COMBINE``."""

    def _stats(self, x, rows):
        return S.range_stats(x, rows)

    def _combine(self, a, b):
        return S.combine_range_stats(a, b)


class HistStats(NamedTuple):
    hist: torch.Tensor  # [n, bins] per-feature counts


class HistogramPartitionFn(_MatrixStatsFn):
    """A partition's per-feature fixed-bin histogram over the driver's
    [mins, maxs] (the quantile sketch's second pass, RobustScaler and
    QuantileDiscretizer); with ``missing`` (Imputer's median) those entries
    go to the dropped overflow bin. Additive."""

    def __init__(self, input_col: str, mins, maxs, bins: int, missing=None,
                 device: str = "cuda"):
        super().__init__(input_col, device)
        self.mins = np.asarray(mins, dtype=np.float64)
        self.maxs = np.asarray(maxs, dtype=np.float64)
        self.bins = int(bins)
        self.missing = None if missing is None else float(missing)

    def _stats(self, x, rows):
        valid = None if self.missing is None else S.valid_mask(x, rows, self.missing)
        mins, maxs = (torch.as_tensor(v, dtype=x.dtype, device=x.device)
                      for v in (self.mins, self.maxs))
        return HistStats(S.histogram_stats(x, rows, mins, maxs, bins=self.bins, valid=valid))

    def _combine(self, a, b):
        return HistStats(a.hist + b.hist)


class NanMomentsPartitionFn(_MatrixStatsFn):
    """The Imputer's mean pass: per-feature counts and sums of the entries
    that are not ``missing``, widened to f64 per batch."""

    def __init__(self, input_col: str, missing: float, device: str = "cuda"):
        super().__init__(input_col, device)
        self.missing = float(missing)

    def _stats(self, x, rows):
        return LIN.as_f64(S.nan_moment_stats(x, rows, self.missing))

    def _combine(self, a, b):
        return S.combine_nan_moment_stats(a, b)


class NanRangePartitionFn(NanMomentsPartitionFn):
    """The Imputer median's range pass: per-feature valid counts, min and
    max over the entries that are not ``missing``; merged by
    ``RANGE_COMBINE``."""

    def _stats(self, x, rows):
        return S.nan_range_stats(x, rows, self.missing)

    def _combine(self, a, b):
        return S.combine_nan_range_stats(a, b)


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


class _MatrixBodyFn(_InstrumentedTransformFn):
    """A transform body around a model's bound host-matrix method
    (``matrix_fn``: [rows, n] ndarray in, arrays out), which ships to the
    worker by pickle with the model inside. ``device`` is the model's; it
    is resolved in the worker before the first batch, so a CUDA model in a
    worker whose cards are hidden raises there. ``map_matrix`` is the array
    body; ``_run`` appends its outputs to each Arrow batch."""

    def __init__(self, input_col: str, matrix_fn: Callable, device: str = "cuda"):
        self.input_col = input_col
        self.matrix_fn = matrix_fn
        self.device = str(device)

    def map_matrix(self, mat: np.ndarray) -> list[tuple[str, np.ndarray]]:
        raise NotImplementedError

    def _run(self, batches):
        import pyarrow as pa

        checked = False
        for batch in batches:
            if batch.num_rows == 0:
                continue
            if not checked:
                worker_device(self.device)
                checked = True
            cols, schema = list(batch.columns), batch.schema
            for name, out in self.map_matrix(columnar.extract_matrix(batch, self.input_col)):
                col = (_list_column(out.reshape(-1), out.shape[1]) if out.ndim == 2
                       else pa.array(out))
                cols.append(col)
                schema = schema.append(pa.field(name, col.type))
            yield pa.RecordBatch.from_arrays(cols, schema=schema)


class MatrixMapPartitionFn(_MatrixBodyFn):
    """The generic model transform: ``matrix_fn(mat)`` appended as one
    float64 column, a list column when 2-D (ArrayType), a scalar column
    when 1-D (predictions)."""

    def __init__(self, input_col: str, output_col: str, matrix_fn: Callable,
                 device: str = "cuda"):
        super().__init__(input_col, matrix_fn, device)
        self.output_col = output_col

    def map_matrix(self, mat):
        return [(self.output_col, np.asarray(self.matrix_fn(mat)).astype(np.float64, copy=False))]


class MultiOutputPartitionFn(_MatrixBodyFn):
    """A transform with any number of outputs from one pass:
    ``matrix_fn(mat)`` returns one array per ``(name, numpy dtype)`` of
    ``output_cols``, each cast to its dtype, since a mapInArrow batch must
    match the declared schema exactly."""

    def __init__(self, input_col: str, output_cols: list, matrix_fn: Callable,
                 device: str = "cuda"):
        super().__init__(input_col, matrix_fn, device)
        self.output_cols = [(n, np.dtype(d)) for n, d in output_cols]

    def map_matrix(self, mat):
        return [(name, np.asarray(out).astype(dtype, copy=False))
                for (name, dtype), out in zip(self.output_cols, self.matrix_fn(mat))]


class ProbaPredictionPartitionFn(_MatrixBodyFn):
    """A classifier's two Spark ML columns from one pass:
    ``probabilityCol`` ([1 − p, p] binary, the softmax row multinomial) and
    ``predictionCol``; ``proba_pred_fn`` is the model's bound
    ``proba_and_predictions``, the decision rule of its local transform."""

    def __init__(self, input_col: str, probability_col: str, prediction_col: str,
                 proba_pred_fn: Callable, device: str = "cuda"):
        super().__init__(input_col, proba_pred_fn, device)
        self.probability_col = probability_col
        self.prediction_col = prediction_col

    def map_matrix(self, mat):
        proba, pred = self.matrix_fn(mat)
        return [(self.probability_col, np.asarray(proba, dtype=np.float64)),
                (self.prediction_col, np.asarray(pred, dtype=np.float64))]


# -- the factories ---------------------------------------------------------------


def make_fit_partition_fn(input_col: str, *, precision: str = "highest",
                          device: str = "cuda", exact_diagonal: bool = True) -> FitPartitionFn:
    return FitPartitionFn(input_col, precision, device, exact_diagonal)


def make_moments_partition_fn(input_col: str, *, device: str = "cuda") -> MomentsPartitionFn:
    return MomentsPartitionFn(input_col, device)


def make_linreg_partition_fn(features_col: str, label_col: str, weight_col: str | None = None,
                             *, device: str = "cuda") -> LinRegPartitionFn:
    return LinRegPartitionFn(features_col, label_col, weight_col, device)


def make_logreg_newton_partition_fn(features_col: str, label_col: str, w_full: np.ndarray, *,
                                    fit_intercept: bool = True, weight_col: str | None = None,
                                    device: str = "cuda") -> LogRegNewtonPartitionFn:
    return LogRegNewtonPartitionFn(features_col, label_col, w_full,
                                   fit_intercept=fit_intercept, weight_col=weight_col,
                                   device=device)


def make_kmeans_partition_fn(input_col: str, centers: np.ndarray,
                             weight_col: str | None = None, *,
                             device: str = "cuda") -> KMeansPartitionFn:
    return KMeansPartitionFn(input_col, centers, weight_col, device)


def make_range_stats_partition_fn(input_col: str, *,
                                  device: str = "cuda") -> RangeStatsPartitionFn:
    return RangeStatsPartitionFn(input_col, device)


RANGE_STATS_FIELDS = ["count", "min", "max", "max_abs"]
RANGE_COMBINE = {"min": np.minimum, "max": np.maximum, "max_abs": np.maximum}


def range_stats_shapes(n: int) -> dict[str, tuple]:
    return {"count": (), "min": (n,), "max": (n,), "max_abs": (n,)}


def range_stats_from_batches(batches: Iterable, n: int) -> S.RangeStats:
    """The partitions' ``RangeStats`` rows merged on the driver: the count
    sums, the rest fold by elementwise min / max. f64 host arrays."""
    arr = arrays_from_batches(batches, range_stats_shapes(n), RANGE_COMBINE)
    return S.RangeStats(arr["count"], arr["min"], arr["max"], arr["max_abs"])


def range_stats_from_rows(rows: Iterable, n: int) -> S.RangeStats:
    """``range_stats_from_batches`` over collected rows (pyspark < 4.0)."""
    arr = arrays_from_rows(rows, range_stats_shapes(n), RANGE_COMBINE)
    return S.RangeStats(arr["count"], arr["min"], arr["max"], arr["max_abs"])


def make_matrix_map_partition_fn(input_col: str, output_col: str, matrix_fn: Callable, *,
                                 device: str = "cuda") -> MatrixMapPartitionFn:
    return MatrixMapPartitionFn(input_col, output_col, matrix_fn, device)


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
