"""Columnar input for the port: [rows, n] matrices out of the containers the
estimators accept, row bucketing, and the partitioned dataset.

Counterpart of ``spark_rapids_ml_tpu/utils/columnar.py``: besides the
matrices, scalar columns (``extract_vector``), a column of any kind for the
feature and text stages (``extract_column_values``), appended output columns
(``append_columns``), the weight-column contract that the clustering
estimators share (``validate_weights``, ``resolve_partition_weights``) and
the supervised estimators' labeled partitions (``labeled_partitions``,
``pad_labeled``, ``pad_labeled_batch``), and the Spark glue's row helpers
(``row_vector_to_ndarray``, ``feature_dim``, ``is_spark_dataframe``).
Accepted inputs: a 2-D ndarray, a pandas DataFrame whose column holds one
array per row, and a pyarrow Table or RecordBatch with a list or
fixed-size-list column (the reference's ArrayType input) or a Spark ML
VectorUDT column, dense or sparse rows (densified).

**The column protocol.** Any container that has these, pandas or not,
passes for a frame of named columns (``has_named_columns``,
``append_columns``, ``apply_column_transform``, ``extract_matrix``,
``extract_vector``, ``extract_column_values``):

- ``columns``: the column names;
- ``assign(**{name: values})``: a new container with those columns added,
  where ``values`` is a 1-D array or a list of per-row arrays;
- ``frame[name]``: the column, an object with ``to_numpy()`` (a 1-D array,
  the [rows, n] matrix itself, or per-row arrays that ``np.stack`` turns
  into it), ``iloc[0]`` (the first row's value) and ``len()``.

Model selection (``models/tuning.py``) also slices rows by
``frame.iloc[indices]`` and counts them by ``len(frame)``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Iterator

import numpy as np

from spark_rapids_ml_tpu_torch.utils.config import get_config

try:  # keep the core importable without pyarrow
    import pyarrow as pa
except ImportError:  # pragma: no cover
    pa = None


# pyspark.ml VectorUDT's Arrow layout: struct<type: int8, size: int32,
# indices: list<int32>, values: list<double>>, type 0 = sparse, 1 = dense.
_VECTOR_UDT_FIELDS = ("type", "size", "indices", "values")


def _is_vector_udt_struct(typ) -> bool:
    if not pa.types.is_struct(typ):
        return False
    names = {typ.field(i).name for i in range(typ.num_fields)}
    return names.issuperset(_VECTOR_UDT_FIELDS)


def _from_vector_struct_column(col) -> np.ndarray:
    """VectorUDT struct column → dense [rows, n]: dense rows reshape in one
    step, sparse rows scatter by their indices, with no per-row loop."""
    fields = {col.type.field(i).name: flat for i, flat in enumerate(col.flatten())}
    tcode = np.asarray(fields["type"].to_numpy(zero_copy_only=False))
    values = fields["values"]
    val_np = np.asarray(values.values.to_numpy(zero_copy_only=False))
    offsets = np.asarray(values.offsets.to_numpy(zero_copy_only=False))
    lengths = np.diff(offsets)
    if np.all(tcode == 1):  # all dense: one reshape
        n = int(lengths[0]) if len(lengths) else 0
        if not np.all(lengths == n):
            raise ValueError("ragged rows: all rows must have equal length")
        return val_np[offsets[0] : offsets[-1]].reshape(-1, n)
    sizes = np.asarray(fields["size"].to_numpy(zero_copy_only=False), dtype=np.float64)
    dims = np.where(tcode == 1, lengths, sizes)
    n = int(dims[0]) if len(dims) else 0
    if not np.all(dims == n):
        raise ValueError("ragged rows: all rows must have equal length")
    indices = fields["indices"]
    idx_np = np.asarray(indices.values.to_numpy(zero_copy_only=False))
    idx_offsets = np.asarray(indices.offsets.to_numpy(zero_copy_only=False))
    rows = len(tcode)
    out = np.zeros((rows, n), dtype=np.float64)
    dense = tcode == 1
    # the flat values buffer concatenates every row's list, so one repeat
    # mask splits dense from sparse values; the indices buffer holds only
    # the sparse rows' entries (a dense row's list is null, of length 0), so
    # it is already the flat column ids and its lengths give the row ids
    flat_vals = val_np[offsets[0] : offsets[-1]]
    sparse_mask = np.repeat(~dense, lengths)
    if dense.any():
        out[dense] = flat_vals[~sparse_mask].reshape(-1, n)
    if (~dense).any():
        col_ids = idx_np[idx_offsets[0] : idx_offsets[-1]]
        row_ids = np.repeat(np.arange(rows), np.diff(idx_offsets))
        out[row_ids, col_ids] = flat_vals[sparse_mask]
    return out


def _from_arrow_column(col) -> np.ndarray:
    """Arrow list / fixed_size_list column, or a Spark ML VectorUDT column
    (its struct, or an extension array over it), → [rows, n] ndarray,
    zero-copy where the values buffer allows it."""
    if isinstance(col, pa.ChunkedArray):
        if col.num_chunks == 1:
            return _from_arrow_column(col.chunk(0))
        return np.concatenate([_from_arrow_column(c) for c in col.chunks])
    if isinstance(col, pa.ExtensionArray):
        # a UDT ships as an extension array over its storage type
        return _from_arrow_column(col.storage)
    if col.null_count:
        raise ValueError("null rows are not supported in the input column")
    if _is_vector_udt_struct(col.type):
        return _from_vector_struct_column(col)
    if pa.types.is_fixed_size_list(col.type):
        n = col.type.list_size
        values = col.values.to_numpy(zero_copy_only=False)
        return values.reshape(-1, n)[col.offset : col.offset + len(col)]
    if pa.types.is_list(col.type) or pa.types.is_large_list(col.type):
        offsets = col.offsets.to_numpy(zero_copy_only=False)
        lengths = np.diff(offsets)
        if len(lengths) == 0:
            raise ValueError("empty input column")
        n = int(lengths[0])
        if not np.all(lengths == n):
            raise ValueError("ragged rows: all rows must have equal length")
        values = col.values.to_numpy(zero_copy_only=False)
        return values[offsets[0] : offsets[-1]].reshape(-1, n)
    raise TypeError(f"unsupported Arrow column type for ArrayType input: {col.type}")


def row_vector_to_ndarray(value: Any) -> np.ndarray:
    """One collected row value of a features column → [n] f64 ndarray: a
    list or ndarray (ArrayType), a pyspark.ml Vector (``toArray``), or the
    VectorUDT struct as a mapping."""
    if hasattr(value, "toArray"):  # pyspark.ml DenseVector / SparseVector
        return np.asarray(value.toArray(), dtype=np.float64)
    if isinstance(value, dict) and set(value).issuperset(_VECTOR_UDT_FIELDS):
        from spark_rapids_ml_tpu_torch.utils.persistence import struct_to_vector

        return struct_to_vector(value)
    return np.asarray(value, dtype=np.float64)


def feature_dim(value: Any) -> int:
    """Feature count of one collected row value, without densifying a
    sparse vector."""
    if hasattr(value, "size") and not isinstance(value, (list, tuple, np.ndarray)):
        return int(value.size)  # pyspark.ml Vector
    if isinstance(value, dict) and set(value).issuperset(_VECTOR_UDT_FIELDS):
        return len(value["values"]) if value["type"] == 1 else int(value["size"])
    return len(value)


def is_spark_dataframe(obj: Any) -> bool:
    """True for a pyspark DataFrame or one of the port's local Spark engine
    (``spark_rapids_ml_tpu_torch.localspark``). The JAX package's engine is
    not one: its workers would run the JAX package."""
    mod = type(obj).__module__ or ""
    return mod.startswith("pyspark.") or mod.startswith("spark_rapids_ml_tpu_torch.localspark")


def extract_matrix(data: Any, input_col: str | None = None) -> np.ndarray:
    """A [rows, n] matrix out of any container the estimators accept."""
    if pa is not None and isinstance(data, (pa.Table, pa.RecordBatch)):
        if input_col is None:
            raise ValueError("input_col is required for Arrow tables")
        return _from_arrow_column(data.column(input_col))
    if hasattr(data, "columns") and hasattr(data, "assign") and input_col is not None:
        rows = data[input_col].to_numpy()  # pandas: one array per row
        if rows.ndim == 2 and rows.dtype != object:
            return rows  # a frame that keeps the column as one matrix
        return np.stack([np.asarray(r) for r in rows])
    arr = np.asarray(data)
    if arr.ndim == 2:
        return arr
    if arr.ndim == 1 and arr.dtype == object:
        return np.stack([np.asarray(r) for r in arr])
    raise TypeError(
        f"cannot extract a [rows, n] matrix from {type(data).__name__}"
        + (f" column {input_col!r}" if input_col else "")
    )


def matrix_to_arrow_column(x: np.ndarray):
    """[rows, k] ndarray → Arrow FixedSizeList column."""
    _, k = x.shape
    values = pa.array(np.ascontiguousarray(x).reshape(-1))
    return pa.FixedSizeListArray.from_arrays(values, k)


def _output_column(out: np.ndarray):
    """Arrow column of a transform's output: a scalar column for [rows] (a
    KMeans prediction), a FixedSizeList for [rows, k]."""
    return pa.array(out) if out.ndim == 1 else matrix_to_arrow_column(out)


def apply_column_transform(dataset: Any, input_col: str | None, output_col: str, fn):
    """Apply a [rows, n] → [rows, k] (or [rows]) matrix function to the input
    column and append the result as ``output_col``, keeping the container
    type (a bare matrix in gives a bare matrix out)."""
    if pa is not None and isinstance(dataset, (pa.Table, pa.RecordBatch)):
        out = np.asarray(fn(extract_matrix(dataset, input_col)))
        if isinstance(dataset, pa.RecordBatch):
            dataset = pa.Table.from_batches([dataset])
        return dataset.append_column(output_col, _output_column(out))
    if hasattr(dataset, "columns") and hasattr(dataset, "assign") and input_col:
        out = np.asarray(fn(extract_matrix(dataset, input_col)))
        return dataset.assign(**{output_col: list(out) if out.ndim > 1 else out})
    if isinstance(dataset, PartitionedDataset):
        return PartitionedDataset(
            [np.asarray(fn(m)) for m in dataset.matrices()], dataset.input_col
        )
    return np.asarray(fn(extract_matrix(dataset, input_col)))


def append_columns(dataset: Any, columns) -> Any:
    """Append precomputed output columns ([(name, ndarray)], 1-D scalar or
    2-D array-valued) to a column-bearing container, keeping its type: the
    many-output sibling of ``apply_column_transform``."""
    if pa is not None and isinstance(dataset, (pa.Table, pa.RecordBatch)):
        if isinstance(dataset, pa.RecordBatch):
            dataset = pa.Table.from_batches([dataset])
        for name, out in columns:
            dataset = dataset.append_column(name, _output_column(np.asarray(out)))
        return dataset
    if hasattr(dataset, "columns") and hasattr(dataset, "assign"):
        return dataset.assign(**{
            name: list(np.asarray(out)) if np.asarray(out).ndim > 1 else np.asarray(out)
            for name, out in columns
        })
    raise TypeError(f"cannot append named columns to {type(dataset).__name__}")


def has_named_columns(dataset: Any) -> bool:
    """True for containers whose transform output carries named columns
    (Arrow tables and batches, pandas): the inputs where appending more
    than one output column means something."""
    if pa is not None and isinstance(dataset, (pa.Table, pa.RecordBatch)):
        return True
    return hasattr(dataset, "columns") and hasattr(dataset, "assign")


def extract_column_values(dataset: Any, col: str) -> np.ndarray:
    """A column as a 1-D string or float array, or a [rows, n] float matrix
    for an array-valued column: numeric shapes take the matrix and vector
    extractors, only string columns the Python-object path. Shared by the
    feature-engineering and text stages."""
    if pa is not None and isinstance(dataset, (pa.Table, pa.RecordBatch)):
        typ = dataset.schema.field(col).type
        if pa.types.is_list(typ) or pa.types.is_fixed_size_list(typ):
            return extract_matrix(dataset, col)
        if pa.types.is_string(typ) or pa.types.is_large_string(typ):
            return np.asarray(dataset.column(col).to_pylist())
        return extract_vector(dataset, col)
    if hasattr(dataset, "columns") and hasattr(dataset, "__getitem__"):
        series = dataset[col]
        first = series.iloc[0] if len(series) else None
        if isinstance(first, (list, tuple, np.ndarray)):
            return extract_matrix(dataset, col)
        arr = series.to_numpy() if hasattr(series, "to_numpy") else np.asarray(series)
        if np.issubdtype(arr.dtype, np.number):
            return extract_vector(dataset, col)
        return arr
    raise TypeError(f"cannot extract column {col!r} from {type(dataset).__name__}")


def extract_vector(data: Any, col: str) -> np.ndarray:
    """A scalar column (weights, ids) as a [rows] f64 vector."""
    if pa is not None and isinstance(data, (pa.Table, pa.RecordBatch)):
        return np.asarray(data.column(col).to_numpy(zero_copy_only=False), dtype=np.float64)
    if hasattr(data, "columns") and hasattr(data, "__getitem__"):
        series = data[col]
        if hasattr(series, "to_numpy"):
            return np.asarray(series.to_numpy(), dtype=np.float64)
    raise TypeError(f"cannot extract label column {col!r} from {type(data).__name__}")


def float_dtype_for(dtype) -> np.dtype:
    """The dtype side vectors (weights) take for a feature matrix: the
    matrix's own when floating, else f64, so that fractional values never
    floor into an integer buffer."""
    return dtype if np.issubdtype(dtype, np.floating) else np.dtype(np.float64)


def validate_weights(
    w: Any, n_rows: int | None = None, *, allow_all_zero: bool = False
) -> np.ndarray:
    """Spark's weightCol contract, checked in one place: 1-D, length-matched,
    non-negative, not all zero."""
    w = np.asarray(w, dtype=np.float64).reshape(-1)
    if n_rows is not None and len(w) != n_rows:
        raise ValueError(f"dataset has {n_rows} rows but weights have {len(w)}")
    if (w < 0).any():
        raise ValueError("instance weights must be non-negative")
    if not allow_all_zero and not (w > 0).any():
        raise ValueError("all instance weights are zero")
    return w


def resolve_partition_weights(
    dataset: Any,
    mats: list[np.ndarray],
    weight_col: str | None = None,
    sample_weight: Any | None = None,
) -> list[np.ndarray] | None:
    """Instance weights as per-partition slices aligned with ``mats`` (the
    partitions' matrices, in order), or None for an unweighted fit.

    Sources, in order of precedence: the ``sample_weight`` array argument
    (sklearn's), then ``weight_col`` extracted from the container, whole,
    or partition by partition for a ``PartitionedDataset`` of tables.
    """
    if sample_weight is None and not weight_col:
        return None
    total_rows = sum(len(m) for m in mats)
    if sample_weight is not None:
        sw = validate_weights(sample_weight, total_rows)
    else:
        try:
            sw = extract_vector(dataset, weight_col)
        except TypeError:
            if isinstance(dataset, PartitionedDataset):
                slices = [
                    validate_weights(
                        extract_vector(p, weight_col), len(m), allow_all_zero=True
                    )
                    for p, m in zip(dataset.partitions, mats)
                ]
                if not any((s > 0).any() for s in slices):
                    raise ValueError("all instance weights are zero")
                return slices
            raise
        sw = validate_weights(sw, total_rows)
    out, off = [], 0
    for m in mats:
        out.append(sw[off:off + len(m)])
        off += len(m)
    return out


def labeled_partitions(
    data: Any,
    features_col: str | None,
    label_col: str | None,
    num_partitions: int | None = None,
    weight_col: str | None = None,
) -> list[tuple[np.ndarray, np.ndarray, np.ndarray | None]]:
    """Supervised data as [(X, y, w or None), ...] partitions.

    Accepted: an (X, y) or (X, y, w) tuple of arrays, or a pandas or Arrow
    container with an array-valued features column, a scalar label column
    and optionally a scalar ``weight_col`` (Spark ML's ``featuresCol``/
    ``labelCol``/``weightCol``). Weights go through ``validate_weights``.
    ``num_partitions`` > 1 splits the rows into that many nearly equal
    slices (views, no copy)."""
    w = None
    if isinstance(data, tuple) and len(data) in (2, 3):
        x, y = np.asarray(data[0]), np.asarray(data[1], dtype=np.float64)
        if len(data) == 3 and data[2] is not None:
            w = data[2]
    else:
        x = extract_matrix(data, features_col)
        y = extract_vector(data, label_col)
        if weight_col:
            w = extract_vector(data, weight_col)
    if len(x) != len(y):
        raise ValueError(f"features have {len(x)} rows but labels have {len(y)}")
    if w is not None:
        w = validate_weights(w, len(x))
    n_split = num_partitions if num_partitions and num_partitions > 1 else 1
    xs = np.array_split(x, n_split)
    ys = np.array_split(y, n_split)
    ws = np.array_split(w, n_split) if w is not None else [None] * n_split
    return list(zip(xs, ys, ws))


def pad_labeled(
    x: np.ndarray,
    y: np.ndarray,
    weights: np.ndarray | None = None,
    *,
    min_bucket: int | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(padded x, padded y, w) of an (X, y[, w]) group bucket-padded on the
    host: ``w`` is 0 on pad rows and the instance weights (1 when none) on
    true rows, so the pad mask and the weighting are one vector."""
    padded, true_rows = pad_rows(x, min_bucket=min_bucket)
    dtype = float_dtype_for(padded.dtype)
    yp = np.zeros(padded.shape[0], dtype=dtype)
    yp[:true_rows] = y
    w = np.zeros(padded.shape[0], dtype=dtype)
    w[:true_rows] = 1.0 if weights is None else weights
    return padded, yp, w


def pad_labeled_batch(x, y, w=None):
    """(padded x, y, w, true_rows) of one whole batch: ``pad_labeled`` with
    the features first cast to a float dtype."""
    fdt = float_dtype_for(np.asarray(x).dtype)
    padded, true_rows = pad_rows(np.asarray(x).astype(fdt, copy=False))
    wv = np.zeros(padded.shape[0], fdt)
    wv[:true_rows] = 1.0 if w is None else w
    yv = np.zeros(padded.shape[0], fdt)
    yv[:true_rows] = y
    return padded, yv, wv, true_rows


def standardize_host(
    mat: np.ndarray, mean: np.ndarray | None, std: np.ndarray | None
) -> np.ndarray:
    """(x − μ)/σ on host rows, zero-variance features unscaled; a no-op when
    ``mean`` is None. Applied before padding, so pad rows stay zero."""
    if mean is None:
        return mat
    safe = np.where(std > 0, std, 1.0)
    return (mat - mean[None, :].astype(mat.dtype)) / safe[None, :].astype(mat.dtype)


def bucket_rows(rows: int, *, min_bucket: int | None = None) -> int:
    """Round a row count up to its power-of-two bucket, at least
    ``min_bucket`` (``TPU_ML_MIN_BUCKET``). Zero rows are exact for every
    reduction of the fit, and the true count travels beside them."""
    if min_bucket is None:
        min_bucket = get_config().min_bucket
    return max(min_bucket, 1 << math.ceil(math.log2(max(rows, 1))))


def pad_rows(x: np.ndarray, *, min_bucket: int | None = None) -> tuple[np.ndarray, int]:
    """Zero-pad [rows, n] to its row bucket; returns (padded, true_rows)."""
    rows = x.shape[0]
    bucket = bucket_rows(rows, min_bucket=min_bucket)
    if bucket == rows:
        return x, rows
    out = np.zeros((bucket, x.shape[1]), dtype=x.dtype)
    out[:rows] = x
    return out, rows


@dataclass
class PartitionedDataset:
    """An ordered list of columnar partitions with their input column."""

    partitions: list[Any]
    input_col: str | None = None

    @staticmethod
    def from_any(
        data: Any, input_col: str | None = None, num_partitions: int | None = None
    ) -> "PartitionedDataset":
        """Wrap a supported container; ``num_partitions`` > 1 splits its rows
        into that many nearly equal slices."""
        if isinstance(data, PartitionedDataset):
            return data
        if isinstance(data, (list, tuple)) and data and (
            pa is not None and isinstance(data[0], (pa.Table, pa.RecordBatch))
        ):
            return PartitionedDataset(list(data), input_col)
        x = extract_matrix(data, input_col)
        if num_partitions and num_partitions > 1:
            return PartitionedDataset(np.array_split(x, num_partitions), input_col)
        return PartitionedDataset([x], input_col)

    def est_rows(self) -> int | None:
        """Total rows from partition metadata alone; None when a partition's
        size is not known without extracting it."""
        total = 0
        for p in self.partitions:
            nr = getattr(p, "num_rows", None)
            if nr is None and isinstance(p, np.ndarray):
                nr = p.shape[0]
            if nr is None:
                return None
            total += int(nr)
        return total

    def est_feature_dim(self) -> int | None:
        """Feature count of a 2-D ndarray first partition, else None."""
        if not self.partitions:
            return None
        p = self.partitions[0]
        if isinstance(p, np.ndarray) and p.ndim == 2:
            return int(p.shape[1])
        return None

    def matrices(self) -> Iterator[np.ndarray]:
        for p in self.partitions:
            yield extract_matrix(p, self.input_col)

    def collect_matrix(self) -> np.ndarray:
        """Every partition's rows in one matrix."""
        mats = list(self.matrices())
        return mats[0] if len(mats) == 1 else np.concatenate(mats)


def _part_size(p: Any) -> tuple[int | None, int | None]:
    if isinstance(p, np.ndarray) and p.ndim == 2:
        return p.shape[0], p.nbytes
    if pa is not None and isinstance(p, (pa.Table, pa.RecordBatch)):
        return p.num_rows, p.nbytes
    return None, None


def dataset_size(data: Any) -> tuple[int | None, int | None]:
    """(rows, bytes) of a container the estimators accept, from its shape
    alone, without extracting it: what a fit's report counts as ingested.
    Either is None where unknown (a pandas frame's bytes, say). A labeled
    ``(X, y)``/``(X, y, w)`` tuple of arrays counts X's rows and the bytes of
    all its arrays."""
    if (isinstance(data, tuple) and len(data) in (2, 3) and isinstance(data[0], np.ndarray)
            and data[0].ndim == 2):
        return data[0].shape[0], sum(np.asarray(a).nbytes for a in data if a is not None)
    if isinstance(data, PartitionedDataset):
        parts = data.partitions
    elif isinstance(data, (list, tuple)) and data and (
        pa is not None and isinstance(data[0], (pa.Table, pa.RecordBatch))
    ):
        parts = data
    elif hasattr(data, "columns") and hasattr(data, "assign"):  # pandas
        return len(data), None
    else:
        parts = [data]
    sizes = [_part_size(p) for p in parts]
    rows = [r for r, _ in sizes]
    nbytes = [b for _, b in sizes]
    return (
        None if None in rows else sum(rows),
        None if None in nbytes else sum(nbytes),
    )


def use_streamed_fit(ds: PartitionedDataset) -> bool:
    """True when partition metadata proves the resident array would exceed
    ``TPU_ML_STREAM_FIT_MAX_RESIDENT_BYTES`` (``spark.ingest.use_streamed_fit``);
    unknown sizes stay resident."""
    rows = ds.est_rows()
    n = ds.est_feature_dim()
    if rows is None or n is None:
        return False
    from spark_rapids_ml_tpu_torch.spark.ingest import use_streamed_fit as _cutover

    return _cutover(rows, n)
