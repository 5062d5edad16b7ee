"""Model persistence of the port: params JSON + parquet data, in two layouts.

Copy of what PCA needs from ``spark_rapids_ml_tpu/utils/persistence.py``,
writing and reading the same files, so a save crosses between the packages:

- **Native layout**: ``path/metadata.json`` (class, uid, timestamp,
  library version, param maps) and ``path/data.parquet`` (one row of
  flattened ndarrays with their shapes under the ``tpu_ml_shapes`` schema
  key).
- **Spark ML layout**: ``path/metadata/part-00000`` (one line of JSON) and
  ``_SUCCESS``, and ``path/data/`` parquet whose columns are Spark's
  MatrixUDT/VectorUDT structs, with the Spark schema under
  ``org.apache.spark.sql.parquet.row.metadata`` so stock Spark rebuilds
  ``DenseMatrix``/``DenseVector`` columns.

Persistence runs on the host and needs pyarrow, which is imported behind a
guard: the package imports without it, and only a save or load that reads
or writes parquet raises. Paths may be fsspec URLs where fsspec is
installed.
"""

from __future__ import annotations

import io
import json
import posixpath
import time
from pathlib import Path
from typing import Any

import numpy as np

try:
    import pyarrow as pa
    import pyarrow.parquet as pq
except Exception:  # pragma: no cover - the card's machine has no pyarrow
    pa = None
    pq = None

try:
    import fsspec
except Exception:  # pragma: no cover
    fsspec = None

_LIBRARY_VERSION_KEY = "libraryVersion"


# ---------------------------------------------------------------------------
# Filesystem facade: pathlib locally, fsspec for URLs
# ---------------------------------------------------------------------------


class _FS:
    """The handful of filesystem operations persistence needs, dispatched to
    fsspec for URL paths and pathlib otherwise — one place, so every save/
    load path (native and Spark layout) is remote-capable."""

    def __init__(self, path: str | Path):
        s = str(path)
        if "://" in s:
            if fsspec is None:
                raise ImportError(
                    f"path {s!r} looks remote but fsspec is not installed; "
                    "pip install fsspec (plus the protocol's package, e.g. "
                    "s3fs/gcsfs) or use a local path"
                )
            self.fs, self.root = fsspec.core.url_to_fs(s)
        else:
            self.fs, self.root = None, s

    def join(self, *parts: str) -> str:
        return posixpath.join(self.root, *parts)

    def exists(self, rel: str = "") -> bool:
        p = self.join(rel) if rel else self.root
        return self.fs.exists(p) if self.fs else Path(p).exists()

    def mkdirs(self, rel: str = "") -> None:
        p = self.join(rel) if rel else self.root
        if self.fs:
            self.fs.makedirs(p, exist_ok=True)
        else:
            Path(p).mkdir(parents=True, exist_ok=True)

    def rmtree(self) -> None:
        if self.fs:
            if self.fs.exists(self.root):
                self.fs.rm(self.root, recursive=True)
        else:
            import shutil

            if Path(self.root).exists():
                shutil.rmtree(self.root)

    def write_text(self, rel: str, text: str) -> None:
        p = self.join(rel)
        if self.fs:
            with self.fs.open(p, "w") as f:
                f.write(text)
        else:
            Path(p).write_text(text)

    def read_text(self, rel: str) -> str:
        p = self.join(rel)
        if self.fs:
            with self.fs.open(p, "r") as f:
                return f.read()
        return Path(p).read_text()

    def listdir(self, rel: str = "") -> list[str]:
        p = self.join(rel) if rel else self.root
        if self.fs:
            return [posixpath.basename(f) for f in self.fs.ls(p, detail=False)]
        return [f.name for f in Path(p).iterdir()]

    def write_parquet(self, rel: str, table) -> None:
        p = self.join(rel)
        if self.fs:
            buf = io.BytesIO()
            pq.write_table(table, buf)
            with self.fs.open(p, "wb") as f:
                f.write(buf.getvalue())
        else:
            pq.write_table(table, p)

    def read_parquet(self, rel: str):
        p = self.join(rel)
        if self.fs:
            with self.fs.open(p, "rb") as f:
                return pq.read_table(io.BytesIO(f.read()))
        return pq.read_table(p)


# ---------------------------------------------------------------------------
# Native layout
# ---------------------------------------------------------------------------


def _jsonable(v: Any) -> Any:
    if isinstance(v, (np.integer, np.floating)):
        return v.item()
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


def _require_pyarrow() -> None:
    if pa is None:
        raise ImportError(
            "saving or loading a model's data needs pyarrow, which is not "
            "installed; pip install pyarrow"
        )


def save_metadata(path: str | Path, instance, extra: dict | None = None) -> None:
    """DefaultParamsWriter.saveMetadata analog, recording the port's own
    version."""
    from spark_rapids_ml_tpu_torch import __version__

    fs = _FS(path)
    fs.mkdirs()
    state = instance._paramState()
    meta = {
        "class": f"{type(instance).__module__}.{type(instance).__qualname__}",
        "timestamp": int(time.time() * 1000),
        _LIBRARY_VERSION_KEY: __version__,
        "uid": instance.uid,
        "paramMap": {k: _jsonable(v) for k, v in state["paramMap"].items()},
        "defaultParamMap": {k: _jsonable(v) for k, v in state["defaultParamMap"].items()},
    }
    if extra:
        meta.update(extra)
    fs.write_text("metadata.json", json.dumps(meta, indent=2))


def load_metadata(path: str | Path) -> dict:
    return json.loads(_FS(path).read_text("metadata.json"))


def save_arrays(path: str | Path, arrays: dict[str, np.ndarray]) -> None:
    """Write named ndarrays as one single-row-group parquet file."""
    _require_pyarrow()
    fs = _FS(path)
    fs.mkdirs()
    cols, names, shapes = [], [], {}
    for name, arr in arrays.items():
        arr = np.asarray(arr)
        shapes[name] = {"shape": list(arr.shape), "dtype": str(arr.dtype)}
        cols.append(pa.array(arr.reshape(-1)))
        names.append(name)
    table = pa.table(
        {n: pa.array([c.to_numpy(zero_copy_only=False)]) for n, c in zip(names, cols)}
    )
    table = table.replace_schema_metadata({"tpu_ml_shapes": json.dumps(shapes)})
    fs.write_parquet("data.parquet", table)


def load_arrays(path: str | Path) -> dict[str, np.ndarray]:
    """The named ndarrays of a native save's ``data.parquet``."""
    _require_pyarrow()
    table = _FS(path).read_parquet("data.parquet")
    shapes = json.loads(table.schema.metadata[b"tpu_ml_shapes"].decode())
    out = {}
    for name in table.column_names:
        flat = np.asarray(table.column(name).to_pylist()[0])
        info = shapes[name]
        out[name] = flat.astype(info["dtype"]).reshape(info["shape"])
    return out


# ---------------------------------------------------------------------------
# Spark ML layout — stock pyspark.ml interop
# ---------------------------------------------------------------------------
#
# Spark's DefaultParamsWriter writes path/metadata/part-00000 as a single
# JSON line; model payloads go to path/data/ as parquet whose columns are
# Spark UDTs. Spark's parquet reader reconstructs UDT columns only when the
# file carries the Spark schema JSON under this key:
_SPARK_ROW_METADATA_KEY = "org.apache.spark.sql.parquet.row.metadata"

_VECTOR_SQL_FIELDS = [
    {"name": "type", "type": "byte", "nullable": False, "metadata": {}},
    {"name": "size", "type": "integer", "nullable": True, "metadata": {}},
    {
        "name": "indices",
        "type": {"type": "array", "elementType": "integer", "containsNull": False},
        "nullable": True,
        "metadata": {},
    },
    {
        "name": "values",
        "type": {"type": "array", "elementType": "double", "containsNull": False},
        "nullable": True,
        "metadata": {},
    },
]

_MATRIX_SQL_FIELDS = [
    {"name": "type", "type": "byte", "nullable": False, "metadata": {}},
    {"name": "numRows", "type": "integer", "nullable": False, "metadata": {}},
    {"name": "numCols", "type": "integer", "nullable": False, "metadata": {}},
    {
        "name": "colPtrs",
        "type": {"type": "array", "elementType": "integer", "containsNull": False},
        "nullable": True,
        "metadata": {},
    },
    {
        "name": "rowIndices",
        "type": {"type": "array", "elementType": "integer", "containsNull": False},
        "nullable": True,
        "metadata": {},
    },
    {
        "name": "values",
        "type": {"type": "array", "elementType": "double", "containsNull": False},
        "nullable": True,
        "metadata": {},
    },
    {"name": "isTransposed", "type": "boolean", "nullable": False, "metadata": {}},
]


def _vector_udt_json() -> dict:
    return {
        "type": "udt",
        "class": "org.apache.spark.ml.linalg.VectorUDT",
        "pyClass": "pyspark.ml.linalg.VectorUDT",
        "sqlType": {"type": "struct", "fields": _VECTOR_SQL_FIELDS},
    }


def _matrix_udt_json() -> dict:
    return {
        "type": "udt",
        "class": "org.apache.spark.ml.linalg.MatrixUDT",
        "pyClass": "pyspark.ml.linalg.MatrixUDT",
        "sqlType": {"type": "struct", "fields": _MATRIX_SQL_FIELDS},
    }


def _dense_vector_struct(values: np.ndarray) -> "pa.StructArray":
    """One dense pyspark.ml.linalg VectorUDT row as its sql struct."""
    values = np.asarray(values, dtype=np.float64).reshape(-1)
    return pa.StructArray.from_arrays(
        [
            pa.array([1], pa.int8()),
            pa.array([None], pa.int32()),
            pa.array([None], pa.list_(pa.int32())),
            pa.array([values.tolist()], pa.list_(pa.float64())),
        ],
        names=["type", "size", "indices", "values"],
    )


def _dense_matrix_struct(mat: np.ndarray) -> "pa.StructArray":
    """One dense MatrixUDT row: Spark DenseMatrix stores values
    COLUMN-major with isTransposed=false (pyspark.ml.linalg.DenseMatrix)."""
    mat = np.asarray(mat, dtype=np.float64)
    rows, cols = mat.shape
    return pa.StructArray.from_arrays(
        [
            pa.array([1], pa.int8()),
            pa.array([rows], pa.int32()),
            pa.array([cols], pa.int32()),
            pa.array([None], pa.list_(pa.int32())),
            pa.array([None], pa.list_(pa.int32())),
            pa.array([mat.flatten(order="F").tolist()], pa.list_(pa.float64())),
            pa.array([False], pa.bool_()),
        ],
        names=["type", "numRows", "numCols", "colPtrs", "rowIndices", "values", "isTransposed"],
    )


def struct_to_vector(row: dict) -> np.ndarray:
    """A collected VectorUDT struct row (dict) → dense [n] ndarray."""
    if row["type"] == 1:
        return np.asarray(row["values"], dtype=np.float64)
    out = np.zeros(int(row["size"]), dtype=np.float64)
    out[np.asarray(row["indices"], dtype=np.int64)] = row["values"]
    return out


def struct_to_matrix(row: dict) -> np.ndarray:
    """A collected MatrixUDT struct row (dict) → dense [rows, cols] ndarray.

    Sparse (type 0) follows Spark's SparseMatrix layout: CSC normally, CSR
    when ``isTransposed`` (colPtrs become row pointers, rowIndices become
    column indices — pyspark.ml.linalg.SparseMatrix docs)."""
    rows, cols = int(row["numRows"]), int(row["numCols"])
    values = np.asarray(row["values"], dtype=np.float64)
    if row["type"] == 0:
        ptrs = np.asarray(row["colPtrs"], dtype=np.int64)
        idx = np.asarray(row["rowIndices"], dtype=np.int64)
        if row.get("isTransposed"):  # CSR: build the transpose as CSC, flip
            out = np.zeros((cols, rows))
            major = rows
        else:  # CSC
            out = np.zeros((rows, cols))
            major = cols
        for c in range(major):
            sl = slice(ptrs[c], ptrs[c + 1])
            out[idx[sl], c] = values[sl]
        return out.T if row.get("isTransposed") else out
    if row.get("isTransposed"):
        return values.reshape(rows, cols)  # row-major when transposed
    return values.reshape(cols, rows).T  # column-major


def save_spark_ml_metadata(
    path: str | Path,
    *,
    class_name: str,
    uid: str,
    param_map: dict,
    default_param_map: dict | None = None,
    spark_version: str = "3.5.0",
) -> None:
    """Write ``path/metadata/part-00000`` + ``_SUCCESS`` the way Spark's
    DefaultParamsWriter does: ONE line of compact JSON."""
    fs = _FS(path)
    fs.mkdirs("metadata")
    meta = {
        "class": class_name,
        "timestamp": int(time.time() * 1000),
        "sparkVersion": spark_version,
        "uid": uid,
        "paramMap": {k: _jsonable(v) for k, v in param_map.items()},
        "defaultParamMap": {
            k: _jsonable(v) for k, v in (default_param_map or {}).items()
        },
    }
    fs.write_text("metadata/part-00000", json.dumps(meta, separators=(",", ":")))
    fs.write_text("metadata/_SUCCESS", "")


def load_spark_ml_metadata(path: str | Path) -> dict:
    """Parse ``path/metadata/part-*`` (Spark may shard, but DefaultParamsWriter
    writes one part; take the first non-empty line found)."""
    fs = _FS(path)
    parts = sorted(
        f for f in fs.listdir("metadata") if f.startswith("part-")
    )
    if not parts:
        raise FileNotFoundError(f"no metadata part files under {path}/metadata")
    for part in parts:
        text = fs.read_text(f"metadata/{part}").strip()
        if text:
            return json.loads(text.splitlines()[0])
    raise ValueError(f"metadata part files under {path}/metadata are empty")


def save_spark_ml_data(
    path: str | Path, columns: dict[str, "pa.StructArray"], spark_schema: dict
) -> None:
    """Write ``path/data/part-00000…parquet`` (+ ``_SUCCESS``) with the Spark
    row-metadata schema key so stock Spark reconstructs the UDT columns."""
    _require_pyarrow()
    fs = _FS(path)
    fs.mkdirs("data")
    table = pa.table(dict(columns))
    table = table.replace_schema_metadata(
        {_SPARK_ROW_METADATA_KEY: json.dumps(spark_schema, separators=(",", ":"))}
    )
    fs.write_parquet("data/part-00000-tpu-ml.snappy.parquet", table)
    fs.write_text("data/_SUCCESS", "")


def load_spark_ml_data(path: str | Path) -> "pa.Table":
    """Read every parquet part under ``path/data`` into one Arrow table."""
    _require_pyarrow()
    fs = _FS(path)
    parts = sorted(
        f
        for f in fs.listdir("data")
        if f.endswith(".parquet") and not f.startswith(("_", "."))
    )
    if not parts:
        raise FileNotFoundError(f"no parquet part files under {path}/data")
    tables = [fs.read_parquet(f"data/{p}") for p in parts]
    return pa.concat_tables(tables) if len(tables) > 1 else tables[0]


def save_spark_ml_vector_model(
    path: str | Path, *, class_name: str, uid: str, params: dict, vectors: dict
) -> None:
    """Persist the Spark ML model shape ``Row(<dense vectors...>)`` with
    DefaultParamsWriter metadata: the scaler family's one writer. The order
    of ``vectors`` is the stock reader's column order."""
    save_spark_ml_metadata(path, class_name=class_name, uid=uid, param_map=params)
    save_spark_ml_data(
        path,
        {name: _dense_vector_struct(v) for name, v in vectors.items()},
        {
            "type": "struct",
            "fields": [
                {"name": name, "type": _vector_udt_json(), "nullable": True, "metadata": {}}
                for name in vectors
            ],
        },
    )


def is_spark_ml_layout(path: str | Path) -> bool:
    """True when ``path`` holds a Spark-ML-layout save (metadata/ dir with
    part files) rather than the native metadata.json layout."""
    fs = _FS(path)
    if fs.exists("metadata.json"):
        return False
    return fs.exists("metadata")
