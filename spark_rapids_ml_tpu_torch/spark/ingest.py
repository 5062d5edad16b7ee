"""Streamed (out-of-core) fit: host chunks folded into a carry on the card.

Counterpart of the streamed-fit part of ``spark_rapids_ml_tpu/spark/ingest.py``
(``use_streamed_fit``, ``stream_chunk_rows``, ``StreamFold``, ``stream_fold``)
for a source that is an iterable of host matrices. The full [rows, n] array
is never assembled, host or device: device memory stays O(chunk + carry).

JAX's async dispatch and donated carry become explicit CUDA streams and
events:

- rows are copied from the source into one of two pinned f32 host staging
  buffers of ``chunk_rows`` rows, filled across partition boundaries as the
  JAX loop fills its chunk buffers, so ⌈rows / chunk_rows⌉ chunks fold and
  the ragged tail is the last one;
- a side stream copies each full (or final) staging buffer into one of two
  device chunk buffers, and the fold, on the current stream, waits for that
  copy's event, so the next chunk is staged while this one is copied and
  folded;
- a staging buffer is refilled only after its copy's event has completed,
  and a device buffer is overwritten only after the fold that read it has
  completed (the side stream waits for that fold's event);
- the fold sees only the chunk's ``fill`` true rows (a view of the device
  buffer), so a ragged chunk's stale tail never reaches the kernel; the unit
  weights stay on the host (``linalg.gram_stats_weighted``).

On the CPU the fold reads the staging buffer directly.

The fold books the JAX package's series: ``ingest.rows``/``ingest.bytes``
per source chunk taken, ``h2d.bytes{path=stream}`` per copy to the card,
the ``stream.active``/``stream.last_beat`` heartbeat gauges the health
monitor watches, and ``stream.overlap_fraction`` (overlapped dispatches
over chunks) once per fold, which ``FitReport.overlap_fraction`` reads.

With ``label_col`` the source yields ``(x, y)`` or ``(x, y, w)`` tuples
(the supervised fits' labeled partitions): the labels and the instance
weights (1 where none are given) ride in two more f32 columns of the same
staging rows, so one copy takes all three to the card, and the fold is
``fold_fn(carry, x, y, w)`` on column views of the device buffer. Then
``h2d.bytes`` counts x, y and w: (n + 2) · 4 bytes a row. A non-finite
label or weight drops or raises its row as a non-finite feature does, and
each chunk's weights pass ``columnar.validate_weights``.

The fold recovers as the JAX fold does (``resilience/``):

- the ``ingest.chunk`` and ``fold.dispatch`` fault sites, each retried
  under the shared policy for transient faults; ``fold.dispatch`` fires
  before the chunk's copy to the card, so a retry re-enters with the carry
  untouched;
- a dispatch that fails with a device OOM (``RESOURCE_EXHAUSTED``) is
  bisected: the chunk's true rows are dispatched again in pieces of half
  its size, aligned to ``TPU_ML_STREAM_CHUNK_FLOOR``, and ``chunk_rows``
  drops to that size for the rest of the stream (``chunk.bisections``,
  ``StreamFold.bisections``); at the floor the error is raised. A piece
  runs at its true row count, as the tail does, so no row is padded;
- with a ``checkpointer`` (``utils/checkpoint.py::TrainingCheckpointer``)
  the carry, synced and copied to the host, and the cursor are saved every
  ``checkpoint_every`` full chunks (``stream.checkpoints``); a later call
  with the same checkpointer resumes (``stream.resumes``,
  ``StreamFold.resumed``): it restores the carry and skips the source rows
  already consumed, before any filter, so the resumed fold is the
  uninterrupted one;
- the terminal wait is bounded (``TPU_ML_FOLD_WAIT_TIMEOUT_S`` or
  ``fold_wait_timeout_s``; 0 is none): past the ``fold.wait`` site, the
  last fold's CUDA event is polled against the deadline, and expiry raises
  ``FoldHangTimeout`` (hung, not slow);
- ``TPU_ML_PROGRESS`` (seconds) prints a heartbeat line to stderr.

Each fold is booked against the analytical cost model as
``stream.fold_step`` (``telemetry/costmodel.py``; the fold step's ``cost``).
When the caller pins no ``chunk_rows``, the tuner picks it
(``autotune.resolve("stream.fold_step", …)``, ``TPU_ML_AUTOTUNE``): a cached
or searched winner sets ``chunk_rows = max(min_chunk_rows,
bucket_rows(winner))`` before the staging buffers are allocated; a search's
trials fold synthetic chunks into throwaway carries
(``autotune.stream_fold_measure``), never the real one. A resumed fold
keeps at most its checkpoint's chunk rows.

The driver chunker (``_iter_chunks``) collects a DataFrame's (features,
label, weight) columns on the driver in bounded chunks for the Spark
estimators that fit on collected rows (``spark/estimators.py::
_collect_xyw``): the port's ``localspark`` streams its partitions; a
pyspark DataFrame takes ``toArrow`` (4.0+) or an Arrow-enabled
``toPandas`` (3.x, ArrayType features) up to
``TPU_ML_MESH_LOCAL_ARROW_MAX_BYTES``, and ``toLocalIterator`` in
``ROW_CHUNK``-row groups above it.

``stream_fold`` also takes a DataFrame source (``features_col`` names its
column; ``selected`` holds [features, label?, weight?]), drained by
``_iter_chunks`` after one ``count()`` that the drained rows must match, and
a ``put_fn`` that places each chunk's device view before the fold
(``parallel.gram.chunk_put`` splits it over a mesh's data shards). A carry
may hold stacked per-shard partials (``parallel.gram.init_chunk_carry``):
a checkpoint saves each such leaf as its [shards, ...] stack, the JAX
fold's layout.

The mesh-local ingest (``stream_to_mesh``) streams a DataFrame into the
data shards of a mesh (``parallel/mesh.py``) at O(shard) host memory: each
shard's f32 buffer is filled across batch boundaries, copied to its
shard's device the moment it is full, and never reused; the tail and the
empty shards are zero rows with weight 0 (``MeshIngest.ws``, the masking
convention). ``TPU_ML_MESH_LOCAL_MAX_BYTES`` caps the device footprint with
an error that names the alternatives.

Not ported yet (``ROADMAP.md`` Queue A): the augmented intercept column,
which the linear mesh fits use.
"""

from __future__ import annotations

import logging
import math
import os
import sys
import threading
import time
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Iterable, Iterator

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.resilience import faults, sites
from spark_rapids_ml_tpu_torch.resilience import retry as R
from spark_rapids_ml_tpu_torch.telemetry import costmodel, trace_range
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY
from spark_rapids_ml_tpu_torch.telemetry.spans import current_fit_id
from spark_rapids_ml_tpu_torch.telemetry.timeline import TIMELINE
from spark_rapids_ml_tpu_torch.utils import columnar
from spark_rapids_ml_tpu_torch.utils.config import (
    DEFAULT_MESH_LOCAL_ARROW_MAX_BYTES as DEFAULT_ARROW_CUTOVER,
    DEFAULT_STREAM_CHUNK_FLOOR,
    FOLD_WAIT_TIMEOUT_S_VAR,
    MESH_LOCAL_ARROW_MAX_BYTES_VAR as ARROW_CUTOVER_VAR,
    MESH_LOCAL_MAX_BYTES_VAR as MAX_BYTES_VAR,
    PROGRESS_VAR,
    STREAM_CHUNK_FLOOR_VAR,
    STREAM_CHUNK_VAR,
    VALID_NONFINITE_POLICIES,
    get_config,
    wire_dtype,
)

logger = logging.getLogger("spark_rapids_ml_tpu_torch")

ROW_CHUNK = 65_536  # rows per driver-side conversion group of toLocalIterator


def _iter_chunks(
    selected,
    features_col: str,
    label_col: str | None,
    weight_col: str | None,
    est_bytes: int = 0,
) -> Iterator[tuple[np.ndarray, np.ndarray | None, np.ndarray | None]]:
    """(x [c, n], y [c] or None, w [c] or None) chunks of a DataFrame's
    columns on the driver, bounding its memory. ``selected`` holds
    [features, label?, weight?] in that order (the row path reads them by
    position).

    The port's ``localspark`` streams its partitions' Arrow batches. A
    pyspark DataFrame of at most ``est_bytes`` ≤ the Arrow cutover is one
    columnar collect (``toArrow`` on 4.0+, an Arrow-enabled ``toPandas``
    on 3.x); a larger one streams ``toLocalIterator`` rows in
    ``ROW_CHUNK`` groups; anything else is one ``collect()``."""

    def columns(b):
        x = columnar.extract_matrix(b, features_col)
        y = columnar.extract_vector(b, label_col) if label_col else None
        w = columnar.extract_vector(b, weight_col) if weight_col else None
        return x, y, w

    if hasattr(selected, "_parts"):  # localspark
        for part in selected._parts():
            for b in part:
                if b.num_rows:
                    yield columns(b)
        return
    cutover = int(float(os.environ.get(ARROW_CUTOVER_VAR, DEFAULT_ARROW_CUTOVER)))
    if est_bytes <= cutover:
        to_arrow = getattr(selected, "toArrow", None)
        if callable(to_arrow):  # pyspark 4.0+
            for b in to_arrow().to_batches():
                if b.num_rows:
                    yield columns(b)
            return
        if _pandas_columnar_ok(selected, features_col):
            # pyspark 3.x: an Arrow-enabled toPandas of an ArrayType column is
            # a columnar one-job collect; anything else degrades it to pickled
            # rows, worse than the row iterator below
            try:
                pdf = selected.toPandas()
            except ImportError:
                pdf = None
            if pdf is not None:
                if len(pdf):
                    yield columns(pdf)
                return
    it = getattr(selected, "toLocalIterator", None)
    rows_iter = it() if callable(it) else iter(selected.collect())
    buf: list[Any] = []
    for row in rows_iter:
        buf.append(row)
        if len(buf) >= ROW_CHUNK:
            yield _chunk_from_rows(buf, label_col, weight_col)
            buf = []
    if buf:
        yield _chunk_from_rows(buf, label_col, weight_col)


def _pandas_columnar_ok(selected, features_col: str) -> bool:
    """True only when ``selected.toPandas()`` is a columnar Arrow collect:
    pandas importable, the session's Arrow transfer on, and the features an
    ArrayType column. Anything unverifiable answers False."""
    if not callable(getattr(selected, "toPandas", None)):
        return False
    try:
        import pandas  # noqa: F401
    except ImportError:
        return False
    try:
        if type(selected.schema[features_col].dataType).__name__ != "ArrayType":
            return False
        enabled = selected.sparkSession.conf.get("spark.sql.execution.arrow.pyspark.enabled")
        return str(enabled).lower() == "true"
    except Exception:  # noqa: BLE001 - any doubt takes the row path
        return False


def _chunk_from_rows(rows: list, label_col, weight_col):
    """(x, y, w) of a group of driver-side rows, [features, label?,
    weight?] by position: plain array rows convert in one ``np.asarray``,
    DenseVector rows stack their ``values``, irregular groups (sparse,
    mixed) take the per-row converter."""
    first = rows[0][0]
    try:
        if isinstance(first, (list, tuple, np.ndarray)):
            x = np.asarray([r[0] for r in rows], dtype=np.float64)
        elif hasattr(first, "values") and not hasattr(first, "indices"):
            x = np.asarray([r[0].values for r in rows], dtype=np.float64)
        else:
            raise ValueError("irregular rows")
        if x.ndim != 2:
            raise ValueError("ragged chunk")
    except (ValueError, AttributeError):
        x = np.stack([columnar.row_vector_to_ndarray(r[0]) for r in rows])
    y = (np.fromiter((r[1] for r in rows), dtype=np.float64, count=len(rows))
         if label_col else None)
    wi = 2 if label_col else 1
    w = (np.fromiter((r[wi] for r in rows), dtype=np.float64, count=len(rows))
         if weight_col else None)
    return x, y, w


@dataclass
class MeshIngest:
    """One DataFrame on a mesh's data shards. ``ws`` follows the masking
    convention: instance weights (1 without a weight column) on true rows,
    0 on pad rows, so one vector is both the pad mask and the weighting."""

    xs: Any            # Sharded [padded_rows, n] f32, over data
    ys: Any | None     # Sharded [padded_rows] labels, or None
    ws: Any | None     # Sharded [padded_rows] weights and pad mask, or None
    mesh: Any
    rows: int          # true rows
    padded_rows: int   # shard rows × data shards


def _check_size(padded_rows: int, n_eff: int) -> None:
    """Refuse an ingest over ``TPU_ML_MESH_LOCAL_MAX_BYTES`` of device
    memory (f32, the port's staging dtype), naming the alternatives."""
    est = padded_rows * n_eff * 4
    cap = os.environ.get(MAX_BYTES_VAR)
    if cap and est > int(float(cap)):
        raise ValueError(
            f"mesh-local ingest needs ~{est / 1e9:.2f} GB of device memory "
            f"({padded_rows}×{n_eff} float32), over the {MAX_BYTES_VAR}={cap} cap. "
            "Use distribution='mesh-barrier' (the rows stay sharded across the "
            "workers) or 'driver-merge' (only [n, n] statistics reach the driver), "
            "or lower TPU_ML_STREAM_FIT_MAX_RESIDENT_BYTES to stream the fit."
        )


def stream_to_mesh(
    selected,
    *,
    features_col: str,
    n: int,
    mesh,
    label_col: str | None = None,
    weight_col: str | None = None,
    with_weights: bool = False,
    augment_intercept: bool = False,
    rows: int | None = None,
) -> MeshIngest:
    """Stream ``selected`` ([features, label?, weight?]) into the data
    shards of ``mesh``. One ``count()`` sizes the shards first (``rows``
    skips it); each shard holds ``bucket_rows(⌈rows / shards⌉)`` rows.
    ``with_weights`` makes ``ws`` without a weight column (1 on true rows, 0
    on pads), for the masked programs. ``augment_intercept`` appends a
    column of ones to the true rows (``xs`` is [rows, n + 1]) for the
    Newton programs; pad rows weigh 0, so they add nothing to any
    statistic."""
    from spark_rapids_ml_tpu_torch.parallel import mesh as M

    if rows is None:
        rows = selected.count()
    if rows == 0:
        raise ValueError("empty dataset")
    ndev = mesh.shape[M.DATA_AXIS]
    shard_rows = columnar.bucket_rows(-(-rows // ndev))
    padded_rows = shard_rows * ndev
    n_eff = n + 1 if augment_intercept else n
    _check_size(padded_rows, n_eff)
    want_y = label_col is not None
    want_w = with_weights or bool(weight_col)
    parts: dict[str, list[torch.Tensor]] = {"x": [], "y": [], "w": []}

    def fresh():
        return (np.zeros((shard_rows, n_eff), np.float32),
                np.zeros(shard_rows, np.float32) if want_y else None,
                np.zeros(shard_rows, np.float32) if want_w else None)

    x_buf, y_buf, w_buf = fresh()
    fill = seen = 0

    def flush():
        nonlocal x_buf, y_buf, w_buf, fill
        dev = mesh.device(len(parts["x"]))
        nbytes = 0
        for key, buf in (("x", x_buf), ("y", y_buf), ("w", w_buf)):
            if buf is not None:
                # a fresh buffer each shard: a CPU "copy" is the same memory
                parts[key].append(torch.from_numpy(buf).to(dev))
                nbytes += buf.nbytes
        REGISTRY.counter_inc("h2d.bytes", nbytes, path="mesh")
        x_buf, y_buf, w_buf = fresh()
        fill = 0

    for xc, yc, wc in _iter_chunks(selected, features_col, label_col, weight_col,
                                   est_bytes=rows * n * 8):
        REGISTRY.counter_inc("ingest.rows", len(xc))
        REGISTRY.counter_inc("ingest.bytes", xc.nbytes)
        REGISTRY.histogram_record("ingest.chunk_rows", len(xc))
        if xc.shape[1] != n:
            raise ValueError(
                f"feature dimension changed mid-stream: expected {n}, got "
                f"{xc.shape[1]} in column {features_col!r}"
            )
        if wc is not None:
            wc = columnar.validate_weights(wc, len(xc), allow_all_zero=True)
        if seen + len(xc) > rows:
            raise ValueError(
                f"dataset produced more rows while streaming than count() reported "
                f"({rows}); cache() the DataFrame if its source is nondeterministic"
            )
        at = 0
        while at < len(xc):
            take = min(shard_rows - fill, len(xc) - at)
            x_buf[fill:fill + take, :n] = xc[at:at + take]
            if augment_intercept:
                x_buf[fill:fill + take, n] = 1.0
            if want_y:
                y_buf[fill:fill + take] = yc[at:at + take]
            if want_w:
                w_buf[fill:fill + take] = 1.0 if wc is None else wc[at:at + take]
            fill += take
            at += take
            seen += take
            if fill == shard_rows:
                flush()
    if seen != rows:
        raise ValueError(
            f"dataset produced {seen} rows while streaming but count() reported "
            f"{rows}; cache() the DataFrame if its source is nondeterministic"
        )
    while len(parts["x"]) < ndev:  # the partial and the empty tail shards
        flush()

    def sharded(key: str, sharding):
        blocks = {(i, 0): parts[key][i] for i in range(ndev)}
        shape = (padded_rows, n_eff) if key == "x" else (padded_rows,)
        return M.Sharded(sharding, blocks, shape, rows)

    vec = M.vector_sharding(mesh)
    return MeshIngest(
        xs=sharded("x", M.data_sharding(mesh)),
        ys=sharded("y", vec) if want_y else None,
        ws=sharded("w", vec) if want_w else None,
        mesh=mesh, rows=rows, padded_rows=padded_rows,
    )


def use_streamed_fit(rows: int, n: int) -> bool:
    """Stream when the resident array (rows × n at the wire dtype) would
    exceed ``TPU_ML_STREAM_FIT_MAX_RESIDENT_BYTES``."""
    return rows * n * wire_dtype().itemsize > get_config().stream_fit_max_resident_bytes


def stream_chunk_rows() -> int:
    """Rows per fold chunk (``TPU_ML_STREAM_CHUNK_ROWS``), bucketed to a
    power of two as in the JAX package."""
    rows = get_config().stream_chunk_rows
    if rows < 1:
        raise ValueError(f"{STREAM_CHUNK_VAR}={rows} must be >= 1")
    return columnar.bucket_rows(rows)


def progress_interval() -> float:
    """Seconds between heartbeat lines (``TPU_ML_PROGRESS``; 0 or unset:
    none)."""
    raw = os.environ.get(PROGRESS_VAR, "")
    if not raw:
        return 0.0
    try:
        every = float(raw)
    except ValueError:
        raise ValueError(f"{PROGRESS_VAR}={raw!r} must be a number of seconds") from None
    return max(0.0, every)


@dataclass
class StreamFold:
    """Result of a streamed fold: the final carry and what the pipeline did.

    ``overlapped`` counts dispatches issued while the previous chunk's fold
    (its copy to the card and its kernels) was still running: the
    counterpart of the JAX loop's ``is_ready()`` test. It is above 0 only
    where the card, not the host, is the slower side. ``copy_overlapped``
    counts chunks whose copy to the card was still in flight when the host
    went on to stage the next one: above 0, the staging is pinned and the
    copy runs beside the host's work. ``max_put_bytes`` is the largest
    single chunk handed to the fold, O(chunk) and never O(rows);
    ``skipped_rows`` counts non-finite rows dropped under the ``skip``
    policy, ``bisections`` the chunk splits after a device OOM, and
    ``resumed`` says whether the fold went on from a checkpoint. ``chunks``
    counts the folds that ran, a resumed fold's earlier ones included."""

    carry: Any
    rows: int
    chunks: int
    overlapped: int
    max_put_bytes: int
    skipped_rows: int = 0
    copy_overlapped: int = 0
    bisections: int = 0
    resumed: bool = False


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor over ``a``'s memory, read-only arrays included (nothing
    here writes through it)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*not writable.*")
        return torch.from_numpy(np.ascontiguousarray(a))


def _nonfinite_rows(x: np.ndarray) -> np.ndarray | None:
    """Mask of the rows holding a NaN or an infinity, or None when all are
    finite. A finite sum proves every value finite, so the common case costs
    one multi-threaded read; only a non-finite sum (a bad value, or an
    overflow of large finite ones) pays for the per-row scan."""
    if math.isfinite(_host_tensor(x).sum().item()):
        return None
    bad = ~np.isfinite(x).all(axis=1)
    return bad if bad.any() else None


def _split_item(item: Any) -> tuple[np.ndarray, np.ndarray | None, np.ndarray | None]:
    """(x, y or None, w or None) of one source item: a bare matrix or an
    ``(x,)``/``(x, y)``/``(x, y, w)`` tuple."""
    if not isinstance(item, tuple):
        return np.asarray(item), None, None
    x = np.asarray(item[0])
    y = np.asarray(item[1]) if len(item) > 1 and item[1] is not None else None
    w = np.asarray(item[2]) if len(item) > 2 and item[2] is not None else None
    return x, y, w


def _bounded_wait(done, timeout_s: float) -> None:
    """Wait for the last fold (``done``, its CUDA event; None on the CPU),
    past the ``fold.wait`` fault site, for at most ``timeout_s`` seconds (0
    or less: no bound). The site runs on a daemon thread and the event is
    polled, so a hang in either raises ``FoldHangTimeout`` at the deadline;
    the stuck thread or work is abandoned with the process, which is
    poisoned for more device work (``retry.ErrorClass.POISONED``)."""
    if not timeout_s or timeout_s <= 0:
        faults.inject(sites.FOLD_WAIT)
        if done is not None:
            done.synchronize()
        return
    deadline = time.monotonic() + timeout_s
    box: dict[str, BaseException] = {}

    def gate() -> None:
        try:
            faults.inject(sites.FOLD_WAIT)
        except BaseException as e:  # noqa: BLE001 - raised again on the caller
            box["error"] = e

    t = threading.Thread(target=gate, name="tpu-ml-fold-wait", daemon=True)
    t.start()
    t.join(timeout_s)
    while not t.is_alive() and done is not None and not done.query():
        if time.monotonic() >= deadline:
            break
        time.sleep(1e-4)
    if t.is_alive() or (done is not None and not done.query()):
        raise R.FoldHangTimeout(
            f"fold.wait did not complete within {timeout_s:g}s: the device fold is "
            "hung, not slow (check the card's health). Raise "
            f"{FOLD_WAIT_TIMEOUT_S_VAR} to wait longer, or set it to 0 to disable the bound."
        )
    if "error" in box:
        raise box["error"]


_CKPT_LEAF = "leaf_{:03d}"


def _carry_leaves(carry) -> list:
    """The carry's leaves in order: tensors, or stacked per-shard partials
    (``mesh.Sharded``), in a bare leaf or nested tuples of them."""
    if not isinstance(carry, (tuple, list)):
        return [carry]
    return [leaf for part in carry for leaf in _carry_leaves(part)]


def _leaf_to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return leaf.join().cpu().numpy()  # the [shards, ...] stack


def _leaf_from_host(leaf, array: np.ndarray) -> None:
    host = torch.from_numpy(np.asarray(array))
    if isinstance(leaf, torch.Tensor):
        leaf.copy_(host)
        return
    for (i, _), block in leaf.blocks.items():
        block.copy_(host[i:i + 1])


def _save_stream_checkpoint(ckpt, carry, *, chunks, seen, skipped, chunk_rows) -> None:
    """Save the carry (copied to the host, which waits for every fold
    queued before it: the checkpoint is the stream's position) and the
    cursor, in the JAX fold's format."""
    arrays = {
        _CKPT_LEAF.format(i): _leaf_to_host(leaf)
        for i, leaf in enumerate(_carry_leaves(carry))
    }
    ckpt.save(chunks, arrays, {
        "kind": "stream_fold",
        "rows_seen": int(seen),
        "skipped_rows": int(skipped),
        "chunks": int(chunks),
        "chunk_rows": int(chunk_rows),
    })
    REGISTRY.counter_inc("stream.checkpoints")
    TIMELINE.record_instant("stream.checkpoint", chunk=int(chunks), rows_seen=int(seen))


def _restore_stream_checkpoint(ckpt, carry) -> dict | None:
    """Copy the newest ``stream_fold`` checkpoint into ``carry``'s tensors
    (their device and dtype) and return its state; None when there is none.
    A checkpoint of another kind is ignored, not misread."""
    latest = ckpt.latest()
    if latest is None:
        return None
    _, arrays, state = latest
    if state.get("kind") != "stream_fold":
        return None
    for i, leaf in enumerate(_carry_leaves(carry)):
        _leaf_from_host(leaf, arrays[_CKPT_LEAF.format(i)])
    return state


def stream_fold(
    source: Iterable[Any],
    fold_fn: Callable,
    *,
    n: int,
    init,
    device: torch.device,
    chunk_rows: int | None = None,
    nonfinite: str | None = None,
    label_col: str | None = None,
    checkpointer=None,
    checkpoint_every: int | None = None,
    min_chunk_rows: int | None = None,
    fold_wait_timeout_s: float | None = None,
    features_col: str | None = None,
    weight_col: str | None = None,
    rows: int | None = None,
    put_fn: Callable | None = None,
    augment_intercept: bool = False,
) -> StreamFold:
    """Fold ``source``, an iterable of host [rows, n] matrices, chunk by
    chunk through ``fold_fn(carry, x, w) -> carry`` (``linalg.gram_fold_step``),
    which gets the device view of each chunk's true rows and their unit
    weights on the host. With ``label_col`` (any name: an iterable source
    has no columns, it only says that labels flow) the items are
    ``(x, y)``/``(x, y, w)`` tuples and the fold is
    ``fold_fn(carry, x, y, w) -> carry`` (``linear.linear_fold_step``) on
    device views of all three. ``init`` is the zero carry on ``device`` or a
    callable that makes it. Non-finite rows follow ``nonfinite``
    (``TPU_ML_NONFINITE_POLICY``): ``raise`` (default), ``skip`` (drop and
    count them) or ``allow`` (no scan). ``checkpointer``, ``checkpoint_every``
    (``TPU_ML_STREAM_CHECKPOINT_EVERY_CHUNKS``), ``min_chunk_rows``
    (``TPU_ML_STREAM_CHUNK_FLOOR``) and ``fold_wait_timeout_s``
    (``TPU_ML_FOLD_WAIT_TIMEOUT_S``) are the recoveries of the module note.
    A resumed fold needs the same source again, from its start. Spans:
    ``ingest.chunk``, ``fold.dispatch``, ``fold.wait``.

    With ``features_col`` the source is a DataFrame ([features, label?,
    weight?]; ``label_col`` and ``weight_col`` name real columns) whose
    ``count()`` (or ``rows``) the drained rows must match. ``put_fn`` maps
    each device view (and the weights) before the fold, e.g.
    ``parallel.gram.chunk_put(mesh)``. ``augment_intercept`` gives the fold
    [rows, n + 1] views whose last column is ones (the Newton programs'
    intercept column)."""
    cfg = get_config()
    if weight_col is not None and label_col is None:
        raise NotImplementedError(
            "an unlabeled fold stages unit weights only: weight_col needs label_col"
        )
    if features_col is not None:
        if rows is None:
            rows = source.count()
        source = _iter_chunks(source, features_col, label_col, weight_col,
                              est_bytes=rows * n * 8)
    n_eff = n + 1 if augment_intercept else n
    tune_geometry = chunk_rows is None
    chunk_rows = stream_chunk_rows() if chunk_rows is None else chunk_rows
    nonfinite = nonfinite or cfg.nonfinite_policy
    if nonfinite not in VALID_NONFINITE_POLICIES:
        raise ValueError(
            f"nonfinite={nonfinite!r} must be one of {VALID_NONFINITE_POLICIES}"
        )
    if min_chunk_rows is None:
        min_chunk_rows = max(
            1, int(os.environ.get(STREAM_CHUNK_FLOOR_VAR, DEFAULT_STREAM_CHUNK_FLOOR))
        )
    if checkpoint_every is None:
        checkpoint_every = cfg.stream_checkpoint_every_chunks
    if fold_wait_timeout_s is None:
        fold_wait_timeout_s = float(cfg.fold_wait_timeout_s)
    policy = R.RetryPolicy.from_config()
    transient_only = frozenset({R.ErrorClass.TRANSIENT})
    cuda = device.type == "cuda"
    labeled = label_col is not None
    carry = init() if callable(init) else init
    if tune_geometry:
        # lazy: autotune/search.py imports utils/config.py, like this module
        from spark_rapids_ml_tpu_torch import autotune

        tuned = autotune.resolve(
            "stream.fold_step",
            n=n,
            dtype="float32",
            device=autotune.cache.device_kind(device),
            measure=autotune.stream_fold_measure(fold_fn, carry, n_eff, device,
                                                 want_y=labeled),
            candidates=autotune.candidate_grid(chunk_rows, floor=min_chunk_rows),
        )
        if tuned is not None and tuned.chunk_rows:
            chunk_rows = max(min_chunk_rows, columnar.bucket_rows(int(tuned.chunk_rows)))

    seen = skipped = n_chunks = overlapped = copy_overlapped = max_put = 0
    bisections = last_ckpt = resume_skip = 0
    resumed = False
    if checkpointer is not None:
        state = _restore_stream_checkpoint(checkpointer, carry)
        if state is not None:
            seen = int(state["rows_seen"])
            skipped = int(state["skipped_rows"])
            n_chunks = last_ckpt = int(state["chunks"])
            # go on at the (perhaps bisected) size the earlier run settled on
            chunk_rows = min(chunk_rows, int(state["chunk_rows"]))
            resume_skip = seen + skipped
            resumed = True
            REGISTRY.counter_inc("stream.resumes")
            TIMELINE.record_instant("stream.resume", chunk=n_chunks, rows_seen=seen)
            logger.warning(
                "resuming streamed fit from checkpoint (chunk %d, %d rows already folded)",
                n_chunks, seen,
            )

    # one staging row holds x, then y and w when labels flow; pin_memory
    # raises on a build without CUDA, so only pin for the card
    width = n_eff + 2 if labeled else n_eff
    staging = [
        torch.empty((chunk_rows, width), dtype=torch.float32, pin_memory=cuda)
        for _ in range(2)
    ]
    unit_w = torch.ones((chunk_rows,), dtype=torch.float32, pin_memory=cuda)
    if cuda:
        on_card = [
            torch.empty((chunk_rows, width), dtype=torch.float32, device=device)
            for _ in range(2)
        ]
        copy_stream = torch.cuda.Stream(device)
        fold_stream = torch.cuda.current_stream(device)
    copied: list[Any] = [None, None]  # staging[s] → on_card[s] copy ended
    folded: list[Any] = [None, None]  # the fold that read on_card[s] ended
    slot = fill = 0

    progress_every = progress_interval()
    progress_t0 = last_beat = time.perf_counter()
    retries0 = REGISTRY.snapshot().counter("retry.attempts") if progress_every else 0

    def maybe_heartbeat() -> None:
        nonlocal last_beat
        if not progress_every:
            return
        now = time.perf_counter()
        if now - last_beat < progress_every:
            return
        last_beat = now
        elapsed = max(now - progress_t0, 1e-9)
        retries = REGISTRY.snapshot().counter("retry.attempts") - retries0
        fid = current_fit_id() or ""
        print(
            f"[tpu-ml progress{' ' + fid if fid else ''}] "
            f"rows={seen} ({seen / elapsed:,.0f} rows/s) "
            f"chunks={n_chunks} chunk_rows={chunk_rows} "
            f"retries={retries:g} bisections={bisections}",
            file=sys.stderr,
            flush=True,
        )

    def fold_rows(lo: int, hi: int) -> None:
        """Fold staging rows [lo, hi) of the current slot; the fault site
        comes before the copy, so a failed attempt changes nothing."""
        nonlocal carry, n_chunks, overlapped, copy_overlapped, max_put
        rows = hi - lo
        with trace_range("fold.dispatch", device):
            faults.inject(sites.FOLD_DISPATCH)
            if cuda:
                previous = folded[1 - slot]
                if previous is not None and not previous.query():
                    overlapped += 1
                with torch.cuda.stream(copy_stream):
                    if folded[slot] is not None:
                        copy_stream.wait_event(folded[slot])
                    on_card[slot][:rows].copy_(staging[slot][lo:hi], non_blocking=True)
                    copied[slot] = copy_stream.record_event()
                REGISTRY.counter_inc("h2d.bytes", rows * width * 4, path="stream")
                fold_stream.wait_event(copied[slot])
                block = on_card[slot][:rows]
            else:
                block = staging[slot][lo:hi]
            args = ((block[:, :n_eff], block[:, n_eff], block[:, n_eff + 1]) if labeled
                    else (block, unit_w[:rows]))
            costmodel.capture("stream.fold_step", fold_fn, carry, *args)
            if put_fn is not None:
                args = tuple(put_fn(a) for a in args)
            carry = fold_fn(carry, *args)
            if cuda:
                folded[slot] = fold_stream.record_event()
                if not copied[slot].query():
                    copy_overlapped += 1
        n_chunks += 1
        max_put = max(max_put, rows * width * 4)

    def dispatch() -> None:
        """Fold the staged chunk, retrying transient faults and bisecting
        on a device OOM, then switch staging slots."""
        nonlocal slot, fill, chunk_rows, bisections
        queue = [(0, fill, chunk_rows)]  # (first row, end, rows the piece was cut to)
        while queue:
            lo, hi, cut = queue.pop(0)
            try:
                R.call_with_retry(
                    lambda: fold_rows(lo, hi),
                    site=sites.FOLD_DISPATCH,
                    policy=policy,
                    retry_on=transient_only,
                )
            except Exception as e:  # noqa: BLE001 - classified below
                if R.classify(e) is not R.ErrorClass.RESOURCE_EXHAUSTED:
                    raise
                half = cut // 2
                new = half - half % min_chunk_rows
                if new < min_chunk_rows or new >= cut:
                    raise  # at the floor: the OOM is not the chunk's size
                logger.warning(
                    "device OOM folding a %d-row chunk; bisecting to %d rows and "
                    "re-dispatching", cut, new,
                )
                REGISTRY.counter_inc("chunk.bisections")
                TIMELINE.record_instant("chunk.bisection", from_rows=cut, to_rows=new)
                bisections += 1
                queue[:0] = [(a, min(a + new, hi), new) for a in range(lo, hi, new)]
                chunk_rows = min(chunk_rows, new)
        REGISTRY.gauge_set("stream.last_beat", time.monotonic())
        slot, fill = 1 - slot, 0
        if copied[slot] is not None:
            copied[slot].synchronize()  # before this staging buffer refills

    it = iter(source)
    REGISTRY.gauge_set("stream.active", 1)
    REGISTRY.gauge_set("stream.last_beat", time.monotonic())
    hung = False
    try:
        while True:
            with trace_range("ingest.chunk", device):
                try:
                    item = next(it)
                except StopIteration:
                    break
            xc, yc, wc = _split_item(item)
            REGISTRY.counter_inc("ingest.rows", len(xc))
            REGISTRY.counter_inc("ingest.bytes", xc.nbytes)
            REGISTRY.histogram_record("ingest.chunk_rows", len(xc))
            TIMELINE.record_instant("stream.chunk", rows=len(xc), nbytes=int(xc.nbytes))
            if xc.ndim != 2 or xc.shape[1] != n:
                raise ValueError(
                    f"feature dimension changed mid-stream: expected {n}, "
                    f"got {xc.shape[1:]}"
                )
            if labeled and yc is None:
                raise ValueError("label column missing from a streamed chunk")
            if resume_skip:
                # the rows an earlier run folded (or skipped), counted before
                # any filter, so the cursor is exact under every policy
                drop = min(resume_skip, len(xc))
                resume_skip -= drop
                xc = xc[drop:]
                yc = yc[drop:] if yc is not None else None
                wc = wc[drop:] if wc is not None else None
                if not len(xc):
                    continue
            xc = R.call_with_retry(
                lambda: faults.inject(sites.INGEST_CHUNK, xc),
                site=sites.INGEST_CHUNK,
                policy=policy,
                retry_on=transient_only,
            )
            # the raw index of each kept row (None: every row is kept) and
            # the skipped count before this item: a checkpoint inside the
            # item counts only the rows skipped before its cursor
            kept_at, skipped_before = None, skipped
            if nonfinite != "allow":
                bad = _nonfinite_rows(xc)
                for side in (yc, wc):
                    if side is not None and not np.isfinite(side).all():
                        side_bad = ~np.isfinite(side)
                        bad = side_bad if bad is None else bad | side_bad
                if bad is not None:
                    n_bad = int(bad.sum())
                    if nonfinite == "raise":
                        raise ValueError(
                            f"{n_bad} non-finite input row(s) in a streamed "
                            "chunk; set TPU_ML_NONFINITE_POLICY=skip to drop "
                            "and count them instead"
                        )
                    keep = ~bad
                    kept_at = np.flatnonzero(keep)
                    xc = xc[keep]
                    yc = yc[keep] if yc is not None else None
                    wc = wc[keep] if wc is not None else None
                    skipped += n_bad
                    REGISTRY.counter_inc("rows.nonfinite_skipped", n_bad)
            if wc is not None:
                wc = columnar.validate_weights(wc, len(xc), allow_all_zero=True)
            at = 0
            while at < len(xc):
                take = min(chunk_rows - fill, len(xc) - at)
                rows_at = staging[slot][fill : fill + take]
                rows_at[:, :n].copy_(_host_tensor(xc[at : at + take]))
                if augment_intercept:
                    rows_at[:, n] = 1.0
                if labeled:
                    rows_at[:, n_eff].copy_(_host_tensor(yc[at : at + take]))
                    if wc is None:
                        rows_at[:, n_eff + 1] = 1.0
                    else:
                        rows_at[:, n_eff + 1].copy_(_host_tensor(wc[at : at + take]))
                fill += take
                at += take
                seen += take
                if fill == chunk_rows:
                    dispatch()
                    maybe_heartbeat()
                    if checkpointer is not None and n_chunks - last_ckpt >= checkpoint_every:
                        raw_at = at if kept_at is None else (
                            int(kept_at[at]) if at < len(kept_at) else len(kept_at) + (
                                skipped - skipped_before))
                        _save_stream_checkpoint(
                            checkpointer, carry, chunks=n_chunks, seen=seen,
                            skipped=skipped_before + raw_at - at, chunk_rows=chunk_rows,
                        )
                        last_ckpt = n_chunks
        if fill:
            dispatch()  # the ragged tail
        if seen == 0:
            raise ValueError("empty dataset")
        if rows is not None and seen + skipped != rows:
            raise ValueError(
                f"dataset produced {seen + skipped} rows while streaming but count() "
                f"reported {rows}; cache() the DataFrame if its source is nondeterministic"
            )
        with trace_range("fold.wait", device):
            try:
                _bounded_wait(folded[1 - slot] if cuda else None, fold_wait_timeout_s)
            except R.FoldHangTimeout:
                hung = True
                raise
    finally:
        # cleared on every exit: the monitor reads an inactive stream as OK
        REGISTRY.gauge_set("stream.active", 0)
        if cuda and not hung:
            # no copy may still write a device buffer once it is freed
            copy_stream.synchronize()
    REGISTRY.histogram_record("stream.overlap_fraction", overlapped / max(n_chunks, 1))
    return StreamFold(
        carry=carry,
        rows=seen,
        chunks=n_chunks,
        overlapped=overlapped,
        max_put_bytes=max_put,
        skipped_rows=skipped,
        copy_overlapped=copy_overlapped,
        bisections=bisections,
        resumed=resumed,
    )
