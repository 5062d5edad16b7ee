"""Executors as one process mesh: the barrier-stage fit path.

Port of the generic half of ``spark_rapids_ml_tpu/spark/spmd.py``. The N
partition tasks of ONE barrier stage join a ``torch.distributed`` process
group and run one shard program whose cross-partition reduction is a
collective (``parallel/backend.py``); the driver receives a single row,
already reduced. No per-partition [n, n] buffer crosses a process boundary
or reaches the driver.

1. the estimator launches ``mapInArrow(fn, schema, barrier=True)``: all N
   tasks run at once (Spark's barrier mode, or ``localspark``'s);
2. one ``allGather`` round of the barrier context exchanges ``{rank, rows,
   n, store}``: rank 0 opens a ``TCPStore`` on port 0 (no port to race for)
   and proposes its address, and the row counts give the common shard
   shape every rank pads to (collectives need equal shapes; zero rows are
   exact for every monoid reduced here);
3. each task joins the group through that store: gloo on the CPU and where
   several ranks share one card, NCCL where each rank owns one
   (``backend.pick_backend``);
4. the program runs on the [N, 1] process mesh (``backend.process_mesh``):
   every rank gathers the ranks' partials and reduces them in rank order,
   so every rank holds the same bits, equal to the in-process mesh
   program's on the same shards;
5. rank 0 alone yields the one row; the others yield nothing. A rank that
   fails fails the stage (its peers are torn down) and no row is emitted.

Each body's array half is ``mesh_arrays(batches, ctx)``: the partition's
batches (Arrow or any frame of named columns) and a barrier context in,
host arrays out on rank 0. ``__call__`` wraps it with the Arrow codec, so
the array half runs without pyarrow.

This half holds the Gram (PCA, TruncatedSVD), moments (StandardScaler),
TSQR (PCA ``solver="svd"``) and TruncatedSVD bodies. The LinearRegression,
LogisticRegression, softmax and KMeans bodies are ROADMAP Queue A's next
item.
"""

from __future__ import annotations

import datetime
import json
from typing import Iterator

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.ops import linalg as L
from spark_rapids_ml_tpu_torch.spark import arrow_fns
from spark_rapids_ml_tpu_torch.utils import columnar

MESH_FIELDS = ["xtx", "col_sum", "count", "mesh_size"]
MOMENTS_MESH_FIELDS = ["total", "total_sq", "count", "mesh_size"]
SVD_FIT_FIELDS = ["pc", "explainedVariance", "count", "mesh_size"]
TSVD_FIT_FIELDS = ["components", "singularValues", "count", "mesh_size"]

_RENDEZVOUS_TIMEOUT_S = 300.0


def get_barrier_context():
    """The live barrier context: pyspark's inside a Spark barrier task, the
    port's ``localspark``'s inside its ``mapInArrow(..., barrier=True)``."""
    try:
        from pyspark import BarrierTaskContext as SparkCtx  # type: ignore

        ctx = SparkCtx.get()
        if ctx is not None:
            return ctx
    except Exception:  # noqa: BLE001 - pyspark absent, or not a barrier task
        pass
    from spark_rapids_ml_tpu_torch.localspark.taskcontext import BarrierTaskContext

    return BarrierTaskContext.get()


def _pad_to(mat: np.ndarray, rows: int) -> np.ndarray:
    if mat.shape[0] == rows:
        return mat
    out = np.zeros((rows,) + mat.shape[1:], dtype=mat.dtype)
    out[: mat.shape[0]] = mat
    return out


def _rank_device(device: str, rank: int) -> torch.device:
    """A rank's device: its own card where there are enough (cuda:rank mod
    cards), else the shared one."""
    dev = arrow_fns.worker_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() > 1:
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


class _MeshReducePartitionFn:
    """A barrier-stage body: one psum of a sum monoid over the process mesh.

    Subclasses set ``FIELDS`` (ending with ``count`` and ``mesh_size``) and
    give ``_shard_kernel()``, or override ``_run_on_mesh`` with a whole fit.
    With ``USES_VECTORS`` the kernel takes ``(x, w, y)``: ``w`` holds the
    instance weights on true rows and 0 on pad rows, ``y`` the labels.
    Picklable: plain column names and tags; everything heavy happens in the
    task."""

    FIELDS: list[str] = []
    #: the count comes from the rendezvous row total unless the kernel
    #: emits a weighted count
    COUNT_FROM_KERNEL = False
    USES_VECTORS = False

    def __init__(self, input_col: str, label_col: str | None = None,
                 weight_col: str | None = None, precision: str = "highest",
                 device: str = "cuda"):
        self.input_col = input_col
        self.label_col = label_col
        self.weight_col = weight_col
        self.precision = precision
        self.device = str(device)

    def _prepare_matrix(self, mat: np.ndarray) -> np.ndarray:
        return mat

    def _shard_kernel(self):
        raise NotImplementedError

    def _run_on_mesh(self, mesh, gx, gw, gy) -> dict[str, np.ndarray]:
        """The program on the process mesh, host arrays out. Default: one
        psum of ``_shard_kernel``'s monoid."""
        from spark_rapids_ml_tpu_torch.parallel import backend as B

        operands, specs = [gx], [B.MATRIX_SPEC]
        if self.USES_VECTORS:
            operands += [gw, gy]
            specs += [B.VECTOR_SPEC, B.VECTOR_SPEC]
        stats = B.mapreduce_data_axis(self._shard_kernel(), mesh, in_specs=tuple(specs))(*operands)
        return {name: v.detach().cpu().numpy().astype(np.float64) for name, v in stats.items()}

    def _local_arrays(self, batches):
        mats, ys, ws = [], [], []
        for b in batches:
            if not getattr(b, "num_rows", len(b)):
                continue
            mat = self._prepare_matrix(columnar.extract_matrix(b, self.input_col))
            mats.append(mat.astype(np.float32, copy=False))
            if self.label_col:
                ys.append(columnar.extract_vector(b, self.label_col).astype(np.float32))
            if self.weight_col:
                ws.append(columnar.validate_weights(
                    columnar.extract_vector(b, self.weight_col), len(mat), allow_all_zero=True,
                ).astype(np.float32))
        local = np.concatenate(mats) if mats else np.zeros((0, 0), np.float32)
        y = np.concatenate(ys) if ys else np.zeros(local.shape[0], np.float32)
        w = np.concatenate(ws) if ws else np.ones(local.shape[0], np.float32)
        return local, y, w

    def mesh_arrays(self, batches, ctx) -> dict[str, np.ndarray] | None:
        """The array half: this partition's rows through the stage's program;
        the reduced host arrays on rank 0, None on the other ranks."""
        import torch.distributed as dist

        from spark_rapids_ml_tpu_torch.parallel import backend as B
        from spark_rapids_ml_tpu_torch.parallel import mesh as M

        rank = ctx.partitionId()
        size = len(ctx.getTaskInfos())
        local, y_local, w_local = self._local_arrays(batches)
        host = ctx.getTaskInfos()[rank].address.split(":")[0] if rank < size else "127.0.0.1"
        store = None
        timeout = datetime.timedelta(seconds=_RENDEZVOUS_TIMEOUT_S)
        if rank == 0:
            store = dist.TCPStore(host, 0, size, True, timeout=timeout, wait_for_workers=False)
        proposal = {
            "rank": rank,
            "rows": int(local.shape[0]),
            "n": int(local.shape[1]),
            "store": f"{host}:{store.port}" if store is not None else None,
        }
        by_rank = sorted((json.loads(m) for m in ctx.allGather(json.dumps(proposal))),
                         key=lambda g: g["rank"])
        n = max(g["n"] for g in by_rank)
        total_rows = sum(g["rows"] for g in by_rank)
        max_rows = max(g["rows"] for g in by_rank)
        if local.shape[0] == 0 and local.shape[1] != n:
            # an empty partition adopts the group's width, so its pad is legal
            local = np.zeros((0, n), np.float32)
        if store is None:
            addr, port = by_rank[0]["store"].rsplit(":", 1)
            store = dist.TCPStore(addr, int(port), size, False, timeout=timeout)
        device = _rank_device(self.device, rank)
        B.initialize(store=store, world_size=size, rank=rank, device=device,
                     timeout_s=_RENDEZVOUS_TIMEOUT_S)
        try:
            mesh = B.process_mesh(device)
            shard_rows = columnar.bucket_rows(max(max_rows, 1))
            gx = M.data_sharding(mesh).shard(torch.from_numpy(_pad_to(local, shard_rows)))
            gw = gy = None
            if self.USES_VECTORS:
                vec = M.vector_sharding(mesh)
                gw = vec.shard(torch.from_numpy(_pad_to(w_local, shard_rows)))  # pads weigh 0
                if self.label_col:
                    gy = vec.shard(torch.from_numpy(_pad_to(y_local, shard_rows)))
            out = self._run_on_mesh(mesh, gx, gw, gy)
        finally:
            B.shutdown()
        if rank != 0:
            return None
        if not self.COUNT_FROM_KERNEL:
            # pad rows add zero to every statistic; the true total is the
            # rendezvous's
            out["count"] = np.float64(total_rows)
        out["mesh_size"] = np.float64(size)
        return {name: out[name] for name in self.FIELDS}

    def __call__(self, batches: Iterator) -> Iterator:
        arrays = self.mesh_arrays(batches, get_barrier_context())
        if arrays is not None:
            yield arrow_fns.arrays_to_batch(arrays)


class MeshGramPartitionFn(_MeshReducePartitionFn):
    """GramStats by one psum over the process mesh (the PCA and
    TruncatedSVD barrier path); at ``"high"`` each rank's Gram is one
    ``fused_gram_moments`` launch. ``exact_diagonal``: ``ops.linalg``'s
    rule at ``"default"``."""

    FIELDS = MESH_FIELDS

    def __init__(self, input_col: str, precision: str = "highest", device: str = "cuda",
                 exact_diagonal: bool = True):
        super().__init__(input_col, precision=precision, device=device)
        self.exact_diagonal = exact_diagonal

    def _shard_kernel(self):
        precision, exact = self.precision, self.exact_diagonal

        def kernel(x):  # zero pad rows are exact for the Gram monoid
            stats = L.gram_stats(x, precision=precision, exact_diagonal=exact)
            return {"xtx": stats.xtx, "col_sum": stats.col_sum}

        return kernel


class MeshMomentsPartitionFn(_MeshReducePartitionFn):
    """MomentStats by one psum (the StandardScaler barrier path)."""

    FIELDS = MOMENTS_MESH_FIELDS

    def _shard_kernel(self):
        def kernel(x):
            return {"total": x.sum(dim=0), "total_sq": (x * x).sum(dim=0)}

        return kernel


class MeshSVDFitFn(_MeshReducePartitionFn):
    """The direct PCA fit in one barrier stage: per-rank QR, the butterfly
    over the process mesh, the SVD of R (``parallel/tsqr.py``). The pad mask
    rides the weight vector, so centering stays exact under the common
    padded shape."""

    FIELDS = SVD_FIT_FIELDS

    def __init__(self, input_col: str, k: int, mean_centering: bool, device: str = "cuda"):
        super().__init__(input_col, device=device)
        self.k = int(k)
        self.mean_centering = bool(mean_centering)
        # only the centered program reads the 1/0 pad mask
        self.USES_VECTORS = self.mean_centering

    def _run_on_mesh(self, mesh, gx, gw, gy):
        from spark_rapids_ml_tpu_torch.parallel import tsqr as TSQR

        if self.mean_centering:
            pc, ev = TSQR.make_distributed_fit_svd_masked(mesh, self.k, mean_centering=True)(gx, gw)
        else:  # zero pad rows are exact for the uncentered QR
            pc, ev = TSQR.make_distributed_fit_svd(mesh, self.k)(gx)
        return {"pc": pc.cpu().numpy().astype(np.float64),
                "explainedVariance": ev.cpu().numpy().astype(np.float64)}


class MeshTSVDFitFn(_MeshReducePartitionFn):
    """TruncatedSVD's barrier fit: TSQR over the process mesh (uncentered,
    so zero pad rows are exact), then the SVD of R: components and the raw
    singular values of X."""

    FIELDS = TSVD_FIT_FIELDS

    def __init__(self, input_col: str, k: int, device: str = "cuda"):
        super().__init__(input_col, device=device)
        self.k = int(k)

    def _run_on_mesh(self, mesh, gx, gw, gy):
        from spark_rapids_ml_tpu_torch.parallel import tsqr as TSQR

        components, sv = L.svd_components_from_r(TSQR.tsqr_r(gx, mesh), self.k)
        return {"components": components.cpu().numpy().astype(np.float64),
                "singularValues": sv[: self.k].cpu().numpy().astype(np.float64)}


def single_row_from_batches(batches, fields: list[str], shapes: dict[str, tuple]
                            ) -> dict[str, np.ndarray]:
    """Decode a barrier stage's output: exactly one reduced row. More than
    one means per-partition statistics reached the driver, the regression
    this path exists to prevent, so it raises instead of summing."""
    import pyarrow as pa

    rows = 0
    arrays = None
    for b in batches:
        t = pa.Table.from_batches([b]) if isinstance(b, pa.RecordBatch) else b
        rows += t.num_rows
        if t.num_rows and arrays is None:
            arrays = {name: np.asarray(t.column(name)[0].values.to_numpy(zero_copy_only=False))
                      for name in fields}
    if arrays is None:
        raise ValueError("no statistics received from the barrier stage")
    if rows != 1:
        raise AssertionError(
            f"mesh fit must deliver exactly ONE pre-reduced stats row to the driver, "
            f"got {rows}: per-partition statistics are leaking"
        )
    return {name: arrays[name].reshape(shapes[name]) for name in fields}


def single_stats_from_batches(batches, n: int) -> tuple[L.GramStats, int]:
    """The PCA-shaped decode of ``single_row_from_batches``: host f64
    GramStats and the mesh size."""
    arrays = single_row_from_batches(
        batches, MESH_FIELDS, {"xtx": (n, n), "col_sum": (n,), "count": (), "mesh_size": ()}
    )
    stats = L.GramStats(arrays["xtx"], arrays["col_sum"], np.float64(arrays["count"]))
    return stats, int(arrays["mesh_size"])
