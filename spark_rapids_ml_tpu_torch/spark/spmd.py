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

The bodies: the Gram (PCA, TruncatedSVD), moments (StandardScaler), TSQR
(PCA ``solver="svd"``) and TruncatedSVD reductions; LinearStats
(LinearRegression); and three whole fits in one stage, the binary and
softmax Newton loops (``MeshLogRegFitFn``, ``MeshSoftmaxFitFn``) and the
Lloyd loop (``MeshKMeansFitFn``), whose host loops
(``parallel/linear.py``, ``parallel/kmeans.py``) run in step on every rank
because each stop decision reads reduced values only. Under
``checkpoint_dir`` (a path every rank and the driver share) rank 0 alone
saves between chunks and every rank runs the same loop; the driver
resolves a resume before it launches the stage.
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
LINREG_MESH_FIELDS = ["xtx", "xty", "x_sum", "y_sum", "y_sq", "count", "mesh_size"]
MOMENTS_MESH_FIELDS = ["total", "total_sq", "count", "mesh_size"]
SVD_FIT_FIELDS = ["pc", "explainedVariance", "count", "mesh_size"]
TSVD_FIT_FIELDS = ["components", "singularValues", "count", "mesh_size"]
LOGREG_FIT_FIELDS = ["w", "iterations", "count", "mesh_size"]
KMEANS_FIT_FIELDS = ["centers", "cost", "iterations", "count", "mesh_size"]

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


def _raise_root_cause(store, rank: int, size: int, error: Exception):
    """Re-raise a rank's failure so that the stage names its root cause: the
    failure is posted on the rendezvous store before this rank leaves the
    group, and a rank whose collective broke because a peer left first
    raises with that peer's posted failure (a barrier stage reports whichever
    rank's error arrives first)."""
    try:
        store.set(f"failed/{rank}", f"{type(error).__name__}: {error}")
        peers = [r for r in range(size) if r != rank and store.check([f"failed/{r}"])]
        cause = store.get(f"failed/{peers[0]}").decode() if peers else None
    except Exception:  # noqa: BLE001 - the store went with a peer: keep the own error
        cause = None
    if cause is not None:
        raise RuntimeError(f"barrier rank {peers[0]} failed first: {cause}") from error
    raise error


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
        except Exception as e:
            _raise_root_cause(store, rank, size, e)
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


class MeshLinRegPartitionFn(_MeshReducePartitionFn):
    """LinearStats by one psum over the process mesh: the distributed
    normal equations, whose [n, n] and [n] reductions never reach the
    driver but as one row. The count is the weighted one (pad rows weigh
    0)."""

    FIELDS = LINREG_MESH_FIELDS
    COUNT_FROM_KERNEL = True
    USES_VECTORS = True

    def _shard_kernel(self):
        from spark_rapids_ml_tpu_torch.ops import linear as LIN

        def kernel(x, w, y):
            return LIN.linear_stats(x, y, w)._asdict()

        return kernel


def _weight_total(mesh, gw) -> float:
    """Σ w over every rank's rows (pad rows weigh 0), from one psum."""
    from spark_rapids_ml_tpu_torch.parallel import backend as B

    return float(B.psum(mesh, [b.sum() for b in gw.data_blocks()])[0])


def _rank0_checkpointer(mesh, checkpoint_dir: str | None):
    """The checkpointer of a barrier fit: rank 0's alone (the other ranks
    run the same loop and save nothing)."""
    if checkpoint_dir is None or mesh.rank not in (None, 0):
        return None
    from spark_rapids_ml_tpu_torch.utils.checkpoint import TrainingCheckpointer

    return TrainingCheckpointer(checkpoint_dir)


class MeshLogRegFitFn(_MeshReducePartitionFn):
    """The whole binary Newton fit in one barrier stage: every iteration is
    the ranks' statistics, one psum and the replicated update
    (``parallel/linear.py``), so no Spark job runs per iteration; the
    driver receives the final [d] parameters. With ``checkpoint_dir`` the
    loop runs in ``checkpoint_every``-iteration chunks from ``w0`` and
    ``start_iter`` (the driver's resume), rank 0 saving between chunks."""

    FIELDS = LOGREG_FIT_FIELDS
    USES_VECTORS = True
    COUNT_FROM_KERNEL = True

    def __init__(self, features_col: str, label_col: str, weight_col: str | None, *,
                 reg_param: float, fit_intercept: bool, max_iter: int, tol: float,
                 elastic_net_param: float = 0.0, checkpoint_dir: str | None = None,
                 checkpoint_every: int = 5, w0: np.ndarray | None = None,
                 start_iter: int = 0, device: str = "cuda"):
        super().__init__(features_col, label_col, weight_col, device=device)
        self.reg_param = float(reg_param)
        self.elastic_net_param = float(elastic_net_param)
        self.fit_intercept = bool(fit_intercept)
        self.max_iter = int(max_iter)
        self.tol = float(tol)
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = int(checkpoint_every)
        self.w0 = None if w0 is None else np.asarray(w0)
        self.start_iter = int(start_iter)

    def _prepare_matrix(self, mat: np.ndarray) -> np.ndarray:
        if self.fit_intercept:
            return np.concatenate([mat, np.ones((mat.shape[0], 1), mat.dtype)], axis=1)
        return mat

    def _reg(self) -> dict:
        return dict(reg_param=self.reg_param, elastic_net_param=self.elastic_net_param,
                    fit_intercept=self.fit_intercept)

    def _make_fit(self, mesh):
        """The whole-loop program: the one hook the softmax body swaps."""
        from spark_rapids_ml_tpu_torch.parallel import linear as PL

        return PL.make_distributed_logreg_fit(mesh, max_iter=self.max_iter, tol=self.tol,
                                              **self._reg())

    def _make_chunk(self, mesh):
        from spark_rapids_ml_tpu_torch.parallel import linear as PL

        return PL.make_distributed_logreg_chunk(mesh, chunk_iters=self.checkpoint_every,
                                                tol=self.tol, **self._reg())

    def _param_dim(self, d: int) -> int:
        return d

    def _run_on_mesh(self, mesh, gx, gw, gy):
        from spark_rapids_ml_tpu_torch.ops import linear as LIN
        from spark_rapids_ml_tpu_torch.parallel import linear as PL

        count = _weight_total(mesh, gw)
        cd = self._param_dim(gx.shape[1])
        if count == 0.0:
            # all-zero weights: no training (the solve would NaN for the
            # wrong reason); the driver raises its contract error on the
            # returned count
            return {"w": np.zeros(cd), "iterations": np.float64(0.0), "count": np.float64(0.0)}
        if self.checkpoint_dir is None:
            w, iters, step = self._make_fit(mesh)(gx, gy, gw)
            LIN.check_newton_outcome(step, w)
        else:
            w, iters = PL.run_chunked_newton(
                self._make_chunk(mesh), gx, gy, gw,
                self.w0 if self.w0 is not None else np.zeros(cd),
                start_iter=self.start_iter, max_iter=self.max_iter, tol=self.tol,
                ckpt=_rank0_checkpointer(mesh, self.checkpoint_dir),
            )
        return {"w": w.cpu().numpy().astype(np.float64), "iterations": np.float64(int(iters)),
                "count": np.float64(count)}


class MeshSoftmaxFitFn(MeshLogRegFitFn):
    """The multinomial sibling of ``MeshLogRegFitFn``: the whole softmax
    Newton loop in one barrier stage; ``w`` comes back flattened [C·d]."""

    def __init__(self, features_col: str, label_col: str, weight_col: str | None,
                 n_classes: int, **kwargs):
        super().__init__(features_col, label_col, weight_col, **kwargs)
        self.n_classes = int(n_classes)

    def _make_fit(self, mesh):
        from spark_rapids_ml_tpu_torch.parallel import linear as PL

        return PL.make_distributed_softmax_fit(mesh, self.n_classes, max_iter=self.max_iter,
                                               tol=self.tol, **self._reg())

    def _make_chunk(self, mesh):
        from spark_rapids_ml_tpu_torch.parallel import linear as PL

        return PL.make_distributed_softmax_chunk(mesh, self.n_classes,
                                                 chunk_iters=self.checkpoint_every,
                                                 tol=self.tol, **self._reg())

    def _param_dim(self, d: int) -> int:
        return self.n_classes * d


class MeshKMeansFitFn(_MeshReducePartitionFn):
    """The whole Lloyd fit in one barrier stage (``parallel/kmeans.py``):
    the initial centres ride the task state, the loop trains on the process
    mesh, the driver receives the final centres and cost. The weights mask
    pad rows and carry instance weights; checkpointing as
    ``MeshLogRegFitFn``'s."""

    FIELDS = KMEANS_FIT_FIELDS
    USES_VECTORS = True
    COUNT_FROM_KERNEL = True

    def __init__(self, input_col: str, centers: np.ndarray, weight_col: str | None, *,
                 max_iter: int, tol: float, checkpoint_dir: str | None = None,
                 checkpoint_every: int = 5, start_iter: int = 0, device: str = "cuda"):
        super().__init__(input_col, None, weight_col, device=device)
        self.centers = np.asarray(centers)
        self.max_iter = int(max_iter)
        self.tol = float(tol)
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = int(checkpoint_every)
        self.start_iter = int(start_iter)

    def _run_on_mesh(self, mesh, gx, gw, gy):
        from spark_rapids_ml_tpu_torch.parallel import kmeans as PK

        centers0 = torch.as_tensor(self.centers, dtype=torch.float32)
        if self.checkpoint_dir is None:
            centers, cost, iters = PK.make_distributed_kmeans_fit(
                mesh, max_iter=self.max_iter, tol=self.tol)(gx, gw, centers0)
        else:
            centers, cost, iters = PK.run_chunked_lloyd(
                PK.make_distributed_kmeans_chunk(mesh, chunk_iters=self.checkpoint_every,
                                                 tol=self.tol),
                gx, gw, centers0, start_iter=self.start_iter, max_iter=self.max_iter,
                tol=self.tol, ckpt=_rank0_checkpointer(mesh, self.checkpoint_dir),
            )
        return {"centers": centers.cpu().numpy().astype(np.float64),
                "cost": np.float64(float(cost)), "iterations": np.float64(int(iters)),
                "count": np.float64(_weight_total(mesh, gw))}


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
