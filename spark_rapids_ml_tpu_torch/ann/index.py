"""Out-of-core IVF-Flat index build: streamed quantizer fit + bucket pack.

Counterpart of ``spark_rapids_ml_tpu/ann/index.py``. ``IVFFlatIndex`` builds
the index of ``ApproximateNearestNeighbors`` without holding the corpus on
the device:

1. **Sample**: one streaming pass fills a seeded reservoir
   (``TPU_ML_ANN_SAMPLE_ROWS``, algorithm R, numpy, so both packages draw
   the same rows) that the k-means‖ init trains the initial coarse
   quantizer on (cost-proportional oversampling rounds drawn with numpy,
   then a weighted k-means++ reduction drawn from a ``torch.Generator``).
2. **Lloyd over the stream**: each iteration is one
   ``spark.ingest.stream_fold`` pass whose carry is the running
   ``(sums, counts, cost)`` with the centres riding along. Between passes,
   empty cells reseed at farthest-point sample rows and overfull cells are
   split (``_rebalance_cells``).
3. **Assign + pack**: a streamed pass assigns each chunk on the device
   keeping only the labels, the cap comes from the full label histogram,
   and a second pass packs the chunks on the host into the skew-capped
   [nlist, cap, n] buckets and exact spill list of ``ops/ivf.py`` with
   running per-cluster fill cursors: the buckets are bit-identical to
   ``build_ivf_buckets`` on the concatenated corpus, and the spill list
   holds the same rows in chunk-major order.

Spans: ``ann build`` around the whole build; inside it ``ann sample``,
``ann init``, one ``ann lloyd`` per pass and ``ann pack`` (the assign pass
``ann assign`` and the pack pass).

Where the device's mesh has more than one data shard (``_mesh_or_none``:
every card of a machine with several), each Lloyd pass is the
mesh-sharded fold (``_lloyd_mesh_fold``, ``_init_mesh_carry``): the carry's
leaves are the stacked per-shard partials of ``parallel/gram.py``, each
shard folds its piece of a chunk into its own slice with no collective, and
one allreduce ends the pass (``finalize_chunk_fold``). The index is built
in f32.

Sources must be **re-iterable** (the build makes several passes): a
[rows, n] ndarray, a list/tuple of chunk arrays, or a zero-arg callable
returning a fresh chunk iterator.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.models.base import Estimator
from spark_rapids_ml_tpu_torch.models.neighbors import (
    ApproximateNearestNeighborsModel,
    _ANNParams,
    _prepare_rows,
)
from spark_rapids_ml_tpu_torch.ops import ivf as IVF
from spark_rapids_ml_tpu_torch.ops import kmeans as KM
from spark_rapids_ml_tpu_torch.telemetry import trace_range
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY
from spark_rapids_ml_tpu_torch.utils.config import (
    ANN_SAMPLE_ROWS_VAR,
    DEFAULT_ANN_SAMPLE_ROWS,
    lenient_int,
)
from spark_rapids_ml_tpu_torch.utils.device import block_rows_for, to_device

#: Convergence floor for the streamed Lloyd loop (squared center shift).
_SHIFT_TOL = 1e-4


def sample_rows_budget() -> int:
    """The quantizer training-sample row budget (``TPU_ML_ANN_SAMPLE_ROWS``;
    0 means the whole stream feeds the init)."""
    return max(0, lenient_int(ANN_SAMPLE_ROWS_VAR, DEFAULT_ANN_SAMPLE_ROWS))


# -- streamed Lloyd fold -----------------------------------------------------


class _LloydCarry(NamedTuple):
    """The ``stream_fold`` carry of one Lloyd pass: running weighted cluster
    statistics plus the centers, which every chunk is assigned against."""

    sums: torch.Tensor     # [k, n]
    counts: torch.Tensor   # [k]
    cost: torch.Tensor     # []
    centers: torch.Tensor  # [k, n]


def _lloyd_step(carry: _LloydCarry, x: torch.Tensor, w: torch.Tensor) -> _LloydCarry:
    """``fold_fn`` of a Lloyd pass: one chunk's ``kmeans_stats`` added into
    the carry in place (the unit weights come from the host)."""
    k = carry.centers.shape[0]
    st = KM.kmeans_stats(
        x, carry.centers, w.to(x.device, non_blocking=True),
        block_rows=block_rows_for(x.device, KM.DEFAULT_BLOCK_ROWS, k),
    )
    carry.sums.add_(st.sums)
    carry.counts.add_(st.counts)
    carry.cost.add_(st.cost)
    return carry


def _lloyd_mesh_fold(mesh):
    """The mesh-sharded ``fold_fn`` of a Lloyd pass: each data shard's
    ``kmeans_stats`` of its piece of the chunk (``chunk_put``) against its
    own copy of the centres, added into its slice of the stacked carry in
    place; no collective."""

    def fold(carry: _LloydCarry, x, w) -> _LloydCarry:
        for i in mesh.data_indices():
            xl = x.block(i)
            centers = carry.centers.block(i)[0]
            st = KM.kmeans_stats(
                xl, centers, w.block(i).to(xl.device, non_blocking=True),
                block_rows=block_rows_for(xl.device, KM.DEFAULT_BLOCK_ROWS, centers.shape[0]),
            )
            carry.sums.block(i)[0].add_(st.sums)
            carry.counts.block(i)[0].add_(st.counts)
            carry.cost.block(i)[0].add_(st.cost)
        return carry

    return fold


def _init_mesh_carry(centers: np.ndarray, mesh) -> _LloydCarry:
    """The zero stacked-partials carry of a mesh Lloyd pass, every shard
    holding its own full copy of the centres."""
    from spark_rapids_ml_tpu_torch.parallel import gram as G

    k, n = centers.shape
    meta = dict(dtype=torch.float32, device="meta")
    zero = G.init_chunk_carry(
        KM.KMeansStats(torch.empty((k, n), **meta), torch.empty((k,), **meta),
                       torch.empty((), **meta)), mesh)
    copies = G.init_chunk_carry(torch.empty((k, n), **meta), mesh)
    for i in mesh.data_indices():
        copies.block(i)[0].copy_(torch.from_numpy(np.asarray(centers, np.float32)))
    return _LloydCarry(zero.sums, zero.counts, zero.cost, copies)


def _assign(x: np.ndarray, centers: torch.Tensor) -> tuple[np.ndarray, np.ndarray]:
    """(labels, min squared distances) of host rows against device centres,
    a bounded block at a time."""
    device = centers.device
    labels, dists = KM.assign_blocks(
        to_device(x, device), centers,
        block_rows=block_rows_for(device, KM.DEFAULT_BLOCK_ROWS, centers.shape[0]),
    )
    return labels.cpu().numpy(), dists.cpu().numpy()


# -- host-side streaming helpers --------------------------------------------


def _chunk_source(source: Any, input_col: str | None) -> Callable:
    """Normalize a corpus source into a zero-arg factory of fresh chunk
    iterators (the build takes several passes)."""
    if callable(source):
        return source
    if isinstance(source, np.ndarray):
        if source.ndim != 2:
            raise ValueError(
                f"corpus array must be [rows, n], got shape {source.shape}"
            )
        from spark_rapids_ml_tpu_torch.spark.ingest import stream_chunk_rows

        step = stream_chunk_rows()

        def from_array():
            for lo in range(0, source.shape[0], step):
                yield source[lo : lo + step]

        return from_array
    if isinstance(source, (list, tuple)):
        return lambda: iter(source)
    if hasattr(source, "matrices"):
        return source.matrices
    from spark_rapids_ml_tpu_torch.utils import columnar

    ds = columnar.PartitionedDataset.from_any(source, input_col, None)
    return ds.matrices


def _reservoir_sample(
    chunks, budget: int, seed: int
) -> tuple[np.ndarray, int]:
    """(sample, total_rows): a seeded uniform row sample over a chunk
    stream (vectorized algorithm R) plus the stream's exact row count.
    ``budget <= 0`` concatenates the whole stream instead."""
    if budget <= 0:
        parts = [np.asarray(c) for c in chunks]
        if not parts:
            raise ValueError("empty corpus: the source yielded no rows")
        whole = np.concatenate(parts, axis=0)
        return whole, whole.shape[0]
    rng = np.random.default_rng(seed)
    buf: np.ndarray | None = None
    filled = seen = 0
    for chunk in chunks:
        chunk = np.asarray(chunk)
        if buf is None:
            buf = np.empty((budget, chunk.shape[1]), chunk.dtype)
        take = min(budget - filled, chunk.shape[0])
        if take > 0:
            buf[filled : filled + take] = chunk[:take]
            filled += take
            seen += take
            chunk = chunk[take:]
        if chunk.shape[0] == 0:
            continue
        # row number i (1-based) replaces a uniform slot with p = budget/i;
        # duplicate slot hits resolve last-writer-wins, the sequential order
        slots = rng.integers(
            1, seen + 2 + np.arange(chunk.shape[0]), dtype=np.int64
        )
        hit = slots <= budget
        buf[slots[hit] - 1] = chunk[hit]
        seen += chunk.shape[0]
    if buf is None:
        raise ValueError("empty corpus: the source yielded no rows")
    return buf[:filled], seen


def _kmeans_parallel_init(
    sample: np.ndarray, k: int, seed: int, device: torch.device, init_steps: int = 2
) -> np.ndarray:
    """k-means‖ on the reservoir sample: ``init_steps`` rounds of
    cost-proportional Bernoulli oversampling with ℓ = 2k expected
    candidates per round (numpy draws, as in the JAX package), a
    candidate-weighting pass, then a weighted k-means++ reduction to
    exactly k centers (drawn from a ``torch.Generator`` seeded with
    ``seed``)."""
    rng = np.random.default_rng(seed)
    ell = 2.0 * k
    candidates = [sample[rng.integers(sample.shape[0])]]
    for _ in range(init_steps):
        d2 = _assign(sample, to_device(np.stack(candidates), device))[1]
        phi = float(d2.sum())
        if phi <= 0.0:  # every row coincides with a candidate
            break
        sel = rng.random(sample.shape[0]) < np.minimum(1.0, ell * d2 / phi)
        if sel.any():
            candidates.extend(sample[sel])
    cand = np.stack(candidates)
    if len(cand) <= k:
        # degenerate oversampling (tiny sample): top up with uniform rows
        need = k - len(cand)
        if need > 0:
            idx = rng.choice(sample.shape[0], need, replace=False)
            cand = np.concatenate([cand, sample[idx]])
        return cand[:k]
    cand_d = to_device(cand, device)
    labels = _assign(sample, cand_d)[0]
    counts = np.bincount(labels, minlength=len(cand))
    gen = torch.Generator(device=device).manual_seed(seed)
    centers = KM.weighted_kmeans_plus_plus_init(
        gen, cand_d, to_device(counts.astype(np.float32), device), k
    )
    return centers.cpu().numpy()


#: A cell whose stream count exceeds this multiple of the mean fill is
#: split between Lloyd passes (it sets the percentile bucket cap). A merged
#: pair of equal natural clusters sits at exactly 2.0x the mean, so the
#: threshold must be strictly below that.
_OVERFULL_FACTOR = 1.5


def _rebalance_cells(
    centers: np.ndarray, counts: np.ndarray, sample: np.ndarray, device: torch.device
) -> tuple[np.ndarray, int]:
    """Repair the two Lloyd local minima that inflate the bucket cap, as the
    JAX package does: **empty cells** reseed at greedy farthest-point sample
    rows (distances updated after each pick); **overfull cells** (stream
    count > ``_OVERFULL_FACTOR``× the mean) are split, the currently
    smallest cell donating its center, reseeded at the overfull cell's
    farthest sample row. Returns (centers, cells changed)."""
    out, changed = centers, 0
    empty = np.flatnonzero(counts == 0)
    live = centers[counts > 0]
    if empty.size and len(live):
        d2 = _assign(sample, to_device(live, device))[1]
        out = out.copy()
        for slot in empty:
            j = int(np.argmax(d2))
            out[slot] = sample[j]
            diff = sample - sample[j]
            d2 = np.minimum(d2, np.einsum("ij,ij->i", diff, diff))
        changed += int(empty.size)

    mean = float(counts.mean())
    over = np.flatnonzero(counts > _OVERFULL_FACTOR * mean)
    if over.size:
        labels, d2 = _assign(sample, to_device(out, device))
        over_set = set(over.tolist()) | set(empty.tolist())
        donors = [
            int(i) for i in np.argsort(counts, kind="stable")
            if counts[i] < mean and int(i) not in over_set
        ]
        if out is centers:
            out = out.copy()
        # biggest offenders split first while donors last
        for cell in sorted(over.tolist(), key=lambda i: -counts[i]):
            in_cell = np.flatnonzero(labels == cell)
            if not donors or in_cell.size == 0:
                break
            donor = donors.pop(0)
            out[donor] = sample[in_cell[np.argmax(d2[in_cell])]]
            changed += 1
    return out, changed


# -- the estimator -----------------------------------------------------------


class IVFFlatIndex(_ANNParams, Estimator):
    """Streamed IVF-Flat index estimator (see the module docstring for the
    three-pass build). Shares the ``ApproximateNearestNeighbors`` parameter
    surface (k/metric/nlist/nprobe/maxIter/seed) and produces an
    :class:`IVFFlatIndexModel` on the same ``device``."""

    def fit(
        self,
        source: Any,
        *,
        ids: np.ndarray | None = None,
    ) -> "IVFFlatIndexModel":
        """Build the index from a re-iterable chunk source. ``ids`` maps
        0-based corpus positions to user item ids (default: the position
        itself). The exact row count comes from the sampling pass."""
        metric = self.getMetric()
        seed = self.getOrDefault("seed")
        device = self.device
        chunk_factory = _chunk_source(source, self._paramMap.get("inputCol"))

        def chunks():
            for c in chunk_factory():
                yield _prepare_rows(np.asarray(c).astype(np.float32, copy=False), metric)

        with trace_range("ann build", device):
            with trace_range("ann sample", device):
                sample, item_count = _reservoir_sample(
                    chunks(), sample_rows_budget(), seed
                )
            n = sample.shape[1]
            nlist = self.getNlist() or max(1, int(np.sqrt(item_count)))
            nlist = min(nlist, sample.shape[0])
            with trace_range("ann init", device):
                centers = _kmeans_parallel_init(sample, nlist, seed, device)
            centers = self._lloyd(chunks, centers, n, sample)
            packed = self._assign_and_pack(chunks, centers, nlist, item_count)

        REGISTRY.counter_inc("ann.build_rows", item_count, index=self.uid)
        spill_rows = int((packed.spill_ids >= 0).sum())
        REGISTRY.gauge_set(
            "ann.spill_fraction",
            spill_rows / item_count if item_count else 0.0,
            index=self.uid,
        )
        if ids is None:
            ids = np.arange(item_count, dtype=np.int64)
        elif len(ids) != item_count:
            raise ValueError(
                f"ids has {len(ids)} entries but the corpus streamed "
                f"{item_count} rows"
            )
        model = IVFFlatIndexModel(
            uid=self.uid,
            centroids=centers,
            bucketItems=packed.bucket_items,
            bucketIds=packed.bucket_ids,
            itemIds=np.asarray(ids),
            spillItems=packed.spill_items,
            spillIds=packed.spill_ids,
            device=device,
        )
        return self._copyValues(model)

    def _lloyd(self, chunks, centers: np.ndarray, n: int, sample: np.ndarray) -> np.ndarray:
        """maxIter streamed Lloyd passes, each one ``stream_fold`` over the
        source. Empty and overfull cells are repaired from the reservoir
        sample (``_rebalance_cells``) before the next pass, and a repairing
        pass never takes the convergence exit, since a reseed moves centers
        arbitrarily far."""
        from spark_rapids_ml_tpu_torch.parallel import gram as G
        from spark_rapids_ml_tpu_torch.parallel.mesh import DATA_AXIS
        from spark_rapids_ml_tpu_torch.spark import ingest

        device = self.device
        k = centers.shape[0]
        mesh = self._mesh_or_none()
        for _ in range(self.getOrDefault("maxIter")):
            with trace_range("ann lloyd", device):
                old = to_device(centers, device)
                if mesh is None:
                    res = ingest.stream_fold(
                        chunks(),
                        _lloyd_step,
                        n=n,
                        init=lambda: _LloydCarry(
                            sums=torch.zeros((k, n), dtype=torch.float32, device=device),
                            counts=torch.zeros((k,), dtype=torch.float32, device=device),
                            cost=torch.zeros((), dtype=torch.float32, device=device),
                            centers=old,
                        ),
                        device=device,
                    )
                    stats = KM.KMeansStats(res.carry.sums, res.carry.counts, res.carry.cost)
                else:
                    res = ingest.stream_fold(
                        chunks(),
                        _lloyd_mesh_fold(mesh),
                        n=n,
                        init=lambda: _init_mesh_carry(centers, mesh),
                        device=mesh.first_device,
                        chunk_rows=G.stream_chunk_rows_for_mesh(mesh),
                        put_fn=G.chunk_put(mesh),
                        min_chunk_rows=mesh.shape[DATA_AXIS],
                    )
                    stats = KM.KMeansStats(*(t.to(device) for t in G.finalize_chunk_fold(
                        KM.KMeansStats(res.carry.sums, res.carry.counts, res.carry.cost),
                        mesh)))
                new = KM.update_centers(stats, old)
                shift = float(KM.center_shift_sq(old, new))
                centers, reseeded = _rebalance_cells(
                    new.cpu().numpy(), stats.counts.cpu().numpy(), sample, device
                )
            if reseeded:
                REGISTRY.counter_inc("ann.cells_reseeded", reseeded, index=self.uid)
                continue
            if shift <= _SHIFT_TOL:
                break
        return centers

    def _mesh_or_none(self):
        """The device's mesh for the Lloyd passes when it has more than one
        data shard (a machine with several cards), else None: the
        one-device fold. A mesh that cannot be made builds on one device."""
        from spark_rapids_ml_tpu_torch.parallel import mesh as M

        if self.device.type != "cuda" or torch.cuda.device_count() <= 1:
            return None
        try:
            return M.local_mesh(self.device)
        except (RuntimeError, ValueError):
            return None

    def _assign_and_pack(self, chunk_factory, centers: np.ndarray, nlist: int,
                         total: int) -> IVF.IvfBuckets:
        """Streamed equivalent of ``ops.ivf.build_ivf_buckets``: pass A
        assigns every chunk on the device keeping only the labels; the cap
        comes from the full label histogram; pass B re-streams the same
        chunks into the preallocated buckets with running per-cluster fill
        cursors."""
        with trace_range("ann pack", self.device):
            cd = to_device(centers, self.device)
            chunk_labels: list[np.ndarray] = []
            counts = np.zeros(nlist, dtype=np.int64)
            n = dt = None
            with trace_range("ann assign", self.device):
                for chunk in chunk_factory():
                    chunk = np.asarray(chunk)
                    if n is None:
                        n, dt = chunk.shape[1], chunk.dtype
                    labels = _assign(chunk, cd)[0]
                    chunk_labels.append(labels)
                    counts += np.bincount(labels, minlength=nlist)
            if n is None:
                raise ValueError("empty corpus: the source yielded no rows")
            cap = IVF.bucket_cap(counts, IVF.default_cap_percentile())
            bucket_items = np.zeros((nlist, cap, n), dtype=dt)
            bucket_ids = np.full((nlist, cap), -1, dtype=np.int32)
            spill_pad = IVF.spill_pad_rows(int(np.maximum(counts - cap, 0).sum()))
            spill_items = np.zeros((spill_pad, n), dtype=dt)
            spill_ids = np.full(spill_pad, -1, dtype=np.int32)
            fill = np.zeros(nlist, dtype=np.int64)
            g0 = at = 0
            for chunk, labels in zip(chunk_factory(), chunk_labels):
                chunk = np.asarray(chunk)
                if chunk.shape[0] != labels.shape[0]:
                    raise ValueError(
                        "corpus source is not re-iterable deterministically: "
                        f"pass B chunk has {chunk.shape[0]} rows where pass "
                        f"A saw {labels.shape[0]}"
                    )
                order = np.argsort(labels, kind="stable")
                sl = labels[order]
                cnt = np.bincount(labels, minlength=nlist)
                starts = np.concatenate([[0], np.cumsum(cnt)[:-1]])
                pos = fill[sl] + (np.arange(len(order)) - starts[sl])
                dense = pos < cap
                bucket_items[sl[dense], pos[dense]] = chunk[order[dense]]
                bucket_ids[sl[dense], pos[dense]] = g0 + order[dense]
                n_sp = int((~dense).sum())
                if n_sp:
                    spill_items[at : at + n_sp] = chunk[order[~dense]]
                    spill_ids[at : at + n_sp] = g0 + order[~dense]
                    at += n_sp
                fill += cnt
                g0 += chunk.shape[0]
            if g0 != total:
                raise ValueError(
                    "corpus source is not re-iterable deterministically: "
                    f"the pack pass streamed {g0} rows, the sampling pass "
                    f"saw {total}"
                )
        return IVF.IvfBuckets(bucket_items, bucket_ids, cap, spill_items, spill_ids)


class IVFFlatIndexModel(ApproximateNearestNeighborsModel):
    """A streamed-built IVF index: the query and persistence surface of
    ``ApproximateNearestNeighborsModel`` plus a per-call ``nprobe``
    override, for recall sweeps over one fitted index."""

    def search(
        self,
        queries: np.ndarray,
        *,
        k: int | None = None,
        nprobe: int | None = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """(distances, ids) for a [q, n] query block; ``nprobe`` overrides
        the fitted operating point for this call only."""
        if nprobe is not None and nprobe < 1:
            raise ValueError(f"nprobe must be >= 1, got {nprobe}")
        return self._kneighbors_matrix(np.asarray(queries), k, nprobe)

    @property
    def nlist(self) -> int:
        return int(self.bucketItems.shape[0])
