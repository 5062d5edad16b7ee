"""NearestNeighbors (exact) and ApproximateNearestNeighbors (IVF-Flat)
estimators and models of the port, on the card by default.

Counterpart of ``spark_rapids_ml_tpu/models/neighbors.py``, plus a
``device`` argument (default ``"cuda"``):

- ``NearestNeighbors``: fit on an item set, then ``kneighbors`` a query set
  → per-query distance and id arrays, brute force through
  ``ops/neighbors.py``'s blocked selection. The cross term is f32, as in
  the JAX package; ``ops.neighbors.knn_topk`` takes the other policies;
- ``ApproximateNearestNeighbors`` (spark-rapids-ml's
  ``algorithm="ivfflat"``): the fit clusters the items with the port's
  ``KMeans`` (k = ``nlist``, auto √items), assigns them and packs them
  into the buckets and spill list of ``ops/ivf.py``; ``kneighbors`` scans
  the ``nprobe`` nearest clusters (``ops.ivf.ivf_search``). The packed
  index goes to the device at the model's first query and stays there.

Metrics follow the cuML/RAFT brute-force surface:

- ``euclidean`` (default): √‖x−y‖², ascending;
- ``sqeuclidean``: ‖x−y‖², ascending;
- ``cosine``: 1 − cos(x, y), ascending over [0, 2] (rows L2-normalized,
  ranked by the dot-product kernel, so a zero row sits at exactly 1 from
  everything, cuML's behavior);
- ``inner_product``: the raw dot product, DESCENDING (a similarity: the k
  returned items maximize x·y, and the "distances" hold the dot products,
  cuML's convention).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.models.base import Estimator, Model
from spark_rapids_ml_tpu_torch.models.params import HasDevice, HasInputCol, Param
from spark_rapids_ml_tpu_torch.ops import neighbors as NN
from spark_rapids_ml_tpu_torch.telemetry import trace_range
from spark_rapids_ml_tpu_torch.utils import columnar
from spark_rapids_ml_tpu_torch.utils.device import block_rows_for, to_device

_METRICS = ("euclidean", "sqeuclidean", "cosine", "inner_product")

#: queries go through in chunks of this many rows, each against the whole
#: corpus, so one [chunk, block] score tile exists at a time
_QUERY_CHUNK = 4096


def _kernel_metric(metric: str) -> str:
    # cosine rides the dot kernel on normalized rows: ranking by largest
    # q̂·ĉ IS ranking by smallest 1 − cos, and a zero row (normalized to
    # zero) scores dot 0 → distance exactly 1 from everything
    return "dot" if metric in ("inner_product", "cosine") else "sqeuclidean"


def _prepare_rows(x: np.ndarray, metric: str) -> np.ndarray:
    """Metric-specific row preparation: cosine L2-normalizes (zero rows stay
    zero — they land at distance 1 from everything, the cuML behavior)."""
    if metric != "cosine":
        return x
    norms = np.linalg.norm(x, axis=1, keepdims=True)
    return x / np.where(norms > 0, norms, 1.0)


def _finalize_distances(scores: np.ndarray, metric: str) -> np.ndarray:
    """Kernel scores (descending-is-better) → user-facing distance arrays."""
    if metric == "inner_product":
        return scores  # dot products, already descending
    if metric == "cosine":
        return np.clip(1.0 - scores, 0.0, 2.0)
    sq = np.clip(-scores, 0.0, None)
    if metric == "sqeuclidean":
        return sq
    return np.sqrt(sq)


class _NearestNeighborsParams(HasDevice, HasInputCol):
    k = Param("k", "number of neighbors to return per query", int)
    metric = Param(
        "metric",
        "distance metric: 'euclidean' (default), 'sqeuclidean', 'cosine', "
        "or 'inner_product' (similarity — descending)",
        str,
    )
    idCol = Param(
        "idCol",
        "optional item-id column; when unset, neighbors are identified by "
        "their 0-based row position in the fitted dataset. Ids travel "
        "through a float64 extractor, so integral ids are exact only up "
        "to 2^53",
        str,
    )

    def __init__(self, uid: str | None = None, device: str | torch.device = "cuda",
                 **kwargs):
        super().__init__(uid, device=device, **kwargs)
        self._setDefault(k=5, metric="euclidean")

    def getK(self) -> int:
        return self.getOrDefault("k")

    def getMetric(self) -> str:
        return self.getOrDefault("metric")


def _extract_items_and_ids(dataset, ds, id_col, k):
    """The fit-side ingestion: concatenated item matrix + aligned ids (positional when ``id_col`` is None; integral ids
    cast back to int64 after the float64 extractor — exact up to 2^53),
    with the k-vs-items and ids-vs-items validations in one place."""
    items = np.concatenate(list(ds.matrices()), axis=0)
    if items.shape[0] < k:
        raise ValueError(
            f"k={k} exceeds the fitted item count {items.shape[0]}"
        )
    if id_col is not None:
        # a list of columnar partitions (the from_any list branch) has
        # its id column extracted per partition, in partition order
        if isinstance(dataset, (list, tuple)) and not isinstance(
            dataset, np.ndarray
        ):
            ids = np.concatenate(
                [columnar.extract_vector(p, id_col) for p in dataset]
            )
        else:
            ids = columnar.extract_vector(dataset, id_col)
        if ids.shape[0] != items.shape[0]:
            raise ValueError(
                f"idCol {id_col!r} has {ids.shape[0]} values for "
                f"{items.shape[0]} items"
            )
        if np.all(ids == np.round(ids)):  # integral ids stay integral
            ids = ids.astype(np.int64)
    else:
        ids = np.arange(items.shape[0], dtype=np.int64)
    return items, ids


class NearestNeighbors(_NearestNeighborsParams, Estimator):
    """Brute-force exact k-NN over a fitted item set."""

    def setK(self, value: int) -> "NearestNeighbors":
        if value < 1:
            raise ValueError(f"k must be >= 1, got {value}")
        return self._set(k=value)

    def setMetric(self, value: str) -> "NearestNeighbors":
        if value not in _METRICS:
            raise ValueError(f"metric must be one of {_METRICS}, got {value!r}")
        return self._set(metric=value)

    def setIdCol(self, value: str) -> "NearestNeighbors":
        return self._set(idCol=value)

    def fit(
        self, dataset: Any, num_partitions: int | None = None
    ) -> "NearestNeighborsModel":
        """Materialize the item set (and ids) into the model — brute-force
        k-NN has no training phase; ``fit`` is ingestion, exactly as in
        spark-rapids-ml's NearestNeighbors."""
        input_col = self._paramMap.get("inputCol")
        ds = columnar.PartitionedDataset.from_any(
            dataset, input_col, num_partitions
        )
        items, ids = _extract_items_and_ids(
            dataset, ds, self._paramMap.get("idCol"), self.getK()
        )
        model = NearestNeighborsModel(
            uid=self.uid, items=items, itemIds=ids, device=self.device
        )
        return self._copyValues(model)


class NearestNeighborsModel(_NearestNeighborsParams, Model):
    """Holds the item matrix; ``kneighbors`` streams query chunks through
    the blocked tournament kernel."""

    def __init__(
        self,
        uid: str | None = None,
        items: np.ndarray | None = None,
        itemIds: np.ndarray | None = None,
        device: str | torch.device = "cuda",
    ):
        super().__init__(uid, device=device)
        self.items = None if items is None else np.asarray(items)
        self.itemIds = None if itemIds is None else np.asarray(itemIds)

    def kneighbors(
        self, dataset: Any, k: int | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """(distances [q, k], item ids [q, k]) for every query row.

        Distances are ordered best-first per the metric (ascending for the
        distance metrics, descending dot products for ``inner_product``).
        """
        queries = columnar.extract_matrix(
            dataset, self._paramMap.get("inputCol")
        )
        return self._kneighbors_matrix(queries, k)

    def _kneighbors_matrix(
        self, queries: np.ndarray, k: int | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """The matrix → (distances, ids) body of ``kneighbors``."""
        k = self.getK() if k is None else k
        if not 1 <= k <= self.items.shape[0]:
            raise ValueError(
                f"k={k} must be in [1, {self.items.shape[0]}] "
                "(the fitted item count)"
            )
        metric = self.getMetric()
        if queries.shape[1] != self.items.shape[1]:
            raise ValueError(
                f"queries have {queries.shape[1]} features but the fitted "
                f"items have {self.items.shape[1]}"
            )
        fdt = columnar.float_dtype_for(queries.dtype)
        corpus = _prepare_rows(self.items.astype(fdt, copy=False), metric)
        queries = _prepare_rows(queries.astype(fdt, copy=False), metric)

        # the corpus goes to the device once per call; queries stream
        # through in chunks against all of it
        device = self.device
        cd = to_device(corpus, device)
        vd = torch.ones(cd.shape[0], dtype=torch.bool, device=device)
        out_scores = np.empty((queries.shape[0], k), dtype=np.float32)
        out_idx = np.empty((queries.shape[0], k), dtype=np.int32)
        with trace_range("knn kneighbors", device):
            for lo in range(0, queries.shape[0], _QUERY_CHUNK):
                scores, idx = NN.knn_topk(
                    to_device(queries[lo:lo + _QUERY_CHUNK], device),
                    cd,
                    vd,
                    k,
                    metric=_kernel_metric(metric),
                )
                out_scores[lo:lo + _QUERY_CHUNK] = scores.cpu().numpy()
                out_idx[lo:lo + _QUERY_CHUNK] = idx.cpu().numpy()

        dists = _finalize_distances(out_scores, metric)
        return dists, self.itemIds[out_idx]

    def transform(self, dataset: Any) -> Any:
        """Append ``indices`` and ``distances`` array columns — the
        DataFrame spelling of ``kneighbors`` (spark-rapids-ml's knn_df)."""
        dists, ids = self.kneighbors(dataset)
        return columnar.append_columns(
            dataset, [("indices", ids), ("distances", dists)]
        )

    def _saveData(self) -> dict[str, np.ndarray]:
        return {"items": self.items, "itemIds": self.itemIds}

    @classmethod
    def _fromSaved(cls, uid, data, device: str | torch.device = "cuda"):
        return cls(uid=uid, items=data["items"], itemIds=data["itemIds"], device=device)


# ---------------------------------------------------------------------------
# Approximate nearest neighbors (IVF-Flat)
# ---------------------------------------------------------------------------

_ANN_METRICS = ("euclidean", "sqeuclidean", "cosine")


class _ANNParams(_NearestNeighborsParams):
    nlist = Param(
        "nlist",
        "IVF cluster count (0 = auto: ~sqrt(items), the cuML heuristic)",
        int,
    )
    nprobe = Param("nprobe", "clusters scanned per query", int)
    maxIter = Param("maxIter", "Lloyd iterations for the coarse quantizer", int)
    seed = Param("seed", "random seed for the coarse quantizer", int)

    def __init__(self, uid: str | None = None, device: str | torch.device = "cuda",
                 **kwargs):
        super().__init__(uid, device=device, **kwargs)
        self._setDefault(nlist=0, nprobe=20, maxIter=10, seed=0)

    def getNlist(self) -> int:
        return self.getOrDefault("nlist")

    def getNprobe(self) -> int:
        return self.getOrDefault("nprobe")

    def setK(self, value: int):
        if value < 1:
            raise ValueError(f"k must be >= 1, got {value}")
        return self._set(k=value)

    def setMetric(self, value: str):
        if value not in _ANN_METRICS:
            raise ValueError(
                f"metric must be one of {_ANN_METRICS}, got {value!r}"
            )
        return self._set(metric=value)

    def setNlist(self, value: int):
        if value < 0:
            raise ValueError(f"nlist must be >= 0, got {value}")
        return self._set(nlist=value)

    def setNprobe(self, value: int):
        if value < 1:
            raise ValueError(f"nprobe must be >= 1, got {value}")
        return self._set(nprobe=value)

    def setMaxIter(self, value: int):
        return self._set(maxIter=value)

    def setSeed(self, value: int):
        return self._set(seed=value)


class ApproximateNearestNeighbors(_ANNParams, Estimator):
    """IVF-Flat approximate k-NN, spark-rapids-ml's
    ``ApproximateNearestNeighbors(algorithm='ivfflat')``: the corpus is
    clustered by the port's KMeans and queries scan only the ``nprobe``
    nearest clusters. ``nprobe == nlist`` is exact search."""

    def setIdCol(self, value: str) -> "ApproximateNearestNeighbors":
        return self._set(idCol=value)

    def fit(
        self, dataset: Any, num_partitions: int | None = None
    ) -> "ApproximateNearestNeighborsModel":
        input_col = self._paramMap.get("inputCol")
        ds = columnar.PartitionedDataset.from_any(
            dataset, input_col, num_partitions
        )
        items, ids = _extract_items_and_ids(
            dataset, ds, self._paramMap.get("idCol"), self.getK()
        )
        return self._fit_items(items, ids)

    def _fit_items(
        self, items: np.ndarray, ids: np.ndarray
    ) -> "ApproximateNearestNeighborsModel":
        """The index build from extracted arrays: the quantizer (spans
        ``kmeans init``/``kmeans lloyd``), the assignment (``ivf assign``)
        and the host pack (``ivf pack``), all inside ``ivf build``."""
        from spark_rapids_ml_tpu_torch.models.kmeans import KMeans
        from spark_rapids_ml_tpu_torch.ops import ivf as IVF
        from spark_rapids_ml_tpu_torch.ops import kmeans as KM

        metric = self.getMetric()
        device = self.device
        prepared = _prepare_rows(items.astype(np.float32, copy=False), metric)
        nlist = self.getNlist() or max(
            1, min(items.shape[0], int(np.sqrt(items.shape[0])))
        )
        nlist = min(nlist, items.shape[0])
        with trace_range("ivf build", device):
            km = KMeans(uid=f"{self.uid}-quantizer", device=device) \
                .setK(nlist) \
                .setMaxIter(self.getOrDefault("maxIter")) \
                .setSeed(self.getOrDefault("seed"))
            centroids = km.fit(prepared).clusterCenters.astype(np.float32)
            with trace_range("ivf assign", device):
                labels, _ = KM.assign_blocks(
                    to_device(prepared, device),
                    to_device(centroids, device),
                    block_rows=block_rows_for(device, KM.DEFAULT_BLOCK_ROWS, nlist),
                )
                labels = labels.cpu().numpy()
            with trace_range("ivf pack", device):
                packed = IVF.build_ivf_buckets(prepared, labels, nlist)
        model = ApproximateNearestNeighborsModel(
            uid=self.uid,
            centroids=centroids,
            bucketItems=packed.bucket_items,
            bucketIds=packed.bucket_ids,
            itemIds=ids,
            spillItems=packed.spill_items,
            spillIds=packed.spill_ids,
            device=device,
        )
        return self._copyValues(model)


def _ann_distances(scores: np.ndarray, metric: str) -> np.ndarray:
    """IVF kernel scores → distances. Cosine rides normalized sqeuclidean
    here: 1 − cos = ‖x̂−ŷ‖²/2 over [0, 2]. Unlike the exact model's
    dot-kernel cosine, an all-zero row lands at 0.5, not 1: the coarse
    quantizer needs one metric for centroids and members, and a zero vector
    has no direction. Unfilled slots (id −1, score −inf) stay inf, never a
    legal 2.0."""
    if metric == "cosine":
        sq = np.clip(-scores, 0.0, None)
        return np.where(np.isfinite(sq), np.clip(sq / 2.0, 0.0, 2.0), np.inf)
    return _finalize_distances(scores, metric)


class ApproximateNearestNeighborsModel(_ANNParams, Model):
    """The packed IVF index (host arrays); ``kneighbors`` streams query
    chunks through ``ops.ivf.ivf_search`` on ``device``."""

    def __init__(
        self,
        uid: str | None = None,
        centroids: np.ndarray | None = None,
        bucketItems: np.ndarray | None = None,
        bucketIds: np.ndarray | None = None,
        itemIds: np.ndarray | None = None,
        spillItems: np.ndarray | None = None,
        spillIds: np.ndarray | None = None,
        device: str | torch.device = "cuda",
    ):
        super().__init__(uid, device=device)
        self.centroids = None if centroids is None else np.asarray(centroids)
        self.bucketItems = (
            None if bucketItems is None else np.asarray(bucketItems)
        )
        self.bucketIds = None if bucketIds is None else np.asarray(bucketIds)
        self.itemIds = None if itemIds is None else np.asarray(itemIds)
        # pre-spill saves and direct construction: an empty spill list is the
        # exact equivalent of the pad-to-largest-cluster packing
        if spillItems is None and self.bucketItems is not None:
            spillItems = np.zeros(
                (0, self.bucketItems.shape[2]), dtype=self.bucketItems.dtype
            )
            spillIds = np.full(0, -1, dtype=np.int32)
        self.spillItems = None if spillItems is None else np.asarray(spillItems)
        self.spillIds = None if spillIds is None else np.asarray(spillIds)
        self._device_index = None

    @property
    def numItems(self) -> int:
        return self.itemIds.shape[0]

    def index_tensors(self) -> dict[str, torch.Tensor]:
        """The packed index as f32/int32 tensors on ``device``, copied there
        at the first call and kept."""
        if self._device_index is None:
            device = self.device
            self._device_index = {
                "centroids": to_device(self.centroids, device),
                "bucket_items": to_device(self.bucketItems, device),
                "bucket_ids": torch.from_numpy(
                    self.bucketIds.astype(np.int32)).to(device),
                "spill_items": to_device(self.spillItems, device),
                "spill_ids": torch.from_numpy(self.spillIds.astype(np.int32)).to(device),
            }
        return self._device_index

    def kneighbors(
        self, dataset: Any, k: int | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        queries = columnar.extract_matrix(
            dataset, self._paramMap.get("inputCol")
        )
        return self._kneighbors_matrix(queries, k)

    def _kneighbors_matrix(
        self, queries: np.ndarray, k: int | None = None, nprobe: int | None = None
    ) -> tuple[np.ndarray, np.ndarray]:
        """(distances, ids) of a [q, n] query matrix; ``nprobe`` overrides
        the param for this call."""
        from spark_rapids_ml_tpu_torch.ops import ivf as IVF

        k = self.getK() if k is None else k
        if not 1 <= k <= self.numItems:
            raise ValueError(
                f"k={k} must be in [1, {self.numItems}] (the fitted item count)"
            )
        metric = self.getMetric()
        if queries.shape[1] != self.centroids.shape[1]:
            raise ValueError(
                f"queries have {queries.shape[1]} features but the fitted "
                f"items have {self.centroids.shape[1]}"
            )
        queries = _prepare_rows(queries.astype(np.float32, copy=False), metric)
        index = self.index_tensors()
        nprobe = self.getNprobe() if nprobe is None else nprobe
        device = self.device
        out_scores = np.empty((queries.shape[0], k), dtype=np.float32)
        out_idx = np.empty((queries.shape[0], k), dtype=np.int32)
        with trace_range("ivf kneighbors", device):
            for lo in range(0, queries.shape[0], _QUERY_CHUNK):
                scores, idx = IVF.ivf_search(
                    to_device(queries[lo:lo + _QUERY_CHUNK], device),
                    index["centroids"], index["bucket_items"], index["bucket_ids"],
                    k, nprobe,
                    spill_items=index["spill_items"], spill_ids=index["spill_ids"],
                )
                out_scores[lo:lo + _QUERY_CHUNK] = scores.cpu().numpy()
                out_idx[lo:lo + _QUERY_CHUNK] = idx.cpu().numpy()
        dists = _ann_distances(out_scores, metric)
        ids = np.where(out_idx >= 0, self.itemIds[np.clip(out_idx, 0, None)], -1)
        return dists, ids

    def transform(self, dataset: Any) -> Any:
        dists, ids = self.kneighbors(dataset)
        return columnar.append_columns(
            dataset, [("indices", ids), ("distances", dists)]
        )

    def _saveData(self) -> dict[str, np.ndarray]:
        return {
            "centroids": self.centroids,
            "bucketItems": self.bucketItems,
            "bucketIds": self.bucketIds,
            "itemIds": self.itemIds,
            "spillItems": self.spillItems,
            "spillIds": self.spillIds,
        }

    @classmethod
    def _fromSaved(cls, uid, data, device: str | torch.device = "cuda"):
        spill_ids = data.get("spillIds")
        return cls(
            uid=uid,
            centroids=data["centroids"],
            bucketItems=data["bucketItems"],
            bucketIds=data["bucketIds"].astype(np.int32),
            itemIds=data["itemIds"],
            spillItems=data.get("spillItems"),
            spillIds=None if spill_ids is None else spill_ids.astype(np.int32),
            device=device,
        )
