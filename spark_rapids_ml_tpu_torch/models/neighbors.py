"""Exact NearestNeighbors estimator and model of the port, on the card by
default.

Counterpart of the exact half of ``spark_rapids_ml_tpu/models/neighbors.py``
(the approximate IVF classes are not ported yet): fit on an item set, then
``kneighbors`` a query set → per-query distance and id arrays, brute force
through ``ops/neighbors.py``'s blocked selection, plus a ``device``
argument (default ``"cuda"``). The cross term is f32, as in the JAX
package; ``ops.neighbors.knn_topk`` takes the other policies.

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
from spark_rapids_ml_tpu_torch.utils.device import to_device

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
