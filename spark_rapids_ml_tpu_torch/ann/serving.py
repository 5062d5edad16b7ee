"""IVF indexes as the ``"ann"`` servable family.

Counterpart of ``spark_rapids_ml_tpu/ann/serving.py``. A registered index
is an ordinary ``serving.registry.ServableEntry``: the inverted lists
(centroids, packed buckets, spill list) are its params, so the HBM fleet
manager pages them like any model's weights, and the query is captured as
one CUDA graph per ladder rung like every family's kernel.
``_query_kernel`` is cached on its static knobs ``(k, nprobe, policy)``, and
``ops.ivf.ivf_search`` has static shapes and no host sync, so the whole
search is capturable.

A query answer is two arrays, one of them integral, but the dispatch path
moves one: the kernel returns a packed [rows, 2k] f32 block whose columns
[:k] are scores and [k:] the int32 neighbour positions bit-cast to f32
(``idx.view(torch.float32)``, no conversion). ``finalize`` decodes it on
the host, turns scores into metric distances (the logic of
``ApproximateNearestNeighborsModel._kneighbors_matrix``), maps positions
through the index's item ids and re-packs float64 ``distances | ids``. JSON
carries the ids exactly (≤ 2^53); the binary f32 wire truncates ids above
2^24.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.models.neighbors import _ann_distances, _prepare_rows
from spark_rapids_ml_tpu_torch.ops import ivf as IVF
from spark_rapids_ml_tpu_torch.telemetry import trace_range
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY
from spark_rapids_ml_tpu_torch.utils.device import to_device


@functools.lru_cache(maxsize=None)
def _query_kernel(k: int, nprobe: int, policy: str):
    """The pure ``kernel(params, x)`` of one (k, nprobe, policy) operating
    point, shared by every index registered at that point."""

    def kernel(params, x: torch.Tensor) -> torch.Tensor:
        centroids, bucket_items, bucket_ids, spill_items, spill_ids = params
        scores, idx = IVF.ivf_search(
            x, centroids, bucket_items, bucket_ids, k, nprobe,
            spill_items=spill_items, spill_ids=spill_ids, policy=policy,
        )
        return torch.cat([scores, idx.view(torch.float32)], dim=1)

    return kernel


def _make_prepare(metric: str):
    def prepare(mat: np.ndarray) -> np.ndarray:
        return _prepare_rows(mat, metric)

    return prepare


def _make_finalize(k: int, metric: str, item_ids: np.ndarray):
    """Host post hook: packed kernel block → float64 ``distances | ids``."""

    def finalize(out: np.ndarray, true_rows: int) -> np.ndarray:
        out = out[:true_rows]
        idx = np.ascontiguousarray(out[:, k:]).view(np.int32)
        dists = _ann_distances(out[:, :k], metric)
        ids = np.where(idx >= 0, item_ids[np.clip(idx, 0, None)], -1)
        packed = np.empty((out.shape[0], 2 * k), dtype=np.float64)
        packed[:, :k] = dists
        packed[:, k:] = ids
        return packed

    return finalize


def unpack_query_result(packed: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(distances float64 [rows, k], ids int64 [rows, k]) from the packed
    wire matrix (−1 ids mark unfilled slots)."""
    packed = np.asarray(packed, dtype=np.float64)
    if packed.ndim != 2 or packed.shape[1] % 2:
        raise ValueError(
            f"packed query result must be [rows, 2k], got {packed.shape}"
        )
    k = packed.shape[1] // 2
    return packed[:, :k], np.rint(packed[:, k:]).astype(np.int64)


def servable_from_index(name: str, model, device: torch.device):
    """The ``"ann"`` family entry of a fitted IVF index model
    (``ApproximateNearestNeighborsModel`` or its streamed subclass), its
    index copied to ``device``."""
    from spark_rapids_ml_tpu_torch.serving import registry as R

    if getattr(model, "bucketItems", None) is None or getattr(
        model, "centroids", None
    ) is None:
        raise TypeError(
            f"{type(model).__name__} is not a fitted IVF index (no packed "
            "buckets)"
        )
    n = int(model.centroids.shape[1])
    k = model.getK()
    nlist = int(model.bucketItems.shape[0])
    nprobe = min(model.getNprobe(), nlist)
    policy = R._consult_policy("ann", n, device)
    params = (
        to_device(model.centroids, device),
        to_device(model.bucketItems, device),
        torch.from_numpy(np.asarray(model.bucketIds, dtype=np.int32)).to(device),
        to_device(model.spillItems, device),
        torch.from_numpy(np.asarray(model.spillIds, dtype=np.int32)).to(device),
    )
    return R.ServableEntry(
        name=name,
        family="ann",
        model_cls=type(model).__name__,
        n_features=n,
        kernel=_query_kernel(k, nprobe, policy),
        params=params,
        prepare=_make_prepare(model.getMetric()),
        finalize=_make_finalize(k, model.getMetric(), np.asarray(model.itemIds)),
        device=device,
        policy=policy,
        model=model,
    )


def register_index(name: str, model, *, bucket_list=None, registry=None):
    """Register a fitted IVF index in the serving runtime (default: the
    process's registry): one CUDA graph per rung of the ladder, and the
    inverted lists booked against the HBM fleet budget."""
    from spark_rapids_ml_tpu_torch.serving import registry as R

    reg = registry if registry is not None else R.get_registry()
    return reg.register(name, model, bucket_list=bucket_list)


def query(
    name: str, queries: np.ndarray, *, timeout: float = 30.0
) -> tuple[np.ndarray, np.ndarray]:
    """(distances, ids) through the full serving path: the in-process
    client's query, over the shared micro-batcher."""
    from spark_rapids_ml_tpu_torch.serving import client as serve_client

    return serve_client.get_client().query(name, queries, timeout=timeout)


def query_direct(
    name: str,
    queries: np.ndarray,
    *,
    k: int | None = None,
    nprobe: int | None = None,
    registry=None,
) -> tuple[np.ndarray, np.ndarray]:
    """(distances, ids) straight off the registered model, bypassing the
    batcher: ``nprobe``/``k`` override the registered operating point per
    call (a recall sweep over one index)."""
    from spark_rapids_ml_tpu_torch.serving import registry as R

    reg = registry if registry is not None else R.get_registry()
    entry = reg.get(name)
    if entry.family != "ann":
        raise TypeError(f"{name!r} is a {entry.family} servable, not ann")
    queries = np.asarray(queries)
    with trace_range("ann query", entry.device):
        dists, ids = entry.model._kneighbors_matrix(queries, k, nprobe)
    REGISTRY.counter_inc("ann.queries", queries.shape[0], index=name)
    return dists, ids
