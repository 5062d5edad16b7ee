"""KMeans on torch tensors: distances, assignment, the Lloyd statistics and
the k-means++ seeding (BASELINE.json config 5).

Counterpart of ``spark_rapids_ml_tpu/ops/kmeans.py``:

- distances: ‖x−c‖² expanded to ‖x‖² + ‖c‖² − 2·x·cᵀ, whose cross term is
  one [rows, n]×[n, k] product under the precision policy (``f32``,
  ``bf16_f32acc`` through ``linalg.policy_matmul``, or ``int8_dist``
  through ``linalg.int8_quantized_matmul``); the norms stay f32;
- centroid sums: the scatter by label as the product onehotᵀ·x in f32 with
  TF32 off, which gives the same bits on every run (f32 atomics would not,
  and a fit resumed from a checkpoint must end at the centres of an
  uninterrupted one).

Rows go through in blocks of ``block_rows`` (a Python loop over views in
place of the JAX package's ``lax.scan``), so the [block, k] distance and
one-hot tiles stay bounded whatever the partition's length. The block
changes only the order of the f32 sums, not what is computed.

Seeding draws from an explicit ``torch.Generator`` on the tensors' device:
the same seed gives the same centres here, not the JAX package's (its
``jax.random`` stream has no torch counterpart). A draw is an inverse CDF on
the device, so the k-step loop never waits for the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from spark_rapids_ml_tpu_torch.autotune.policy import PrecisionPolicy
from spark_rapids_ml_tpu_torch.ops.linalg import (
    DEFAULT_POLICY,
    _require_f32_matmul,
    int8_quantized_matmul,
    policy_matmul,
)

_INT8_DIST = PrecisionPolicy.INT8_DIST.value

#: rows per block of the Lloyd pass; the CPU parity tests use it, the
#: estimator passes a larger one on the card (``models/kmeans.py``)
DEFAULT_BLOCK_ROWS = 8192


class KMeansStats(NamedTuple):
    """Sufficient statistics of one Lloyd iteration over a row shard."""

    sums: torch.Tensor    # [k, n] per-cluster feature sums
    counts: torch.Tensor  # [k] per-cluster (weighted) row counts
    cost: torch.Tensor    # [] sum of min squared distances (inertia)


def combine_kmeans_stats(a: KMeansStats, b: KMeansStats) -> KMeansStats:
    return KMeansStats(a.sums + b.sums, a.counts + b.counts, a.cost + b.cost)


def pairwise_sq_dists(
    x: torch.Tensor, centers: torch.Tensor, *, policy: str = DEFAULT_POLICY
) -> torch.Tensor:
    """[rows, k] squared distances by the cross-term expansion, clipped at
    0. Only the cross term follows ``policy``; the norms stay full
    precision."""
    x_sq = torch.sum(x * x, dim=1, keepdim=True)
    c_sq = torch.sum(centers * centers, dim=1)[None, :]
    if policy == _INT8_DIST:
        cross = int8_quantized_matmul(x, centers.T)
    else:
        cross = policy_matmul(x, centers.T, policy=policy)
    # (‖x‖² + ‖c‖²) − 2·cross in place on the one [rows, k] tile; 2·cross is
    # exact, so this rounds as the unfused expression does
    return (x_sq + c_sq).sub_(cross, alpha=2.0).clamp_(min=0.0)


def assign_clusters(
    x: torch.Tensor, centers: torch.Tensor, *, policy: str = DEFAULT_POLICY
) -> tuple[torch.Tensor, torch.Tensor]:
    """(labels [rows], min squared distances [rows]); the first centre wins a
    tie, as ``jnp.argmin`` picks."""
    dists, labels = torch.min(pairwise_sq_dists(x, centers, policy=policy), dim=1)
    return labels, dists


def assign_blocks(
    x: torch.Tensor,
    centers: torch.Tensor,
    *,
    block_rows: int = DEFAULT_BLOCK_ROWS,
    policy: str = DEFAULT_POLICY,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``assign_clusters`` over ``x`` a block of rows at a time, so only a
    [block, k] tile exists: labels (int32) and min squared distances of
    every row."""
    rows = x.shape[0]
    labels = torch.empty(rows, dtype=torch.int32, device=x.device)
    dists = torch.empty(rows, dtype=x.dtype, device=x.device)
    for lo in range(0, rows, block_rows):
        lab, d = assign_clusters(x[lo:lo + block_rows], centers, policy=policy)
        labels[lo:lo + block_rows] = lab
        dists[lo:lo + block_rows] = d
    return labels, dists


def kmeans_stats(
    x: torch.Tensor,
    centers: torch.Tensor,
    weights: torch.Tensor | None = None,
    *,
    block_rows: int = DEFAULT_BLOCK_ROWS,
    policy: str = DEFAULT_POLICY,
) -> KMeansStats:
    """One Lloyd accumulation pass over a row shard, block by block.

    ``weights`` masks padded rows (weight 0) and carries instance weights."""
    _require_f32_matmul()
    rows, n = x.shape
    k = centers.shape[0]
    if weights is None:
        weights = torch.ones(rows, dtype=x.dtype, device=x.device)
    sums = torch.zeros((k, n), dtype=x.dtype, device=x.device)
    counts = torch.zeros(k, dtype=x.dtype, device=x.device)
    cost = torch.zeros((), dtype=x.dtype, device=x.device)
    for lo in range(0, rows, block_rows):
        xi = x[lo:lo + block_rows]
        wi = weights[lo:lo + block_rows]
        labels, dists = assign_clusters(xi, centers, policy=policy)
        onehot = torch.zeros((xi.shape[0], k), dtype=x.dtype, device=x.device)
        onehot.scatter_(1, labels[:, None], wi[:, None])
        sums += onehot.T @ xi
        counts += onehot.sum(dim=0)
        cost += torch.sum(dists * wi)
    return KMeansStats(sums, counts, cost)


def update_centers(stats: KMeansStats, old_centers: torch.Tensor) -> torch.Tensor:
    """New centroids = sums/counts; an empty cluster keeps its old centre
    (Spark MLlib behavior)."""
    counts = stats.counts[:, None]
    safe = torch.where(counts > 0, counts, torch.ones_like(counts))
    return torch.where(counts > 0, stats.sums / safe, old_centers)


def center_shift_sq(old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Max squared movement of any centroid, the convergence criterion."""
    return torch.max(torch.sum((old - new) ** 2, dim=1))


def min_sq_dists(
    x: torch.Tensor, centers: torch.Tensor, *, policy: str = DEFAULT_POLICY
) -> torch.Tensor:
    """[rows] squared distance of each row to its nearest centre."""
    return torch.min(pairwise_sq_dists(x, centers, policy=policy), dim=1).values


def _draw(gen: torch.Generator, scores: torch.Tensor) -> torch.Tensor:
    """One index drawn with probability ∝ ``scores`` (≥ 0), as a [1] tensor on
    the scores' device, by inverse CDF: a row of score 0 is never drawn. A
    uniform that rounds onto the total falls back to the largest score."""
    cum = torch.cumsum(scores, dim=0)
    u = torch.rand(1, generator=gen, device=scores.device, dtype=scores.dtype) * cum[-1:]
    idx = torch.searchsorted(cum, u, right=True)
    return torch.where(idx < scores.shape[0], idx, torch.argmax(scores).reshape(1))


def kmeans_plus_plus_init(gen: torch.Generator, x: torch.Tensor, k: int) -> torch.Tensor:
    """k-means++ seeding on a (sub)sample: the unweighted case of
    ``weighted_kmeans_plus_plus_init``."""
    return weighted_kmeans_plus_plus_init(
        gen, x, torch.ones(x.shape[0], dtype=x.dtype, device=x.device), k
    )


def weighted_kmeans_plus_plus_init(
    gen: torch.Generator, x: torch.Tensor, w: torch.Tensor, k: int
) -> torch.Tensor:
    """Weighted k-means++, the finishing step of k-means‖ (Bahmani et al.,
    §3.4): k seeds drawn ∝ w·D². ``w`` are candidate weights (the rows each
    candidate owns); a zero-weight candidate is never drawn."""
    w = w.to(x.dtype)
    centers = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    first = x.index_select(0, _draw(gen, w))
    centers[0:1] = first
    dists = torch.sum((x - first) ** 2, dim=1)
    for i in range(1, k):
        c = x.index_select(0, _draw(gen, w * dists))
        centers[i:i + 1] = c
        dists = torch.minimum(dists, torch.sum((x - c) ** 2, dim=1))
    return centers
