"""Exact k-nearest-neighbours on torch tensors: brute force over corpus
blocks.

Counterpart of ``spark_rapids_ml_tpu/ops/neighbors.py``:

- distances are the ‖x‖² + ‖y‖² − 2·x·yᵀ expansion of KMeans, one
  [q, n]×[n, block] cross-term product per corpus block, under the
  precision policy (``f32``, ``bf16_f32acc`` or ``int8_dist``);
- selection keeps the best k by score (larger is better) and merges
  blockwise: the running [q, k] winners join each block's [q, block]
  scores and the best k of the union survive, so the [q, rows] distance
  matrix never exists.

Ties: ``lax.top_k`` puts the lower position first among equal scores, and
``torch.topk`` promises no order, so a merge is a stable descending sort.
The running winners come before the block and hold lower ids, so the ids
equal the JAX package's.
"""

from __future__ import annotations

import torch

from spark_rapids_ml_tpu_torch.autotune.policy import PrecisionPolicy
from spark_rapids_ml_tpu_torch.ops.linalg import (
    DEFAULT_POLICY,
    _require_f32_matmul,
    int8_quantized_matmul,
    policy_matmul,
)

#: kernel metrics; ranking is by LARGEST score:
#: "sqeuclidean": score = −‖x−y‖² (top-k = nearest);
#: "dot":         score = x·y     (top-k = largest inner product).
_METRICS = ("sqeuclidean", "dot")

DEFAULT_BLOCK_ROWS = 8192


def _block_scores(
    queries: torch.Tensor, block: torch.Tensor, metric: str, policy: str = DEFAULT_POLICY
) -> torch.Tensor:
    """[q, block] ranking scores (larger = better neighbour). The cross term
    follows ``policy``; the norms stay full precision."""
    if policy == PrecisionPolicy.INT8_DIST.value:
        cross = int8_quantized_matmul(queries, block.T)
    else:
        cross = policy_matmul(queries, block.T, policy=policy)
    if metric == "dot":
        return cross
    q_sq = torch.sum(queries * queries, dim=1, keepdim=True)
    b_sq = torch.sum(block * block, dim=1)[None, :]
    return -torch.clamp((q_sq + b_sq).sub_(cross, alpha=2.0), min=0.0)


def merge_topk(
    scores_a: torch.Tensor,
    idx_a: torch.Tensor,
    scores_b: torch.Tensor,
    idx_b: torch.Tensor,
    k: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The best k of two candidate sets (larger score is better), in
    descending order, the earlier position first among equal scores."""
    scores = torch.cat([scores_a, scores_b], dim=1)
    idx = torch.cat([idx_a, idx_b], dim=1)
    best, which = torch.sort(scores, dim=1, descending=True, stable=True)
    return best[:, :k], torch.gather(idx, 1, which[:, :k])


def knn_topk(
    queries: torch.Tensor,
    corpus: torch.Tensor,
    valid: torch.Tensor,
    k: int,
    *,
    metric: str = "sqeuclidean",
    block_rows: int = DEFAULT_BLOCK_ROWS,
    index_offset: int = 0,
    policy: str = DEFAULT_POLICY,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Best-k corpus rows per query, streamed over corpus blocks.

    ``valid`` masks corpus rows ([rows] bool; 0 for padding): an invalid
    row scores −inf and is never selected. Returns ``(scores [q, k]
    descending, indices [q, k] int32)``, the indices offset by
    ``index_offset``. Scores are negated squared distances for
    ``metric="sqeuclidean"`` and inner products for ``metric="dot"``; the
    model converts them to distances."""
    if metric not in _METRICS:
        raise ValueError(f"metric must be one of {_METRICS}, got {metric!r}")
    _require_f32_matmul()
    rows = corpus.shape[0]
    q = queries.shape[0]
    if k > rows:
        raise ValueError(f"k={k} exceeds corpus rows={rows}")
    valid = valid.to(torch.bool)
    neg_inf = torch.tensor(float("-inf"), dtype=queries.dtype, device=queries.device)
    best = torch.full((q, k), float("-inf"), dtype=queries.dtype, device=queries.device)
    bidx = torch.full((q, k), -1, dtype=torch.int32, device=queries.device)
    for lo in range(0, rows, block_rows):
        block = corpus[lo:lo + block_rows]
        scores = torch.where(
            valid[lo:lo + block_rows][None, :],
            _block_scores(queries, block, metric, policy),
            neg_inf,
        )
        ids = torch.arange(
            index_offset + lo, index_offset + lo + block.shape[0],
            dtype=torch.int32, device=queries.device,
        ).expand(q, -1)
        best, bidx = merge_topk(best, bidx, scores, ids, k)
    return best, bidx
