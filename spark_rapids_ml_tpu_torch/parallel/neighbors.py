"""Mesh-sharded exact k-NN: distributed brute force as a shard program.

Counterpart of ``spark_rapids_ml_tpu/parallel/neighbors.py``. The corpus is
row-sharded over the ``data`` axis and the queries are replicated; each
shard streams its rows through ``ops.neighbors.knn_topk`` with its global
index base (``shard · shard_rows``). One ``all_gather`` brings every
shard's [q, k] candidates together in shard order, and a stable
descending sort keeps the best k: the lower global index first among equal
scores, as ``lax.top_k`` orders them. k·ndev candidates cross per query,
never the [q, rows] distance matrix.
"""

from __future__ import annotations

from typing import Any

import torch

from spark_rapids_ml_tpu_torch.ops import neighbors as NN
from spark_rapids_ml_tpu_torch.parallel import backend as B
from spark_rapids_ml_tpu_torch.parallel.mesh import Mesh


def make_sharded_knn(mesh: Mesh, k: int, *, metric: str = "sqeuclidean",
                     block_rows: int = NN.DEFAULT_BLOCK_ROWS):
    """``run(corpus, valid, queries) -> (scores, indices)``: ``corpus``
    [rows, n] and ``valid`` [rows] data-sharded (equal shards, pad rows at
    valid 0), ``queries`` [q, n] replicated; [q, k] outputs on the mesh's
    first device, scores larger-is-better (``ops.neighbors``). Each shard
    gives ``min(k, shard_rows)`` candidates, padded to k with −inf and −1."""

    def run(corpus: Any, valid: Any, queries: Any) -> tuple[torch.Tensor, torch.Tensor]:
        valid = torch.as_tensor(valid).to(torch.float32)
        local = B.shard_operands(mesh, (corpus, valid, queries),
                                 (B.MATRIX_SPEC, B.VECTOR_SPEC, B.REPLICATED_SPEC))
        shard_rows = local[0][0].shape[0]
        kk = min(k, shard_rows)
        scores, ids = [], []
        for shard, (cl, vl, ql) in zip(mesh.data_indices(), local):
            s, i = NN.knn_topk(ql, cl, vl > 0, kk, metric=metric,
                               block_rows=min(block_rows, shard_rows),
                               index_offset=shard * shard_rows)
            if kk < k:
                q = ql.shape[0]
                s = torch.cat([s, s.new_full((q, k - kk), float("-inf"))], dim=1)
                i = torch.cat([i, i.new_full((q, k - kk), -1)], dim=1)
            scores.append(s)
            ids.append(i)
        dev = mesh.first_device
        flat_s = torch.cat([v.to(dev) for v in B.all_gather(mesh, scores)], dim=1)
        flat_i = torch.cat([v.to(dev) for v in B.all_gather(mesh, ids)], dim=1)
        best, which = torch.sort(flat_s, dim=1, descending=True, stable=True)
        return best[:, :k], torch.gather(flat_i, 1, which[:, :k])

    return run
