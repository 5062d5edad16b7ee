"""Mesh-sharded random-forest build: level histograms summed over rows.

Counterpart of ``spark_rapids_ml_tpu/parallel/forest.py``. The per-level
[features, nodes, bins, stats] histogram of ``ops.forest.build_tree`` is a
monoid over rows, so the distributed build has the shape of every mesh fit
here (and of Spark MLlib's own forest aggregation): rows sharded over the
``data`` axis, each shard's histogram, one ``psum`` a level in shard
order (``build_tree``'s ``reduce`` hook), and every shard takes the same
split decisions while routing only its own rows. In one process the
shards build each level in lock step; across processes the psum is the
process group's gather. The per-node feature subsets come from the
per-tree generators, seeded alike on every rank, so every shard draws the
same subsets.

Under integer weights (unit weights × Poisson bootstrap counts) the class
counts are sums of integers, exact in f32 below 2²⁴ a cell in any order,
so the trees equal the one-device build's; weighted or regression
statistics may differ from it by the f32 rounding of a cell's sum.
"""

from __future__ import annotations

from typing import Any

import torch

from spark_rapids_ml_tpu_torch.ops import forest as FO
from spark_rapids_ml_tpu_torch.parallel import backend as B
from spark_rapids_ml_tpu_torch.parallel.mesh import DATA_AXIS, Mesh


def _row_blocks(mesh: Mesh, binned_t: Any, row_stats: Any, weights: Any):
    """Each owned shard's (binned_t [F, r], row_stats [r, S], weights [T, r])
    on its device. On a mesh of this process the rows are padded to a
    multiple of the data shards (pad weight 0: invisible to every
    histogram) and split in order; on a process mesh the arguments are
    this rank's own rows."""
    binned_t, row_stats, weights = (torch.as_tensor(a) for a in (binned_t, row_stats, weights))
    if mesh.distributed:
        dev = mesh.first_device
        return [(binned_t.to(dev), row_stats.to(dev), weights.to(dev))]
    ndev = mesh.shape[DATA_AXIS]
    rows = binned_t.shape[1]
    per = -(-rows // ndev)
    pad = per * ndev - rows
    if pad:
        binned_t = torch.cat([binned_t, binned_t.new_zeros((binned_t.shape[0], pad))], dim=1)
        row_stats = torch.cat([row_stats, row_stats.new_zeros((pad, row_stats.shape[1]))])
        weights = torch.cat([weights, weights.new_zeros((weights.shape[0], pad))], dim=1)
    out = []
    for i in mesh.data_indices():
        dev = mesh.device(i)
        lo, hi = i * per, (i + 1) * per
        out.append((binned_t[:, lo:hi].to(dev).contiguous(), row_stats[lo:hi].to(dev),
                    weights[:, lo:hi].to(dev)))
    return out


def make_sharded_forest(mesh: Mesh, *, max_depth: int, n_bins: int, k_features: int,
                        impurity: str):
    """``run(binned_t, row_stats, weights, min_inst, min_gain, generators=None)
    -> TreeArrays [T, ...]`` on the mesh's first device: ``binned_t`` [F,
    rows], ``row_stats`` [rows, S] and ``weights`` [T, rows] (one row of
    bootstrap × instance weights a tree) sharded by rows, trees
    replicated; ``generators`` one a tree on the first device (the feature
    subsets). The same call signature as ``ops.forest.build_forest``."""
    static = dict(max_depth=max_depth, n_bins=n_bins, k_features=k_features, impurity=impurity)

    def reduce(hists):
        return B.psum(mesh, hists)[0]

    def run(binned_t, row_stats, weights, min_inst, min_gain, generators=None):
        blocks = _row_blocks(mesh, binned_t, row_stats, weights)
        trees = [
            FO.build_tree(
                [b for b, _, _ in blocks], [r for _, r, _ in blocks], [w[t] for _, _, w in blocks],
                min_inst, min_gain, generator=None if generators is None else generators[t],
                reduce=reduce, **static,
            )
            for t in range(blocks[0][2].shape[0])
        ]
        return FO.TreeArrays(*(torch.stack(parts) for parts in zip(*trees)))

    return run
