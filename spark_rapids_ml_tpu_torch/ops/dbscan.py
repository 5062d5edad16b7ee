"""DBSCAN on torch tensors: density clustering without an n×n adjacency.

Counterpart of ``spark_rapids_ml_tpu/ops/dbscan.py``, the same three steps:

1. the eps-neighbourhood test is the ‖x−y‖² cross-term expansion of
   ``ops.kmeans.pairwise_sq_dists``, one product per (row block, corpus
   block) tile pair, in a double loop, so only [blk, blk] tiles exist;
2. connected components over the core-point graph by min-label
   propagation: every core point takes the smallest label among its core
   eps-neighbours, each sweep the same blocked pass with a masked min;
3. pointer jumping (``labels = labels[labels]``) after each sweep collapses
   label chains, because a label is always the index of another core row in
   the same cluster.

Labels out (int32): cluster id = the smallest core-row index in the cluster,
border rows take the smallest label among their core neighbours, noise and
padding −1. The result is deterministic, so it equals the JAX package's
exactly. ``w`` is sklearn's sample_weight: a row is core when the weight
sum of its eps-neighbourhood (itself included) reaches ``min_pts``; weights
gate core status only. ``valid`` is the padding mask: an invalid row adds
nothing, is never core and comes out −1.
"""

from __future__ import annotations

import torch

from spark_rapids_ml_tpu_torch.ops.kmeans import pairwise_sq_dists

#: rows per block of each side of a tile; the CPU parity tests use it, the
#: model passes a larger one on the card (``models/dbscan.py``)
DEFAULT_BLOCK_ROWS = 2048


def make_count_fn(eps_sq):
    """Tile accumulator: the weighted eps-neighbourhood mass."""

    def count_fn(acc, d, extras):
        return acc + torch.sum(
            torch.where(d <= eps_sq, extras["w"][None, :], 0.0), dim=1
        )

    return count_fn


def make_min_fn(eps_sq, sentinel: int):
    """Tile accumulator: the smallest label among core eps-neighbours."""

    def min_fn(acc, d, extras):
        cand = torch.where(
            (d <= eps_sq) & extras["core"][None, :],
            extras["labels"][None, :],
            sentinel,
        )
        return torch.minimum(acc, torch.min(cand, dim=1).values)

    return min_fn


def _blocked_rowpass(
    queries: torch.Tensor,
    corpus_x: torch.Tensor,
    row_fn,
    init_row,
    *,
    block_rows: int,
    corpus: dict[str, torch.Tensor] | None = None,
) -> torch.Tensor:
    """Run ``row_fn(acc_tile, d_tile, corpus_slice) -> acc_tile`` over every
    (query block × corpus block) tile of the pairwise distance matrix and
    return the [q_rows] accumulators: the skeleton of the count pass and of
    every propagation sweep. ``corpus`` holds per-corpus-row extras
    (weights, labels, core mask), given to ``row_fn`` as [blk] slices;
    ``init_row`` is the accumulators' (initial value, dtype)."""
    corpus = corpus or {}
    q_rows, c_rows = queries.shape[0], corpus_x.shape[0]
    out = torch.empty(q_rows, dtype=init_row[1], device=queries.device)
    for qlo in range(0, q_rows, block_rows):
        qi = queries[qlo:qlo + block_rows]
        acc = torch.full((qi.shape[0],), init_row[0], dtype=init_row[1], device=qi.device)
        for clo in range(0, c_rows, block_rows):
            d = pairwise_sq_dists(qi, corpus_x[clo:clo + block_rows])
            extras = {k: v[clo:clo + block_rows] for k, v in corpus.items()}
            acc = row_fn(acc, d, extras)
        out[qlo:qlo + block_rows] = acc
    return out


def dbscan_core_mask(
    x: torch.Tensor,
    w: torch.Tensor,
    valid: torch.Tensor,
    eps_sq: float,
    min_pts: float,
    *,
    block_rows: int = DEFAULT_BLOCK_ROWS,
) -> torch.Tensor:
    """[rows] bool: valid, and weighted eps-neighbourhood mass (itself
    included) ≥ min_pts."""
    valid = valid.to(torch.bool)
    wv = torch.where(valid, w, 0.0)
    counts = _blocked_rowpass(
        x, x, make_count_fn(eps_sq), (0.0, x.dtype),
        block_rows=block_rows, corpus={"w": wv},
    )
    return (counts >= min_pts) & valid


def dbscan_labels(
    x: torch.Tensor,
    w: torch.Tensor,
    valid: torch.Tensor,
    eps_sq: float,
    min_pts: float,
    *,
    block_rows: int = DEFAULT_BLOCK_ROWS,
) -> torch.Tensor:
    """DBSCAN of the rows of ``x``: [rows] int32 labels (smallest core index
    per cluster; border → smallest core neighbour label; noise and padding
    −1)."""
    rows = x.shape[0]
    valid = valid.to(torch.bool)
    core = dbscan_core_mask(x, w, valid, eps_sq, min_pts, block_rows=block_rows)
    sentinel = rows
    min_fn = make_min_fn(eps_sq, sentinel)

    def donated_min(labels):
        """[rows] smallest label among each row's CORE eps-neighbours."""
        return _blocked_rowpass(
            x, x, min_fn, (sentinel, torch.int32),
            block_rows=block_rows, corpus={"core": core, "labels": labels},
        )

    arange = torch.arange(rows, dtype=torch.int32, device=x.device)
    labels = torch.where(core, arange, sentinel).to(torch.int32)
    while True:  # one wait for the device per sweep
        new = torch.where(core, torch.minimum(labels, donated_min(labels)), labels)
        for _ in range(2):  # pointer jumping
            new = torch.where(core, new[torch.clamp(new, 0, rows - 1).long()], new)
        changed = bool(torch.any(new != labels))  # tpulint: disable=TPL002 -- the propagation loop stops on the host: one flag per sweep
        labels = new
        if not changed:
            break

    # border pass: non-core rows adopt the smallest core neighbour's
    # (converged) cluster; no core neighbour ⇒ noise. Invalid (pad) rows −1.
    donated = donated_min(labels)
    out = torch.where(core, labels, torch.where(donated < sentinel, donated, -1))
    return torch.where(valid, out, -1).to(torch.int32)
