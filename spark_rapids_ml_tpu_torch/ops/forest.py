"""Histogram trees grown level-order on torch tensors: the random-forest and
decision-tree kernels.

Counterpart of ``spark_rapids_ml_tpu/ops/forest.py``. Features arrive
quantile-binned (``models/forest.py``); all 2^d nodes of a level build their
[features, bins, stats] histograms in one pass over the rows, and split
selection is a cumsum, a gain, a mask and an argmax over a dense
[nodes, F·B] tensor, in the JAX package's flattened layout, so that "the
first maximum" (``torch.argmax`` and ``jnp.argmax`` both return it) is the
same element in both.

Trees live in fixed heap-layout arrays (root 0, children 2i+1/2i+2, size
2^(maxDepth+1)−1): ``feature``/``split_bin`` per node, ``is_leaf``,
``leaf_stats`` (class counts, or [w, wy, wy²] for regression) for every
materialized node, and ``gain``. Impurities are n-scaled (n·impurity), so
gain·n_total = imp_n(parent) − imp_n(left) − imp_n(right).

**The histogram.** ``jax.ops.segment_sum`` becomes one ``index_add_`` per
level over the feature-major bins [F, rows], every (feature, node, bin)
cell an address of one flat [F·nodes·B, S] table. On the card it runs on
f32 atomics, whose order the hardware picks:

- class counts under integer weights (unit weights × Poisson bootstrap
  counts) are sums of integers, exact in any order below 2²⁴ per cell, so a
  classifier's tree is the same on every run and on every device (and on
  the CPU, where the adds run in row order as the JAX package's do);
- regression statistics (w·y, w·y²) are not integers: their sums, and so a
  near tie between two split gains, may change from run to run by the f32
  rounding of a cell's sum (about cell_rows·2⁻²⁴ relative). A split chosen
  here is then within that bound of the best split, not always the same one
  (``chip_smoke.py`` phase 16 holds every split to it in f64).

The root level has only F·B·S cells (1,792 at 28 features, 32 bins, 2
classes), so its adds contend for few addresses; the rows go through in
chunks of ``_HIST_ROWS`` to bound the flat index and source temporaries.

Per-node feature subsets (``k_features`` < F) draw uniform variates from a
seeded ``torch.Generator`` and keep each node's k largest, a uniform
k-subset as the JAX package's Gumbel top-k is; ``jax.random`` has no torch
counterpart, so the subsets are the port's own.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

IMPURITIES = ("gini", "entropy", "variance")

#: rows per chunk of the histogram's ``index_add_``
_HIST_ROWS = 1 << 21


class TreeArrays(NamedTuple):
    """One tree (or a [T, ...] stack) in heap layout."""

    feature: torch.Tensor     # [nodes] int32, −1 at leaves
    split_bin: torch.Tensor   # [nodes] int32, go left when bin ≤ split_bin
    is_leaf: torch.Tensor     # [nodes] bool
    leaf_stats: torch.Tensor  # [nodes, S]
    gain: torch.Tensor        # [nodes] n-scaled impurity decrease at split nodes


def _impurity_n(stats: torch.Tensor, impurity: str) -> torch.Tensor:
    """n·impurity over the trailing stats axis; 0 for empty cells."""
    if impurity == "variance":
        w = stats[..., 0]
        safe = torch.where(w > 0, w, torch.ones_like(w))
        v = stats[..., 2] - stats[..., 1] * stats[..., 1] / safe
        return torch.where(w > 0, torch.clamp(v, min=0.0), torch.zeros_like(v))
    n = torch.sum(stats, dim=-1)
    safe = torch.where(n > 0, n, torch.ones_like(n))
    zero = torch.zeros_like(n)
    if impurity == "gini":
        return torch.where(n > 0, n - torch.sum(stats * stats, dim=-1) / safe, zero)
    # entropy: Σ c·log(n/c), 0·log(·) := 0
    ratio = torch.where(stats > 0, stats / safe[..., None], torch.ones_like(stats))
    return torch.where(n > 0, -safe * torch.sum(ratio * torch.log(ratio), dim=-1), zero)


def _node_count(stats: torch.Tensor, impurity: str) -> torch.Tensor:
    """Weighted instance count per cell from the stats vector."""
    return stats[..., 0] if impurity == "variance" else torch.sum(stats, dim=-1)


def level_histogram(
    binned_t: torch.Tensor, local: torch.Tensor, contrib: torch.Tensor,
    nodes: int, n_bins: int,
) -> torch.Tensor:
    """[F, nodes, B, S] weighted stat sums of one level: cell (f, node, bin)
    sums ``contrib`` over the rows at ``node`` whose feature f falls in
    ``bin``. ``binned_t`` is [F, rows] int32, ``local`` [rows] the rows'
    node within the level, ``contrib`` [rows, S]."""
    n_feat, rows = binned_t.shape
    s = contrib.shape[1]
    hist = torch.zeros((n_feat * nodes * n_bins, s), dtype=contrib.dtype,
                       device=contrib.device)
    base = (torch.arange(n_feat, device=local.device, dtype=torch.int64) * nodes)[:, None]
    for lo in range(0, rows, _HIST_ROWS):
        hi = min(lo + _HIST_ROWS, rows)
        # feature-major: feature f's cells take rows lo..hi in row order
        idx = ((base + local[None, lo:hi]) * n_bins + binned_t[:, lo:hi]).reshape(-1)
        hist.index_add_(0, idx, contrib[lo:hi].repeat(n_feat, 1))
    return hist.reshape(n_feat, nodes, n_bins, s)


def _running_sums(hist: torch.Tensor) -> torch.Tensor:
    """Cumulative sums over the bin axis of [F, nodes, B, S], added bin
    after bin: the order of the JAX package's ``cumsum`` and bin total on
    the CPU (``torch.cumsum`` on the CPU adds in another order), and one
    fixed order on every device."""
    left = torch.empty_like(hist)
    acc = hist[:, :, 0].clone()
    left[:, :, 0] = acc
    for b in range(1, hist.shape[2]):
        acc = acc + hist[:, :, b]
        left[:, :, b] = acc
    return left


def build_tree(
    binned_t,                 # [F, rows] int32 bin ids in [0, n_bins)
    row_stats,                # [rows, S] per-row stats (unweighted)
    w,                        # [rows] bootstrap × instance weights (0 = excluded)
    min_instances: float,     # weighted count floor per child
    min_info_gain: float,
    *,
    max_depth: int,
    n_bins: int,
    k_features: int,
    impurity: str,
    generator: torch.Generator | None = None,
    reduce=None,
) -> TreeArrays:
    """Grow one histogram tree level-order. ``generator`` draws the per-node
    feature subsets when ``k_features`` < F.

    ``reduce`` is the sharded build's per-level reduction
    (``parallel/forest.py``): ``binned_t``, ``row_stats`` and ``w`` are then
    lists of the owned data shards' blocks, in shard order, and
    ``reduce(hists) -> hist`` sums the shards' level histograms. Every shard
    takes the split decisions of the reduced histogram (on the first
    shard's device) and routes its own rows. With None (the default) the
    arguments are single tensors: the one-device build."""
    if impurity not in IMPURITIES:
        raise ValueError(f"impurity must be one of {IMPURITIES}")
    if reduce is None:
        shards = [(binned_t, row_stats, w)]
    else:
        shards = list(zip(binned_t, row_stats, w))
    n_feat = shards[0][0].shape[0]
    s = shards[0][1].shape[1]
    max_nodes = 2 ** (max_depth + 1) - 1
    dev, fdt = shards[0][1].device, shards[0][1].dtype

    feature = torch.full((max_nodes,), -1, dtype=torch.int32, device=dev)
    split_bin = torch.zeros((max_nodes,), dtype=torch.int32, device=dev)
    is_leaf = torch.ones((max_nodes,), dtype=torch.bool, device=dev)
    leaf_stats = torch.zeros((max_nodes, s), dtype=fdt, device=dev)
    gain = torch.zeros((max_nodes,), dtype=fdt, device=dev)

    # heap node and activity per row, per shard
    nodes = [torch.zeros((b.shape[1],), dtype=torch.int64, device=b.device) for b, _, _ in shards]
    actives = [torch.ones((b.shape[1],), dtype=torch.bool, device=b.device) for b, _, _ in shards]
    last_bin = torch.arange(n_bins, device=dev)[None, None, :] < n_bins - 1
    neg_inf = torch.tensor(float("-inf"), dtype=fdt, device=dev)

    for d in range(max_depth + 1):
        nodes_d = 2 ** d
        offset = nodes_d - 1
        locals_, hists = [], []
        for (b_t, r_s, w_s), node, active in zip(shards, nodes, actives):
            # inactive rows keep the heap id of the level they went leaf at:
            # clipped into range, they add 0 (weight 0) and never route
            local = torch.clamp(node - offset, 0, nodes_d - 1)
            wa = torch.where(active, w_s, torch.zeros_like(w_s))
            contrib = r_s * wa[:, None]
            hists.append(level_histogram(b_t, local, contrib, nodes_d, n_bins))
            locals_.append(local)
        hist = hists[0] if reduce is None else reduce(hists)

        left = _running_sums(hist)  # [F, nodes_d, B, S]
        total = left[0, :, -1]      # [nodes_d, S]
        leaf_stats[offset:offset + nodes_d] = total
        if d == max_depth:
            break  # depth-capped: this level is all leaves

        right = total[None, :, None, :] - left
        gain_n = (
            _impurity_n(total, impurity)[None, :, None]
            - _impurity_n(left, impurity)
            - _impurity_n(right, impurity)
        )
        n_tot = _node_count(total, impurity)
        n_l = _node_count(left, impurity)
        n_r = _node_count(right, impurity)
        safe_tot = torch.where(n_tot > 0, n_tot, torch.ones_like(n_tot))
        ok = (
            (n_l >= min_instances)
            & (n_r >= min_instances)
            & (gain_n / safe_tot[None, :, None] >= min_info_gain)
            & (gain_n > 1e-12)
        )
        # the last bin's "split" puts everything left: structurally invalid
        ok = ok & last_bin
        if k_features < n_feat:
            # Spark's per-node feature subsampling: k distinct features per
            # node, the k largest of uniform variates
            g = torch.rand((nodes_d, n_feat), generator=generator, device=dev, dtype=fdt)
            kth = torch.topk(g, k_features, dim=1).values[:, -1]
            ok = ok & (g.T[:, :, None] >= kth[None, :, None])

        masked = torch.where(ok, gain_n, neg_inf)
        flat = masked.permute(1, 0, 2).reshape(nodes_d, n_feat * n_bins)
        best = torch.argmax(flat, dim=1)
        best_gain = torch.gather(flat, 1, best[:, None])[:, 0]
        best_f = (best // n_bins).to(torch.int32)
        best_b = (best % n_bins).to(torch.int32)
        do_split = best_gain > neg_inf

        feature[offset:offset + nodes_d] = torch.where(do_split, best_f, -1)
        split_bin[offset:offset + nodes_d] = torch.where(do_split, best_b, 0)
        is_leaf[offset:offset + nodes_d] = ~do_split
        gain[offset:offset + nodes_d] = torch.where(do_split, best_gain, 0.0)

        # route rows: split nodes send rows to 2·node+1 (+1 if bin > b)
        for i, ((b_t, _, _), local) in enumerate(zip(shards, locals_)):
            sd = b_t.device
            row_split = actives[i] & do_split.to(sd)[local]
            rf = best_f.to(sd)[local].to(torch.int64)
            rb = best_b.to(sd)[local]
            row_bin = torch.gather(b_t, 0, rf[None, :])[0]
            goes_right = (row_bin > rb).to(torch.int64)
            nodes[i] = torch.where(row_split, 2 * nodes[i] + 1 + goes_right, nodes[i])
            actives[i] = actives[i] & row_split

    return TreeArrays(feature, split_bin, is_leaf, leaf_stats, gain)


def build_forest(
    binned_t: torch.Tensor,
    row_stats: torch.Tensor,
    weights: torch.Tensor,  # [T, rows] per-tree bootstrap × instance weights
    min_instances: float,
    min_info_gain: float,
    *,
    generators: list[torch.Generator] | None = None,
    **static,
) -> TreeArrays:
    """:func:`build_tree` for each tree, one after another → [T, ...]
    TreeArrays. ``generators`` holds one per tree (feature subsets)."""
    trees = [
        build_tree(
            binned_t, row_stats, weights[t], min_instances, min_info_gain,
            generator=None if generators is None else generators[t], **static,
        )
        for t in range(weights.shape[0])
    ]
    return TreeArrays(*(torch.stack(parts) for parts in zip(*trees)))


def tree_apply_binned(tree: TreeArrays, binned_t: torch.Tensor, *, max_depth: int) -> torch.Tensor:
    """[rows, S] leaf stats of ONE tree by descending on bin ids (go left
    when bin ≤ split_bin): the training-time router of gradient boosting.
    ``binned_t`` is [F, rows]."""
    node = torch.zeros((binned_t.shape[1],), dtype=torch.int64, device=binned_t.device)
    for _ in range(max_depth):
        leaf = tree.is_leaf[node]
        f = torch.clamp(tree.feature[node], min=0).to(torch.int64)
        b = torch.gather(binned_t, 0, f[None, :])[0]
        goes_right = (b > tree.split_bin[node]).to(torch.int64)
        node = torch.where(leaf, node, 2 * node + 1 + goes_right)
    return tree.leaf_stats[node]


def forest_apply(
    trees: TreeArrays,          # [T, ...] stack
    x: torch.Tensor,            # [rows, F] raw feature values
    thresholds: torch.Tensor,   # [T, nodes] split values (edges[f, b])
    *,
    max_depth: int,
) -> torch.Tensor:
    """[T, rows, S] leaf stats: ``max_depth`` dependent steps, each a
    gather and a compare (x > threshold goes right) for every tree at once.
    The compare runs in the thresholds' dtype (f64 edges: exactly the
    training bins' comparison of an f32 value against its edge). Static
    shapes and no host sync: a CUDA graph captures it."""
    t = trees.feature.shape[0]
    node = torch.zeros((t, x.shape[0]), dtype=torch.int64, device=x.device)
    x_t = x.T
    for _ in range(max_depth):
        leaf = torch.gather(trees.is_leaf, 1, node)
        f = torch.clamp(torch.gather(trees.feature, 1, node), min=0).to(torch.int64)
        xv = torch.gather(x_t, 0, f).to(thresholds.dtype)
        goes_right = (xv > torch.gather(thresholds, 1, node)).to(torch.int64)
        node = torch.where(leaf, node, 2 * node + 1 + goes_right)
    s = trees.leaf_stats.shape[2]
    return torch.gather(trees.leaf_stats, 1, node[:, :, None].expand(-1, -1, s))
