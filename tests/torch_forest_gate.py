"""The forests' gate rule, shared by the tests that hold the port's trees to
the JAX package's.

Both packages split a node when its best n-scaled gain passes
``gain_n > 1e-12``, computed from f32 histograms whose sums run in
different orders (``index_add_`` and a running sum in the port, XLA's
segment sum, ``cumsum`` and ``sum`` in JAX). A pure node's exact gain is 0,
but each of its three n-scaled impurities n − Σc²/n rounds to a few ulps of
n, so either package may find a positive gain of that size and split it.
The rule: a node may differ between the packages, and so may its subtree,
only when its best gain recomputed in f64 lies within

    bound = 3·(S + 3)·2⁻²⁴·n

of the gate, with n the node's weighted count and S the stats width (three
impurities, each with S + 3 rounded operations on values up to n). Every
other node is equal field for field.
"""

from __future__ import annotations

import numpy as np

GATE = 1e-12


def forest_inputs(x, y, w, *, num_trees: int, max_bins: int, seed: int = 0, rate: float = 1.0):
    """(binned [rows, F], one-hot row stats [rows, S], per-tree weights
    [T, rows]) as a bootstrapped classifier forest of either package draws
    them (quantile edges, Poisson(rate) bootstrap × instance weights)."""
    from spark_rapids_ml_tpu_torch.models import forest as PF

    x = np.asarray(x, np.float32)
    edges = PF.quantile_bin_edges(x, max_bins, seed, w)
    binned = PF.bin_features(x, edges)
    classes = np.round(y).astype(np.int64)
    stats = np.eye(int(classes.max()) + 1, dtype=np.float32)[classes]
    rng = np.random.default_rng(seed)
    weights = rng.poisson(rate, size=(num_trees, len(x))).astype(np.float32)
    base = np.ones(len(x), np.float32) if w is None else np.asarray(w).astype(np.float32)
    return binned, stats, weights * base[None, :]


def _gini_n(c):
    n = c.sum(axis=-1)
    safe = np.where(n > 0, n, 1.0)
    return np.where(n > 0, n - (c * c).sum(axis=-1) / safe, 0.0)


def _rows_at(tree_feature, tree_split, binned, node):
    """Mask of the rows the tree routes to ``node`` (bin > split goes right)."""
    path = []
    while node:
        parent = (node - 1) // 2
        path.append((parent, node == 2 * parent + 2))
        node = parent
    mask = np.ones(len(binned), bool)
    for parent, right in reversed(path):
        goes_right = binned[:, tree_feature[parent]] > tree_split[parent]
        mask &= goes_right if right else ~goes_right
    return mask


def f64_best_gain(binned, stats, w, mask, *, n_bins: int, min_instances: float,
                  min_info_gain: float) -> tuple[float, float]:
    """(best n-scaled gini gain over the allowed splits, or -inf; the node's
    weighted count), in f64 over every feature."""
    contrib = stats[mask].astype(np.float64) * w[mask, None].astype(np.float64)
    total = contrib.sum(axis=0)
    n_tot = total.sum()
    best = -np.inf
    for f in range(binned.shape[1]):
        hist = np.zeros((n_bins, stats.shape[1]))
        np.add.at(hist, binned[mask, f], contrib)
        left = np.cumsum(hist, axis=0)[:-1]  # the last bin's split is invalid
        right = total[None, :] - left
        gain = _gini_n(total) - _gini_n(left) - _gini_n(right)
        ok = ((left.sum(1) >= min_instances) & (right.sum(1) >= min_instances)
              & (gain / max(n_tot, 1e-300) >= min_info_gain))
        if ok.any():
            best = max(best, float(gain[ok].max()))
    return best, float(n_tot)


def assert_trees_equal_up_to_gate_rule(got, ref, binned, stats, weights, *, n_bins: int,
                                       min_instances: float = 1.0,
                                       min_info_gain: float = 0.0) -> int:
    """``got`` and ``ref`` (``TreeArrays`` of [T, nodes] host arrays) equal
    in feature, split bin and leaf flag at every node but those the rule
    excuses; returns how many nodes it excused at their root."""
    excused_roots = 0
    s = stats.shape[1]
    for t in range(ref.feature.shape[0]):
        excused: set[int] = set()
        for node in range(ref.feature.shape[1]):
            if node and (node - 1) // 2 in excused:
                excused.add(node)
                continue
            same = all(getattr(got, f)[t, node] == getattr(ref, f)[t, node]
                       for f in ("feature", "split_bin", "is_leaf"))
            if same:
                continue
            mask = _rows_at(ref.feature[t], ref.split_bin[t], binned, node)
            best, n = f64_best_gain(binned, stats, weights[t], mask, n_bins=n_bins,
                                    min_instances=min_instances, min_info_gain=min_info_gain)
            bound = 3 * (s + 3) * 2.0**-24 * n
            assert best <= GATE + bound, (
                f"tree {t} node {node} differs with an f64 best gain of {best!r}, "
                f"beyond the gate's f32 bound {bound!r}"
            )
            excused.add(node)
            excused_roots += 1
    return excused_roots
