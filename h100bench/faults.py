"""Faults planted in the program's timed path, for the tests and for the
readings the limits are set from (``calibrate.py``). Each fault takes a
``setattr(target, name, value)`` (pytest's ``monkeypatch.setattr``, or
``Patch`` below) and breaks one thing where it is produced. The cells run
on one card, so the fault of an exchange between cards is not theirs.
"""

from __future__ import annotations

import numpy as np
import torch


def kmeans_state_unchanged(setattr):
    """A Lloyd step that returns its centres unchanged."""
    import spark_rapids_ml_tpu_torch.ops.kmeans as KM

    setattr(KM, "update_centers", lambda stats, old: old)


def kmeans_half_batch(setattr):
    """Half of each partition's rows left out, the sums, counts and cost
    over the rest."""
    import spark_rapids_ml_tpu_torch.ops.kmeans as KM

    orig = KM.kmeans_stats

    def half(x, centers, weights=None, **kw):
        w = weights.clone()
        w[int((w > 0).sum()) // 2:] = 0.0
        return orig(x, centers, w, **kw)

    setattr(KM, "kmeans_stats", half)


def kmeans_answer_altered(setattr):
    """One centre of the answer moved by 1% of its norm in one coordinate."""
    import spark_rapids_ml_tpu_torch.models.kmeans as M

    orig = M.KMeansModel.__init__

    def altered(self, *a, clusterCenters=None, **kw):
        c = np.array(clusterCenters)
        c[0, 0] += 1e-2 * np.linalg.norm(c[0])
        orig(self, *a, clusterCenters=c, **kw)

    setattr(M.KMeansModel, "__init__", altered)


def kmeans_seeding_stuck(setattr):
    """A k-means++ draw that always returns the sample's first row: every
    seed is that one row."""
    import spark_rapids_ml_tpu_torch.ops.kmeans as KM

    setattr(KM, "_draw", lambda gen, scores: torch.zeros(1, dtype=torch.long,
                                                          device=scores.device))


def kmeans_seeding_uniform(setattr):
    """k-means++ drawing uniformly from its sample, its D² weights
    ignored: on well separated blobs of equal size this reads as a sound
    seeding does (PERF.md), so no number of the cell is expected to catch
    it."""
    import spark_rapids_ml_tpu_torch.ops.kmeans as KM

    orig = KM._draw
    setattr(KM, "_draw", lambda gen, scores: orig(gen, torch.ones_like(scores)))


FAULTS = {f.__name__: f for f in (kmeans_state_unchanged, kmeans_half_batch,
                                   kmeans_answer_altered, kmeans_seeding_stuck,
                                   kmeans_seeding_uniform)}


class Patch:
    """A ``setattr`` that remembers, and ``undo`` that restores."""

    def __init__(self):
        self.saved = []

    def __call__(self, target, name, value):
        self.saved.append((target, name, getattr(target, name)))
        setattr(target, name, value)

    def undo(self):
        while self.saved:
            target, name, value = self.saved.pop()
            setattr(target, name, value)
