"""KMeans estimator and model of the port, on the card by default
(BASELINE.json config 5).

Counterpart of ``spark_rapids_ml_tpu/models/kmeans.py``: the same params,
defaults (``maxIter=20``, ``tol=1e-4``, ``initMode="k-means++"``,
``initSteps=2``), setters and messages, plus a ``device`` argument (default
``"cuda"``). Lloyd iterations run as per-partition passes that give
``KMeansStats``, tree-reduced across partitions.

Each partition goes to the device once, padded there to its row bucket
(``utils.device.to_device_padded``; the weight vector masks the padding),
and stays for the seeding and every Lloyd iteration. The seeding:

- ``random``: k rows of a bounded sample, drawn with numpy as the JAX
  package draws them, so both packages start from the same centres;
- ``k-means++``: D²-sampling on a 16,384-row sample (numpy picks the
  sample; the draws come from a ``torch.Generator`` seeded from ``seed``);
- ``k-means||``: ``initSteps`` rounds in which every row of every partition
  is a Bernoulli trial (numpy, as in the JAX package) on its distance to
  the candidates (on the device), then a weighting pass and a weighted
  k-means++ down to k.

On the card a Lloyd pass takes blocks of ``utils.device.block_rows_for``
rows (65,536 at k = 1000) in place of the 8,192 of the CPU and the JAX
package; the block changes only the order of the f32 sums. The distance
policy is ``TPU_ML_PRECISION_POLICY`` (``f32``, ``bf16_f32acc`` or
``int8_dist``); the sums stay f32. With ``checkpoint_dir`` the centres,
iteration and cost are checkpointed (``utils.checkpoint``), in the JAX
package's format.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.autotune.policy import resolve_policy
from spark_rapids_ml_tpu_torch.models.base import Estimator, Model
from spark_rapids_ml_tpu_torch.models.params import HasDevice, HasInputCol, HasOutputCol, Param
from spark_rapids_ml_tpu_torch.ops import kmeans as KM
from spark_rapids_ml_tpu_torch.parallel.tree_aggregate import tree_reduce
from spark_rapids_ml_tpu_torch.telemetry import trace_range
from spark_rapids_ml_tpu_torch.utils import columnar
from spark_rapids_ml_tpu_torch.utils.device import block_rows_for, to_device, to_device_padded

_MAX_INIT_SAMPLE = 16384

#: blocks per host-to-device copy of transform and computeCost
_TRANSFER_BLOCKS = 16


def _resume_kmeans_checkpoint(checkpoint_dir: str | None, k: int):
    """(centers-or-None, start_iter, cost, checkpointer-or-None) for a Lloyd
    loop, resuming from the newest durable checkpoint when one exists."""
    if checkpoint_dir is None:
        return None, 0, np.inf, None
    from spark_rapids_ml_tpu_torch.utils.checkpoint import TrainingCheckpointer

    ckpt = TrainingCheckpointer(checkpoint_dir)
    resumed = ckpt.latest()
    if resumed is None:
        return None, 0, np.inf, ckpt
    step, arrays, state = resumed
    if arrays["centers"].shape[0] != k:
        raise ValueError(
            f"checkpoint at {checkpoint_dir} holds "
            f"{arrays['centers'].shape[0]} centers but k={k}; "
            "point checkpoint_dir at a fresh directory to train "
            "with different params"
        )
    return arrays["centers"], step + 1, float(state.get("cost", np.inf)), ckpt


def _select_rows(x: torch.Tensor, kept: np.ndarray | None, idx) -> torch.Tensor:
    """Rows ``idx`` of the kept rows of ``x`` (all rows when ``kept`` is
    None), as a [len(idx), n] tensor on x's device."""
    idx = np.asarray(idx, dtype=np.int64)
    rows = idx if kept is None else kept[idx]
    return x.index_select(0, torch.from_numpy(rows).to(x.device))


class _KMeansParams(HasDevice, HasInputCol, HasOutputCol):
    k = Param("k", "number of clusters", int)
    maxIter = Param("maxIter", "maximum Lloyd iterations", int)
    tol = Param("tol", "convergence tolerance on max centroid movement", float)
    seed = Param("seed", "random seed", int)
    initMode = Param(
        "initMode",
        "'k-means||' (distributed oversampling init, Bahmani et al. — "
        "Spark MLlib's default; scales to large k because candidates come "
        "from cost-proportional passes over ALL rows), 'k-means++' (on a "
        "bounded driver-side sample), or 'random'",
        str,
    )
    initSteps = Param(
        "initSteps", "number of k-means|| oversampling rounds (Spark: 2)", int
    )
    weightCol = Param(
        "weightCol",
        "optional instance-weight column (Spark ML weightCol contract); "
        "weighted Lloyd sums/counts/cost ride the same per-row vector that "
        "masks shape-bucketing padding",
        str,
    )

    def __init__(self, uid: str | None = None, device: str | torch.device = "cuda",
                 **kwargs):
        super().__init__(uid, device=device, **kwargs)
        self._setDefault(
            maxIter=20, tol=1e-4, seed=0, initMode="k-means++", initSteps=2,
            outputCol="prediction",
        )

    def getK(self) -> int:
        return self.getOrDefault("k")

    def getMaxIter(self) -> int:
        return self.getOrDefault("maxIter")

    def getTol(self) -> float:
        return self.getOrDefault("tol")

    def getSeed(self) -> int:
        return self.getOrDefault("seed")

    def getInitMode(self) -> str:
        return self.getOrDefault("initMode")

    def getInitSteps(self) -> int:
        return self.getOrDefault("initSteps")


class KMeans(_KMeansParams, Estimator):
    """KMeans with Spark MLlib's API, fitted on ``device``.

    >>> model = KMeans(k=3, seed=1).fit(x)
    >>> labels = model.transform(x)
    """

    def setK(self, value: int) -> "KMeans":
        return self._set(k=value)

    def setMaxIter(self, value: int) -> "KMeans":
        return self._set(maxIter=value)

    def setTol(self, value: float) -> "KMeans":
        return self._set(tol=value)

    def setSeed(self, value: int) -> "KMeans":
        return self._set(seed=value)

    def setInitMode(self, value: str) -> "KMeans":
        if value not in ("k-means||", "k-means++", "random"):
            raise ValueError(
                "initMode must be 'k-means||', 'k-means++', or 'random'"
            )
        return self._set(initMode=value)

    def setInitSteps(self, value: int) -> "KMeans":
        if value < 1:
            raise ValueError(f"initSteps must be >= 1, got {value}")
        return self._set(initSteps=value)

    def setWeightCol(self, value: str) -> "KMeans":
        return self._set(weightCol=value)

    def _generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(self.getSeed())

    def _init_centers(self, mats: list[np.ndarray], k: int, part_weights, parts) -> torch.Tensor:
        """[k, n] initial centres on the device. ``mats`` are the host
        partitions, ``parts`` their (padded rows, weights, true rows) on the
        device."""
        if self.getInitMode() == "k-means||":
            return self._kmeans_parallel_init(parts, part_weights, k)
        rng = np.random.default_rng(self.getSeed())
        # bounded sample across partitions for seeding; zero-weight rows are
        # excluded instances and must never seed a center (a zero-count
        # center would survive Lloyd updates unchanged)
        if part_weights is not None:
            mats = [m[w > 0] for m, w in zip(mats, part_weights)]
            mats = [m for m in mats if len(m)]
        total = sum(len(m) for m in mats)
        take = min(total, _MAX_INIT_SAMPLE)
        sample = np.concatenate(
            [m[rng.choice(len(m), max(1, int(take * len(m) / total)), replace=False)]
             for m in mats]
        )
        if self.getInitMode() == "random":
            idx = rng.choice(len(sample), k, replace=False)
            return to_device(sample[idx], self.device)
        return KM.kmeans_plus_plus_init(self._generator(), to_device(sample, self.device), k)

    def _kmeans_parallel_init(self, parts, part_weights, k: int) -> torch.Tensor:
        """k-means‖ (Bahmani et al., VLDB'12, Spark MLlib's default init):
        ``initSteps`` rounds of cost-proportional oversampling (ℓ = 2k
        expected candidates per round) in which every row of every
        partition is a Bernoulli trial with p = ℓ·w·d²/φ, then a
        candidate-weighting pass (rows owned per candidate) and a weighted
        k-means++ reduction to k. The distances and assignments run on the
        device-resident partitions; the trials draw from numpy."""
        rng = np.random.default_rng(self.getSeed())
        ell = 2.0 * k
        # (true rows on the device, kept row ids or None for all, kept weights)
        pairs = []
        for i, (x, _, rows) in enumerate(parts):
            w = (
                np.ones(rows, dtype=np.float64)
                if part_weights is None
                else np.asarray(part_weights[i], dtype=np.float64)
            )
            keep = w > 0
            if keep.all():
                pairs.append((x[:rows], None, w))
            elif keep.any():
                pairs.append((x[:rows], np.flatnonzero(keep), w[keep]))
        if not pairs:
            raise ValueError("no rows with positive weight to seed from")

        def kept_rows(values: torch.Tensor, kept) -> np.ndarray:
            out = values.cpu().numpy()
            return out if kept is None else out[kept]

        # first candidate: one weight-proportional row
        totals = np.array([w.sum() for _, _, w in pairs])
        pi = rng.choice(len(pairs), p=totals / totals.sum())
        x0, kept0, w0 = pairs[pi]
        candidates = [_select_rows(x0, kept0, [rng.choice(len(w0), p=w0 / w0.sum())])]

        for _ in range(self.getInitSteps()):
            c = torch.cat(candidates)
            block = block_rows_for(self.device, KM.DEFAULT_BLOCK_ROWS, c.shape[0])
            d2s = [
                kept_rows(KM.assign_blocks(x, c, block_rows=block)[1], kept)
                for x, kept, _ in pairs
            ]
            phi = sum(float(np.dot(d2, w)) for d2, (_, _, w) in zip(d2s, pairs))
            if phi <= 0.0:  # every row coincides with a candidate
                break
            for d2, (x, kept, w) in zip(d2s, pairs):
                p_sel = np.minimum(1.0, ell * w * d2 / phi)
                sel = rng.random(len(w)) < p_sel
                if sel.any():
                    candidates.append(_select_rows(x, kept, np.flatnonzero(sel)))

        cand = torch.cat(candidates)
        if len(cand) <= k:
            # degenerate oversampling (tiny data or phi collapsed): top up
            # with uniform rows so exactly k centers come out
            need = k - len(cand)
            if need > 0:
                offsets = np.cumsum([0] + [len(w) for _, _, w in pairs])
                idx = rng.choice(offsets[-1], need, replace=False)
                which = np.searchsorted(offsets, idx, side="right") - 1
                extra = [
                    _select_rows(pairs[j][0], pairs[j][1], [i - offsets[j]])
                    for i, j in zip(idx, which)
                ]
                cand = torch.cat([cand, *extra])
            return cand[:k]

        # weighting pass: instance-weighted row counts owned by each candidate
        counts = np.zeros(len(cand), dtype=np.float64)
        block = block_rows_for(self.device, KM.DEFAULT_BLOCK_ROWS, len(cand))
        for x, kept, w in pairs:
            labels = kept_rows(KM.assign_blocks(x, cand, block_rows=block)[0], kept)
            counts += np.bincount(labels, weights=w, minlength=len(cand))
        return KM.weighted_kmeans_plus_plus_init(
            self._generator(), cand, torch.from_numpy(counts).to(self.device), k
        )

    def fit(
        self,
        dataset: Any,
        num_partitions: int | None = None,
        *,
        sample_weight=None,
        checkpoint_dir: str | None = None,
        checkpoint_every: int = 1,
    ) -> "KMeansModel":
        """Lloyd training with optional mid-training checkpoint/resume.

        With ``checkpoint_dir`` set, the centres, iteration and cost are
        checkpointed every ``checkpoint_every`` iterations, and an
        interrupted fit pointed at the same directory resumes from the
        newest checkpoint instead of seeding again.
        """
        if checkpoint_every < 1:
            raise ValueError(f"checkpoint_every must be >= 1, got {checkpoint_every}")
        input_col = self._paramMap.get("inputCol")
        ds = columnar.PartitionedDataset.from_any(dataset, input_col, num_partitions)
        k = self.getK()
        tol_sq = self.getTol() ** 2
        device = self.device
        mats = list(ds.matrices())  # materialize ONCE (extraction may copy)
        n_cols = mats[0].shape[1]
        for m in mats[1:]:
            if m.shape[1] != n_cols:
                raise ValueError(f"inconsistent feature dim: {m.shape[1]} != {n_cols}")
        part_weights = columnar.resolve_partition_weights(
            dataset, mats, self._paramMap.get("weightCol"), sample_weight
        )

        centers, start_iter, cost, ckpt = _resume_kmeans_checkpoint(checkpoint_dir, k)

        # every partition to the device once, padded there; the weight vector
        # masks padding (0) and carries instance weights (1.0 when
        # unweighted) on true rows
        parts = []
        for i, mat in enumerate(mats):
            rows = mat.shape[0]
            bucket = columnar.bucket_rows(rows)
            w = np.zeros(bucket, np.float32)
            w[:rows] = 1.0 if part_weights is None else part_weights[i]
            parts.append((to_device_padded(mat, bucket, device), to_device(w, device), rows))

        if centers is None:
            with trace_range("kmeans init", device):
                c = self._init_centers(mats, k, part_weights, parts)
        else:
            c = to_device(centers, device)
        if c.shape[1] != n_cols:
            raise ValueError(
                f"checkpoint/init centers have {c.shape[1]} features but "
                f"the dataset has {n_cols}; is checkpoint_dir stale?"
            )

        # env-selected distance policy (bf16 or int8 cross terms); the
        # Lloyd accumulators inside kmeans_stats stay full precision
        dist_policy = resolve_policy(None)
        block = block_rows_for(device, KM.DEFAULT_BLOCK_ROWS, k)
        with trace_range("kmeans lloyd", device):
            for it in range(start_iter, self.getMaxIter()):
                partials = [
                    KM.kmeans_stats(x, c, w, block_rows=block, policy=dist_policy)
                    for x, w, _ in parts
                ]
                stats = tree_reduce(partials, KM.combine_kmeans_stats)
                new_c = KM.update_centers(stats, c)
                # the one wait for the device per iteration
                cost = float(stats.cost)
                shift = float(KM.center_shift_sq(c, new_c))
                c = new_c
                if ckpt is not None and (it + 1) % checkpoint_every == 0:
                    ckpt.save(it, {"centers": c.cpu().numpy()}, {"cost": cost})
                if shift <= tol_sq:
                    break

        model = KMeansModel(
            uid=self.uid, clusterCenters=c.cpu().numpy(), trainingCost=cost, device=device
        )
        return self._copyValues(model)


class KMeansModel(_KMeansParams, Model):
    """Fitted KMeans: ``clusterCenters`` [k, n] and ``trainingCost`` on the
    host; ``transform`` and ``computeCost`` assign on ``device``."""

    def __init__(
        self,
        uid: str | None = None,
        clusterCenters: np.ndarray | None = None,
        trainingCost: float = float("nan"),
        device: str | torch.device = "cuda",
    ):
        super().__init__(uid, device=device)
        self.clusterCenters = (
            None if clusterCenters is None else np.asarray(clusterCenters)
        )
        self.trainingCost = trainingCost

    def _assign_chunks(self, mat: np.ndarray):
        """(labels int32, min squared distances) of the host rows ``mat``,
        copied to the device a chunk at a time and assigned block by
        block."""
        device = self.device
        c = to_device(self.clusterCenters, device)
        block = block_rows_for(device, KM.DEFAULT_BLOCK_ROWS, c.shape[0])
        chunk = block * _TRANSFER_BLOCKS
        for lo in range(0, mat.shape[0], chunk):
            yield KM.assign_blocks(to_device(mat[lo:lo + chunk], device), c, block_rows=block)

    def _predict_matrix(self, mat: np.ndarray) -> np.ndarray:
        labels = [lab.cpu().numpy() for lab, _ in self._assign_chunks(mat)]
        return np.concatenate(labels) if labels else np.zeros(0, np.int32)

    def transform(self, dataset: Any) -> Any:
        """Append an integer ``prediction`` column (Spark KMeansModel shape)."""
        with trace_range("kmeans transform", self.device):
            return columnar.apply_column_transform(
                dataset,
                self._paramMap.get("inputCol"),
                self.getOutputCol(),
                self._predict_matrix,
            )

    def predict(self, row) -> int:
        """Single-row prediction (host path)."""
        d = np.sum((self.clusterCenters - np.asarray(row)[None, :]) ** 2, axis=1)
        return int(np.argmin(d))

    def computeCost(self, dataset: Any) -> float:
        """Sum of squared distances to the nearest centroid (inertia)."""
        input_col = self._paramMap.get("inputCol")
        ds = columnar.PartitionedDataset.from_any(dataset, input_col)
        total = 0.0
        for mat in ds.matrices():
            for _, dists in self._assign_chunks(mat):
                total += float(torch.sum(dists))
        return total

    def _saveData(self) -> dict[str, np.ndarray]:
        return {
            "clusterCenters": self.clusterCenters,
            "trainingCost": np.asarray([self.trainingCost]),
        }

    @classmethod
    def _fromSaved(cls, uid, data, device: str | torch.device = "cuda"):
        return cls(
            uid=uid,
            clusterCenters=data["clusterCenters"],
            trainingCost=float(data["trainingCost"][0]),
            device=device,
        )
