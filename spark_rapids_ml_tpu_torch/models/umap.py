"""UMAP estimator and model of the port (spark-rapids-ml's manifold-learning
family), on the card by default.

Counterpart of ``spark_rapids_ml_tpu/models/umap.py``: the same params
(cuML/umap-learn names), defaults, setters and persistence, plus a
``device`` argument (default ``"cuda"``). The fit:

1. the exact k-NN graph (``ops.neighbors.knn_topk`` with k+1, self
   dropped), queries in chunks against all rows on the device;
2. (rho, sigma) by bisection and the directed memberships on the device
   (``ops/umap.py``), their fuzzy union on the host;
3. spectral (scipy ``eigsh`` on the host) or uniform init;
4. the force layout on the device, ``nEpochs`` epochs (0 = 500 below
   10,000 rows, else 200), every pair in both directions.

``transform`` embeds new rows as the JAX package does: their k-NN among the
training rows, the membership-weighted mean of those neighbours'
embeddings as the start, then 30 epochs at a quarter of the learning rate
in which only the new points move.

The layout's negatives come from a ``torch.Generator`` seeded by ``seed``
(``seed + 1`` for transform): the port's own draws, not ``jax.random``'s.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.models.base import Estimator, Model
from spark_rapids_ml_tpu_torch.models.neighbors import _QUERY_CHUNK, _finalize_distances
from spark_rapids_ml_tpu_torch.models.params import HasDevice, HasInputCol, HasOutputCol, Param
from spark_rapids_ml_tpu_torch.ops import neighbors as NN
from spark_rapids_ml_tpu_torch.ops import umap as UM
from spark_rapids_ml_tpu_torch.telemetry import trace_range
from spark_rapids_ml_tpu_torch.utils import columnar
from spark_rapids_ml_tpu_torch.utils.device import to_device


def knn_graph(queries: torch.Tensor, corpus: torch.Tensor, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(euclidean distances [q, k], ids [q, k]) of each query's k nearest
    corpus rows, the queries in chunks of ``_QUERY_CHUNK``."""
    valid = torch.ones(corpus.shape[0], dtype=torch.bool, device=corpus.device)
    scores = np.empty((queries.shape[0], k), dtype=np.float32)
    ids = np.empty((queries.shape[0], k), dtype=np.int32)
    for lo in range(0, queries.shape[0], _QUERY_CHUNK):
        s, i = NN.knn_topk(queries[lo:lo + _QUERY_CHUNK], corpus, valid, k)
        scores[lo:lo + _QUERY_CHUNK] = s.cpu().numpy()
        ids[lo:lo + _QUERY_CHUNK] = i.cpu().numpy()
    return _finalize_distances(scores, "euclidean"), ids


def fuzzy_graph(knn_d: np.ndarray, knn_i: np.ndarray, device: torch.device):
    """(heads, tails, weights, rho, sigma) of the k-NN graph (self dropped):
    the calibration and memberships on ``device``, their fuzzy union on the
    host (each pair once)."""
    dd = torch.from_numpy(np.ascontiguousarray(knn_d)).to(device)
    rho, sigma = UM.smooth_knn_calibration(dd)
    w = UM.membership_strengths(dd, rho, sigma).cpu().numpy()
    return (*UM.fuzzy_union_edges(knn_i, w), rho, sigma)


def strong_edges(heads: np.ndarray, tails: np.ndarray, weights: np.ndarray, n_epochs: int):
    """The edges strong enough to fire in ``n_epochs`` (umap-learn's
    threshold, weight ≥ max/n_epochs)."""
    keep = weights >= weights.max() / float(n_epochs)
    return heads[keep], tails[keep], weights[keep]


def layout_edges(heads: np.ndarray, tails: np.ndarray, weights: np.ndarray):
    """(heads, tails, epochs_per_sample) of the layout: every pair in both
    directions, so each point is a head, gets negative-sample repulsion,
    and each pair fires at the reference rate."""
    weights_d = np.concatenate([weights, weights])
    return (np.concatenate([heads, tails]), np.concatenate([tails, heads]),
            weights_d.max() / weights_d)


def layout_generator(seed: int, device: torch.device) -> torch.Generator:
    """The layout's negative-sample generator on ``device``."""
    return torch.Generator(device=device).manual_seed(int(seed))


class _UMAPParams(HasDevice, HasInputCol, HasOutputCol):
    nNeighbors = Param("nNeighbors", "k of the fuzzy k-NN graph", int)
    nComponents = Param("nComponents", "embedding dimensionality", int)
    nEpochs = Param(
        "nEpochs", "SGD epochs (0 = auto: 500 small / 200 large, the umap-learn rule)", int,
    )
    learningRate = Param("learningRate", "initial SGD learning rate", float)
    minDist = Param("minDist", "minimum embedded pair distance", float)
    spread = Param("spread", "embedding scale of the membership curve", float)
    negativeSampleRate = Param("negativeSampleRate", "negative samples per positive edge", int)
    init = Param("init", "'spectral' (default) or 'random'", str)
    seed = Param("seed", "random seed", int)

    def __init__(self, uid: str | None = None, device: str | torch.device = "cuda", **kwargs):
        super().__init__(uid, device=device, **kwargs)
        self._setDefault(
            nNeighbors=15, nComponents=2, nEpochs=0, learningRate=1.0,
            minDist=0.1, spread=1.0, negativeSampleRate=5, init="spectral",
            seed=0, outputCol="embedding",
        )

    def getNNeighbors(self) -> int:
        return self.getOrDefault("nNeighbors")

    def getNComponents(self) -> int:
        return self.getOrDefault("nComponents")


class UMAP(_UMAPParams, Estimator):
    def setNNeighbors(self, value: int) -> "UMAP":
        if value < 2:
            raise ValueError(f"nNeighbors must be >= 2, got {value}")
        return self._set(nNeighbors=value)

    def setNComponents(self, value: int) -> "UMAP":
        if value < 1:
            raise ValueError(f"nComponents must be >= 1, got {value}")
        return self._set(nComponents=value)

    def setNEpochs(self, value: int) -> "UMAP":
        return self._set(nEpochs=value)

    def setLearningRate(self, value: float) -> "UMAP":
        return self._set(learningRate=float(value))

    def setMinDist(self, value: float) -> "UMAP":
        return self._set(minDist=float(value))

    def setSpread(self, value: float) -> "UMAP":
        return self._set(spread=float(value))

    def setNegativeSampleRate(self, value: int) -> "UMAP":
        return self._set(negativeSampleRate=value)

    def setInit(self, value: str) -> "UMAP":
        if value not in ("spectral", "random"):
            raise ValueError(f"init must be 'spectral' or 'random', got {value!r}")
        return self._set(init=value)

    def setSeed(self, value: int) -> "UMAP":
        return self._set(seed=value)

    def fit(self, dataset: Any, num_partitions: int | None = None) -> "UMAPModel":
        ds = columnar.PartitionedDataset.from_any(
            dataset, self._paramMap.get("inputCol"), num_partitions
        )
        x = np.concatenate(list(ds.matrices()), axis=0).astype(np.float32, copy=False)
        n = x.shape[0]
        k = self.getNNeighbors()
        if n <= k:
            raise ValueError(f"nNeighbors={k} needs more than {k} rows, got {n}")
        seed = self.getOrDefault("seed")
        dim = self.getNComponents()
        device = self.device

        with trace_range("umap knn graph", device):
            xd = to_device(x, device)
            # self lands in the list; calibration treats d = 0 as self
            knn_d, knn_i = knn_graph(xd, xd, k + 1)
            knn_d, knn_i = knn_d[:, 1:], knn_i[:, 1:]
            del xd

        with trace_range("umap fuzzy graph", device):
            heads, tails, weights, _, _ = fuzzy_graph(knn_d, knn_i, device)

        n_epochs = self.getOrDefault("nEpochs") or (500 if n < 10_000 else 200)
        heads, tails, weights = strong_edges(heads, tails, weights, n_epochs)
        heads_d, tails_d, eps_per_sample = layout_edges(heads, tails, weights)

        a, b = UM.find_ab_params(self.getOrDefault("spread"), self.getOrDefault("minDist"))
        with trace_range("umap init", device):
            if self.getOrDefault("init") == "spectral":
                emb0 = UM.spectral_init(heads, tails, weights, n, dim, seed)
            else:
                emb0 = np.random.default_rng(seed).uniform(-10, 10, size=(n, dim))

        with trace_range("umap layout", device):
            emb = UM.optimize_layout(
                to_device(emb0, device),
                torch.from_numpy(heads_d.astype(np.int64)).to(device),
                torch.from_numpy(tails_d.astype(np.int64)).to(device),
                to_device(eps_per_sample, device),
                float(np.float32(a)), float(np.float32(b)),
                n_epochs=int(n_epochs),
                n_neg=int(self.getOrDefault("negativeSampleRate")),
                initial_lr=float(self.getOrDefault("learningRate")),
                generator=layout_generator(seed, device),
            ).cpu().numpy()
        model = UMAPModel(uid=self.uid, rawData=x, embedding=emb, a=a, b=b, device=device)
        return self._copyValues(model)


class UMAPModel(_UMAPParams, Model):
    """The training rows and their embedding (cuML's UMAPModel shape:
    ``embedding_`` is the fitted layout; transform embeds new rows)."""

    def __init__(
        self,
        uid: str | None = None,
        rawData: np.ndarray | None = None,
        embedding: np.ndarray | None = None,
        a: float = 1.577,
        b: float = 0.895,
        device: str | torch.device = "cuda",
    ):
        super().__init__(uid, device=device)
        self.rawData = None if rawData is None else np.asarray(rawData)
        self.embedding_ = None if embedding is None else np.asarray(embedding)
        self.a = float(a)
        self.b = float(b)

    def _embed_matrix(self, mat: np.ndarray) -> np.ndarray:
        """Out-of-sample embedding: neighbour-weighted init, then a short
        refinement in which the new points move and the training points
        stay fixed."""
        q = np.asarray(mat, dtype=np.float32)
        if q.shape[1] != self.rawData.shape[1]:
            raise ValueError(
                f"rows have {q.shape[1]} features but the model was fitted "
                f"on {self.rawData.shape[1]}"
            )
        device = self.device
        k = min(self.getNNeighbors(), self.rawData.shape[0])
        nq = q.shape[0]
        knn_d, knn_i = knn_graph(to_device(q, device), to_device(self.rawData, device), k)
        dd = torch.from_numpy(np.ascontiguousarray(knn_d)).to(device)
        rho, sigma = UM.smooth_knn_calibration(dd)
        w = UM.membership_strengths(dd, rho, sigma).cpu().numpy()
        w = w / np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
        init = np.einsum("qk,qkd->qd", w, self.embedding_[knn_i])

        # new points (heads, offset by the reference count) attract to
        # their neighbours; the reference points stay fixed
        n_ref = self.embedding_.shape[0]
        heads = np.repeat(np.arange(nq, dtype=np.int64), k) + n_ref
        tails = knn_i.reshape(-1).astype(np.int64)
        weights = w.reshape(-1)
        keep = weights > 1e-12
        heads, tails, weights = heads[keep], tails[keep], weights[keep]
        eps_per_sample = weights.max() / weights
        combined = np.concatenate([self.embedding_, init])
        out = UM.optimize_layout(
            to_device(combined, device),
            torch.from_numpy(heads).to(device),
            torch.from_numpy(tails).to(device),
            to_device(eps_per_sample, device),
            float(np.float32(self.a)), float(np.float32(self.b)),
            n_epochs=30,
            n_neg=self.getOrDefault("negativeSampleRate"),
            initial_lr=float(self.getOrDefault("learningRate")) / 4.0,
            move_tails=False,
            generator=layout_generator(self.getOrDefault("seed") + 1, device),
        )
        return out[n_ref:].cpu().numpy()

    def transform(self, dataset: Any) -> Any:
        with trace_range("umap transform", self.device):
            return columnar.apply_column_transform(
                dataset,
                self._paramMap.get("inputCol"),
                self.getOrDefault("outputCol"),
                self._embed_matrix,
            )

    def _saveData(self) -> dict[str, np.ndarray]:
        return {
            "rawData": self.rawData,
            "embedding": self.embedding_,
            "ab": np.asarray([self.a, self.b]),
        }

    @classmethod
    def _fromSaved(cls, uid, data, device: str | torch.device = "cuda"):
        return cls(
            uid=uid,
            rawData=data["rawData"],
            embedding=data["embedding"],
            a=float(data["ab"][0]),
            b=float(data["ab"][1]),
            device=device,
        )
