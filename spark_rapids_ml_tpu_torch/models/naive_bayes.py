"""NaiveBayes of the port, on the card by default: pyspark.ml's three model
types from one statistics pass.

Counterpart of ``spark_rapids_ml_tpu/models/naive_bayes.py``: ``modelType``
'multinomial' (default) / 'bernoulli' / 'gaussian', ``smoothing`` λ,
``weightCol``, and the model's ``pi`` (log class priors), ``theta`` (log
feature parameters or gaussian means, [C, F]) and ``sigma`` (gaussian
variances), plus a ``device`` argument (default ``"cuda"``).

- the fit is one pass of one-hot products per partition on the device
  (``ops.naive_bayes.nb_stats``, f32), tree-reduced across partitions, then
  the closed forms in f64 on the host:
  multinomial θ = log((S_cf + λ) / (Σ_f S_cf + λF));
  bernoulli p = (S_cf + λ) / (N_c + 2λ) (0/1 features, checked as Spark
  checks them); gaussian μ = S/N, σ² from the second, centred pass
  (``nb_centered_sq``) Σw(x−μ_c)²/N, floored at 1e-12;
- the input checks are the JAX package's: integer labels 0..C−1,
  non-negative features for multinomial and bernoulli, 0/1 for bernoulli;
- ``distribution="mesh-local"`` concatenates the rows once onto the
  device's own mesh (``parallel.mesh.local_mesh``: every card, one shard
  on the CPU), padded with weight 0, and both passes are one psum each
  (``parallel/naive_bayes.py``); ``"driver-merge"`` tree-reduces the
  partitions' statistics on the device;
- the raw scores (Spark's rawPrediction) are computed on the device in f64
  from the f32 rows, a chunk of rows at a time; probabilities and the
  argmax are host numpy.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.models.base import Estimator, Model
from spark_rapids_ml_tpu_torch.models.params import (
    HasDevice,
    HasFeaturesCol,
    HasLabelCol,
    HasPredictionCol,
    Param,
)
from spark_rapids_ml_tpu_torch.ops import naive_bayes as NB
from spark_rapids_ml_tpu_torch.parallel.tree_aggregate import tree_reduce
from spark_rapids_ml_tpu_torch.telemetry import trace_range
from spark_rapids_ml_tpu_torch.utils import columnar
from spark_rapids_ml_tpu_torch.utils.device import to_device

_MODEL_TYPES = ("multinomial", "bernoulli", "gaussian")

#: f64 elements of one chunk's gaussian [rows, C, F] deviation tensor
_SCORE_CHUNK_ELEMS = 1 << 25


class _NBParams(HasDevice, HasFeaturesCol, HasLabelCol, HasPredictionCol):
    modelType = Param(
        "modelType", "'multinomial' (default), 'bernoulli', or 'gaussian'", str
    )
    smoothing = Param("smoothing", "Laplace smoothing λ", float)
    probabilityCol = Param("probabilityCol", "class-probability column", str)
    rawPredictionCol = Param(
        "rawPredictionCol", "per-class log-likelihood column", str
    )
    weightCol = Param("weightCol", "optional instance-weight column", str)
    distribution = Param(
        "distribution",
        "'driver-merge' (partition statistics tree-reduced on the device) or "
        "'mesh-local' (the rows sharded over the device's mesh, one psum a pass)",
        str,
    )

    def __init__(self, uid: str | None = None, device: str | torch.device = "cuda",
                 **kwargs):
        super().__init__(uid, device=device, **kwargs)
        self._setDefault(
            featuresCol="features", labelCol="label",
            predictionCol="prediction", probabilityCol="probability",
            rawPredictionCol="rawPrediction",
            modelType="multinomial", smoothing=1.0,
            distribution="driver-merge",
        )

    def getModelType(self) -> str:
        return self.getOrDefault("modelType")

    def getSmoothing(self) -> float:
        return self.getOrDefault("smoothing")


class NaiveBayes(_NBParams, Estimator):
    def setModelType(self, value: str) -> "NaiveBayes":
        if value not in _MODEL_TYPES:
            raise ValueError(
                f"modelType must be one of {_MODEL_TYPES}, got {value!r}"
            )
        return self._set(modelType=value)

    def setSmoothing(self, value: float) -> "NaiveBayes":
        if value < 0:
            raise ValueError(f"smoothing must be >= 0, got {value}")
        return self._set(smoothing=float(value))

    def setWeightCol(self, value: str) -> "NaiveBayes":
        return self._set(weightCol=value)

    def setProbabilityCol(self, value: str) -> "NaiveBayes":
        return self._set(probabilityCol=value)

    def setRawPredictionCol(self, value: str) -> "NaiveBayes":
        return self._set(rawPredictionCol=value)

    def setDistribution(self, value: str) -> "NaiveBayes":
        if value not in ("driver-merge", "mesh-local"):
            raise ValueError(
                "distribution must be 'driver-merge' or 'mesh-local', "
                f"got {value!r}"
            )
        return self._set(distribution=value)

    def fit(self, dataset: Any, num_partitions: int | None = None):
        parts = columnar.labeled_partitions(
            dataset,
            self.getOrDefault("featuresCol"),
            self.getOrDefault("labelCol"),
            num_partitions,
            weight_col=self._paramMap.get("weightCol"),
        )
        model_type = self.getModelType()
        all_labels = np.unique(np.concatenate([np.unique(y) for _, y, _ in parts]))
        if not np.all(all_labels == np.round(all_labels)) or all_labels.min() < 0:
            raise ValueError(
                f"NaiveBayes requires integer class labels 0..C-1, got "
                f"{all_labels[:8]}"
            )
        n_classes = int(all_labels.max()) + 1
        if model_type in ("multinomial", "bernoulli"):
            for x, _, _ in parts:
                if (x < 0).any():
                    raise ValueError(
                        f"modelType='{model_type}' requires non-negative "
                        "features (Spark's requireNonnegativeValues)"
                    )
                if model_type == "bernoulli" and not np.isin(x, (0.0, 1.0)).all():
                    raise ValueError(
                        "modelType='bernoulli' requires 0/1 features "
                        "(Spark's requireZeroOneBernoulliValues)"
                    )

        device = self.device
        mesh_local = self.getOrDefault("distribution") == "mesh-local"
        if mesh_local:
            from spark_rapids_ml_tpu_torch.parallel import mesh as M
            from spark_rapids_ml_tpu_torch.parallel import naive_bayes as PNB

            # the rows once onto the device's mesh, pad rows at weight 0
            mesh = M.local_mesh(device)
            x_all = np.concatenate([p[0] for p in parts]).astype(np.float32, copy=False)
            y_all = np.concatenate([p[1] for p in parts]).astype(np.float32)
            w_all = np.concatenate([np.ones(len(x), np.float32) if w is None
                                    else np.asarray(w, np.float32) for x, _, w in parts])
            xs, ys, ws = (M.shard(x_all, mesh), M.vector_sharding(mesh).shard(y_all),
                          M.vector_sharding(mesh).shard(w_all))
            with trace_range("naive bayes stats (mesh)", device):
                stats = PNB.sharded_nb_stats(xs, ys, ws, n_classes, mesh)
        else:
            device_parts = [
                (
                    to_device(x, device),
                    to_device(np.asarray(y), device),
                    to_device(np.ones(len(x), np.float32) if w is None else w, device),
                )
                for x, y, w in parts
            ]
            with trace_range("naive bayes stats", device):
                stats = tree_reduce(
                    [NB.nb_stats(xd, yd, wd, n_classes) for xd, yd, wd in device_parts],
                    NB.combine_nb_stats,
                )
        counts = stats.counts.cpu().numpy().astype(np.float64)
        feat_sum = stats.feat_sum.cpu().numpy().astype(np.float64)
        lam = self.getSmoothing()
        total = counts.sum()
        safe_counts = np.where(counts > 0, counts, 1.0)
        # Spark smooths the class priors with the same λ as the likelihoods:
        # π_i = log((n_i + λ)/(N + λ·C))
        with np.errstate(divide="ignore"):
            pi = np.log(counts + lam) - np.log(total + lam * len(counts))
        n_feat = feat_sum.shape[1]

        sigma = np.zeros((0, 0))
        if model_type == "multinomial":
            theta = np.log(feat_sum + lam) - np.log(
                feat_sum.sum(axis=1, keepdims=True) + lam * n_feat
            )
        elif model_type == "bernoulli":
            p = (feat_sum + lam) / (counts[:, None] + 2.0 * lam)
            theta = np.log(p)  # log(1-p) is derived at predict time
        else:  # gaussian
            mu = feat_sum / safe_counts[:, None]
            with trace_range("naive bayes variance pass", device):
                mu_d = to_device(mu, device)
                if mesh_local:
                    sq = PNB.sharded_nb_centered_sq(xs, ys, ws, mu_d, n_classes, mesh)
                else:
                    sq = tree_reduce(
                        [NB.nb_centered_sq(xd, yd, wd, mu_d, n_classes)
                         for xd, yd, wd in device_parts],
                        lambda a, b: a + b,
                    )
            var = sq.cpu().numpy().astype(np.float64) / safe_counts[:, None]
            theta = mu
            sigma = np.maximum(var, 1e-12)

        model = NaiveBayesModel(uid=self.uid, pi=pi, theta=theta, sigma=sigma, device=device)
        return self._copyValues(model)


class NaiveBayesModel(_NBParams, Model):
    def __init__(
        self,
        uid: str | None = None,
        pi: np.ndarray | None = None,
        theta: np.ndarray | None = None,
        sigma: np.ndarray | None = None,
        device: str | torch.device = "cuda",
    ):
        super().__init__(uid, device=device)
        self.pi = None if pi is None else np.asarray(pi)
        self.theta = None if theta is None else np.asarray(theta)
        self.sigma = None if sigma is None else np.asarray(sigma)

    @property
    def numClasses(self) -> int:
        return self.pi.shape[0]

    def _raw_scores(self, mat: np.ndarray) -> np.ndarray:
        """[rows, C] joint log-likelihoods (Spark's rawPrediction), in f64
        on the device."""
        model_type = self.getModelType()
        if model_type == "bernoulli" and not np.isin(mat, (0.0, 1.0)).all():
            raise ValueError(
                "Bernoulli naive Bayes requires 0 or 1 feature values "
                "at predict time (the Spark contract)"
            )
        device = self.device

        def f64(a):
            return torch.from_numpy(np.asarray(a, dtype=np.float64)).to(device)

        pi = f64(self.pi)
        if model_type == "multinomial":
            weight, bias = f64(self.theta), pi
        elif model_type == "bernoulli":
            log_p = f64(self.theta)
            log_1mp = torch.log1p(-torch.exp(log_p))
            weight, bias = log_p - log_1mp, pi + log_1mp.sum(dim=1)
        else:
            mu, var = f64(self.theta), f64(self.sigma)
            const = -0.5 * torch.log(2.0 * np.pi * var).sum(dim=1)
        n_classes, n_feat = self.theta.shape
        chunk = max(1, _SCORE_CHUNK_ELEMS // (n_classes * n_feat))
        out = np.empty((mat.shape[0], n_classes), dtype=np.float64)
        for lo in range(0, mat.shape[0], chunk):
            x = to_device(mat[lo:lo + chunk], device).to(torch.float64)
            if model_type == "gaussian":
                quad = -0.5 * ((x[:, None, :] - mu[None]) ** 2 / var[None]).sum(dim=2)
                raw = pi[None, :] + const[None, :] + quad
            else:
                raw = bias[None, :] + x @ weight.T
            out[lo:lo + chunk] = raw.cpu().numpy()
        return out

    @staticmethod
    def _from_raw(raw: np.ndarray):
        shifted = raw - raw.max(axis=1, keepdims=True)
        e = np.exp(shifted)
        proba = e / e.sum(axis=1, keepdims=True)
        return proba, np.argmax(raw, axis=1).astype(np.float64)

    def proba_and_predictions(self, mat: np.ndarray):
        return self._from_raw(self._raw_scores(mat))

    def _predict_matrix(self, mat: np.ndarray) -> np.ndarray:
        return self.proba_and_predictions(mat)[1]

    def transform(self, dataset: Any) -> Any:
        if columnar.has_named_columns(dataset):
            mat = columnar.extract_matrix(dataset, self.getOrDefault("featuresCol"))
            raw = self._raw_scores(mat)  # one scoring pass feeds all three
            proba, preds = self._from_raw(raw)
            return columnar.append_columns(
                dataset,
                [
                    (self.getOrDefault("rawPredictionCol"), raw),
                    (self.getOrDefault("probabilityCol"), proba),
                    (self.getOrDefault("predictionCol"), preds),
                ],
            )
        return columnar.apply_column_transform(
            dataset,
            self.getOrDefault("featuresCol"),
            self.getOrDefault("predictionCol"),
            self._predict_matrix,
        )

    def predict(self, row) -> float:
        return float(self._predict_matrix(np.asarray(row, dtype=np.float64)[None, :])[0])

    def _saveData(self) -> dict[str, np.ndarray]:
        return {"pi": self.pi, "theta": self.theta, "sigma": self.sigma}

    @classmethod
    def _fromSaved(cls, uid, data, device: str | torch.device = "cuda"):
        return cls(uid=uid, pi=data["pi"], theta=data["theta"], sigma=data["sigma"],
                   device=device)
