"""MultilayerPerceptronClassifier of the port: pyspark.ml's feed-forward
network, trained full-batch on the card by default.

Counterpart of ``spark_rapids_ml_tpu/models/mlp.py``: the same params,
defaults, setters, messages and persistence, plus a ``device`` argument
(default ``"cuda"``). Spark's architecture: sigmoid hidden layers, softmax
output, cross-entropy loss; ``layers`` is [inputs, hidden..., classes];
``weights`` is Spark's flat vector (per layer the [in, out] matrix, then
the [out] bias).

Training (``train_mlp``) is a loop on the device with autograd on the one
flat parameter tensor (``ops/optim.py``): ``solver="l-bfgs"`` (the default)
is the port's reproduction of ``optax.lbfgs()`` at its defaults, ``"gd"``
is plain SGD at ``stepSize``. The stop rule is the JAX package's: iterate
while ``it < maxIter`` and the loss moved by more than ``tol``. The loss is
the weighted mean softmax cross-entropy (weights 0 on no row here: the
port pads nothing).

The initial weights are Glorot-uniform from a ``torch.Generator`` seeded by
``seed``; the JAX package draws them from ``jax.random``, which torch
cannot reproduce, so the same seed gives another start (``train_mlp``
takes any start, so a JAX start can be passed across).
"""

from __future__ import annotations

from typing import Any, Callable

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
from spark_rapids_ml_tpu_torch.ops import optim
from spark_rapids_ml_tpu_torch.telemetry import trace_range
from spark_rapids_ml_tpu_torch.utils import columnar
from spark_rapids_ml_tpu_torch.utils.device import to_device

_SOLVERS = ("l-bfgs", "gd")


def _unflatten(flat: torch.Tensor, layers: tuple) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Spark's weight layout: per layer, the [in, out] matrix then the
    [out] bias, concatenated flat."""
    params = []
    at = 0
    for fan_in, fan_out in zip(layers[:-1], layers[1:]):
        w = flat[at:at + fan_in * fan_out].reshape(fan_in, fan_out)
        at += fan_in * fan_out
        b = flat[at:at + fan_out]
        at += fan_out
        params.append((w, b))
    return params


def _forward(flat: torch.Tensor, x: torch.Tensor, layers: tuple) -> torch.Tensor:
    """Logits of Spark's topology: sigmoid hidden layers, affine output."""
    h = x
    params = _unflatten(flat, layers)
    for i, (w, b) in enumerate(params):
        h = h @ w + b
        if i < len(params) - 1:
            h = torch.sigmoid(h)
    return h


def cross_entropy_loss(flat: torch.Tensor, x: torch.Tensor, y: torch.Tensor, w: torch.Tensor,
                       layers: tuple) -> torch.Tensor:
    """Weighted mean softmax cross-entropy of integer labels ``y``:
    log Σ exp(z − max z) − (z_y − max z), the function of
    ``optax.softmax_cross_entropy_with_integer_labels``. The log of the sum
    is taken as log1p of the terms other than the maximum's (which is
    exactly 1): the same value, but without the f32 loss of every term
    below 2⁻²⁴ that log(1 + ε) suffers, so a fit that drives the loss
    towards 0 still reports it to f32 accuracy. The maximum is not
    detached: its gradient reaches the argmax logit, where the sum's
    gradient needs it."""
    logits = _forward(flat, x, layers)
    top = logits.max(dim=1, keepdim=True)
    shifted = logits - top.values
    others = torch.exp(shifted).scatter(1, top.indices, 0.0).sum(dim=1)
    ll = torch.log1p(others) - shifted.gather(1, y[:, None])[:, 0]
    return torch.sum(ll * w) / torch.clamp(torch.sum(w), min=1.0)


def train_mlp(
    flat0: torch.Tensor,
    x: torch.Tensor,
    y: torch.Tensor,  # [rows] class indices
    w: torch.Tensor,  # [rows] instance weights
    *,
    layers: tuple,
    solver: str,
    max_iter: int,
    step_size: float = 0.03,
    tol: float = 1e-6,
    callback: Callable[[int, torch.Tensor, float], None] | None = None,
) -> tuple[torch.Tensor, float, int]:
    """Full-batch training on ``x``'s device → (weights, loss, iterations).
    ``callback(it, flat, loss)`` sees every iterate."""
    y_idx = y.to(torch.int64)

    def loss_fn(flat):
        return cross_entropy_loss(flat, x, y_idx, w, layers)

    if solver == "l-bfgs":
        step = optim.LBFGS(loss_fn).step
    elif solver == "gd":
        step = optim.sgd_step(loss_fn, step_size)
    else:
        raise ValueError(f"solver must be one of {_SOLVERS}, got {solver!r}")
    return optim.minimize(loss_fn, flat0, step, max_iter=max_iter, tol=tol, callback=callback)


def glorot_init(layers: tuple, seed: int, device: torch.device,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Glorot-uniform weights and zero biases in Spark's flat layout, drawn
    from a ``torch.Generator`` seeded by ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    pieces = []
    for fan_in, fan_out in zip(layers[:-1], layers[1:]):
        limit = float(np.sqrt(6.0 / (fan_in + fan_out)))
        u = torch.rand((fan_in * fan_out,), generator=gen, device=device, dtype=dtype)
        pieces.append(u * (2.0 * limit) - limit)
        pieces.append(torch.zeros((fan_out,), device=device, dtype=dtype))
    return torch.cat(pieces)


class _MLPParams(HasDevice, HasFeaturesCol, HasLabelCol, HasPredictionCol):
    layers = Param("layers", "layer sizes [inputs, hidden..., classes] (the Spark spec)", list)
    maxIter = Param("maxIter", "maximum optimizer iterations", int)
    tol = Param("tol", "convergence tolerance on the loss decrease", float)
    stepSize = Param("stepSize", "learning rate for solver='gd'", float)
    solver = Param("solver", "'l-bfgs' (default) or 'gd'", str)
    seed = Param("seed", "weight-initialization seed", int)
    probabilityCol = Param("probabilityCol", "class-probability column", str)
    rawPredictionCol = Param("rawPredictionCol", "logits column", str)

    def __init__(self, uid: str | None = None, device: str | torch.device = "cuda", **kwargs):
        super().__init__(uid, device=device, **kwargs)
        self._setDefault(
            featuresCol="features", labelCol="label",
            predictionCol="prediction", probabilityCol="probability",
            rawPredictionCol="rawPrediction",
            maxIter=100, tol=1e-6, stepSize=0.03, solver="l-bfgs", seed=0,
        )

    def getLayers(self) -> list:
        return self.getOrDefault("layers")

    def getMaxIter(self) -> int:
        return self.getOrDefault("maxIter")


class MultilayerPerceptronClassifier(_MLPParams, Estimator):
    def setLayers(self, value) -> "MultilayerPerceptronClassifier":
        value = [int(v) for v in value]
        if len(value) < 2 or any(v < 1 for v in value):
            raise ValueError(f"layers needs >= 2 positive sizes [in, ..., out], got {value}")
        return self._set(layers=value)

    def setMaxIter(self, value: int):
        return self._set(maxIter=value)

    def setTol(self, value: float):
        return self._set(tol=float(value))

    def setStepSize(self, value: float):
        if value <= 0:
            raise ValueError(f"stepSize must be > 0, got {value}")
        return self._set(stepSize=float(value))

    def setSolver(self, value: str):
        if value not in _SOLVERS:
            raise ValueError(f"solver must be one of {_SOLVERS}, got {value!r}")
        return self._set(solver=value)

    def setSeed(self, value: int):
        return self._set(seed=value)

    def fit(self, dataset: Any, num_partitions: int | None = None):
        """``num_partitions`` is accepted for Estimator-signature
        uniformity; training is full-batch either way. Instance weights
        ((X, y, w) tuples) weight the loss."""
        if "layers" not in self._paramMap:
            raise ValueError("setLayers([...]) before fit (the Spark spec)")
        layers = tuple(self.getLayers())
        parts = columnar.labeled_partitions(
            dataset, self.getOrDefault("featuresCol"), self.getOrDefault("labelCol"), None,
        )
        x = np.concatenate([p[0] for p in parts])
        y = np.concatenate([p[1] for p in parts])
        w = np.concatenate([p[2] for p in parts]) if parts[0][2] is not None else None
        if x.shape[1] != layers[0]:
            raise ValueError(f"layers[0]={layers[0]} but the data has {x.shape[1]} features")
        classes = np.unique(y)
        if not np.all(classes == np.round(classes)) or classes.min() < 0:
            raise ValueError(f"labels must be integers 0..C-1, got {classes[:8]}")
        if int(classes.max()) + 1 > layers[-1]:
            raise ValueError(
                f"labels imply {int(classes.max()) + 1} classes but layers[-1]={layers[-1]}"
            )
        device = self.device
        with trace_range("mlp train", device):
            xt = to_device(x, device)
            yt = torch.from_numpy(y.astype(np.int64)).to(device)
            wt = torch.from_numpy(
                np.ones(len(x), np.float32) if w is None else w.astype(np.float32)).to(device)
            flat, loss, it = train_mlp(
                glorot_init(layers, self.getOrDefault("seed"), device), xt, yt, wt,
                layers=layers,
                solver=self.getOrDefault("solver"),
                max_iter=self.getMaxIter(),
                step_size=self.getOrDefault("stepSize"),
                tol=self.getOrDefault("tol"),
            )
            weights = flat.cpu().numpy()
        if not np.isfinite(weights).all():
            raise ValueError(
                "MLP training diverged to non-finite weights; lower "
                "stepSize or check the data for NaN/Inf"
            )
        model = MultilayerPerceptronClassificationModel(
            uid=self.uid, weights=weights, trainLoss=loss, iterations=it, device=device,
        )
        return self._copyValues(model)


class MultilayerPerceptronClassificationModel(_MLPParams, Model):
    def __init__(
        self,
        uid: str | None = None,
        weights: np.ndarray | None = None,
        trainLoss: float = float("nan"),
        iterations: int = 0,
        device: str | torch.device = "cuda",
    ):
        super().__init__(uid, device=device)
        self.weights = None if weights is None else np.asarray(weights)
        self.trainLoss = float(trainLoss)
        self.iterations = int(iterations)

    @property
    def numClasses(self) -> int:
        return int(self.getLayers()[-1])

    def _logits(self, mat: np.ndarray) -> np.ndarray:
        layers = tuple(self.getLayers())
        with torch.no_grad():
            flat = torch.from_numpy(self.weights.astype(np.float32)).to(self.device)
            return _forward(flat, to_device(mat, self.device), layers).cpu().numpy()

    @staticmethod
    def _from_logits(logits: np.ndarray):
        """THE softmax/argmax decision rule, in one place."""
        shifted = logits - logits.max(axis=1, keepdims=True)
        e = np.exp(shifted)
        proba = e / e.sum(axis=1, keepdims=True)
        return proba, np.argmax(logits, axis=1).astype(np.float64)

    def proba_and_predictions(self, mat: np.ndarray):
        return self._from_logits(self._logits(mat))

    def _predict_matrix(self, mat: np.ndarray) -> np.ndarray:
        return np.argmax(self._logits(mat), axis=1).astype(np.float64)

    def transform(self, dataset: Any) -> Any:
        if columnar.has_named_columns(dataset):
            mat = columnar.extract_matrix(dataset, self.getOrDefault("featuresCol"))
            logits = self._logits(mat)
            proba, preds = self._from_logits(logits)
            return columnar.append_columns(
                dataset,
                [
                    (self.getOrDefault("rawPredictionCol"), logits),
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
        return {
            "weights": self.weights,
            "meta": np.asarray([self.trainLoss, float(self.iterations)]),
        }

    @classmethod
    def _fromSaved(cls, uid, data, device: str | torch.device = "cuda"):
        return cls(
            uid=uid,
            weights=data["weights"],
            trainLoss=float(data["meta"][0]),
            iterations=int(data["meta"][1]),
            device=device,
        )
