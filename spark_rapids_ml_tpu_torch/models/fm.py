"""FMRegressor / FMClassifier of the port: pyspark.ml's factorization
machines, trained full-batch on the card by default.

Counterpart of ``spark_rapids_ml_tpu/models/fm.py``: the same params,
defaults, setters, messages and persistence, plus a ``device`` argument
(default ``"cuda"``). The degree-2 score (Rendle 2010, Spark's):

    ŷ(x) = b + wᵀx + ½ Σ_f [ (Σ_i v_{if} x_i)² − Σ_i v_{if}² x_i² ]

is two products through the (Σvx)² − Σ(vx)² identity (``fm_score``). The
loss is squared (regressor) or logistic on ±1 labels (classifier), its
weighted mean over the rows. ``solver="adamW"`` (Spark's default) applies
``regParam`` as DECOUPLED weight decay; ``"gd"`` puts the L2 term in the
loss. ``fitIntercept``/``fitLinear`` False freeze their groups at 0: the
gradient is masked on the way in and the parameters on the way out.

``train_fm`` is a loop on the device (``ops/optim.py``) with the JAX
package's stop rule; the AdamW step is written out in optax's order, since
``torch.optim.AdamW`` decays before the Adam step (the same algebra,
rounded otherwise) and has no place for the mask.

The factor init is ``initStd``·N(0, 1) from a ``torch.Generator`` seeded
by ``seed``, not ``jax.random``'s draw: the same seed gives another start
(``train_fm`` takes any start, so a JAX start can be passed across).
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

_SOLVERS = ("adamW", "gd")


def _split(flat: torch.Tensor, n_feat: int, k: int):
    """flat = [b, w (n), V (n·k)]."""
    return flat[0], flat[1:1 + n_feat], flat[1 + n_feat:].reshape(n_feat, k)


def fm_score(flat: torch.Tensor, x: torch.Tensor, *, n_feat: int, k: int) -> torch.Tensor:
    """[rows] FM scores by the two-product interaction identity."""
    b, w, v = _split(flat, n_feat, k)
    linear = x @ w
    xv = x @ v  # [rows, k]
    x2v2 = (x * x) @ (v * v)
    inter = 0.5 * torch.sum(xv * xv - x2v2, dim=1)
    return b + linear + inter


def param_mask(n_feat: int, k: int, *, fit_intercept: bool, fit_linear: bool,
               dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """[1 + n + n·k] 1/0 mask that freezes disabled groups at zero."""
    return torch.cat([
        torch.full((1,), 1.0 if fit_intercept else 0.0, dtype=dtype, device=device),
        torch.full((n_feat,), 1.0 if fit_linear else 0.0, dtype=dtype, device=device),
        torch.ones((n_feat * k,), dtype=dtype, device=device),
    ])


def fm_loss(flat, x, y, w, mask, *, n_feat: int, k: int, classification: bool,
            l2: float) -> torch.Tensor:
    """Weighted mean squared or logistic loss at ``flat·mask``, plus ``l2``
    times the squared norm (loss-side L2; 0 under adamW)."""
    fm = flat * mask
    s = fm_score(fm, x, n_feat=n_feat, k=k)
    w_sum = torch.clamp(torch.sum(w), min=1.0)
    if classification:
        yy = 2.0 * y - 1.0  # logistic loss on ±1
        data = torch.sum(w * torch.logaddexp(torch.zeros_like(s), -yy * s)) / w_sum
    else:
        data = torch.sum(w * (y - s) ** 2) / w_sum
    return data + l2 * torch.sum(fm * fm)


def train_fm(
    flat0: torch.Tensor,
    x: torch.Tensor,
    y: torch.Tensor,
    w: torch.Tensor,
    *,
    n_feat: int,
    k: int,
    solver: str,
    max_iter: int,
    classification: bool,
    fit_intercept: bool,
    fit_linear: bool,
    step_size: float = 1.0,
    reg_param: float = 0.0,
    tol: float = 1e-6,
    callback: Callable[[int, torch.Tensor, float], None] | None = None,
) -> tuple[torch.Tensor, float, int]:
    """Full-batch FM training on ``x``'s device → (flat, loss, iterations).
    ``callback(it, flat, loss)`` sees every iterate."""
    mask = param_mask(n_feat, k, fit_intercept=fit_intercept, fit_linear=fit_linear,
                      dtype=flat0.dtype, device=flat0.device)
    l2 = reg_param if solver == "gd" else 0.0

    def loss_fn(flat):
        return fm_loss(flat, x, y, w, mask, n_feat=n_feat, k=k,
                       classification=classification, l2=l2)

    if solver == "adamW":
        opt = optim.AdamW(step_size, weight_decay=reg_param)

        def step(flat):
            value, grad = optim.value_and_grad(loss_fn, flat)
            return (flat + opt.update(grad * mask, flat)) * mask, value
    elif solver == "gd":
        def step(flat):
            value, grad = optim.value_and_grad(loss_fn, flat)
            return (flat + (-step_size) * (grad * mask)) * mask, value
    else:
        raise ValueError(f"solver must be one of {_SOLVERS}, got {solver!r}")
    with torch.no_grad():
        start = flat0 * mask
    return optim.minimize(loss_fn, start, step, max_iter=max_iter, tol=tol, callback=callback)


class _FMParams(HasDevice, HasFeaturesCol, HasLabelCol, HasPredictionCol):
    factorSize = Param("factorSize", "latent factor dimension k", int)
    fitIntercept = Param("fitIntercept", "fit the global bias", bool)
    fitLinear = Param("fitLinear", "fit the 1-way (linear) term", bool)
    regParam = Param("regParam", "L2 regularization", float)
    maxIter = Param("maxIter", "maximum optimizer iterations", int)
    stepSize = Param("stepSize", "optimizer learning rate", float)
    tol = Param("tol", "convergence tolerance on the loss decrease", float)
    solver = Param("solver", "'adamW' (default, Spark's) or 'gd'", str)
    initStd = Param("initStd", "factor-init standard deviation", float)
    seed = Param("seed", "factor-initialization seed", int)

    def __init__(self, uid: str | None = None, device: str | torch.device = "cuda", **kwargs):
        super().__init__(uid, device=device, **kwargs)
        self._setDefault(
            featuresCol="features", labelCol="label",
            predictionCol="prediction",
            factorSize=8, fitIntercept=True, fitLinear=True, regParam=0.0,
            maxIter=100, stepSize=1.0, tol=1e-6, solver="adamW",
            initStd=0.01, seed=0,
        )

    def getFactorSize(self) -> int:
        return self.getOrDefault("factorSize")


def fm_init(n_feat: int, k: int, init_std: float, seed: int, device: torch.device,
            dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Zero bias and linear terms, ``init_std``·N(0, 1) factors from a
    ``torch.Generator`` seeded by ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    factors = torch.randn((n_feat * k,), generator=gen, device=device, dtype=dtype)
    return torch.cat([torch.zeros((1 + n_feat,), device=device, dtype=dtype), init_std * factors])


class _FMEstimator(_FMParams, Estimator):
    _classification: bool

    def setFactorSize(self, value: int):
        if value < 1:
            raise ValueError(f"factorSize must be >= 1, got {value}")
        return self._set(factorSize=value)

    def setFitIntercept(self, value: bool):
        return self._set(fitIntercept=bool(value))

    def setFitLinear(self, value: bool):
        return self._set(fitLinear=bool(value))

    def setRegParam(self, value: float):
        if value < 0:
            raise ValueError(f"regParam must be >= 0, got {value}")
        return self._set(regParam=float(value))

    def setMaxIter(self, value: int):
        return self._set(maxIter=value)

    def setStepSize(self, value: float):
        if value <= 0:
            raise ValueError(f"stepSize must be > 0, got {value}")
        return self._set(stepSize=float(value))

    def setTol(self, value: float):
        return self._set(tol=float(value))

    def setSolver(self, value: str):
        if value not in _SOLVERS:
            raise ValueError(f"solver must be one of {_SOLVERS}, got {value!r}")
        return self._set(solver=value)

    def setInitStd(self, value: float):
        if value <= 0:
            raise ValueError(f"initStd must be > 0, got {value}")
        return self._set(initStd=float(value))

    def setSeed(self, value: int):
        return self._set(seed=value)

    def fit(self, dataset: Any, num_partitions: int | None = None):
        """``num_partitions`` is accepted for signature uniformity; training
        is full-batch."""
        parts = columnar.labeled_partitions(
            dataset, self.getOrDefault("featuresCol"), self.getOrDefault("labelCol"), None,
        )
        x = np.concatenate([p[0] for p in parts])
        y = np.concatenate([p[1] for p in parts])
        w = np.concatenate([p[2] for p in parts]) if parts[0][2] is not None else None
        if self._classification:
            classes = np.unique(y)
            if not np.all(np.isin(classes, (0.0, 1.0))):
                raise ValueError(f"FMClassifier requires binary 0/1 labels, got {classes[:8]}")
        n_feat = x.shape[1]
        k = self.getFactorSize()
        device = self.device
        with trace_range("fm train", device):
            flat, loss, it = train_fm(
                fm_init(n_feat, k, self.getOrDefault("initStd"), self.getOrDefault("seed"),
                        device),
                to_device(x, device),
                torch.from_numpy(y.astype(np.float32)).to(device),
                torch.from_numpy(
                    np.ones(len(x), np.float32) if w is None else w.astype(np.float32)
                ).to(device),
                n_feat=n_feat,
                k=k,
                solver=self.getOrDefault("solver"),
                max_iter=self.getOrDefault("maxIter"),
                classification=self._classification,
                fit_intercept=self.getOrDefault("fitIntercept"),
                fit_linear=self.getOrDefault("fitLinear"),
                step_size=self.getOrDefault("stepSize"),
                reg_param=self.getOrDefault("regParam"),
                tol=self.getOrDefault("tol"),
            )
            weights = flat.cpu().numpy()
        if not np.isfinite(weights).all():
            raise ValueError("FM training diverged to non-finite weights; lower stepSize")
        model = self._model_cls(
            uid=self.uid, flatWeights=weights, numFeatures=n_feat,
            trainLoss=loss, iterations=it, device=device,
        )
        return self._copyValues(model)


class _FMModel(_FMParams, Model):
    def __init__(
        self,
        uid: str | None = None,
        flatWeights: np.ndarray | None = None,
        numFeatures: int = 0,
        trainLoss: float = float("nan"),
        iterations: int = 0,
        device: str | torch.device = "cuda",
    ):
        super().__init__(uid, device=device)
        self.flatWeights = None if flatWeights is None else np.asarray(flatWeights)
        self._num_features = int(numFeatures)
        self.trainLoss = float(trainLoss)
        self.iterations = int(iterations)

    @property
    def numFeatures(self) -> int:
        return self._num_features

    @property
    def intercept(self) -> float:
        return float(self.flatWeights[0])

    @property
    def linear(self) -> np.ndarray:
        return self.flatWeights[1:1 + self._num_features]

    @property
    def factors(self) -> np.ndarray:
        return self.flatWeights[1 + self._num_features:].reshape(
            self._num_features, self.getFactorSize()
        )

    def _scores(self, mat: np.ndarray) -> np.ndarray:
        if mat.shape[1] != self._num_features:
            raise ValueError(
                f"input has {mat.shape[1]} features but the model was "
                f"fitted on {self._num_features}"
            )
        flat = torch.from_numpy(self.flatWeights.astype(np.float32)).to(self.device)
        return fm_score(flat, to_device(mat, self.device), n_feat=self._num_features,
                        k=self.getFactorSize()).cpu().numpy()

    def predict(self, row) -> float:
        return float(self._predict_matrix(np.asarray(row, dtype=np.float64)[None, :])[0])

    def _saveData(self) -> dict[str, np.ndarray]:
        return {
            "flatWeights": self.flatWeights,
            "meta": np.asarray(
                [float(self._num_features), self.trainLoss, float(self.iterations)]
            ),
        }

    @classmethod
    def _fromSaved(cls, uid, data, device: str | torch.device = "cuda"):
        return cls(
            uid=uid,
            flatWeights=data["flatWeights"],
            numFeatures=int(data["meta"][0]),
            trainLoss=float(data["meta"][1]),
            iterations=int(data["meta"][2]),
            device=device,
        )


class FMRegressor(_FMEstimator):
    _classification = False

    @property
    def _model_cls(self):
        return FMRegressionModel


class FMRegressionModel(_FMModel):
    def _predict_matrix(self, mat: np.ndarray) -> np.ndarray:
        return self._scores(mat)

    def transform(self, dataset: Any) -> Any:
        return columnar.apply_column_transform(
            dataset,
            self.getOrDefault("featuresCol"),
            self.getOrDefault("predictionCol"),
            self._predict_matrix,
        )


class _FMClassifierCols:
    probabilityCol = Param("probabilityCol", "class-probability column", str)
    rawPredictionCol = Param("rawPredictionCol", "margin column [−s, s]", str)

    def __init__(self, uid=None, **kwargs):
        super().__init__(uid, **kwargs)
        self._setDefault(probabilityCol="probability", rawPredictionCol="rawPrediction")

    def setProbabilityCol(self, value: str):
        return self._set(probabilityCol=value)

    def setRawPredictionCol(self, value: str):
        return self._set(rawPredictionCol=value)


class FMClassifier(_FMClassifierCols, _FMEstimator):
    _classification = True

    @property
    def _model_cls(self):
        return FMClassificationModel


class FMClassificationModel(_FMClassifierCols, _FMModel):
    @property
    def numClasses(self) -> int:
        return 2

    @staticmethod
    def _outputs_from_scores(s: np.ndarray):
        """THE decision rule in one place: (proba [rows, 2], preds)."""
        from scipy.special import expit  # overflow-free sigmoid

        p1 = expit(s)
        return np.stack([1.0 - p1, p1], axis=1), (s > 0).astype(np.float64)

    def proba_and_predictions(self, mat: np.ndarray):
        return self._outputs_from_scores(self._scores(mat))

    def _predict_matrix(self, mat: np.ndarray) -> np.ndarray:
        return (self._scores(mat) > 0).astype(np.float64)

    def transform(self, dataset: Any) -> Any:
        if columnar.has_named_columns(dataset):
            mat = columnar.extract_matrix(dataset, self.getOrDefault("featuresCol"))
            s = self._scores(mat)
            proba, preds = self._outputs_from_scores(s)
            return columnar.append_columns(
                dataset,
                [
                    (self.getOrDefault("rawPredictionCol"), np.stack([-s, s], axis=1)),
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
