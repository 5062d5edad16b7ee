"""GBTRegressor / GBTClassifier of the port: gradient-boosted trees on the
forest's histogram trees, on the card by default.

Counterpart of ``spark_rapids_ml_tpu/models/gbt.py``: the same params,
defaults, setters, messages and persistence, plus a ``device`` argument
(default ``"cuda"``). Every stage is one ``ops.forest.build_tree`` variance
tree on the stage's pseudo-residual stats ``[1, r, r²]``; the bins, edges,
thresholds and importances are the forest's (``models/forest.py``).

Spark MLlib semantics kept from the JAX package (GradientBoostedTrees.boost):

- the FIRST tree enters with weight 1.0, every later stage with
  ``stepSize``; each adds its leaf mean of pseudo-residuals (over the rows
  sampled for that stage) to every row routed to the leaf; the model
  exposes ``treeWeights`` and per-stage ``trainLosses``;
- regressor: squared loss, residuals y − F;
- classifier: Friedman's deviance with y ∈ {−1, 1} and margin 2F, residuals
  2y/(1+exp(2yF)); rawPrediction [−2F, 2F], probability σ(2F), prediction
  1[F > 0]. DISCLOSED DIVERGENCE (the JAX package's): Spark's
  LogLoss.gradient is 2× these residuals, so decisions track Spark's and
  margins do not;
- ``featureSubsetStrategy`` 'auto' resolves to 'all';
- ``subsamplingRate`` < 1 draws a Bernoulli row sample per stage from
  numpy's ``default_rng(seed)``, the JAX package's draws, so a subsampled
  fit samples the same rows in both packages.

With a feature subset smaller than all features, each stage's per-node
subsets come from its own ``torch.Generator`` (``forest.tree_generators``),
not from ``jax.random``: the port's own draws, as the forest's are.

``F [rows]`` lives on the device between stages; each stage reads one
scalar, its loss, to the host. Neither model class derives from the
random-forest models, so the serving registry (which serves forests by
``isinstance``) refuses GBT models instead of voting their leaves as
class counts.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.models.base import Model
from spark_rapids_ml_tpu_torch.models.forest import (
    _ForestEstimator,
    _ForestParams,
    bin_on_device,
    quantile_bin_edges,
    split_thresholds,
    subset_size,
    tree_feature_importances,
    tree_generators,
)
from spark_rapids_ml_tpu_torch.models.params import Param
from spark_rapids_ml_tpu_torch.ops import forest as FO
from spark_rapids_ml_tpu_torch.telemetry import trace_range
from spark_rapids_ml_tpu_torch.utils import columnar
from spark_rapids_ml_tpu_torch.utils.device import to_device


class _GBTParams(_ForestParams):
    stepSize = Param("stepSize", "learning rate per boosting stage", float)

    def __init__(self, uid: str | None = None, **kwargs):
        super().__init__(uid, **kwargs)
        # Spark GBT defaults; the stage count maxIter is stored as numTrees
        self._setDefault(
            stepSize=0.1, numTrees=20, featureSubsetStrategy="all",
            impurity="variance",
        )

    def setStepSize(self, value: float):
        if not 0.0 < value <= 1.0:
            raise ValueError(f"stepSize must be in (0, 1], got {value}")
        return self._set(stepSize=float(value))

    def getStepSize(self) -> float:
        return self.getOrDefault("stepSize")

    def setMaxIter(self, value: int):
        if value < 1:
            raise ValueError(f"maxIter must be >= 1, got {value}")
        return self._set(numTrees=value)

    def getMaxIter(self) -> int:
        return self.getOrDefault("numTrees")


class _GBTClassifierCols:
    """probability/rawPrediction columns of GBTClassifier and its model."""

    probabilityCol = Param("probabilityCol", "class-probability column", str)
    rawPredictionCol = Param(
        "rawPredictionCol", "margin column [−2F, 2F] (Spark GBT shape)", str
    )

    def __init__(self, uid=None, **kwargs):
        super().__init__(uid, **kwargs)
        self._setDefault(probabilityCol="probability", rawPredictionCol="rawPrediction")

    def setProbabilityCol(self, value: str):
        return self._set(probabilityCol=value)

    def setRawPredictionCol(self, value: str):
        return self._set(rawPredictionCol=value)


class _GBTEstimator(_GBTParams, _ForestEstimator):
    """The forest estimator's setters and labeled ``fit``; the model build
    is the boosting loop."""

    impurity = Param("impurity", "'variance' (every stage is regression)", str)
    _impurity_choices = ("variance",)

    def _make_model(self, x, y, w):  # _ForestEstimator.fit's hook
        return self._boost(x, y, w)

    def _boost(self, x: np.ndarray, y: np.ndarray, w: np.ndarray | None):
        if self.getImpurity() != "variance":
            raise ValueError(
                "GBT stages are regression trees; impurity must be "
                f"'variance', got {self.getImpurity()!r}"
            )
        n_bins = self.getMaxBins()
        seed = self.getSeed()
        n_stages = self.getMaxIter()
        max_depth = self.getMaxDepth()
        lr = self.getStepSize()
        device = self.device
        x = np.asarray(x, dtype=np.float32)
        rng = np.random.default_rng(seed)

        edges = quantile_bin_edges(x, n_bins, seed, w)
        rows = x.shape[0]
        base_w = np.ones(rows, np.float32) if w is None else w.astype(np.float32)
        rate = self.getOrDefault("subsamplingRate")
        strategy = self.getOrDefault("featureSubsetStrategy")
        if str(strategy).lower() == "auto":
            strategy = "all"  # Spark's GBT rule (one tree per stage)
        k_feat = subset_size(strategy, x.shape[1], classification=False)
        gens = tree_generators(seed, n_stages, device) if k_feat < x.shape[1] else None
        min_inst = float(np.float32(self.getOrDefault("minInstancesPerNode")))
        min_gain = float(np.float32(self.getOrDefault("minInfoGain")))

        # MLlib boost schedule: first tree weight 1.0, later stages lr
        tree_weights = np.asarray([1.0] + [lr] * (n_stages - 1), dtype=np.float64)
        trees, losses = [], []
        with trace_range("gbt boost", device):
            binned_t = bin_on_device(to_device(x, device), edges)
            yt = torch.from_numpy(self._targets(y).astype(np.float32)).to(device)
            base_wt = torch.from_numpy(base_w).to(device)
            F = torch.zeros((rows,), dtype=torch.float32, device=device)
            for m in range(n_stages):
                r = self._pseudo_residuals(yt, F)
                stats = torch.stack([torch.ones_like(r), r, r * r], dim=1)
                stage_w = base_wt
                if rate < 1.0:
                    keep = (rng.random(rows) < rate).astype(np.float32)
                    stage_w = torch.from_numpy(base_w * keep).to(device)
                tree = FO.build_tree(
                    binned_t, stats, stage_w, min_inst, min_gain,
                    max_depth=max_depth, n_bins=n_bins, k_features=k_feat,
                    impurity="variance", generator=None if gens is None else gens[m],
                )
                leaf = FO.tree_apply_binned(tree, binned_t, max_depth=max_depth)
                # leaf mean over the SAMPLED rows that built the tree,
                # applied to every row routed there (Friedman)
                pred = leaf[:, 1] / torch.where(leaf[:, 0] > 0, leaf[:, 0], torch.ones_like(leaf[:, 0]))
                F = F + float(tree_weights[m]) * pred
                losses.append(float(self._loss(yt, F, base_wt)))
                trees.append(FO.TreeArrays(*(a.cpu().numpy() for a in tree)))

        stacked = FO.TreeArrays(
            *(np.stack([getattr(t, f) for t in trees]) for f in FO.TreeArrays._fields)
        )
        model = self._model_cls(
            uid=self.uid,
            trees=stacked,
            thresholds=split_thresholds(stacked, edges),
            treeWeights=tree_weights,
            numFeatures=x.shape[1],
            trainLosses=np.asarray(losses),
            device=device,
        )
        return self._copyValues(model)


class _GBTModel(_GBTParams, Model):
    def __init__(
        self,
        uid: str | None = None,
        trees: FO.TreeArrays | None = None,
        thresholds: np.ndarray | None = None,
        treeWeights: np.ndarray | None = None,
        numFeatures: int = -1,
        trainLosses: np.ndarray | None = None,
        device: str | torch.device = "cuda",
    ):
        super().__init__(uid, device=device)
        self.trees = None if trees is None else FO.TreeArrays(*(np.asarray(a) for a in trees))
        self.thresholds = None if thresholds is None else np.asarray(thresholds)
        #: per-stage weights ([1.0, lr, lr, ...], Spark's treeWeights)
        self.treeWeights = None if treeWeights is None else np.asarray(treeWeights)
        self._num_features = int(numFeatures)
        #: per-stage training loss, Spark GBT's summary hook
        self.trainLosses = None if trainLosses is None else np.asarray(trainLosses)

    @property
    def numFeatures(self) -> int:
        return self._num_features

    @property
    def featureImportances(self) -> np.ndarray:
        """Impurity-based importances (the forest's recipe, as Spark's)."""
        return tree_feature_importances(self.trees, self._num_features)

    def getNumTrees(self) -> int:
        return self.trees.feature.shape[0]

    def _leaf_stats_for(self, mat: np.ndarray) -> np.ndarray:
        """[T, rows, 3] leaf stats by the device descent."""
        max_depth = int(np.log2(self.trees.feature.shape[1] + 1) - 1)
        params = [
            torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
            for a in (*self.trees, self.thresholds.astype(np.float64))
        ]
        return FO.forest_apply(
            FO.TreeArrays(*params[:5]), to_device(mat, self.device), params[5],
            max_depth=max_depth,
        ).cpu().numpy()

    def _margins(self, mat: np.ndarray) -> np.ndarray:
        """[rows] additive prediction F(x) = Σ treeWeights·(leaf mean)."""
        leaf = self._leaf_stats_for(mat)
        pred = leaf[..., 1] / np.where(leaf[..., 0] > 0, leaf[..., 0], 1.0)
        return self.treeWeights @ pred

    def predict(self, row) -> float:
        return float(self._predict_matrix(np.asarray(row, dtype=np.float64)[None, :])[0])

    def _saveData(self) -> dict[str, np.ndarray]:
        return {
            "feature": self.trees.feature,
            "split_bin": self.trees.split_bin,
            "is_leaf": self.trees.is_leaf,
            "leaf_stats": self.trees.leaf_stats,
            "gain": self.trees.gain,
            "thresholds": self.thresholds,
            "treeWeights": self.treeWeights,
            "numFeatures": np.asarray([self._num_features]),
            "trainLosses": self.trainLosses if self.trainLosses is not None else np.zeros(0),
        }

    @classmethod
    def _fromSaved(cls, uid, data, device: str | torch.device = "cuda"):
        trees = FO.TreeArrays(
            data["feature"].astype(np.int32),
            data["split_bin"].astype(np.int32),
            data["is_leaf"].astype(bool),
            data["leaf_stats"].astype(np.float32),
            data["gain"].astype(np.float32),
        )
        return cls(
            uid=uid, trees=trees, thresholds=data["thresholds"],
            treeWeights=data["treeWeights"],
            numFeatures=int(data["numFeatures"][0]),
            trainLosses=data["trainLosses"],
            device=device,
        )


# ---------------------------------------------------------------------------
# Regressor
# ---------------------------------------------------------------------------


class GBTRegressor(_GBTEstimator):
    _classification = False

    def _targets(self, y: np.ndarray) -> np.ndarray:
        return np.asarray(y, dtype=np.float64)

    @staticmethod
    def _pseudo_residuals(y: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
        return y - F  # squared loss

    @staticmethod
    def _loss(y: torch.Tensor, F: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return torch.sum(w * (y - F) ** 2) / torch.sum(w)

    @property
    def _model_cls(self):
        return GBTRegressionModel


class GBTRegressionModel(_GBTModel):
    def _predict_matrix(self, mat: np.ndarray) -> np.ndarray:
        return self._margins(mat)

    def transform(self, dataset: Any) -> Any:
        return columnar.apply_column_transform(
            dataset,
            self.getOrDefault("featuresCol"),
            self.getOrDefault("predictionCol"),
            self._predict_matrix,
        )


# ---------------------------------------------------------------------------
# Classifier
# ---------------------------------------------------------------------------


class GBTClassifier(_GBTClassifierCols, _GBTEstimator):
    _classification = True

    def _targets(self, y: np.ndarray) -> np.ndarray:
        classes = np.unique(y)
        if not np.all(np.isin(classes, (0.0, 1.0))):
            raise ValueError(f"GBTClassifier requires binary 0/1 labels, got {classes[:8]}")
        return 2.0 * np.asarray(y, dtype=np.float64) - 1.0  # ±1

    @staticmethod
    def _pseudo_residuals(y: torch.Tensor, F: torch.Tensor) -> torch.Tensor:
        # −∂/∂F log(1+exp(−2yF)) = 2y/(1+exp(2yF)), Friedman's scaling
        return 2.0 * y / (1.0 + torch.exp(2.0 * y * F))

    @staticmethod
    def _loss(y: torch.Tensor, F: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        # logistic (deviance) loss, logaddexp for stability
        return torch.sum(w * torch.logaddexp(torch.zeros_like(F), -2.0 * y * F)) / torch.sum(w)

    @property
    def _model_cls(self):
        return GBTClassificationModel


class GBTClassificationModel(_GBTClassifierCols, _GBTModel):
    @property
    def numClasses(self) -> int:
        return 2

    @staticmethod
    def _outputs(F: np.ndarray):
        """(rawPrediction [rows, 2], probability [rows, 2], prediction)."""
        from scipy.special import expit  # overflow-free sigmoid

        p1 = expit(2.0 * F)
        return (np.stack([-2.0 * F, 2.0 * F], axis=1), np.stack([1.0 - p1, p1], axis=1),
                (F > 0).astype(np.float64))

    def proba_and_predictions(self, mat: np.ndarray):
        _, proba, preds = self._outputs(self._margins(mat))
        return proba, preds

    def _predict_matrix(self, mat: np.ndarray) -> np.ndarray:
        return (self._margins(mat) > 0).astype(np.float64)

    def transform(self, dataset: Any) -> Any:
        if columnar.has_named_columns(dataset):
            mat = columnar.extract_matrix(dataset, self.getOrDefault("featuresCol"))
            raw, proba, preds = self._outputs(self._margins(mat))
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
