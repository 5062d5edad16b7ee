"""RandomForestClassifier / RandomForestRegressor and the DecisionTree
estimators of the port, on the card by default.

Counterpart of ``spark_rapids_ml_tpu/models/forest.py``: the same params,
defaults, setters, messages and persistence, plus a ``device`` argument
(default ``"cuda"``), over the histogram trees of ``ops/forest.py``.

Spark semantics kept from the JAX package:

- features are quantile-binned to ``maxBins`` bins from a bounded sample
  (``quantile_bin_edges``, numpy, the same edges in both packages);
- bootstrap draws Poisson(subsamplingRate) per-row counts (numpy, the same
  draws in both packages), multiplied into any ``weightCol`` weights;
  ``bootstrap=False`` with a rate below 1 draws Bernoulli rows;
- ``featureSubsetStrategy`` per node ('auto' = sqrt(F) for
  classification, F/3 for regression). The per-node subsets come from one
  ``torch.Generator`` per tree (seeded from ``seed`` through numpy's
  ``SeedSequence``), not from ``jax.random``: with a subset strategy other
  than "all" the same seed gives the same forest here, not the JAX
  package's; with "all" there is no draw and the trees are the JAX
  package's;
- classifier probability = average of per-tree leaf class distributions,
  rawPrediction their sum; regressor prediction = mean of per-tree leaf
  means;
- the trees are binned and built on the device; prediction descends them
  there (``ops.forest.forest_apply``) and the votes are host numpy.
"""

from __future__ import annotations

import math
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
from spark_rapids_ml_tpu_torch.ops import forest as FO
from spark_rapids_ml_tpu_torch.telemetry import trace_range
from spark_rapids_ml_tpu_torch.utils import columnar
from spark_rapids_ml_tpu_torch.utils.device import to_device

#: rows sampled (not streamed) for quantile bin-edge estimation
_MAX_BIN_SAMPLE = 200_000


def subset_size(strategy: str, n_features: int, *, classification: bool) -> int:
    """Spark featureSubsetStrategy → per-node feature count."""
    s = str(strategy).lower()
    if s == "auto":
        s = "sqrt" if classification else "onethird"
    if s == "all":
        return n_features
    # Spark ceils the named strategies (sqrt → ceil(√F), log2 → ceil(log₂F),
    # onethird → ceil(F/3))
    if s == "sqrt":
        return max(1, math.ceil(math.sqrt(n_features)))
    if s == "log2":
        return max(1, math.ceil(math.log2(n_features)))
    if s == "onethird":
        return max(1, math.ceil(n_features / 3.0))
    try:
        v = float(s)
    except ValueError:
        raise ValueError(
            f"featureSubsetStrategy must be auto/all/sqrt/log2/onethird or "
            f"a number, got {strategy!r}"
        ) from None
    if v >= 1.0:
        return min(n_features, int(v))
    if v > 0.0:
        # Spark ceils fractional strategies (RandomForest.getFeatureSubsetNumber)
        return min(n_features, max(1, math.ceil(v * n_features)))
    raise ValueError(f"featureSubsetStrategy must be > 0, got {strategy!r}")


def quantile_bin_edges(
    x: np.ndarray, n_bins: int, seed: int, w: np.ndarray | None = None
) -> np.ndarray:
    """[F, n_bins−1] interior quantile edges from a bounded row sample.
    Zero-weight rows are excluded before the quantile pass."""
    if w is not None:
        x = x[np.asarray(w) > 0]
    if x.shape[0] > _MAX_BIN_SAMPLE:
        rng = np.random.default_rng(seed)
        x = x[rng.choice(x.shape[0], _MAX_BIN_SAMPLE, replace=False)]
    qs = np.linspace(0.0, 1.0, n_bins + 1)[1:-1]
    return np.quantile(x, qs, axis=0).T.astype(np.float64)


def tree_feature_importances(trees: FO.TreeArrays, n_features: int) -> np.ndarray:
    """Spark's TreeEnsembleModel.featureImportances: per tree, sum each
    split node's n-scaled impurity gain by feature and normalize to 1;
    average the per-tree vectors; normalize again."""
    T = trees.feature.shape[0]
    out = np.zeros((T, n_features))
    for t in range(T):
        feat = trees.feature[t]
        split = feat >= 0
        np.add.at(out[t], feat[split], trees.gain[t][split])
        tot = out[t].sum()
        if tot > 0:
            out[t] /= tot
    avg = out.mean(0)
    s = avg.sum()
    return avg / s if s > 0 else avg


def split_thresholds(trees: FO.TreeArrays, edges: np.ndarray) -> np.ndarray:
    """[T, nodes] raw-value split thresholds from (feature, split_bin): bin
    b splits at edges[f, b] (go right when x > edge); leaves get 0."""
    feat = np.clip(trees.feature, 0, None)
    thresholds = np.take_along_axis(
        edges[feat.reshape(-1)],
        np.clip(trees.split_bin, 0, edges.shape[1] - 1).reshape(-1, 1),
        axis=1,
    ).reshape(trees.feature.shape)
    return np.where(trees.feature >= 0, thresholds, 0.0)


def bin_on_device(x: torch.Tensor, edges: np.ndarray) -> torch.Tensor:
    """[F, rows] int32 bin ids of [rows, F] rows, feature-major: bin b ⇔
    edges[b−1] < x ≤ edges[b], each f32 value compared in f64 with its f64
    edges (numpy's ``searchsorted(side="left")`` on the f32 value)."""
    e = torch.as_tensor(edges, dtype=torch.float64, device=x.device)
    out = torch.empty((x.shape[1], x.shape[0]), dtype=torch.int32, device=x.device)
    for j in range(x.shape[1]):
        out[j] = torch.searchsorted(e[j].contiguous(), x[:, j].to(torch.float64))
    return out


def bin_features(x: np.ndarray, edges: np.ndarray) -> np.ndarray:
    """[rows, F] int32 bin ids: bin b ⇔ edges[b−1] < x ≤ edges[b]."""
    return bin_on_device(torch.from_numpy(np.asarray(x)), edges).T.numpy().copy()


def forest_votes(leaf: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """([rows, C] averaged per-tree class distributions, [rows] argmax as
    float64) of [T, rows, C] leaf stats: Spark's
    RandomForestClassificationModel decision rule."""
    tot = leaf.sum(-1, keepdims=True)
    per_tree = np.divide(leaf, np.where(tot > 0, tot, 1.0), dtype=leaf.dtype)
    proba = per_tree.sum(0) / leaf.shape[0]
    return proba, np.argmax(proba, axis=1).astype(np.float64)


def tree_generators(seed: int, n_trees: int, device: torch.device) -> list[torch.Generator]:
    """One ``torch.Generator`` per tree on ``device``, seeded from ``seed``
    through numpy's ``SeedSequence`` (the per-node feature subsets)."""
    states = np.random.SeedSequence(seed).generate_state(n_trees, dtype=np.uint64)
    return [torch.Generator(device=device).manual_seed(int(s) >> 1) for s in states]


class _ForestParams(HasDevice, HasFeaturesCol, HasLabelCol, HasPredictionCol):
    numTrees = Param("numTrees", "number of trees", int)
    maxDepth = Param("maxDepth", "maximum tree depth (root = depth 0)", int)
    maxBins = Param("maxBins", "histogram bins per feature", int)
    minInstancesPerNode = Param(
        "minInstancesPerNode",
        "minimum weighted instance count per child for a split",
        float,
    )
    minInfoGain = Param("minInfoGain", "minimum impurity decrease", float)
    featureSubsetStrategy = Param(
        "featureSubsetStrategy",
        "features considered per node: auto/all/sqrt/log2/onethird or a "
        "count/fraction",
        str,
    )
    subsamplingRate = Param("subsamplingRate", "bootstrap sample rate per tree", float)
    bootstrap = Param(
        "bootstrap",
        "Poisson bootstrap per tree (False = every tree sees all rows)",
        bool,
    )
    seed = Param("seed", "random seed", int)
    weightCol = Param("weightCol", "optional instance-weight column", str)

    def __init__(self, uid: str | None = None, device: str | torch.device = "cuda",
                 **kwargs):
        super().__init__(uid, device=device, **kwargs)
        self._setDefault(
            featuresCol="features", labelCol="label",
            predictionCol="prediction",
            numTrees=20, maxDepth=5, maxBins=32, minInstancesPerNode=1.0,
            minInfoGain=0.0, featureSubsetStrategy="auto",
            subsamplingRate=1.0, bootstrap=True, seed=0,
        )

    def getNumTrees(self) -> int:
        return self.getOrDefault("numTrees")

    def getMaxDepth(self) -> int:
        return self.getOrDefault("maxDepth")

    def getMaxBins(self) -> int:
        return self.getOrDefault("maxBins")

    def getSeed(self) -> int:
        return self.getOrDefault("seed")


class _ForestEstimator(_ForestParams, Estimator):
    _classification: bool  # set by subclasses
    _impurity_choices: tuple

    def setNumTrees(self, value: int):
        if value < 1:
            raise ValueError(f"numTrees must be >= 1, got {value}")
        return self._set(numTrees=value)

    def setMaxDepth(self, value: int):
        if not 0 <= value <= 14:
            raise ValueError(f"maxDepth must be in [0, 14], got {value}")
        return self._set(maxDepth=value)

    def setMaxBins(self, value: int):
        if value < 2:
            raise ValueError(f"maxBins must be >= 2, got {value}")
        return self._set(maxBins=value)

    def setMinInstancesPerNode(self, value: float):
        if value < 1:
            raise ValueError(f"minInstancesPerNode must be >= 1, got {value}")
        return self._set(minInstancesPerNode=float(value))

    def setMinInfoGain(self, value: float):
        return self._set(minInfoGain=float(value))

    def setFeatureSubsetStrategy(self, value):
        return self._set(featureSubsetStrategy=str(value))

    def setSubsamplingRate(self, value: float):
        if not 0.0 < value <= 1.0:
            raise ValueError(f"subsamplingRate must be in (0, 1], got {value}")
        return self._set(subsamplingRate=float(value))

    def setBootstrap(self, value: bool):
        return self._set(bootstrap=bool(value))

    def setSeed(self, value: int):
        return self._set(seed=value)

    def setWeightCol(self, value: str):
        return self._set(weightCol=value)

    def setImpurity(self, value: str):
        if value not in self._impurity_choices:
            raise ValueError(
                f"impurity must be one of {self._impurity_choices}, got {value!r}"
            )
        return self._set(impurity=value)

    def getImpurity(self) -> str:
        return self.getOrDefault("impurity")

    def _make_model(self, x, y, w, builder=None):
        """Fit the arrays and wrap them in the subclass's model."""
        trees, thresholds = self._fit_arrays(x, y, w, builder=builder)
        model = self._model_cls(
            uid=self.uid, trees=trees, thresholds=thresholds,
            numFeatures=x.shape[1], device=self.device,
        )
        return self._copyValues(model)

    def _fit_arrays(
        self, x: np.ndarray, y: np.ndarray, w: np.ndarray | None, builder=None
    ) -> tuple[FO.TreeArrays, np.ndarray]:
        """(trees as host arrays, thresholds): bin edges and bootstrap
        weights on the host (numpy), binning and the build on the device.
        ``builder`` replaces :func:`ops.forest.build_forest` (the same
        arguments) so that the Spark estimator can route the build through
        the mesh-sharded program (``parallel/forest.py``)."""
        n_bins = self.getMaxBins()
        seed = self.getSeed()
        n_trees = self.getNumTrees()
        device = self.device
        x = np.asarray(x, dtype=np.float32)

        edges = quantile_bin_edges(x, n_bins, seed, w)
        row_stats = self._row_stats(y)

        rng = np.random.default_rng(seed)
        base_w = np.ones(len(x), np.float32) if w is None else w.astype(np.float32)
        rate = self.getOrDefault("subsamplingRate")
        if self.getOrDefault("bootstrap"):
            weights = rng.poisson(rate, size=(n_trees, len(x))).astype(np.float32)
        elif rate < 1.0:
            # Spark bootstrap=False subsampling is without replacement:
            # Bernoulli(rate) per row per tree (BaggedPoint semantics)
            weights = (rng.random(size=(n_trees, len(x))) < rate).astype(np.float32)
        else:
            weights = np.ones((n_trees, len(x)), np.float32)
        weights *= base_w[None, :]

        k_feat = subset_size(
            self.getOrDefault("featureSubsetStrategy"),
            x.shape[1],
            classification=self._classification,
        )
        with trace_range("forest build", device):
            binned_t = bin_on_device(to_device(x, device), edges)
            build = FO.build_forest if builder is None else builder
            trees = build(
                binned_t,
                to_device(row_stats, device),
                to_device(weights, device),
                float(np.float32(self.getOrDefault("minInstancesPerNode"))),
                float(np.float32(self.getOrDefault("minInfoGain"))),
                generators=tree_generators(seed, n_trees, device),
                max_depth=self.getMaxDepth(),
                n_bins=n_bins,
                k_features=k_feat,
                impurity=self.getImpurity(),
            )
            trees = FO.TreeArrays(*(a.cpu().numpy() for a in trees))
        return trees, split_thresholds(trees, edges)

    def fit(self, dataset: Any, num_partitions: int | None = None):
        parts = columnar.labeled_partitions(
            dataset,
            self.getOrDefault("featuresCol"),
            self.getOrDefault("labelCol"),
            num_partitions,
            weight_col=self._paramMap.get("weightCol"),
        )
        x = np.concatenate([p[0] for p in parts])
        y = np.concatenate([p[1] for p in parts])
        w = (
            np.concatenate([p[2] for p in parts])
            if parts[0][2] is not None
            else None
        )
        return self._make_model(x, y, w)


class _ForestModel(_ForestParams, Model):
    def __init__(
        self,
        uid: str | None = None,
        trees: FO.TreeArrays | None = None,
        thresholds: np.ndarray | None = None,
        numFeatures: int = -1,
        device: str | torch.device = "cuda",
    ):
        super().__init__(uid, device=device)
        self.trees = None if trees is None else FO.TreeArrays(*(np.asarray(a) for a in trees))
        self.thresholds = None if thresholds is None else np.asarray(thresholds)
        self._num_features = int(numFeatures)

    @property
    def numFeatures(self) -> int:
        """Training feature count (Spark model API)."""
        return self._num_features

    @property
    def maxTreeDepth(self) -> int:
        """The depth the heap arrays hold (maxDepth of the fit)."""
        return int(np.log2(self.trees.feature.shape[1] + 1) - 1)

    def predict(self, row) -> float:
        return float(self._predict_matrix(np.asarray(row, dtype=np.float64)[None, :])[0])

    def getNumTrees(self) -> int:  # fitted count, not the param
        return self.trees.feature.shape[0]

    @property
    def totalNumNodes(self) -> int:
        """Materialized (reachable) nodes across the forest."""
        reachable = np.sum(self.trees.leaf_stats.sum(-1) > 0, axis=1)
        return int(np.sum(np.maximum(reachable, 1)))

    def device_params(self, device: torch.device | None = None) -> tuple[torch.Tensor, ...]:
        """The trees' five arrays and the f64 thresholds as tensors on
        ``device`` (default the model's): the params of
        ``ops.forest.forest_apply``."""
        device = self.device if device is None else device
        return tuple(
            torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (*self.trees, self.thresholds.astype(np.float64))
        )

    def _leaf_stats_for(self, mat: np.ndarray) -> np.ndarray:
        """[T, rows, S] leaf stats by the device descent."""
        params = self.device_params()
        return FO.forest_apply(
            FO.TreeArrays(*params[:5]), to_device(mat, self.device), params[5],
            max_depth=self.maxTreeDepth,
        ).cpu().numpy()

    @property
    def featureImportances(self) -> np.ndarray:
        """Impurity-based importances, Spark's recipe."""
        return tree_feature_importances(self.trees, self._num_features)

    def _saveData(self) -> dict[str, np.ndarray]:
        return {
            "feature": self.trees.feature,
            "split_bin": self.trees.split_bin,
            "is_leaf": self.trees.is_leaf,
            "leaf_stats": self.trees.leaf_stats,
            "gain": self.trees.gain,
            "thresholds": self.thresholds,
            "numFeatures": np.asarray([self._num_features]),
        }

    @classmethod
    def _fromSaved(cls, uid, data, device: str | torch.device = "cuda"):
        trees = FO.TreeArrays(
            data["feature"].astype(np.int32),
            data["split_bin"].astype(np.int32),
            data["is_leaf"].astype(bool),
            data["leaf_stats"].astype(np.float32),
            # pre-gain saves load with zero importances rather than failing
            data.get("gain", np.zeros(data["feature"].shape)).astype(np.float32),
        )
        return cls(
            uid=uid,
            trees=trees,
            thresholds=data["thresholds"],
            numFeatures=int(data["numFeatures"][0]),
            device=device,
        )


# ---------------------------------------------------------------------------
# Classifier
# ---------------------------------------------------------------------------


class _ClassifierCols:
    probabilityCol = Param("probabilityCol", "class-probability column", str)
    rawPredictionCol = Param(
        "rawPredictionCol", "summed per-tree distribution column", str
    )

    def __init__(self, uid=None, **kwargs):
        super().__init__(uid, **kwargs)
        self._setDefault(
            probabilityCol="probability", rawPredictionCol="rawPrediction",
            impurity="gini",
        )

    def setProbabilityCol(self, value: str):
        return self._set(probabilityCol=value)

    def setRawPredictionCol(self, value: str):
        return self._set(rawPredictionCol=value)


class RandomForestClassifier(_ClassifierCols, _ForestEstimator):
    impurity = Param("impurity", "'gini' or 'entropy'", str)
    _classification = True
    _impurity_choices = ("gini", "entropy")

    def _row_stats(self, y: np.ndarray) -> np.ndarray:
        classes = np.round(y).astype(np.int64)
        if (classes < 0).any() or not np.allclose(y, classes):
            raise ValueError(
                "classification labels must be non-negative integers "
                "(Spark ML label contract)"
            )
        return np.eye(int(classes.max()) + 1, dtype=np.float32)[classes]

    @property
    def _model_cls(self):
        return RandomForestClassificationModel


class RandomForestClassificationModel(_ClassifierCols, _ForestModel):
    impurity = Param("impurity", "'gini' or 'entropy'", str)

    @property
    def numClasses(self) -> int:
        return self.trees.leaf_stats.shape[-1]

    def proba_and_predictions(self, mat):
        """([rows, C] averaged per-tree distributions, [rows] argmax)."""
        return forest_votes(self._leaf_stats_for(mat))

    def _predict_matrix(self, mat: np.ndarray) -> np.ndarray:
        return self.proba_and_predictions(mat)[1]

    def transform(self, dataset: Any) -> Any:
        if columnar.has_named_columns(dataset):
            mat = columnar.extract_matrix(dataset, self.getOrDefault("featuresCol"))
            proba, preds = self.proba_and_predictions(mat)
            cols = [
                (self.getOrDefault("rawPredictionCol"), proba * len(self.trees.feature)),
                (self.getOrDefault("probabilityCol"), proba),
                (self.getOrDefault("predictionCol"), preds),
            ]
            return columnar.append_columns(dataset, cols)
        return columnar.apply_column_transform(
            dataset,
            self.getOrDefault("featuresCol"),
            self.getOrDefault("predictionCol"),
            self._predict_matrix,
        )


# ---------------------------------------------------------------------------
# Regressor
# ---------------------------------------------------------------------------


class RandomForestRegressor(_ForestEstimator):
    impurity = Param("impurity", "'variance'", str)
    _classification = False
    _impurity_choices = ("variance",)

    def __init__(self, uid=None, device: str | torch.device = "cuda", **kwargs):
        super().__init__(uid, device=device, **kwargs)
        self._setDefault(impurity="variance")

    def _row_stats(self, y: np.ndarray) -> np.ndarray:
        y = y.astype(np.float32)
        return np.stack([np.ones_like(y), y, y * y], axis=1)

    @property
    def _model_cls(self):
        return RandomForestRegressionModel


class RandomForestRegressionModel(_ForestModel):
    impurity = Param("impurity", "'variance'", str)

    def _predict_matrix(self, mat: np.ndarray) -> np.ndarray:
        leaf = self._leaf_stats_for(mat)  # [T, rows, 3]
        w = leaf[..., 0]
        mean = leaf[..., 1] / np.where(w > 0, w, 1.0)
        return mean.mean(0)

    def transform(self, dataset: Any) -> Any:
        return columnar.apply_column_transform(
            dataset,
            self.getOrDefault("featuresCol"),
            self.getOrDefault("predictionCol"),
            self._predict_matrix,
        )


# ---------------------------------------------------------------------------
# Single decision trees (pyspark.ml parity: a forest of one)
# ---------------------------------------------------------------------------


class _SingleTreeDefaults:
    """pyspark.ml's DecisionTree* estimators: the forest machinery at
    numTrees=1, no bootstrap, all features per node."""

    def __init__(self, uid=None, **kwargs):
        super().__init__(uid, **kwargs)
        self._setDefault(numTrees=1, bootstrap=False, featureSubsetStrategy="all")

    def setNumTrees(self, value):  # a decision tree IS one tree
        raise AttributeError(
            "DecisionTree estimators fit exactly one tree; use the "
            "RandomForest estimators for ensembles"
        )


class DecisionTreeClassifier(_SingleTreeDefaults, RandomForestClassifier):
    @property
    def _model_cls(self):
        return DecisionTreeClassificationModel


def _require_single_tree(data):
    """A DecisionTree model's load rejects multi-tree (forest) saves."""
    n_trees = data["feature"].shape[0]
    if n_trees != 1:
        raise TypeError(
            f"save holds {n_trees} trees; a DecisionTree model is exactly "
            "one — load it through the RandomForest model class"
        )


def _tree_depth(model) -> int:
    """Depth of the fitted tree (deepest materialized split + 1)."""
    split_nodes = np.flatnonzero(model.trees.feature[0] >= 0)
    if len(split_nodes) == 0:
        return 0
    return int(np.floor(np.log2(split_nodes.max() + 1)) + 1)


class DecisionTreeClassificationModel(RandomForestClassificationModel):
    depth = property(_tree_depth)

    @classmethod
    def _fromSaved(cls, uid, data, device: str | torch.device = "cuda"):
        _require_single_tree(data)
        return super()._fromSaved(uid, data, device)


class DecisionTreeRegressor(_SingleTreeDefaults, RandomForestRegressor):
    @property
    def _model_cls(self):
        return DecisionTreeRegressionModel


class DecisionTreeRegressionModel(RandomForestRegressionModel):
    depth = property(_tree_depth)

    @classmethod
    def _fromSaved(cls, uid, data, device: str | torch.device = "cuda"):
        _require_single_tree(data)
        return super()._fromSaved(uid, data, device)
