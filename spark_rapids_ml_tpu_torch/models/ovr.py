"""OneVsRest of the port: pyspark.ml's multiclass meta-estimator.

Counterpart of ``spark_rapids_ml_tpu/models/ovr.py``: it wraps any binary
classifier of the port whose model gives a probability or a margin
(LogisticRegression, LinearSVC, GBTClassifier, FMClassifier, ...): fit
trains C one-vs-rest copies (label == c → 1.0), predict takes the class
whose model scores its positive side highest.

The meta-layer is host work: each sub-fit and sub-prediction runs on the
device its classifier was made with, and the argmax over the C scores is
numpy. Persistence is the JAX package's layout: the template classifier in
``classifier/``, the fitted class models in ``class-0/``, ``class-1/``, ...
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.models.base import Estimator, Model, Saveable
from spark_rapids_ml_tpu_torch.models.params import (
    HasFeaturesCol,
    HasLabelCol,
    HasPredictionCol,
)
from spark_rapids_ml_tpu_torch.telemetry import trace_range
from spark_rapids_ml_tpu_torch.utils import columnar, persistence


def _positive_score(model, mat: np.ndarray) -> np.ndarray:
    """[rows] 'how positive' score of a fitted binary model, the surface
    OneVsRest ranks classes on: the probability of class 1 where the model
    gives one, else its raw margin."""
    if hasattr(model, "proba_and_predictions"):
        proba, _ = model.proba_and_predictions(mat)
        proba = np.asarray(proba)
        return proba[:, 1] if proba.ndim == 2 else proba
    if hasattr(model, "predict_proba_matrix"):
        p = np.asarray(model.predict_proba_matrix(mat))
        return p[:, 1] if p.ndim == 2 else p
    if hasattr(model, "margins"):
        return np.asarray(model.margins(mat))
    raise TypeError(
        f"{type(model).__name__} exposes no probability or margin surface "
        "for OneVsRest scoring"
    )


class OneVsRest(HasFeaturesCol, HasLabelCol, HasPredictionCol, Estimator):
    def __init__(self, uid: str | None = None, classifier=None, **kwargs):
        super().__init__(uid, **kwargs)
        self.classifier = classifier
        self._setDefault(featuresCol="features", labelCol="label", predictionCol="prediction")

    def setClassifier(self, value) -> "OneVsRest":
        self.classifier = value
        return self

    def getClassifier(self):
        return self.classifier

    def fit(self, dataset: Any, num_partitions: int | None = None):
        if self.classifier is None:
            raise ValueError("setClassifier(...) before fit")
        parts = columnar.labeled_partitions(
            dataset, self.getOrDefault("featuresCol"), self.getOrDefault("labelCol"), None,
        )
        x = np.concatenate([p[0] for p in parts])
        y = np.concatenate([p[1] for p in parts])
        return self._fit_xy(x, y, num_partitions)

    def _fit_xy(self, x: np.ndarray, y: np.ndarray, num_partitions: int | None = None):
        """The per-class training loop from extracted arrays."""
        if self.classifier is None:
            raise ValueError("setClassifier(...) before fit")
        classes = np.unique(y)
        if not np.all(classes == np.round(classes)) or classes.min() < 0:
            raise ValueError(
                f"OneVsRest requires integer class labels 0..C-1, got {classes[:8]}"
            )
        n_classes = int(classes.max()) + 1
        if n_classes < 2:
            raise ValueError("OneVsRest needs at least 2 classes")
        models = []
        with trace_range("one-vs-rest fit"):
            for c in range(n_classes):
                est = self.classifier.copy()
                models.append(est.fit((x, (y == c).astype(np.float64)), num_partitions))
        model = OneVsRestModel(uid=self.uid, models=models)
        return self._copyValues(model)

    def save(self, path: str, overwrite: bool = False, layout: str = "native") -> None:
        """The params, and the template classifier in ``classifier/``."""
        if self.classifier is None:
            raise ValueError("OneVsRest has no classifier set; nothing meaningful to save")
        super().save(path, overwrite=overwrite, layout=layout)
        self.classifier.save(persistence._FS(path).join("classifier"))

    @classmethod
    def _loadNative(cls, path: str, meta: dict, device: str | torch.device) -> "OneVsRest":
        classifier = Saveable.load(persistence._FS(path).join("classifier"), device=device)
        return cls(uid=meta["uid"], classifier=classifier)


class OneVsRestModel(HasFeaturesCol, HasLabelCol, HasPredictionCol, Model):
    def __init__(self, uid: str | None = None, models: list | None = None):
        super().__init__(uid)
        self.models = list(models or [])
        self._setDefault(featuresCol="features", labelCol="label", predictionCol="prediction")

    @property
    def numClasses(self) -> int:
        return len(self.models)

    def _predict_matrix(self, mat: np.ndarray) -> np.ndarray:
        scores = np.stack([_positive_score(m, mat) for m in self.models], axis=1)
        return np.argmax(scores, axis=1).astype(np.float64)

    def transform(self, dataset: Any) -> Any:
        with trace_range("one-vs-rest transform"):
            return columnar.apply_column_transform(
                dataset,
                self.getOrDefault("featuresCol"),
                self.getOrDefault("predictionCol"),
                self._predict_matrix,
            )

    def _saveData(self) -> dict[str, np.ndarray]:
        return {"numClasses": np.asarray([len(self.models)])}

    def save(self, path: str, overwrite: bool = False, layout: str = "native") -> None:
        """The params and class count, and each class model in
        ``class-<c>/``."""
        super().save(path, overwrite=overwrite, layout=layout)
        fs = persistence._FS(path)
        for c, m in enumerate(self.models):
            m.save(fs.join(f"class-{c}"))

    @classmethod
    def _loadNative(cls, path: str, meta: dict, device: str | torch.device) -> "OneVsRestModel":
        n = int(persistence.load_arrays(path)["numClasses"][0])
        fs = persistence._FS(path)
        models = [Saveable.load(fs.join(f"class-{c}"), device=device) for c in range(n)]
        return cls(uid=meta["uid"], models=models)
