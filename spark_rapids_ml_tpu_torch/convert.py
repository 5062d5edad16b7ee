"""Carry fitted models from the JAX package into the port.

Each function here takes the dict that the JAX model's ``_saveData()`` returns,
plain numpy arrays, so nothing of the JAX package is imported:

- ``pca_model_from_arrays``: ``pc`` and ``explainedVariance``, and
  ``mean``/``std`` for a model fitted with standardize=True;
- ``model_from_arrays``: any model or stage the port has, named by its
  class name (``"StandardScalerModel"``: ``mean``/``std``;
  ``"MinMaxScalerModel"``: ``originalMin``/``originalMax``;
  ``"RobustScalerModel"``: ``median``/``range``; ``"ImputerModel"``:
  ``surrogate``; ``"QuantileDiscretizerModel"``: ``splits``;
  ``"VarianceThresholdSelectorModel"``: ``selectedFeatures``;
  ``"KMeansModel"``: ``clusterCenters``/``trainingCost``;
  ``"NearestNeighborsModel"``: ``items``/``itemIds``;
  ``"LinearRegressionModel"``, ``"LinearSVCModel"`` and a binary
  ``"LogisticRegressionModel"``: ``coefficients``/``intercept``; a
  multinomial ``"LogisticRegressionModel"``: ``coefficientMatrix``/
  ``interceptVector``; ``"TruncatedSVDModel"``: ``components``/
  ``singularValues``; ``"ApproximateNearestNeighborsModel"`` and
  ``"IVFFlatIndexModel"``: ``centroids``/``bucketItems``/``bucketIds``/
  ``itemIds`` and ``spillItems``/``spillIds`` (absent in a pre-spill save);
  the six tree models (``"RandomForestClassificationModel"``,
  ``"RandomForestRegressionModel"``, ``"DecisionTree*Model"``):
  ``feature``/``split_bin``/``is_leaf``/``leaf_stats``/``gain``/
  ``thresholds``/``numFeatures``; ``"NaiveBayesModel"``: ``pi``/``theta``/
  ``sigma``; ``"GBTClassificationModel"`` and ``"GBTRegressionModel"``:
  the tree arrays and ``thresholds``/``treeWeights``/``numFeatures``/
  ``trainLosses``; ``"MultilayerPerceptronClassificationModel"``:
  ``weights``/``meta`` (with the ``layers`` param); ``"FMClassificationModel"``
  and ``"FMRegressionModel"``: ``flatWeights``/``meta`` (numFeatures, loss,
  iterations); ``"UMAPModel"``: ``rawData``/``embedding``/``ab``;
  ``"IsotonicRegressionModel"``: ``boundaries``/``predictions``;
  ``"StringIndexerModel"``: ``labels`` (UTF-8 bytes); ``"OneHotEncoderModel"``:
  ``categorySize``; ``"IDFModel"``: ``idf``/``docFreq``/``numDocs``; a
  stateless stage such as ``"Normalizer"``, ``"DBSCANModel"`` or
  ``"VectorAssembler"``: nothing),
  with the params the JAX model had set (its ``_paramMap``), which
  ``_saveData`` does not hold;
- ``incremental_from_state``: an incremental estimator (``"IncrementalPCA"``,
  ``"IncrementalTruncatedSVD"``, ``"IncrementalStandardScaler"``,
  ``"IncrementalLinearRegression"``, ``"IncrementalKMeans"``) resumed from
  the ``(arrays, scalars)`` of the JAX estimator's ``to_state()``, with its
  params;
- ``pipeline_model_from_arrays``: a ``PipelineModel`` from a list of
  ``{"class", "data", "params"}`` dicts, one per stage, in order;
- ``one_vs_rest_model_from_arrays``: a ``OneVsRestModel`` from the same
  dicts, one per class model, in class order.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.models.base import port_class
from spark_rapids_ml_tpu_torch.models.ovr import OneVsRestModel
from spark_rapids_ml_tpu_torch.models.pca import PCAModel
from spark_rapids_ml_tpu_torch.models.pipeline import PipelineModel


def pca_model_from_arrays(
    data: Mapping[str, np.ndarray],
    device: str | torch.device = "cuda",
) -> PCAModel:
    """A port ``PCAModel`` holding the given components (and scaling):
    ``model_from_arrays("PCAModel", data, device)`` after a check that the
    arrays are whole."""
    missing = {"pc", "explainedVariance"} - set(data)
    if missing:
        raise KeyError(f"model arrays lack {sorted(missing)}")
    if ("mean" in data) != ("std" in data):
        raise KeyError("model arrays must hold both 'mean' and 'std', or neither")
    return model_from_arrays("PCAModel", data, device)


def model_from_arrays(
    model_class: str,
    data: Mapping[str, np.ndarray],
    device: str | torch.device = "cuda",
    params: Mapping[str, Any] | None = None,
) -> Any:
    """The port's ``model_class`` holding ``data`` (the JAX model's
    ``_saveData()``), with ``params`` set."""
    model = port_class(model_class)._fromSaved(
        None, {k: np.asarray(v) for k, v in data.items()}, device
    )
    if params:
        model._set(**params)
    return model


def incremental_from_state(
    estimator_class: str,
    arrays: Mapping[str, np.ndarray],
    state: Mapping[str, Any],
    device: str | torch.device = "cuda",
    params: Mapping[str, Any] | None = None,
) -> Any:
    """The port's ``estimator_class`` with ``params`` set, holding the
    running statistic of the JAX estimator's ``to_state()``: its next
    ``partial_fit`` continues the stream."""
    est = port_class(estimator_class)(device=device)
    if params:
        est._set(**params)
    return est.from_state({k: np.asarray(v) for k, v in arrays.items()}, dict(state))


def pipeline_model_from_arrays(
    stages: Sequence[Mapping[str, Any]], device: str | torch.device = "cuda"
) -> PipelineModel:
    """A ``PipelineModel`` of the stages ``[{"class": ..., "data": ...,
    "params": ...}, ...]`` (``data`` and ``params`` may be left out)."""
    return PipelineModel(stages=[
        model_from_arrays(s["class"], s.get("data", {}), device, s.get("params"))
        for s in stages
    ])


def one_vs_rest_model_from_arrays(
    models: Sequence[Mapping[str, Any]], device: str | torch.device = "cuda",
    params: Mapping[str, Any] | None = None,
) -> OneVsRestModel:
    """A ``OneVsRestModel`` of the class models ``[{"class": ..., "data":
    ..., "params": ...}, ...]`` in class order, with its own ``params``."""
    model = OneVsRestModel(models=[
        model_from_arrays(m["class"], m.get("data", {}), device, m.get("params"))
        for m in models
    ])
    if params:
        model._set(**params)
    return model
