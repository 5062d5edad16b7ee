"""DBSCAN estimator and model of the port, on the card by default.

Counterpart of ``spark_rapids_ml_tpu/models/dbscan.py``: the same params
(``eps``, ``minSamples``, ``metric``, ``predictionCol``, ``weightCol``),
defaults, setters and messages, plus a ``device`` argument (default
``"cuda"``). ``fit`` captures the params (density clustering has no
training phase apart from inference) and ``DBSCANModel.transform(dataset)``
clusters the dataset it is given, appending an integer cluster column (−1 =
noise). The kernels are ``ops/dbscan.py``'s.

Cluster ids go by the smallest member core-row index, relabeled to 0..C−1
in that order, and a border row joins the smallest core neighbour's
cluster, so the output does not depend on partitioning or row order.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.models.base import Estimator, Model
from spark_rapids_ml_tpu_torch.models.params import HasDevice, HasInputCol, Param
from spark_rapids_ml_tpu_torch.ops import dbscan as DB
from spark_rapids_ml_tpu_torch.telemetry import trace_range
from spark_rapids_ml_tpu_torch.utils import columnar
from spark_rapids_ml_tpu_torch.utils.device import block_rows_for, to_device

_METRICS = ("euclidean", "sqeuclidean")


class _DBSCANParams(HasDevice, HasInputCol):
    eps = Param("eps", "neighborhood radius", float)
    minSamples = Param(
        "minSamples",
        "weighted neighbor mass (self included) required for a core point",
        float,
    )
    metric = Param("metric", "'euclidean' (default) or 'sqeuclidean'", str)
    predictionCol = Param("predictionCol", "output cluster-id column", str)
    weightCol = Param(
        "weightCol",
        "optional sample-weight column: a point is core when the WEIGHT SUM "
        "of its eps-neighborhood reaches minSamples; weights gate core "
        "status only, so zero-weight points still receive border labels "
        "(sklearn sample_weight semantics)",
        str,
    )

    def __init__(self, uid: str | None = None, device: str | torch.device = "cuda",
                 **kwargs):
        super().__init__(uid, device=device, **kwargs)
        self._setDefault(
            eps=0.5, minSamples=5.0, metric="euclidean",
            predictionCol="prediction",
        )

    def getEps(self) -> float:
        return self.getOrDefault("eps")

    def getMinSamples(self) -> float:
        return self.getOrDefault("minSamples")

    def getMetric(self) -> str:
        return self.getOrDefault("metric")

    def getPredictionCol(self) -> str:
        return self.getOrDefault("predictionCol")


class DBSCAN(_DBSCANParams, Estimator):
    def setEps(self, value: float) -> "DBSCAN":
        if value <= 0:
            raise ValueError(f"eps must be > 0, got {value}")
        return self._set(eps=float(value))

    def setMinSamples(self, value: float) -> "DBSCAN":
        if value < 1:
            raise ValueError(f"minSamples must be >= 1, got {value}")
        return self._set(minSamples=float(value))

    def setMetric(self, value: str) -> "DBSCAN":
        if value not in _METRICS:
            raise ValueError(f"metric must be one of {_METRICS}, got {value!r}")
        return self._set(metric=value)

    def setPredictionCol(self, value: str) -> "DBSCAN":
        return self._set(predictionCol=value)

    def setWeightCol(self, value: str) -> "DBSCAN":
        return self._set(weightCol=value)

    def fit(self, dataset: Any = None) -> "DBSCANModel":
        """Parameter capture (the clustering itself runs in
        ``DBSCANModel.transform``); ``dataset`` is accepted for the
        Estimator contract and ignored."""
        return self._copyValues(DBSCANModel(uid=self.uid, device=self.device))


class DBSCANModel(_DBSCANParams, Model):
    def _cluster_matrix(self, mat: np.ndarray, weights: np.ndarray | None) -> np.ndarray:
        """The clustering body: eps resolution, the kernel run, the
        consecutive relabel. The threshold is compared in f32, the dtype of
        the rows on the device."""
        eps = self.getEps()
        eps_sq = eps * eps if self.getMetric() == "euclidean" else eps
        labels = self._compute_labels(
            mat, weights, float(np.float32(eps_sq)), float(np.float32(self.getMinSamples()))
        )
        return _relabel_consecutive(labels)

    @staticmethod
    def _pad_inputs(x, weights, pad_to: int):
        """(padded x, weight vector, valid mask) with pad rows at weight 0 /
        valid False."""
        fdt = columnar.float_dtype_for(x.dtype)
        rows = x.shape[0]
        xp = np.zeros((pad_to, x.shape[1]), fdt)
        xp[:rows] = x
        w = np.zeros(pad_to, fdt)
        w[:rows] = 1.0 if weights is None else weights
        valid = np.zeros(pad_to, bool)
        valid[:rows] = True
        return xp, w, valid

    def _compute_labels(self, x, weights, eps_sq: float, min_samples: float) -> np.ndarray:
        """The kernel on the device. The port compiles nothing per shape,
        so the rows go unpadded (``pad_to`` = rows): padding would only add
        quadratic work."""
        device = self.device
        xp, w, valid = self._pad_inputs(x, weights, x.shape[0])
        labels = DB.dbscan_labels(
            to_device(xp, device),
            to_device(w, device),
            torch.from_numpy(valid).to(device),
            eps_sq,
            min_samples,
            block_rows=block_rows_for(device, DB.DEFAULT_BLOCK_ROWS),
        )
        return labels.cpu().numpy()

    def clusterLabels(self, dataset: Any) -> np.ndarray:
        """[rows] int32 cluster ids (−1 = noise) of ``dataset``: the ndarray
        spelling of ``transform``."""
        mat = columnar.extract_matrix(dataset, self._paramMap.get("inputCol"))
        weight_col = self._paramMap.get("weightCol")
        weights = None
        if weight_col is not None:
            weights = columnar.validate_weights(
                columnar.extract_vector(dataset, weight_col), mat.shape[0]
            )
        with trace_range("dbscan cluster", self.device):
            return self._cluster_matrix(mat, weights)

    def transform(self, dataset: Any) -> Any:
        labels = self.clusterLabels(dataset)
        return columnar.append_columns(dataset, [(self.getPredictionCol(), labels)])


def _relabel_consecutive(labels: np.ndarray) -> np.ndarray:
    """Map cluster ids (smallest-core-index values) onto 0..C−1, ascending;
    −1 noise passes through."""
    ids = np.unique(labels[labels >= 0])
    remap = np.full(int(ids.max()) + 1 if len(ids) else 0, -1, dtype=np.int32)
    remap[ids] = np.arange(len(ids), dtype=np.int32)
    out = labels.copy()
    out[labels >= 0] = remap[labels[labels >= 0]]
    return out
