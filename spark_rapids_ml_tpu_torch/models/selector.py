"""VarianceThresholdSelector: feature selection on the moments monoid.

Port of ``spark_rapids_ml_tpu/models/selector.py`` (Spark 3.1+'s surface:
``featuresCol``/``outputCol``/``varianceThreshold``, default 0.0): keep the
features whose sample variance is strictly above the threshold. The fit is
StandardScaler's moments pass on the device (``ops/scaler.py``); the
transform is a column gather on the host, as in the JAX package.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.models.base import Estimator, Model, spark_set_params
from spark_rapids_ml_tpu_torch.models.params import HasDevice, HasFeaturesCol, HasOutputCol, Param
from spark_rapids_ml_tpu_torch.models.scaler import _moments_with_true_count, _partition_reduce
from spark_rapids_ml_tpu_torch.ops import scaler as S
from spark_rapids_ml_tpu_torch.telemetry import trace_range
from spark_rapids_ml_tpu_torch.utils import columnar
from spark_rapids_ml_tpu_torch.utils import persistence as P


def select_by_variance(variances: np.ndarray, threshold: float) -> np.ndarray:
    """Variances → the sorted indices kept; raises when none survives."""
    selected = np.flatnonzero(variances > threshold).astype(np.int32)
    if len(selected) == 0:
        raise ValueError(
            f"varianceThreshold={threshold} rejects every feature (max "
            f"sample variance {variances.max():.6g}); lower the threshold"
        )
    return selected


class _SelectorParams(HasDevice, HasFeaturesCol, HasOutputCol):
    varianceThreshold = Param(
        "varianceThreshold",
        "keep features with sample variance strictly greater than this",
        float,
    )

    def __init__(self, uid: str | None = None, device: str | torch.device = "cuda", **kwargs):
        super().__init__(uid, device=device, **kwargs)
        self._setDefault(varianceThreshold=0.0, outputCol="selected_features")

    def getVarianceThreshold(self) -> float:
        return self.getOrDefault("varianceThreshold")


class VarianceThresholdSelector(_SelectorParams, Estimator):
    def setVarianceThreshold(self, value: float) -> "VarianceThresholdSelector":
        if value < 0:
            raise ValueError(f"varianceThreshold must be >= 0, got {value}")
        return self._set(varianceThreshold=float(value))

    def setFeaturesCol(self, value: str) -> "VarianceThresholdSelector":
        return self._set(featuresCol=value)

    def fit(
        self, dataset: Any, num_partitions: int | None = None
    ) -> "VarianceThresholdSelectorModel":
        ds = columnar.PartitionedDataset.from_any(
            dataset, self._paramMap.get("featuresCol"), num_partitions
        )
        with trace_range("variance selector fit", self.device):
            stats = _partition_reduce(
                ds, self.device, _moments_with_true_count, S.combine_moment_stats
            )
            _, std = S.finalize_moments(stats)
        selected = select_by_variance(std.cpu().numpy() ** 2, self.getVarianceThreshold())
        model = VarianceThresholdSelectorModel(
            uid=self.uid, selectedFeatures=selected, device=self.device
        )
        return self._copyValues(model)


class VarianceThresholdSelectorModel(_SelectorParams, Model):
    def __init__(
        self,
        uid: str | None = None,
        selectedFeatures: np.ndarray | None = None,
        device: str | torch.device = "cuda",
    ):
        super().__init__(uid, device=device)
        self.selectedFeatures = (
            None if selectedFeatures is None else np.asarray(selectedFeatures, dtype=np.int32)
        )

    def _select(self, mat: np.ndarray) -> np.ndarray:
        return np.ascontiguousarray(mat[:, self.selectedFeatures])

    def transform(self, dataset: Any) -> Any:
        with trace_range("variance selector transform", self.device):
            return columnar.apply_column_transform(
                dataset, self._paramMap.get("featuresCol"), self.getOutputCol(), self._select
            )

    def _saveData(self) -> dict[str, np.ndarray]:
        return {"selectedFeatures": self.selectedFeatures}

    @classmethod
    def _fromSaved(cls, uid, data, device):
        return cls(uid=uid, selectedFeatures=data["selectedFeatures"], device=device)

    # stock Spark persists Row(selectedFeatures: array<int>)
    _SPARK_ML_CLASS = "org.apache.spark.ml.feature.VarianceThresholdSelectorModel"
    _SPARK_ML_PARAMS = ("varianceThreshold", "featuresCol", "outputCol")

    def _saveSparkML(self, path: str) -> None:
        import pyarrow as pa

        params = {k: v for k, v in spark_set_params(self).items() if k in self._SPARK_ML_PARAMS}
        P.save_spark_ml_metadata(
            path, class_name=self._SPARK_ML_CLASS, uid=self.uid, param_map=params
        )
        P.save_spark_ml_data(
            path,
            {"selectedFeatures": pa.array([self.selectedFeatures.tolist()],
                                          pa.list_(pa.int32()))},
            {
                "type": "struct",
                "fields": [{
                    "name": "selectedFeatures",
                    "type": {"type": "array", "elementType": "integer", "containsNull": False},
                    "nullable": True,
                    "metadata": {},
                }],
            },
        )

    @classmethod
    def _fromSparkML(cls, meta: dict, table, device) -> "VarianceThresholdSelectorModel":
        return cls(
            uid=meta["uid"],
            selectedFeatures=np.asarray(table.column("selectedFeatures")[0].as_py(),
                                        dtype=np.int32),
            device=device,
        )
