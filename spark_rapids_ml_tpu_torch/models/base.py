"""Minimal Estimator / Model bases of the port.

Counterpart of ``spark_rapids_ml_tpu/models/base.py`` without its fit and
transform telemetry and without persistence: ``save`` and ``load`` raise
until the persistence slice ports them.
"""

from __future__ import annotations

from typing import Any

from spark_rapids_ml_tpu_torch.models.params import Params

_PERSISTENCE_TODO = (
    "save/load is not ported yet (queued as the persistence slice); carry a "
    "model across with spark_rapids_ml_tpu_torch.convert.pca_model_from_arrays"
)


class _Saveable(Params):
    def save(self, path: str, *args, **kwargs) -> None:
        raise NotImplementedError(_PERSISTENCE_TODO)

    @classmethod
    def load(cls, path: str) -> Any:
        raise NotImplementedError(_PERSISTENCE_TODO)


class Estimator(_Saveable):
    def fit(self, dataset: Any) -> "Model":
        raise NotImplementedError


class Model(_Saveable):
    def transform(self, dataset: Any) -> Any:
        raise NotImplementedError
