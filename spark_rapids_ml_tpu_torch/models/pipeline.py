"""Pipeline: chained stages, Spark ML's shape.

Port of ``spark_rapids_ml_tpu/models/pipeline.py``, the end-to-end form of
BASELINE config 4: ``Pipeline(stages=[StandardScaler(...), PCA(...)])``
fits the preprocessing and the decomposition as one unit and transforms
through them in order. Each stage runs on its own device. Both save in the
JAX package's native layout: metadata with ``numStages`` and one numbered
subdirectory per stage (``stage_0``, ``stage_1``, ...).
"""

from __future__ import annotations

from typing import Any

import torch

from spark_rapids_ml_tpu_torch.models.base import Estimator, Model, Saveable, Transformer
from spark_rapids_ml_tpu_torch.utils import persistence


def _save_stages(self, path: str, overwrite: bool = False, layout: str = "native") -> None:
    """The numbered-subdirectory layout of a pipeline and its model."""
    if layout != "native":
        raise ValueError("pipelines support only the native layout")
    fs = persistence._FS(path)
    if fs.exists():
        if not overwrite:
            raise FileExistsError(
                f"{path} already exists (use overwrite=True or write().overwrite())"
            )
        fs.rmtree()
    persistence.save_metadata(path, self, extra={"numStages": len(self.stages)})
    for i, stage in enumerate(self.stages):
        stage.save(fs.join(f"stage_{i}"))


def _load_stages(cls, path: str, meta: dict, device: str | torch.device):
    fs = persistence._FS(path)
    stages = [Saveable.load(fs.join(f"stage_{i}"), device=device)
              for i in range(meta["numStages"])]
    return cls(uid=meta["uid"], stages=stages)


class Pipeline(Estimator):
    def __init__(self, uid: str | None = None, stages: list | None = None):
        super().__init__(uid)
        self.stages = list(stages or [])

    def setStages(self, stages: list) -> "Pipeline":
        self.stages = list(stages)
        return self

    def getStages(self) -> list:
        return self.stages

    def fit(self, dataset: Any) -> "PipelineModel":
        """Fit the estimator stages in order, transforming the running
        dataset through each fitted model (Spark's Pipeline semantics)."""
        fitted = []
        current = dataset
        for stage in self.stages:
            if isinstance(stage, Estimator):
                model = stage.fit(current)
                fitted.append(model)
                current = model.transform(current)
            elif isinstance(stage, Transformer):
                fitted.append(stage)
                current = stage.transform(current)
            else:
                raise TypeError(f"pipeline stage {stage!r} is not a stage")
        return PipelineModel(uid=self.uid, stages=fitted)

    save = _save_stages
    _loadNative = classmethod(_load_stages)


class PipelineModel(Model):
    def __init__(self, uid: str | None = None, stages: list | None = None):
        super().__init__(uid)
        self.stages = list(stages or [])

    def transform(self, dataset: Any) -> Any:
        current = dataset
        for stage in self.stages:
            current = stage.transform(current)
        return current

    save = _save_stages
    _loadNative = classmethod(_load_stages)
