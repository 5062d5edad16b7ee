"""Estimator / Model bases of the port, with save and load.

Counterpart of ``spark_rapids_ml_tpu/models/base.py`` without its fit and
transform telemetry. Persistence writes the JAX package's two layouts
(``utils/persistence.py``): the native ``metadata.json`` + ``data.parquet``
and ``layout="spark"``, stock Spark ML's shape. ``load`` tells them apart.

What crosses between the packages:

- a JAX-package save loads here in either layout. A native save names its
  class, and a ``spark_rapids_ml_tpu.*`` name resolves to the port's
  counterpart through ``_JAX_CLASSES``; that module is never imported;
- a Spark-layout save of the port loads in the JAX package and in Spark;
- a native save of the port does not load in the JAX package, whose load
  admits only its own classes; its ``data.parquet`` reads there all the
  same (``load_arrays``).

Loading runs on the host; the loaded stage runs on ``device`` (default
``"cuda"``), as every entry point of the port does.
"""

from __future__ import annotations

import importlib
from typing import Any

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.models.params import Params
from spark_rapids_ml_tpu_torch.utils import persistence

_PCA_MODULE = "spark_rapids_ml_tpu_torch.models.pca"

# Stock Spark ML class name -> the port's class, for Spark-layout saves.
_SPARK_ML_CLASSES: dict[str, str] = {
    "org.apache.spark.ml.feature.PCAModel": f"{_PCA_MODULE}.PCAModel",
}

# A JAX-package class recorded in a native save -> the port's counterpart.
_JAX_PACKAGE = "spark_rapids_ml_tpu"
_JAX_CLASSES: dict[str, str] = {
    "spark_rapids_ml_tpu.models.pca.PCA": f"{_PCA_MODULE}.PCA",
    "spark_rapids_ml_tpu.models.pca.PCAModel": f"{_PCA_MODULE}.PCAModel",
}


def _import_class(name: str):
    module, _, qualname = name.rpartition(".")
    return getattr(importlib.import_module(module), qualname)


def _native_class(recorded: str, path: str):
    """The class a native save names: a JAX-package name through
    ``_JAX_CLASSES`` (never imported), any other name imported as the JAX
    package's loader does."""
    if recorded.split(".", 1)[0] == _JAX_PACKAGE:
        target = _JAX_CLASSES.get(recorded)
        if target is None:
            raise TypeError(
                f"{path} holds a JAX-package {recorded!r}, which has no "
                f"counterpart in the port yet (ported: {sorted(_JAX_CLASSES)})"
            )
        return _import_class(target)
    return _import_class(recorded)


def _resolve_load_class(cls, klass, path: str):
    """The load-time class policy of both layouts: the recorded (or mapped)
    class wins when it satisfies the caller; a caller that is a subclass of
    it upgrades the load; anything else is a mismatch. ``Saveable`` itself
    accepts everything."""
    if cls is Saveable or issubclass(klass, cls):
        return klass
    if issubclass(cls, klass):
        return cls
    raise TypeError(f"{path} holds a {klass.__name__}, not a {cls.__name__}")


class MLWriter:
    """Spark-style fluent writer: ``model.write().overwrite().save(path)``,
    and ``model.write().format("spark").save(path)`` for the Spark layout."""

    def __init__(self, instance: "Saveable"):
        self._instance = instance
        self._overwrite = False
        self._layout = "native"

    def overwrite(self) -> "MLWriter":
        self._overwrite = True
        return self

    def format(self, layout: str) -> "MLWriter":
        if layout not in ("native", "spark"):
            raise ValueError("format must be 'native' or 'spark'")
        self._layout = layout
        return self

    def save(self, path: str) -> None:
        self._instance.save(path, overwrite=self._overwrite, layout=self._layout)


class Saveable(Params):
    """DefaultParamsWritable/Readable analog. Models override
    ``_saveData``/``_fromSaved`` for their arrays, and
    ``_saveSparkML``/``_fromSparkML`` where stock Spark ML has a twin."""

    def save(self, path: str, overwrite: bool = False, layout: str = "native") -> None:
        # everything is checked before the filesystem is touched: an
        # overwrite never deletes the old save and then fails to write
        if layout not in ("native", "spark"):
            raise ValueError("layout must be 'native' or 'spark'")
        if layout == "spark" and type(self)._saveSparkML is Saveable._saveSparkML:
            raise NotImplementedError(
                f"{type(self).__name__} has no stock Spark ML twin; use the native layout"
            )
        if layout == "spark":
            self._checkSparkML()
        data = self._saveData() if layout == "native" else {}
        if layout == "spark" or data:
            persistence._require_pyarrow()
        fs = persistence._FS(path)
        if fs.exists():
            if not overwrite:
                raise FileExistsError(
                    f"{path} already exists (use overwrite=True or write().overwrite())"
                )
            fs.rmtree()
        if layout == "spark":
            self._saveSparkML(path)
            return
        persistence.save_metadata(path, self)
        if data:
            persistence.save_arrays(path, data)

    def write(self) -> MLWriter:
        return MLWriter(self)

    def _saveData(self) -> dict[str, np.ndarray]:
        return {}

    def _checkSparkML(self) -> None:
        """Raise where this instance's state has no Spark ML form."""

    def _saveSparkML(self, path: str) -> None:
        raise NotImplementedError(
            f"{type(self).__name__} has no stock Spark ML twin; use the native layout"
        )

    @classmethod
    def load(cls, path: str, device: str | torch.device = "cuda") -> Any:
        """The stage saved at ``path``, in either layout, on ``device``."""
        if persistence.is_spark_ml_layout(path):
            return cls._load_spark_layout(path, device)
        meta = persistence.load_metadata(path)
        klass = _resolve_load_class(cls, _native_class(meta["class"], path), path)
        data = {}
        if persistence._FS(path).exists("data.parquet"):
            data = persistence.load_arrays(path)
        instance = klass._fromSaved(meta["uid"], data, device)
        instance._restoreParamState(meta)
        return instance

    @classmethod
    def _load_spark_layout(cls, path: str, device: str | torch.device) -> Any:
        meta = persistence.load_spark_ml_metadata(path)
        spark_class = meta.get("class", "")
        target = _SPARK_ML_CLASSES.get(spark_class)
        if target is None:
            raise TypeError(
                f"{path} holds a Spark ML {spark_class!r} save with no mapped "
                f"implementation here (mapped: {sorted(_SPARK_ML_CLASSES)})"
            )
        klass = _resolve_load_class(cls, _import_class(target), path)
        instance = klass._fromSparkML(meta, persistence.load_spark_ml_data(path), device)
        _restore_spark_params(instance, meta)
        return instance

    @classmethod
    def _fromSaved(cls, uid: str, data: dict[str, np.ndarray], device: str | torch.device):
        return cls(uid=uid, device=device)

    @classmethod
    def _fromSparkML(cls, meta: dict, table, device: str | torch.device) -> Any:
        raise NotImplementedError


def _restore_spark_params(instance: Params, meta: dict) -> None:
    """Apply a Spark-layout metadata's param maps onto ``instance``, keeping
    only the param names it knows (Spark-only params have no effect here)."""
    known = {p.name for p in type(instance).params()}
    for k, v in meta.get("defaultParamMap", {}).items():
        if k in known:
            instance._defaultParamMap[k] = v
    for k, v in meta.get("paramMap", {}).items():
        if k in known:
            instance._paramMap[k] = v


def spark_set_params(instance: Params) -> dict:
    """The explicitly set params of ``instance``, JSON-shaped: what a
    Spark-layout save records in ``paramMap``."""
    return {k: persistence._jsonable(v) for k, v in instance._paramMap.items()}


class Estimator(Saveable):
    def fit(self, dataset: Any) -> "Model":
        raise NotImplementedError


class Model(Saveable):
    def transform(self, dataset: Any) -> Any:
        raise NotImplementedError
