"""A Spark-ML-shaped Params system.

Copy of ``Param``, ``Params``, ``HasInputCol``, ``HasOutputCol``,
``HasFeaturesCol``, ``HasLabelCol`` and ``HasPredictionCol`` from
``spark_rapids_ml_tpu/models/params.py``: typed
params with defaults, fluent setters, constructor keyword params
(``PCA(k=3)`` is ``PCA().setK(3)``), ``copy`` that keeps the uid, and the
param state that a save records. ``HasDevice`` is the port's own: the
device a stage computes on, an attribute and not a param, so a save does
not record it.
"""

from __future__ import annotations

import copy as _copy
import uuid
from typing import Any, Callable, Generic, TypeVar

import torch

from spark_rapids_ml_tpu_torch.utils.device import resolve_device

T = TypeVar("T")


class Param(Generic[T]):
    """A typed parameter descriptor owned by a Params class."""

    def __init__(self, name: str, doc: str, convert: Callable[[Any], T] | None = None):
        self.name = name
        self.doc = doc
        self.convert = convert

    def __repr__(self):
        return f"Param({self.name})"


class _ParamsMeta(type):
    """Applies constructor param kwargs after the whole ``__init__`` chain,
    so setters see every subclass default."""

    def __call__(cls, *args, **kwargs):
        obj = super().__call__(*args, **kwargs)
        pending = obj.__dict__.pop("_pendingCtorKwargs", None)
        if pending:
            obj._applyCtorKwargs(pending)
        return obj


class Params(metaclass=_ParamsMeta):
    """A param map and a default map keyed by param name; set values shadow
    defaults."""

    def __init__(self, uid: str | None = None, **kwargs):
        self.uid = uid or f"{type(self).__name__}_{uuid.uuid4().hex[:12]}"
        self._paramMap: dict[str, Any] = {}
        self._defaultParamMap: dict[str, Any] = {}
        self._pendingCtorKwargs = kwargs

    def _applyCtorKwargs(self, kwargs: dict[str, Any]) -> None:
        # through the fluent setter where there is one, so its validation
        # holds for both spellings; None leaves the param unset
        for name, value in kwargs.items():
            if value is None:
                continue
            self._param(name)  # unknown params raise KeyError
            setter = getattr(self, f"set{name[0].upper()}{name[1:]}", None)
            if callable(setter):
                setter(value)
            else:
                self._set(**{name: value})

    @classmethod
    def params(cls) -> list[Param]:
        out = []
        for klass in cls.__mro__:
            for v in vars(klass).values():
                if isinstance(v, Param) and v not in out:
                    out.append(v)
        return out

    def _param(self, name: str) -> Param:
        for p in type(self).params():
            if p.name == name:
                return p
        raise KeyError(f"{type(self).__name__} has no param {name!r}")

    def _set(self, **kwargs) -> "Params":
        for name, value in kwargs.items():
            p = self._param(name)
            if value is not None and p.convert is not None:
                value = p.convert(value)
            self._paramMap[name] = value
        return self

    def _setDefault(self, **kwargs) -> "Params":
        self._defaultParamMap.update(kwargs)
        return self

    def isSet(self, name: str) -> bool:
        return name in self._paramMap

    def hasDefault(self, name: str) -> bool:
        return name in self._defaultParamMap

    def getOrDefault(self, name: str) -> Any:
        if name in self._paramMap:
            return self._paramMap[name]
        if name in self._defaultParamMap:
            return self._defaultParamMap[name]
        raise KeyError(f"param {name!r} is not set and has no default")

    def copy(self) -> "Params":
        other = _copy.copy(self)
        other._paramMap = dict(self._paramMap)
        other._defaultParamMap = dict(self._defaultParamMap)
        return other

    def _copyValues(self, to: "Params") -> "Params":
        """Propagate this instance's set params onto ``to`` (estimator →
        model)."""
        for p in type(to).params():
            if p.name in self._paramMap:
                to._paramMap[p.name] = self._paramMap[p.name]
        return to

    def explainParams(self) -> str:
        lines = []
        for p in type(self).params():
            cur = self._paramMap.get(p.name, self._defaultParamMap.get(p.name))
            lines.append(f"{p.name}: {p.doc} (current: {cur})")
        return "\n".join(lines)

    # -- persistence hooks (see utils.persistence) --------------------------
    def _paramState(self) -> dict:
        return {"paramMap": dict(self._paramMap), "defaultParamMap": dict(self._defaultParamMap)}

    def _restoreParamState(self, state: dict) -> None:
        self._paramMap.update(state.get("paramMap", {}))
        self._defaultParamMap.update(state.get("defaultParamMap", {}))


class HasInputCol(Params):
    inputCol = Param("inputCol", "name of the input ArrayType column", str)

    def setInputCol(self, value: str):
        return self._set(inputCol=value)

    def getInputCol(self) -> str:
        return self.getOrDefault("inputCol")


class HasOutputCol(Params):
    outputCol = Param("outputCol", "name of the output column", str)

    def setOutputCol(self, value: str):
        return self._set(outputCol=value)

    def getOutputCol(self) -> str:
        return self.getOrDefault("outputCol")


class HasFeaturesCol(Params):
    featuresCol = Param("featuresCol", "name of the features ArrayType column", str)

    def setFeaturesCol(self, value: str):
        return self._set(featuresCol=value)

    def getFeaturesCol(self) -> str:
        return self.getOrDefault("featuresCol")


class HasLabelCol(Params):
    labelCol = Param("labelCol", "name of the scalar label column", str)

    def setLabelCol(self, value: str):
        return self._set(labelCol=value)

    def getLabelCol(self) -> str:
        return self.getOrDefault("labelCol")


class HasPredictionCol(Params):
    predictionCol = Param("predictionCol", "name of the prediction output column", str)

    def setPredictionCol(self, value: str):
        return self._set(predictionCol=value)

    def getPredictionCol(self) -> str:
        return self.getOrDefault("predictionCol")


class HasDevice(Params):
    """A stage that computes on ``device`` (default the card; raises
    without one unless the CPU is named)."""

    def __init__(self, uid: str | None = None, device: str | torch.device = "cuda", **kwargs):
        super().__init__(uid, **kwargs)
        self.device = resolve_device(device)
