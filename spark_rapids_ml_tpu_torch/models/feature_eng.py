"""Column-level feature engineering of the port: VectorAssembler,
StringIndexer, OneHotEncoder and IndexToString.

Counterpart of ``spark_rapids_ml_tpu/models/feature_eng.py``, with the same
params, defaults, Spark semantics and saves:

- VectorAssembler concatenates scalar and array columns in order;
  ``handleInvalid`` 'error' (default) raises on NaN, 'keep' passes it;
- StringIndexer orders labels by ``stringOrderType``: frequencyDesc
  (default, ties broken alphabetically, Spark's rule), frequencyAsc,
  alphabetAsc or alphabetDesc; its model's ``handleInvalid`` 'keep' maps
  an unseen label to numLabels;
- OneHotEncoder learns each category size at fit; its model writes
  one-hot rows with ``dropLast`` (default True);
- IndexToString maps an index column back to labels.

These stages are host work by design, in both packages: string tables and
index arithmetic in numpy, whose output feeds the estimators that run on
the card. They take no ``device`` and never touch the card. Columns come
through ``utils/columnar.py::extract_column_values`` and go out through
``append_columns``, so any container of that module's column protocol
works, pandas or not.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from spark_rapids_ml_tpu_torch.models.base import Estimator, Model, Transformer
from spark_rapids_ml_tpu_torch.models.params import HasInputCol, HasOutputCol, Param
from spark_rapids_ml_tpu_torch.utils import columnar

_column_values = columnar.extract_column_values


class VectorAssembler(HasOutputCol, Transformer):
    inputCols = Param("inputCols", "columns to concatenate, in order", list)
    handleInvalid = Param(
        "handleInvalid", "'error' (default) or 'keep' for NaN values", str
    )

    def __init__(self, uid: str | None = None, **kwargs):
        super().__init__(uid, **kwargs)
        self._setDefault(outputCol="features", handleInvalid="error")

    def setInputCols(self, value) -> "VectorAssembler":
        return self._set(inputCols=list(value))

    def getInputCols(self) -> list:
        return self.getOrDefault("inputCols")

    def setHandleInvalid(self, value: str) -> "VectorAssembler":
        if value not in ("error", "keep"):
            raise ValueError(
                f"handleInvalid must be 'error' or 'keep', got {value!r}"
            )
        return self._set(handleInvalid=value)

    def transform(self, dataset: Any) -> Any:
        cols = self.getInputCols()
        pieces = []
        for c in cols:
            v = _column_values(dataset, c)
            v = np.asarray(v, dtype=np.float64)
            pieces.append(v[:, None] if v.ndim == 1 else v)
        out = np.concatenate(pieces, axis=1)
        # Spark errors on NaN (null) only — Infinity is a legal Double
        if self.getOrDefault("handleInvalid") == "error" and np.isnan(
            out
        ).any():
            bad = [c for c, p in zip(cols, pieces) if np.isnan(p).any()]
            raise ValueError(
                f"VectorAssembler found NaN in columns {bad}; set "
                "handleInvalid='keep' to pass them through"
            )
        return columnar.append_columns(dataset, [(self.getOutputCol(), out)])


class StringIndexer(HasInputCol, HasOutputCol, Estimator):
    stringOrderType = Param(
        "stringOrderType",
        "'frequencyDesc' (default; ties alphabetical — Spark's rule), "
        "'frequencyAsc', 'alphabetAsc', or 'alphabetDesc'",
        str,
    )
    handleInvalid = Param(
        "handleInvalid",
        "'error' (default) or 'keep' (unseen labels → index numLabels)",
        str,
    )

    _ORDERS = ("frequencyDesc", "frequencyAsc", "alphabetAsc", "alphabetDesc")

    def __init__(self, uid: str | None = None, **kwargs):
        super().__init__(uid, **kwargs)
        self._setDefault(
            stringOrderType="frequencyDesc", handleInvalid="error"
        )

    def setStringOrderType(self, value: str) -> "StringIndexer":
        if value not in self._ORDERS:
            raise ValueError(
                f"stringOrderType must be one of {self._ORDERS}, got {value!r}"
            )
        return self._set(stringOrderType=value)

    def setHandleInvalid(self, value: str) -> "StringIndexer":
        if value not in ("error", "keep"):
            raise ValueError(
                f"handleInvalid must be 'error' or 'keep', got {value!r}"
            )
        return self._set(handleInvalid=value)

    def fit(self, dataset: Any) -> "StringIndexerModel":
        values = _column_values(dataset, self.getOrDefault("inputCol"))
        strings = np.asarray([str(v) for v in values])
        uniq, counts = np.unique(strings, return_counts=True)
        order = self.getOrDefault("stringOrderType")
        if order == "frequencyDesc":
            # np.lexsort: last key is primary — frequency desc, ties by
            # value ascending (Spark's tie rule)
            idx = np.lexsort((uniq, -counts))
        elif order == "frequencyAsc":
            idx = np.lexsort((uniq, counts))
        elif order == "alphabetAsc":
            idx = np.argsort(uniq)
        else:  # alphabetDesc
            idx = np.argsort(uniq)[::-1]
        model = StringIndexerModel(uid=self.uid, labels=list(uniq[idx]))
        return self._copyValues(model)


class StringIndexerModel(HasInputCol, HasOutputCol, Model):
    stringOrderType = StringIndexer.stringOrderType
    handleInvalid = StringIndexer.handleInvalid

    def __init__(self, uid: str | None = None, labels: list | None = None):
        super().__init__(uid)
        self.labels = list(labels or [])
        self._setDefault(
            stringOrderType="frequencyDesc", handleInvalid="error"
        )

    def setHandleInvalid(self, value: str) -> "StringIndexerModel":
        if value not in ("error", "keep"):
            raise ValueError(
                f"handleInvalid must be 'error' or 'keep', got {value!r}"
            )
        return self._set(handleInvalid=value)

    def transform(self, dataset: Any) -> Any:
        values = _column_values(dataset, self.getOrDefault("inputCol"))
        strings = np.asarray([str(v) for v in values])
        # vectorized lookup: searchsorted over the sorted label table (the
        # transform hot path stays free of per-row Python dict probing)
        labels = np.asarray(self.labels)
        sort_idx = np.argsort(labels)
        sorted_labels = labels[sort_idx]
        pos = np.searchsorted(sorted_labels, strings)
        pos_c = np.clip(pos, 0, len(labels) - 1)
        found = sorted_labels[pos_c] == strings
        if len(labels) == 0:
            found = np.zeros(len(strings), dtype=bool)
        if not found.all():
            if self.getOrDefault("handleInvalid") != "keep":
                bad = str(strings[~found][0])
                raise ValueError(
                    f"StringIndexer met unseen label {bad!r}; set "
                    "handleInvalid='keep' to index it as numLabels"
                )
        out = np.where(
            found,
            sort_idx[pos_c].astype(np.float64),
            float(len(labels)),
        )
        return columnar.append_columns(dataset, [(self.getOutputCol(), out)])

    def _saveData(self) -> dict[str, np.ndarray]:
        # explicit UTF-8: numpy's U->S cast is ASCII-only and would raise
        # mid-save (after the base layer already cleared an overwrite)
        return {
            "labels": np.asarray(
                [lab.encode("utf-8") for lab in self.labels], dtype=object
            ).astype("S")
        }

    @classmethod
    def _fromSaved(cls, uid, data, device=None):
        return cls(
            uid=uid,
            labels=[v.decode("utf-8") for v in data["labels"].tolist()],
        )


class OneHotEncoder(HasInputCol, HasOutputCol, Estimator):
    dropLast = Param(
        "dropLast", "drop the last category (Spark's default)", bool
    )
    handleInvalid = Param(
        "handleInvalid",
        "'error' (default) or 'keep' (out-of-range → all-zero / extra slot)",
        str,
    )

    def __init__(self, uid: str | None = None, **kwargs):
        super().__init__(uid, **kwargs)
        self._setDefault(dropLast=True, handleInvalid="error")

    def setDropLast(self, value: bool) -> "OneHotEncoder":
        return self._set(dropLast=bool(value))

    def setHandleInvalid(self, value: str) -> "OneHotEncoder":
        if value not in ("error", "keep"):
            raise ValueError(
                f"handleInvalid must be 'error' or 'keep', got {value!r}"
            )
        return self._set(handleInvalid=value)

    def fit(self, dataset: Any) -> "OneHotEncoderModel":
        v = np.asarray(
            _column_values(dataset, self.getOrDefault("inputCol")),
            dtype=np.float64,
        )
        if (v < 0).any() or not np.all(v == np.round(v)):
            raise ValueError(
                "OneHotEncoder requires non-negative integer indices"
            )
        model = OneHotEncoderModel(
            uid=self.uid, categorySize=int(v.max()) + 1
        )
        return self._copyValues(model)


class OneHotEncoderModel(HasInputCol, HasOutputCol, Model):
    dropLast = OneHotEncoder.dropLast
    handleInvalid = OneHotEncoder.handleInvalid

    def __init__(self, uid: str | None = None, categorySize: int = 0):
        super().__init__(uid)
        self.categorySize = int(categorySize)
        self._setDefault(dropLast=True, handleInvalid="error")

    def setDropLast(self, value: bool) -> "OneHotEncoderModel":
        return self._set(dropLast=bool(value))

    def setHandleInvalid(self, value: str) -> "OneHotEncoderModel":
        if value not in ("error", "keep"):
            raise ValueError(
                f"handleInvalid must be 'error' or 'keep', got {value!r}"
            )
        return self._set(handleInvalid=value)

    def transform(self, dataset: Any) -> Any:
        v = np.asarray(
            _column_values(dataset, self.getOrDefault("inputCol")),
            dtype=np.float64,
        ).astype(np.int64)
        keep = self.getOrDefault("handleInvalid") == "keep"
        size = self.categorySize + (1 if keep else 0)
        width = size - (1 if self.getOrDefault("dropLast") else 0)
        if not keep and ((v < 0) | (v >= self.categorySize)).any():
            raise ValueError(
                f"OneHotEncoder met index outside [0, {self.categorySize}); "
                "set handleInvalid='keep' to map it to the extra slot"
            )
        v = np.where((v < 0) | (v >= self.categorySize), self.categorySize, v)
        out = np.zeros((len(v), width), dtype=np.float64)
        in_range = v < width
        out[np.flatnonzero(in_range), v[in_range]] = 1.0
        return columnar.append_columns(dataset, [(self.getOutputCol(), out)])

    def _saveData(self) -> dict[str, np.ndarray]:
        return {"categorySize": np.asarray([self.categorySize])}

    @classmethod
    def _fromSaved(cls, uid, data, device=None):
        return cls(uid=uid, categorySize=int(data["categorySize"][0]))


class IndexToString(HasInputCol, HasOutputCol, Transformer):
    """The StringIndexer inverse (pyspark.ml.feature.IndexToString): map a
    numeric index column back to labels — typically a model's prediction
    column back to the original categories."""

    labels = Param("labels", "index → label table (required)", list)

    def setLabels(self, value) -> "IndexToString":
        value = [str(v) for v in value]
        if not value:
            raise ValueError("labels must be non-empty")
        return self._set(labels=value)

    def getLabels(self) -> list:
        return self.getOrDefault("labels")

    def transform(self, dataset: Any) -> Any:
        if "labels" not in self._paramMap:
            raise ValueError("setLabels([...]) before transform")
        labels = np.asarray(self.getLabels())
        idx = np.asarray(
            _column_values(dataset, self.getOrDefault("inputCol")),
            dtype=np.float64,
        ).astype(np.int64)
        if ((idx < 0) | (idx >= len(labels))).any():
            bad = int(idx[(idx < 0) | (idx >= len(labels))][0])
            raise ValueError(
                f"index {bad} outside the label table of size {len(labels)}"
            )
        return columnar.append_columns(
            dataset, [(self.getOutputCol(), labels[idx])]
        )
