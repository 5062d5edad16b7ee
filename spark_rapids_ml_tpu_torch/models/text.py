"""Text features of the port: Tokenizer, HashingTF, IDF.

Counterpart of ``spark_rapids_ml_tpu/models/text.py``, with the same
params, defaults, divergences from Spark and saves:

- Tokenizer lowercases and splits on runs of whitespace (Spark's
  ``split("\\s")`` would emit empty tokens between consecutive
  separators);
- HashingTF maps each term to ``numFeatures`` buckets by the JAX package's
  md5-derived hash (not Spark's Murmur3), bit for bit, and counts terms (or
  flags them, ``binary``) in a dense float64 matrix, refusing one above
  ``_MAX_DENSE_BYTES`` (2 GiB);
- IDF fits Spark's ``log((m + 1) / (df + 1))`` from the document
  frequencies, with ``minDocFreq`` zeroing rare terms.

Host work by design, in both packages: hashing strings and counting them
is numpy's, whose matrix feeds the estimators that run on the card. These
stages take no ``device``. HashingTF hashes each distinct term once per
call and scatters the counts with one ``np.add.at`` (flags with one
assignment), which gives the JAX loop's matrix exactly: the counts are
small integers, exact in float64 in any order.
"""

from __future__ import annotations

import hashlib
from typing import Any

import numpy as np

from spark_rapids_ml_tpu_torch.models.base import Estimator, Model, Transformer
from spark_rapids_ml_tpu_torch.models.params import HasInputCol, HasOutputCol, Param
from spark_rapids_ml_tpu_torch.utils import columnar


def _string_column(dataset: Any, col: str) -> list:
    """The raw values of a string or token column. A container of named
    columns hands over its values as they are, so documents of different
    token counts pass (the JAX package stacks a pandas token column into a
    matrix and refuses them)."""
    if columnar.pa is not None and isinstance(dataset, (columnar.pa.Table, columnar.pa.RecordBatch)):
        return dataset.column(col).to_pylist()
    if columnar.has_named_columns(dataset):
        return list(dataset[col].to_numpy())
    return list(columnar.extract_column_values(dataset, col))


def _bucket(term: str, num_features: int) -> int:
    """Stable non-negative term bucket (md5-derived — deterministic across
    processes and Python runs, unlike built-in str hashing)."""
    digest = hashlib.md5(term.encode("utf-8")).digest()
    return int.from_bytes(digest[:8], "little") % num_features


class Tokenizer(HasInputCol, HasOutputCol, Transformer):
    """Lowercase + whitespace split (pyspark.ml.feature.Tokenizer)."""

    def __init__(self, uid: str | None = None, **kwargs):
        super().__init__(uid, **kwargs)
        self._setDefault(outputCol="tokens")

    def transform(self, dataset: Any) -> Any:
        texts = _string_column(dataset, self.getOrDefault("inputCol"))
        tokens = [str(t).lower().split() for t in texts]
        return columnar.append_columns(
            dataset, [(self.getOutputCol(), np.asarray(tokens, dtype=object))]
        )


class HashingTF(HasInputCol, HasOutputCol, Transformer):
    numFeatures = Param("numFeatures", "hash bucket count", int)
    binary = Param(
        "binary", "presence flags instead of term counts", bool
    )

    #: dense-output guard: reject transforms whose [docs, numFeatures]
    #: float64 matrix would exceed this (the columnar layer is dense —
    #: Spark's sparse vectors don't pay this; lower numFeatures instead)
    _MAX_DENSE_BYTES = 2 << 30

    def __init__(self, uid: str | None = None, **kwargs):
        super().__init__(uid, **kwargs)
        self._setDefault(
            numFeatures=1 << 18, binary=False, outputCol="tf_features"
        )

    def setNumFeatures(self, value: int) -> "HashingTF":
        if value < 1:
            raise ValueError(f"numFeatures must be >= 1, got {value}")
        return self._set(numFeatures=value)

    def getNumFeatures(self) -> int:
        return self.getOrDefault("numFeatures")

    def setBinary(self, value: bool) -> "HashingTF":
        return self._set(binary=bool(value))

    def transform(self, dataset: Any) -> Any:
        docs = _string_column(dataset, self.getOrDefault("inputCol"))
        nf = self.getNumFeatures()
        binary = self.getOrDefault("binary")
        need = len(docs) * nf * 8
        if need > self._MAX_DENSE_BYTES:
            raise ValueError(
                f"HashingTF dense output would be {need / 2**30:.1f} GiB "
                f"({len(docs)} docs x numFeatures={nf}); this package's "
                "columnar layer is dense — lower setNumFeatures (e.g. "
                "1<<14) for large corpora"
            )
        out = np.zeros((len(docs), nf), dtype=np.float64)
        buckets: dict[str, int] = {}
        rows: list[int] = []
        cols: list[int] = []
        for i, doc in enumerate(docs):
            if isinstance(doc, str):
                raise TypeError(
                    f"HashingTF input column holds raw strings, not token "
                    f"arrays — run Tokenizer first (got {doc[:30]!r})"
                )
            for term in doc:
                term = str(term)
                j = buckets.get(term)
                if j is None:
                    j = buckets[term] = _bucket(term, nf)
                cols.append(j)
            rows.extend([i] * (len(cols) - len(rows)))
        if binary:
            out[rows, cols] = 1.0
        else:
            np.add.at(out, (np.asarray(rows, dtype=np.intp), np.asarray(cols, dtype=np.intp)), 1.0)
        return columnar.append_columns(dataset, [(self.getOutputCol(), out)])


class IDF(HasInputCol, HasOutputCol, Estimator):
    minDocFreq = Param(
        "minDocFreq", "terms in fewer documents get IDF 0 (Spark)", int
    )

    def __init__(self, uid: str | None = None, **kwargs):
        super().__init__(uid, **kwargs)
        self._setDefault(minDocFreq=0, outputCol="tfidf_features")

    def setMinDocFreq(self, value: int) -> "IDF":
        if value < 0:
            raise ValueError(f"minDocFreq must be >= 0, got {value}")
        return self._set(minDocFreq=value)

    def fit(self, dataset: Any, num_partitions: int | None = None) -> "IDFModel":
        ds = columnar.PartitionedDataset.from_any(
            dataset, self._paramMap.get("inputCol"), num_partitions
        )
        # document-frequency monoid: per-partition presence-count sums
        df = None
        n_docs = 0
        for mat in ds.matrices():
            part = (mat > 0).sum(axis=0).astype(np.float64)
            df = part if df is None else df + part
            n_docs += mat.shape[0]
        idf = np.log((n_docs + 1.0) / (df + 1.0))  # Spark's exact formula
        idf = np.where(df >= self.getOrDefault("minDocFreq"), idf, 0.0)
        model = IDFModel(uid=self.uid, idf=idf, docFreq=df, numDocs=n_docs)
        return self._copyValues(model)


class IDFModel(HasInputCol, HasOutputCol, Model):
    minDocFreq = IDF.minDocFreq

    def __init__(
        self,
        uid: str | None = None,
        idf: np.ndarray | None = None,
        docFreq: np.ndarray | None = None,
        numDocs: int = 0,
    ):
        super().__init__(uid)
        self.idf = None if idf is None else np.asarray(idf)
        self.docFreq = None if docFreq is None else np.asarray(docFreq)
        self.numDocs = int(numDocs)
        self._setDefault(minDocFreq=0, outputCol="tfidf_features")

    def _scale(self, mat: np.ndarray) -> np.ndarray:
        if mat.shape[1] != self.idf.shape[0]:
            raise ValueError(
                f"input has {mat.shape[1]} features but the model was "
                f"fitted on {self.idf.shape[0]}"
            )
        return mat * self.idf[None, :]

    def transform(self, dataset: Any) -> Any:
        return columnar.apply_column_transform(
            dataset,
            self._paramMap.get("inputCol"),
            self.getOutputCol(),
            self._scale,
        )

    def _saveData(self) -> dict[str, np.ndarray]:
        return {
            "idf": self.idf,
            "docFreq": self.docFreq,
            "numDocs": np.asarray([self.numDocs]),
        }

    @classmethod
    def _fromSaved(cls, uid, data, device=None):
        return cls(
            uid=uid, idf=data["idf"], docFreq=data["docFreq"],
            numDocs=int(data["numDocs"][0]),
        )
