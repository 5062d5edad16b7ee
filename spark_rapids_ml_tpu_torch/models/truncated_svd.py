"""TruncatedSVD of the port: the top-k SVD of the uncentered rows, on the
card by default.

Counterpart of ``spark_rapids_ml_tpu/models/truncated_svd.py``: the same
params, setters, defaults and messages, plus a ``device`` argument (default
``"cuda"``). The model carries ``components`` [n, k] and the singular
values σᵢ of X. Solvers:

- ``"svd"``: each partition's R factor on the card (``linalg.qr_r``),
  tree-reduced with ``linalg.combine_r``, then the SVD of R;
- ``"gram"``, ``"randomized"``, ``"auto"``: the partitions' Gram XᵀX summed
  by a tree, then the refined eigensolve, the randomized subspace iteration
  (on a ``torch.Generator`` sketch, seed 0) or the choice between them
  (``linalg.randomized_profitable``). The Gram is an f32 matmul at
  precision ``"highest"`` and the ``fused_gram_moments`` kernel's instance
  of the tier at ``"high"`` and ``"default"`` (``_gram``), its diagonal the
  kernel's Σx², as PCA's Gram pass takes it.

The JAX package pads each partition to a power-of-two row bucket; zero rows
change neither R nor the Gram, and torch needs no shape buckets, so the
port sends each partition's true rows alone.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.models.base import Estimator, Model
from spark_rapids_ml_tpu_torch.models.params import HasDevice, HasInputCol, HasOutputCol, Param
from spark_rapids_ml_tpu_torch.ops import linalg as L
from spark_rapids_ml_tpu_torch.parallel.executor import run_partition_tasks
from spark_rapids_ml_tpu_torch.parallel.tree_aggregate import tree_reduce
from spark_rapids_ml_tpu_torch.telemetry import trace_range
from spark_rapids_ml_tpu_torch.utils import columnar
from spark_rapids_ml_tpu_torch.utils.config import get_config
from spark_rapids_ml_tpu_torch.utils.device import to_device

SOLVERS = ("gram", "svd", "randomized", "auto")


class TruncatedSVDParams(HasDevice, HasInputCol, HasOutputCol):
    k = Param("k", "number of singular vectors to keep", int)
    precision = Param(
        "precision",
        "matmul precision for the Gram pass ('highest'/'high'/'default')",
        str,
    )
    solver = Param(
        "solver",
        "decomposition solver: 'gram' (Gram + refined eigh), 'svd' (TSQR "
        "direct), 'randomized' (HMT subspace iteration), 'auto'",
        str,
    )

    def __init__(self, uid: str | None = None, device: str | torch.device = "cuda",
                 **kwargs):
        super().__init__(uid, device=device, **kwargs)
        self._setDefault(
            outputCol="svd_features",
            precision=get_config().default_precision,
            solver="gram",
        )

    def getK(self) -> int:
        return self.getOrDefault("k")


def _gram(x: torch.Tensor, precision: str) -> torch.Tensor:
    """XᵀX of one block at ``precision``: an f32 matmul at ``"highest"``,
    else the fused kernel's instance of the tier."""
    L._check_precision(precision)
    if precision == "highest":
        return L.gram(x)
    return L._kernel_gram(x, precision, symmetric=False)[0]


def _decompose_gram(g: torch.Tensor, k: int, solver: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Gram → (components [n, k], singular values [n], or the l = k + 10
    Ritz values of the randomized solver)."""
    if solver == "auto":
        solver = "randomized" if L.randomized_profitable(g.shape[0], k) else "gram"
    if solver == "randomized":
        u, s, _ = L.randomized_eigh_descending(g, k)
        return u, s
    if solver != "gram":
        # setSolver validates, but constructor kwargs and param maps bypass it
        raise ValueError(f"unknown solver {solver!r}")
    components, s = L.eigh_descending(g)
    return components[:, :k], s


class TruncatedSVD(TruncatedSVDParams, Estimator):
    """Top-k SVD of the (uncentered) input matrix, fitted on ``device``.

    >>> model = TruncatedSVD().setInputCol("f").setK(10).fit(df)
    >>> reduced = model.transform(df)
    """

    def setK(self, value: int) -> "TruncatedSVD":
        return self._set(k=value)

    def setPrecision(self, value: str) -> "TruncatedSVD":
        if value not in L.PRECISIONS:
            raise ValueError(f"precision must be one of {sorted(L.PRECISIONS)}")
        return self._set(precision=value)

    def setSolver(self, value: str) -> "TruncatedSVD":
        if value not in SOLVERS:
            raise ValueError("solver must be 'gram', 'svd', 'randomized', or 'auto'")
        return self._set(solver=value)

    def fit(self, dataset: Any, num_partitions: int | None = None) -> "TruncatedSVDModel":
        input_col = self._paramMap.get("inputCol") or self._defaultParamMap.get("inputCol")
        ds = columnar.PartitionedDataset.from_any(dataset, input_col, num_partitions)
        k = self.getK()
        solver = self.getOrDefault("solver")
        precision = self.getOrDefault("precision")
        device = self.device

        with trace_range("tsvd reduce", device):
            mats = list(ds.matrices())
            n_cols = mats[0].shape[1]
            for m in mats[1:]:
                if m.shape[1] != n_cols:
                    raise ValueError(f"inconsistent feature dim: {m.shape[1]} != {n_cols}")
            if k > n_cols:
                raise ValueError(f"k={k} must be <= number of features {n_cols}")
            if solver == "svd":
                def task(mat):
                    return L.qr_r(to_device(mat, device))

                reduced = tree_reduce(run_partition_tasks(task, mats), L.combine_r)
            else:
                def task(mat):
                    return _gram(to_device(mat, device), precision)

                reduced = tree_reduce(run_partition_tasks(task, mats), torch.add)

        with trace_range("tsvd decompose", device):
            if solver == "svd":
                components, s = L.svd_components_from_r(reduced, k)
            else:
                components, s = _decompose_gram(reduced, k, solver)

        model = TruncatedSVDModel(
            uid=self.uid,
            components=components.cpu().numpy(),
            singularValues=s[:k].cpu().numpy(),
            device=device,
        )
        return self._copyValues(model)


class TruncatedSVDModel(TruncatedSVDParams, Model):
    """Fitted model: ``components`` [n, k] and ``singularValues`` [k] (σ of
    X) on the host; ``transform`` projects on ``device``."""

    def __init__(
        self,
        uid: str | None = None,
        components: np.ndarray | None = None,
        singularValues: np.ndarray | None = None,
        device: str | torch.device = "cuda",
    ):
        super().__init__(uid, device=device)
        self.components = None if components is None else np.asarray(components)
        self.singularValues = None if singularValues is None else np.asarray(singularValues)

    def explained_variance_ratio(self) -> np.ndarray:
        """σᵢ/Σσ over the retained spectrum (a truncated model has only k
        values)."""
        total = self.singularValues.sum()
        return self.singularValues / (total if total > 0 else 1.0)

    def _project_matrix(self, mat: np.ndarray) -> np.ndarray:
        x = to_device(mat, self.device)
        return L.project(x, to_device(self.components, self.device)).cpu().numpy()

    def transform(self, dataset: Any) -> Any:
        with trace_range("tsvd transform", self.device):
            return columnar.apply_column_transform(
                dataset,
                self._paramMap.get("inputCol"),
                self.getOutputCol(),
                self._project_matrix,
            )

    def transform_rows(self, rows) -> list[np.ndarray]:
        ct = self.components.T
        return [ct @ np.asarray(r) for r in rows]

    def _saveData(self) -> dict[str, np.ndarray]:
        return {"components": self.components, "singularValues": self.singularValues}

    @classmethod
    def _fromSaved(cls, uid: str, data: dict[str, np.ndarray],
                   device: str | torch.device = "cuda") -> "TruncatedSVDModel":
        return cls(
            uid=uid,
            components=data["components"],
            singularValues=data["singularValues"],
            device=device,
        )
