"""PCA estimator and model of the port, on the card by default.

Counterpart of ``spark_rapids_ml_tpu/models/pca.py``: the same params,
setters, defaults and messages, plus a ``device`` argument (default
``"cuda"``). Semantics are the reference's: the covariance is the
scatter-form Gram (no 1/(n−1)), components come in descending eigenvalue
order with each column's largest-magnitude element positive, and
explainedVariance is sᵢ/Σs over the full singular-value spectrum (s = √λ),
truncated to k. ``meanCentering=True`` really centers.

The covariance solvers (``"full"``, ``"randomized"``, ``"auto"``) take the
Gram statistics at precision ``"highest"`` (f32 matmul), ``"high"`` (the
split-bf16 kernels) or ``"default"`` (the kernels' one-bf16-pass
instances). Data whose partition metadata puts it above the streamed-fit
cutover folds chunk by chunk through ``spark.ingest.stream_fold`` instead
of going resident (under the fold's ``TPU_ML_PRECISION_POLICY``), and
``standardize=True`` derives the scaler's moments from the same Gram
statistics on both paths. Solver ``"svd"`` never streams: it reduces the
partitions' R factors (QR on the card, a tree of stacked-pair QRs) and
takes the SVD of R. Models save and load in the JAX package's two layouts
(``models/base.py``; host-side, needs pyarrow).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.models.base import Estimator, Model
from spark_rapids_ml_tpu_torch.models.params import HasDevice, HasInputCol, HasOutputCol, Param
from spark_rapids_ml_tpu_torch.ops import linalg as L
from spark_rapids_ml_tpu_torch.parallel.executor import run_partition_tasks
from spark_rapids_ml_tpu_torch.parallel.tree_aggregate import tree_reduce
from spark_rapids_ml_tpu_torch.spark import ingest
from spark_rapids_ml_tpu_torch.telemetry import costmodel, trace_range
from spark_rapids_ml_tpu_torch.utils import columnar
from spark_rapids_ml_tpu_torch.utils import persistence as P
from spark_rapids_ml_tpu_torch.utils.config import get_config
from spark_rapids_ml_tpu_torch.utils.device import to_device


class PCAParams(HasDevice, HasInputCol, HasOutputCol):
    """Shared params (the RapidsPCAParams analog)."""

    k = Param("k", "number of principal components", int)
    meanCentering = Param(
        "meanCentering",
        "center the data before computing the covariance (the reference "
        "accepts this but computes the uncentered Gram regardless; False "
        "reproduces reference behavior exactly)",
        bool,
    )
    precision = Param(
        "precision",
        "matmul precision for the Gram pass: 'highest' (f32 with TF32 off, "
        "default), 'high' (split-bf16 tensor-core kernel: three bf16 "
        "products, ~16 mantissa bits), or 'default' (the same kernel's one "
        "bf16 pass with an f32 result, ~8 mantissa bits)",
        str,
    )
    standardize = Param(
        "standardize",
        "fuse StandardScaler into the fit: the decomposition runs on the "
        "covariance of (x−μ)/σ and transform standardizes before projecting",
        bool,
    )
    solver = Param(
        "solver",
        "decomposition solver: 'full' (exact refined eigh, reference "
        "parity), 'randomized' (HMT subspace iteration, O(n²(k+10))), 'svd' "
        "(TSQR + SVD of R: never forms XᵀX, works at cond(X)), or 'auto' "
        "(randomized when n ≥ 256 and k+10 ≤ n/4, else full)",
        str,
    )

    def __init__(self, uid: str | None = None, device: str | torch.device = "cuda",
                 **kwargs):
        super().__init__(uid, device=device, **kwargs)
        self._setDefault(
            meanCentering=False,
            standardize=False,
            outputCol="pca_features",
            precision=get_config().default_precision,
            solver="full",
        )

    def getK(self) -> int:
        return self.getOrDefault("k")

    def getMeanCentering(self) -> bool:
        return self.getOrDefault("meanCentering")


class PCA(PCAParams, Estimator):
    """PCA with the reference's drop-in API, fitted on ``device``.

    >>> model = PCA().setInputCol("features").setOutputCol("pca").setK(3).fit(df)
    >>> out = model.transform(df)
    """

    def setK(self, value: int) -> "PCA":
        return self._set(k=value)

    def setMeanCentering(self, value: bool) -> "PCA":
        return self._set(meanCentering=value)

    def setStandardize(self, value: bool) -> "PCA":
        return self._set(standardize=value)

    def setPrecision(self, value: str) -> "PCA":
        if value not in L.PRECISIONS:
            raise ValueError(f"precision must be one of {sorted(L.PRECISIONS)}")
        return self._set(precision=value)

    def setSolver(self, value: str) -> "PCA":
        if value not in L.SOLVERS:
            raise ValueError(
                "solver must be 'full', 'randomized', 'svd', or 'auto'"
            )
        return self._set(solver=value)

    def _stream_gram_stats(
        self, ds: columnar.PartitionedDataset, k: int, precision: str
    ) -> ingest.StreamFold:
        """Out-of-core Gram statistics: the partitions drain lazily through
        ``spark.ingest.stream_fold`` into one carry on the card, updated in
        place (``linalg.gram_fold_step``), so the rows are never resident at
        once, host or device."""
        it = ds.matrices()
        first = next(it)
        n_cols = first.shape[1]
        if k > n_cols:
            raise ValueError(f"k={k} must be <= number of features {n_cols}")

        return ingest.stream_fold(
            itertools.chain([first], it),
            L.gram_fold_step(precision),
            n=n_cols,
            init=L.init_gram_carry(n_cols, self.device),
            device=self.device,
        )

    @staticmethod
    def _resident_matrices(ds: columnar.PartitionedDataset, k: int) -> list[np.ndarray]:
        """Every partition's host matrix, checked for one width and k."""
        mats = list(ds.matrices())
        n_cols = mats[0].shape[1]
        for m in mats[1:]:
            if m.shape[1] != n_cols:
                raise ValueError(f"inconsistent feature dim: {m.shape[1]} != {n_cols}")
        if k > n_cols:
            raise ValueError(f"k={k} must be <= number of features {n_cols}")
        return mats

    def _resident_gram_stats(self, mats: list[np.ndarray], precision: str) -> L.GramStats:
        """Per-partition Gram statistics on the card and a tree reduction of
        them."""
        device = self.device

        def partition_task(mat):
            padded, true_rows = columnar.pad_rows(mat)
            xd = to_device(padded, device)
            costmodel.capture("linalg.gram_stats", L.gram_stats, xd, precision=precision)
            stats = L.gram_stats(xd, precision=precision)
            # padding adds zero rows: fix only the count
            return L.GramStats(
                stats.xtx, stats.col_sum, torch.full_like(stats.count, true_rows)
            )

        return tree_reduce(run_partition_tasks(partition_task, mats), L.combine_gram_stats)

    def _reduce_r(self, mats: list[np.ndarray], mean_centering: bool) -> torch.Tensor:
        """The direct fit's reduction: each partition's R factor on the card
        (``linalg.qr_r``), tree-reduced with ``linalg.combine_r``. Centering
        takes the global mean first, in f64 on the host, and subtracts it
        before padding, so pad rows stay zero and R stays unchanged by
        them."""
        mean = None
        if mean_centering:
            count = max(sum(m.shape[0] for m in mats), 1)
            mean = sum(m.sum(axis=0, dtype=np.float64) for m in mats) / count
        device = self.device

        def partition_task(mat):
            if mean is not None:
                mat = mat - mean.astype(mat.dtype)[None, :]
            padded, _ = columnar.pad_rows(mat)
            return L.qr_r(to_device(padded, device))

        return tree_reduce(run_partition_tasks(partition_task, mats), L.combine_r)

    def fit(self, dataset: Any, num_partitions: int | None = None) -> "PCAModel":
        """Gram statistics on the card, resident or streamed above the
        ``TPU_ML_STREAM_FIT_MAX_RESIDENT_BYTES`` cutover, then one
        decomposition by the solver; or, for solver ``"svd"``, always
        resident, the partitions' reduced R factor and its SVD. A streamed
        fit's model keeps the fold's ``StreamFold`` record (without the
        carry) as ``stream_report``."""
        input_col = self._paramMap.get("inputCol") or self._defaultParamMap.get("inputCol")
        ds = columnar.PartitionedDataset.from_any(dataset, input_col, num_partitions)
        k = self.getK()
        mean_centering = self.getMeanCentering()
        solver = self.getOrDefault("solver")
        precision = self.getOrDefault("precision")
        standardize = self.getOrDefault("standardize")
        if standardize and solver == "svd":
            raise ValueError(
                "standardize=True derives the scaled covariance from "
                "GramStats and so requires a covariance solver "
                "('full'/'randomized'/'auto'); solver='svd' decomposes "
                "R factors of the raw rows"
            )
        device = self.device

        report = None
        with trace_range("compute cov", device):
            if solver != "svd" and columnar.use_streamed_fit(ds):
                report = self._stream_gram_stats(ds, k, precision)
                stats = report.carry
            elif solver == "svd":
                r = self._reduce_r(self._resident_matrices(ds, k), mean_centering)
            else:
                stats = self._resident_gram_stats(self._resident_matrices(ds, k), precision)

        mean = std = None
        with trace_range("eigh", device):
            if solver == "svd":
                pc, explained = L.svd_from_r(r, k)
            else:
                if standardize:
                    cov, mean, std = L.standardized_cov_from_stats(stats)
                else:
                    cov = L.covariance_from_stats(stats, mean_centering=mean_centering)
                pc, explained = L.pca_fit_from_cov(cov, k, solver=solver)

        model = PCAModel(
            uid=self.uid,
            pc=pc.cpu().numpy(),
            explainedVariance=explained.cpu().numpy(),
            mean=None if mean is None else mean.cpu().numpy(),
            std=None if std is None else std.cpu().numpy(),
            device=device,
        )
        if report is not None:
            model.stream_report = dataclasses.replace(report, carry=None)
        return self._copyValues(model)


class PCAModel(PCAParams, Model):
    """Fitted PCA model: ``pc`` [n, k] and ``explainedVariance`` [k] as host
    arrays, and ``mean``/``std`` for a model fitted with standardize=True.
    ``stream_report`` is the streamed fold's record for a streamed fit, else
    None. ``transform`` projects on ``device``; ``transform_rows`` is the
    row-at-a-time host path."""

    def __init__(
        self,
        uid: str | None = None,
        pc: np.ndarray | None = None,
        explainedVariance: np.ndarray | None = None,
        mean: np.ndarray | None = None,
        std: np.ndarray | None = None,
        device: str | torch.device = "cuda",
    ):
        super().__init__(uid, device=device)
        self.pc = None if pc is None else np.asarray(pc)
        self.explainedVariance = (
            None if explainedVariance is None else np.asarray(explainedVariance)
        )
        self.mean = None if mean is None else np.asarray(mean)
        self.std = None if std is None else np.asarray(std)
        self.stream_report: ingest.StreamFold | None = None

    def _project_matrix(self, mat: np.ndarray) -> np.ndarray:
        padded, true_rows = columnar.pad_rows(
            columnar.standardize_host(mat, self.mean, self.std)
        )
        xd, pc = to_device(padded, self.device), to_device(self.pc, self.device)
        costmodel.capture("linalg.project", L.project, xd, pc)
        return L.project(xd, pc)[:true_rows].cpu().numpy()

    def transform(self, dataset: Any) -> Any:
        """Project the input column; returns the same container type with the
        output column appended."""
        with trace_range("pca transform", self.device):
            return columnar.apply_column_transform(
                dataset,
                self._paramMap.get("inputCol"),
                self.getOutputCol(),
                self._project_matrix,
            )

    def transform_rows(self, rows) -> list[np.ndarray]:
        """Row-at-a-time host projection pcᵀ·row (the reference's ``apply``),
        in numpy; the card is not involved."""
        mat = columnar.standardize_host(
            np.stack([np.asarray(r) for r in rows]), self.mean, self.std
        )
        pct = self.pc.T
        return [pct @ r for r in mat]

    # -- persistence ----------------------------------------------------------
    def _saveData(self) -> dict[str, np.ndarray]:
        out = {"pc": self.pc, "explainedVariance": self.explainedVariance}
        if self.mean is not None:
            out["mean"] = self.mean
            out["std"] = self.std
        return out

    @classmethod
    def _fromSaved(
        cls, uid: str, data: dict[str, np.ndarray], device: str | torch.device
    ) -> "PCAModel":
        return cls(
            uid=uid,
            pc=data["pc"],
            explainedVariance=data["explainedVariance"],
            mean=data.get("mean"),
            std=data.get("std"),
            device=device,
        )

    # Stock Spark's PCAModel writer persists Row(pc: DenseMatrix,
    # explainedVariance: DenseVector) under data/ plus DefaultParamsWriter
    # metadata. Only params stock Spark's PCAModel knows may appear in the
    # metadata (its loader rejects unknown names).
    _SPARK_ML_CLASS = "org.apache.spark.ml.feature.PCAModel"
    _SPARK_ML_PARAMS = ("k", "inputCol", "outputCol")

    def _checkSparkML(self) -> None:
        if self.mean is not None:
            raise NotImplementedError(
                "stock Spark ML's PCAModel cannot represent a "
                "standardize=True model's scaling state (mean/std); save "
                "with the native layout, or fit an explicit "
                "StandardScaler + PCA pipeline for Spark interop"
            )

    def _saveSparkML(self, path: str) -> None:
        from spark_rapids_ml_tpu_torch.models.base import spark_set_params

        params = {k: v for k, v in spark_set_params(self).items() if k in self._SPARK_ML_PARAMS}
        params.setdefault("k", int(self.pc.shape[1]))
        P.save_spark_ml_metadata(
            path, class_name=self._SPARK_ML_CLASS, uid=self.uid, param_map=params
        )
        P.save_spark_ml_data(
            path,
            {
                "pc": P._dense_matrix_struct(self.pc),
                "explainedVariance": P._dense_vector_struct(self.explainedVariance),
            },
            {
                "type": "struct",
                "fields": [
                    {"name": "pc", "type": P._matrix_udt_json(), "nullable": True,
                     "metadata": {}},
                    {"name": "explainedVariance", "type": P._vector_udt_json(),
                     "nullable": True, "metadata": {}},
                ],
            },
        )

    @classmethod
    def _fromSparkML(cls, meta: dict, table, device: str | torch.device) -> "PCAModel":
        return cls(
            uid=meta["uid"],
            pc=P.struct_to_matrix(table.column("pc")[0].as_py()),
            explainedVariance=P.struct_to_vector(table.column("explainedVariance")[0].as_py()),
            device=device,
        )
