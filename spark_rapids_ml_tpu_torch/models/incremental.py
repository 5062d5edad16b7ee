"""Incremental (streaming) fits of the port: ``partial_fit`` folds a batch
into a running statistic on the card, ``finalize`` solves.

Counterpart of ``spark_rapids_ml_tpu/models/incremental.py``. The monoid
estimators (PCA, TruncatedSVD, StandardScaler, LinearRegression) carry the
statistic their one-shot fit reduces, so ``partial_fit(a); partial_fit(b);
finalize()`` is ``fit(concat(a, b))`` up to the order of the f32 sums.
Accumulator memory is O(n²) ([n, n] Gram, R or normal equations) or O(n)
(the scaler's moments) however long the stream. The fold steps update the
carry in place (``linalg.gram_fold_step``, ``linalg.gram_fold_xtx_step``,
``scaler.moment_fold_step``, ``linear.linear_fold_step``), on each batch's
true rows with unit weights: at precision ``"high"`` and ``"default"`` the
Gram folds run the ``symmetric_gram_moments`` kernel's instance of the
tier. The linear carry is f64 (``ops/linear.py``); the others f32.

``IncrementalKMeans`` is mini-batch k-means (Sculley, WWW'10): one weighted
assignment pass a batch (``kmeans.kmeans_stats``) and a per-centre online
mean with step 1/n_c.

Every estimator round-trips its state through ``to_state() -> (arrays,
scalars)`` / ``from_state(arrays, scalars)`` under the JAX package's names,
so a state saved by either package (``utils.checkpoint``'s npz and json)
resumes in the other.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.models.kmeans import KMeans, KMeansModel
from spark_rapids_ml_tpu_torch.models.linear import LinearRegression, LinearRegressionModel
from spark_rapids_ml_tpu_torch.models.params import Param
from spark_rapids_ml_tpu_torch.models.pca import PCA, PCAModel
from spark_rapids_ml_tpu_torch.models.scaler import StandardScaler, StandardScalerModel
from spark_rapids_ml_tpu_torch.models.truncated_svd import (
    TruncatedSVD,
    TruncatedSVDModel,
    _decompose_gram,
)
from spark_rapids_ml_tpu_torch.ops import kmeans as KM
from spark_rapids_ml_tpu_torch.ops import linalg as L
from spark_rapids_ml_tpu_torch.ops import linear as LIN
from spark_rapids_ml_tpu_torch.ops import scaler as S
from spark_rapids_ml_tpu_torch.utils import columnar
from spark_rapids_ml_tpu_torch.utils.device import block_rows_for, to_device


def _check_state_kind(est, state: dict) -> None:
    kind = state.get("kind")
    if kind != type(est).__name__:
        raise ValueError(f"checkpoint state is for {kind!r}, not {type(est).__name__}")


def _as_matrix(est, batch: Any) -> np.ndarray:
    """The batch's matrix, its width pinned at the first batch."""
    mat = columnar.extract_matrix(batch, est._paramMap.get("inputCol"))
    if est._n_cols is None:
        est._n_cols = mat.shape[1]
    elif mat.shape[1] != est._n_cols:
        raise ValueError(f"inconsistent feature dim: {mat.shape[1]} != {est._n_cols}")
    return mat


def _pin_solver(est) -> str:
    """The accumulator's layout depends on the solver route, so the solver
    is pinned at the first partial_fit."""
    solver = est.getOrDefault("solver")
    pinned = getattr(est, "_solver_used", None)
    if pinned is None:
        est._solver_used = solver
    elif solver != pinned:
        raise ValueError(
            f"solver changed mid-stream ({pinned!r} -> {solver!r}); "
            "reset() before switching solvers"
        )
    return solver


def _unit_weights(rows: int) -> torch.Tensor:
    """Unit weights on the host: the Gram fold reads them there without a
    device sync (``linalg.gram_stats_weighted``)."""
    return torch.ones(rows, dtype=torch.float32)


def _host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _on(device: torch.device, a: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def _fold_r(acc: torch.Tensor | None, x: torch.Tensor) -> torch.Tensor:
    r = L.qr_r(x)
    return r if acc is None else L.combine_r(acc, r)


class IncrementalPCA(PCA):
    """PCA fitted by streaming batches.

    >>> inc = IncrementalPCA().setK(4)
    >>> for chunk in stream:
    ...     inc.partial_fit(chunk)
    >>> model = inc.finalize()

    ``fit`` is PCA's one-shot fit. The running statistic is PCA's
    ``GramStats`` (or, for solver ``"svd"``, the R factor).
    """

    def __init__(self, uid: str | None = None, **kwargs):
        super().__init__(uid, **kwargs)
        self._acc: L.GramStats | None = None
        self._r_acc: torch.Tensor | None = None
        self._n_cols: int | None = None
        self._rows_seen = 0

    @property
    def n_rows_seen(self) -> int:
        if self._acc is not None:
            return int(self._acc.count)
        return self._rows_seen if self._r_acc is not None else 0

    def partial_fit(self, batch: Any) -> "IncrementalPCA":
        mat = _as_matrix(self, batch)
        solver = _pin_solver(self)
        x = to_device(mat, self.device)
        if solver == "svd":
            if self.getMeanCentering():
                raise ValueError(
                    "solver='svd' with meanCentering needs the global mean "
                    "before any QR; use the gram-route solvers for "
                    "incremental centered fits"
                )
            self._r_acc = _fold_r(self._r_acc, x)
            self._rows_seen += len(mat)
            return self
        if self._acc is None:
            self._acc = L.init_gram_carry(x.shape[1], self.device)
        step = L.gram_fold_step(self.getOrDefault("precision"))
        self._acc = step(self._acc, x, _unit_weights(x.shape[0]))
        return self

    def finalize(self) -> PCAModel:
        k = self.getK()
        if self._n_cols is not None and k > self._n_cols:
            raise ValueError(f"k={k} must be <= number of features {self._n_cols}")
        if self._acc is not None or self._r_acc is not None:
            _pin_solver(self)  # a switch after the last batch is the same mistake
        if self._r_acc is not None:
            pc, explained = L.svd_from_r(self._r_acc, k)
        elif self._acc is not None:
            cov = L.covariance_from_stats(self._acc, mean_centering=self.getMeanCentering())
            pc, explained = L.pca_fit_from_cov(cov, k, solver=self._solver_used)
        else:
            raise ValueError("finalize() before any partial_fit()")
        model = PCAModel(uid=self.uid, pc=_host(pc), explainedVariance=_host(explained),
                         device=self.device)
        return self._copyValues(model)

    def reset(self) -> "IncrementalPCA":
        self._acc = self._r_acc = self._n_cols = self._solver_used = None
        self._rows_seen = 0
        return self

    def to_state(self) -> tuple[dict[str, np.ndarray], dict]:
        arrays: dict[str, np.ndarray] = {}
        if self._acc is not None:
            arrays["gram_xtx"] = _host(self._acc.xtx)
            arrays["gram_col_sum"] = _host(self._acc.col_sum)
            arrays["gram_count"] = _host(self._acc.count)
        if self._r_acc is not None:
            arrays["r_acc"] = _host(self._r_acc)
        return arrays, {
            "kind": type(self).__name__,
            "n_cols": self._n_cols,
            "rows_seen": int(self._rows_seen),
            "solver_used": getattr(self, "_solver_used", None),
        }

    def from_state(self, arrays: dict[str, np.ndarray], state: dict) -> "IncrementalPCA":
        _check_state_kind(self, state)
        self.reset()
        if "gram_xtx" in arrays:
            self._acc = L.GramStats(*(
                _on(self.device, arrays[name])
                for name in ("gram_xtx", "gram_col_sum", "gram_count")
            ))
        if "r_acc" in arrays:
            self._r_acc = _on(self.device, arrays["r_acc"])
        self._n_cols = state.get("n_cols")
        self._rows_seen = int(state.get("rows_seen", 0))
        if state.get("solver_used") is not None:
            self._solver_used = state["solver_used"]
        return self


class IncrementalTruncatedSVD(TruncatedSVD):
    """TruncatedSVD fitted by streaming batches: the bare [n, n] Gram
    (gram-route solvers) or the R factor (``"svd"``)."""

    def __init__(self, uid: str | None = None, **kwargs):
        super().__init__(uid, **kwargs)
        self._gram: torch.Tensor | None = None
        self._r_acc: torch.Tensor | None = None
        self._n_cols: int | None = None

    def partial_fit(self, batch: Any) -> "IncrementalTruncatedSVD":
        x = to_device(_as_matrix(self, batch), self.device)
        if _pin_solver(self) == "svd":
            self._r_acc = _fold_r(self._r_acc, x)
        else:
            if self._gram is None:
                self._gram = torch.zeros((x.shape[1], x.shape[1]), dtype=x.dtype,
                                         device=self.device)
            self._gram = L.gram_fold_xtx_step(self.getOrDefault("precision"))(self._gram, x)
        return self

    def finalize(self) -> TruncatedSVDModel:
        k = self.getK()
        if self._n_cols is not None and k > self._n_cols:
            raise ValueError(f"k={k} must be <= number of features {self._n_cols}")
        if self._gram is not None or self._r_acc is not None:
            _pin_solver(self)
        if self._r_acc is not None:
            components, s = L.svd_components_from_r(self._r_acc, k)
        elif self._gram is not None:
            components, s = _decompose_gram(self._gram, k, self._solver_used)
        else:
            raise ValueError("finalize() before any partial_fit()")
        model = TruncatedSVDModel(uid=self.uid, components=_host(components),
                                  singularValues=_host(s[:k]), device=self.device)
        return self._copyValues(model)

    def reset(self) -> "IncrementalTruncatedSVD":
        self._gram = self._r_acc = self._n_cols = self._solver_used = None
        return self

    def to_state(self) -> tuple[dict[str, np.ndarray], dict]:
        arrays: dict[str, np.ndarray] = {}
        if self._gram is not None:
            arrays["gram"] = _host(self._gram)
        if self._r_acc is not None:
            arrays["r_acc"] = _host(self._r_acc)
        return arrays, {
            "kind": type(self).__name__,
            "n_cols": self._n_cols,
            "solver_used": getattr(self, "_solver_used", None),
        }

    def from_state(self, arrays: dict[str, np.ndarray], state: dict) -> "IncrementalTruncatedSVD":
        _check_state_kind(self, state)
        self.reset()
        if "gram" in arrays:
            self._gram = _on(self.device, arrays["gram"])
        if "r_acc" in arrays:
            self._r_acc = _on(self.device, arrays["r_acc"])
        self._n_cols = state.get("n_cols")
        if state.get("solver_used") is not None:
            self._solver_used = state["solver_used"]
        return self


class IncrementalStandardScaler(StandardScaler):
    """StandardScaler fitted by streaming batches (the moments fold)."""

    def __init__(self, uid: str | None = None, **kwargs):
        super().__init__(uid, **kwargs)
        self._acc: S.MomentStats | None = None
        self._n_cols: int | None = None

    def partial_fit(self, batch: Any) -> "IncrementalStandardScaler":
        x = to_device(_as_matrix(self, batch), self.device)
        if self._acc is None:
            self._acc = S.init_moment_carry(x.shape[1], self.device)
        ones = torch.ones(x.shape[0], dtype=x.dtype, device=self.device)
        self._acc = S.moment_fold_step()(self._acc, x, ones)
        return self

    def finalize(self) -> StandardScalerModel:
        if self._acc is None:
            raise ValueError("finalize() before any partial_fit()")
        mean, std = S.finalize_moments(self._acc)
        model = StandardScalerModel(uid=self.uid, mean=_host(mean), std=_host(std),
                                    device=self.device)
        return self._copyValues(model)

    def reset(self) -> "IncrementalStandardScaler":
        self._acc = self._n_cols = None
        return self

    def to_state(self) -> tuple[dict[str, np.ndarray], dict]:
        arrays: dict[str, np.ndarray] = {}
        if self._acc is not None:
            arrays["moment_count"] = _host(self._acc.count)
            arrays["moment_total"] = _host(self._acc.total)
            arrays["moment_total_sq"] = _host(self._acc.total_sq)
        return arrays, {"kind": type(self).__name__, "n_cols": self._n_cols}

    def from_state(self, arrays: dict[str, np.ndarray], state: dict) -> "IncrementalStandardScaler":
        _check_state_kind(self, state)
        self.reset()
        if "moment_count" in arrays:
            self._acc = S.MomentStats(*(
                _on(self.device, arrays[name])
                for name in ("moment_count", "moment_total", "moment_total_sq")
            ))
        self._n_cols = state.get("n_cols")
        return self


class IncrementalLinearRegression(LinearRegression):
    """LinearRegression fitted by streaming labeled batches: the
    ``LinearStats`` carry of the streamed fit (f64 on the card), so
    ``partial_fit(a); partial_fit(b); finalize()`` is ``fit(concat(a, b))``,
    elastic net included. A batch is anything the one-shot fit takes: an
    ``(X, y)``/``(X, y, w)`` tuple or a container with ``featuresCol``/
    ``labelCol`` (and ``weightCol``)."""

    def __init__(self, uid: str | None = None, **kwargs):
        super().__init__(uid, **kwargs)
        self._acc: LIN.LinearStats | None = None
        self._n_cols: int | None = None
        self._rows_seen = 0

    @property
    def n_rows_seen(self) -> int:
        # LinearStats.count is the weight sum, not the row count
        return self._rows_seen

    def partial_fit(self, batch: Any) -> "IncrementalLinearRegression":
        for x, y, sw in self._labeled(batch, 1):
            if self._n_cols is None:
                self._n_cols = x.shape[1]
            elif x.shape[1] != self._n_cols:
                raise ValueError(f"inconsistent feature dim: {x.shape[1]} != {self._n_cols}")
            if self._acc is None:
                self._acc = LIN.init_linear_carry(x.shape[1], self.device)
            self._acc = LIN.linear_fold_step()(
                self._acc,
                to_device(x, self.device),
                to_device(np.asarray(y), self.device),
                None if sw is None else to_device(sw, self.device),
            )
            self._rows_seen += x.shape[0]
        return self

    def finalize(self) -> LinearRegressionModel:
        if self._acc is None:
            raise ValueError("finalize() before any partial_fit()")
        coef, intercept = LIN.solve_from_stats(self._acc, **self._solve_args())
        model = LinearRegressionModel(uid=self.uid, coefficients=_host(coef),
                                      intercept=float(intercept), device=self.device)
        return self._copyValues(model)

    def reset(self) -> "IncrementalLinearRegression":
        self._acc = self._n_cols = None
        self._rows_seen = 0
        return self

    def to_state(self) -> tuple[dict[str, np.ndarray], dict]:
        arrays: dict[str, np.ndarray] = {}
        if self._acc is not None:
            for fld, value in zip(self._acc._fields, self._acc):
                arrays[f"linear_{fld}"] = _host(value)
        return arrays, {
            "kind": type(self).__name__,
            "n_cols": self._n_cols,
            "rows_seen": int(self._rows_seen),
        }

    def from_state(self, arrays: dict[str, np.ndarray], state: dict) -> "IncrementalLinearRegression":
        _check_state_kind(self, state)
        self.reset()
        if "linear_xtx" in arrays:
            self._acc = LIN.LinearStats(*(
                _on(self.device, arrays[f"linear_{fld}"], torch.float64)
                for fld in LIN.LinearStats._fields
            ))
        self._n_cols = state.get("n_cols")
        self._rows_seen = int(state.get("rows_seen", 0))
        return self


class IncrementalKMeans(KMeans):
    """Mini-batch KMeans fitted by streaming batches (Sculley, WWW'10; the
    ``sklearn.cluster.MiniBatchKMeans`` shape).

    Each ``partial_fit(batch)`` runs one weighted assignment pass and moves
    every centre to the online mean of what it has owned, step 1/n_c with
    n_c its cumulative weight. Rows buffer on the host until
    ``max(k, seedRows)`` arrive; the buffer then seeds k centres
    (``initMode="random"``: k positive-weight rows drawn with numpy, as the
    JAX package draws them; ``"k-means++"`` and ``"k-means||"``: k-means++
    on the buffer, from a ``torch.Generator``) and replays as the first
    mini-batch. ``finalize()`` seeds from a short stream's buffer when it
    holds k positive-weight rows; the model's ``trainingCost`` is the last
    batch's assignment cost. A cluster-sorted stream seeds from whichever
    cluster comes first: shuffle it, or raise ``seedRows``.
    """

    seedRows = Param("seedRows", "rows buffered before k-means++ seeding", int)

    def __init__(self, uid: str | None = None, **kwargs):
        super().__init__(uid, **kwargs)
        self._setDefault(seedRows=4096)
        self._centers: torch.Tensor | None = None      # [k, n]
        self._cum_weights: torch.Tensor | None = None  # [k]
        self._n_cols: int | None = None
        self._rows_seen = 0
        self._last_cost = float("nan")
        self._seed_rows: list[np.ndarray] = []
        self._seed_weights: list[np.ndarray] = []

    @property
    def n_rows_seen(self) -> int:
        return self._rows_seen

    def _batch_arrays(self, batch: Any, sample_weight):
        mat = _as_matrix(self, batch)
        w = None
        if sample_weight is not None:
            w = columnar.validate_weights(sample_weight, len(mat), allow_all_zero=True)
        else:
            weight_col = self._paramMap.get("weightCol")
            if weight_col:
                w = columnar.validate_weights(
                    columnar.extract_vector(batch, weight_col), len(mat), allow_all_zero=True
                )
        return mat, (np.ones(len(mat)) if w is None else w)

    def _minibatch(self, mat: np.ndarray, w: np.ndarray) -> None:
        x = to_device(mat, self.device)
        block = block_rows_for(self.device, KM.DEFAULT_BLOCK_ROWS, self._centers.shape[0])
        stats = KM.kmeans_stats(x, self._centers, to_device(w, self.device), block_rows=block)
        self._centers, self._cum_weights = _minibatch_center_update(
            self._centers, self._cum_weights, stats.sums, stats.counts
        )
        self._last_cost = float(stats.cost)

    def partial_fit(self, batch: Any, sample_weight=None) -> "IncrementalKMeans":
        mat, w = self._batch_arrays(batch, sample_weight)
        self._rows_seen += len(mat)
        if self._centers is None:
            self._seed_rows.append(mat)
            self._seed_weights.append(w)
            buffered = sum(len(m) for m in self._seed_rows)
            if buffered < max(self.getK(), self.getOrDefault("seedRows")):
                return self  # keep buffering
            mat, w = self._seed_from_buffer()  # replayed as the first mini-batch
        self._minibatch(mat, w)
        return self

    def _seed_from_buffer(self) -> tuple[np.ndarray, np.ndarray]:
        """Seed k centres from the buffered rows; returns them (mat, w) for
        replay. Raises without consuming the buffer when it holds fewer
        than k positive-weight rows."""
        mat = np.concatenate(self._seed_rows)
        w = np.concatenate(self._seed_weights)
        keep = w > 0
        if keep.sum() < self.getK():
            raise ValueError(
                f"k={self.getK()} but only {int(keep.sum())} buffered "
                "rows with positive weight to seed from"
            )
        if self.getInitMode() == "random":
            rng = np.random.default_rng(self.getSeed())
            pool = mat[keep]
            self._centers = to_device(
                pool[rng.choice(len(pool), self.getK(), replace=False)], self.device
            )
        else:
            self._centers = KM.kmeans_plus_plus_init(
                self._generator(), to_device(mat[keep], self.device), self.getK()
            )
        self._cum_weights = torch.zeros(self.getK(), dtype=self._centers.dtype,
                                        device=self.device)
        self._seed_rows, self._seed_weights = [], []
        return mat, w

    def finalize(self) -> KMeansModel:
        if self._centers is None and self._seed_rows:
            # a short stream: seed from the buffer and run it as the one
            # mini-batch
            self._minibatch(*self._seed_from_buffer())
        if self._centers is None:
            raise ValueError(
                "finalize() before seeding completed — no rows were "
                "streamed through partial_fit()"
            )
        model = KMeansModel(uid=self.uid, clusterCenters=_host(self._centers),
                            trainingCost=self._last_cost, device=self.device)
        return self._copyValues(model)

    def setSeedRows(self, value: int) -> "IncrementalKMeans":
        if value < 1:
            raise ValueError(f"seedRows must be >= 1, got {value}")
        return self._set(seedRows=value)

    def reset(self) -> "IncrementalKMeans":
        self._centers = self._cum_weights = self._n_cols = None
        self._rows_seen = 0
        self._last_cost = float("nan")
        self._seed_rows, self._seed_weights = [], []
        return self

    def to_state(self) -> tuple[dict[str, np.ndarray], dict]:
        arrays: dict[str, np.ndarray] = {}
        if self._centers is not None:
            arrays["centers"] = _host(self._centers)
            arrays["cum_weights"] = _host(self._cum_weights)
        if self._seed_rows:
            arrays["seed_rows"] = np.concatenate(self._seed_rows)
            arrays["seed_weights"] = np.concatenate(self._seed_weights)
        return arrays, {
            "kind": type(self).__name__,
            "n_cols": self._n_cols,
            "rows_seen": int(self._rows_seen),
            "last_cost": self._last_cost,
        }

    def from_state(self, arrays: dict[str, np.ndarray], state: dict) -> "IncrementalKMeans":
        _check_state_kind(self, state)
        self.reset()
        if "centers" in arrays:
            self._centers = _on(self.device, arrays["centers"])
            self._cum_weights = _on(self.device, arrays["cum_weights"])
        if "seed_rows" in arrays:
            self._seed_rows = [np.asarray(arrays["seed_rows"])]
            self._seed_weights = [np.asarray(arrays["seed_weights"])]
        self._n_cols = state.get("n_cols")
        self._rows_seen = int(state.get("rows_seen", 0))
        self._last_cost = float(state.get("last_cost", float("nan")))
        return self


def _minibatch_center_update(centers, cum_weights, batch_sums, batch_counts):
    """Per-centre online mean c ← (W_c·c + Σ_batch) / (W_c + w_batch),
    Sculley's 1/n_c step in its weighted form; a centre that has owned
    nothing stays put."""
    new_cum = cum_weights + batch_counts
    owned = new_cum > 0
    upd = (centers * cum_weights[:, None] + batch_sums) / torch.where(
        owned, new_cum, torch.ones_like(new_cum)
    )[:, None]
    return torch.where(owned[:, None], upd, centers), new_cum
