"""PCA linear algebra on torch tensors.

Counterpart of ``spark_rapids_ml_tpu/ops/linalg.py`` for the PCA fit:
per-partition sufficient statistics, their monoid combine, the streamed
fit's fold step, the covariance (standardized or not), the refined
descending eigensolve with the reference's sign rule, the explained variance
and the projection. Functions take tensors on any device and compute in
their dtype; the estimators pass f32 tensors.

Precision tiers of the Gram pass (``gram_stats`` for the resident fit,
``gram_stats_weighted`` for the streamed fold):

- ``"highest"``: an f32 ``torch.matmul`` with TF32 off;
- ``"high"``: the split-bf16 kernels, ``ops.gram_moments.fused_gram_moments``
  resident and ``symmetric_gram_moments`` streamed. Their Gram drops loᵀlo,
  whose diagonal Σlo² is one-sided (~2⁻¹⁸ of Σx²) and would bias σ by
  (μ² + σ²)/σ² times that for a feature far from zero; so the diagonal is
  replaced by the kernels' Σ(hi + lo)², which drops nothing one-sided;
- ``"default"``: not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.ops import scaler as S
from spark_rapids_ml_tpu_torch.ops.gram_moments import (
    fused_gram_moments,
    symmetric_gram_moments,
)

PRECISIONS = ("highest", "high", "default")


class GramStats(NamedTuple):
    """Partition-local sufficient statistics, summed across partitions by
    ``combine_gram_stats``."""

    xtx: torch.Tensor      # [n, n] XᵀX of the partition's rows
    col_sum: torch.Tensor  # [n] per-feature sums
    count: torch.Tensor    # [] number of rows


def _require_f32_matmul() -> None:
    # Asserted rather than set: the fit runs partitions on threads, and the
    # flag is process-wide.
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "these products must run in full f32, but "
            "torch.get_float32_matmul_precision() is "
            f"{torch.get_float32_matmul_precision()!r} (TF32 on); call "
            "torch.set_float32_matmul_precision('highest')"
        )


def gram(x: torch.Tensor) -> torch.Tensor:
    """Uncentered Gram matrix XᵀX of a row-major [rows, n] block, in f32."""
    _require_f32_matmul()
    return x.T @ x


def _unported_precision(precision: str) -> Exception:
    if precision == "default":
        return NotImplementedError(
            "precision 'default' (one bf16 pass with an f32 result) is not "
            "ported yet; use 'high' or 'highest'"
        )
    return ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")


def gram_stats(x: torch.Tensor, *, precision: str = "highest") -> GramStats:
    """The sufficient-statistics triple of one partition."""
    count = torch.tensor(x.shape[0], dtype=x.dtype, device=x.device)
    if precision == "highest":
        return GramStats(gram(x), x.sum(dim=0), count)
    if precision == "high":
        xtx, col_sum, sum_sq = fused_gram_moments(x)
        xtx.diagonal().copy_(sum_sq)  # see the module note on "high"
        return GramStats(xtx, col_sum, count)
    raise _unported_precision(precision)


def combine_gram_stats(a: GramStats, b: GramStats) -> GramStats:
    """Monoid combine: elementwise sum of the triples."""
    return GramStats(a.xtx + b.xtx, a.col_sum + b.col_sum, a.count + b.count)


def gram_stats_weighted(
    x: torch.Tensor, w: torch.Tensor, *, precision: str = "highest"
) -> GramStats:
    """GramStats of one chunk under the masking convention: ``w`` carries
    instance weights on true rows and 0.0 on pad rows, so xᵀ(x·w), the
    weighted column sums and the weight-sum count are exact over padded
    chunks.

    - ``"highest"``: that arithmetic, with an f32 matmul; ``w`` may lie on
      the host and is copied to ``x``'s device.
    - ``"high"``: the symmetric split-bf16 kernel under a unit-weight
      contract: every weight must be 1, so pass only the chunk's true rows
      (PCA has no weight column). The weights are read where they lie: a
      host tensor costs no device sync, which is why the streamed fold keeps
      them on the host.
    """
    if precision == "highest":
        _require_f32_matmul()
        w = w.to(device=x.device, dtype=x.dtype, non_blocking=True)
        xw = x * w[:, None]
        return GramStats(x.T @ xw, xw.sum(dim=0), w.sum())
    if precision == "high":
        if w.shape != (x.shape[0],) or not bool(torch.all(w == 1)):
            raise ValueError(
                "precision 'high' folds unit weights only: pass the chunk's "
                "true rows with weight 1 (weighted 'high' folds are not "
                "ported)"
            )
        xtx, col_sum, sum_sq = symmetric_gram_moments(x)
        xtx.diagonal().copy_(sum_sq)  # see the module note on "high"
        count = torch.full((), float(x.shape[0]), dtype=x.dtype, device=x.device)
        return GramStats(xtx, col_sum, count)
    raise _unported_precision(precision)


def fold_gram_stats(
    carry: GramStats, x: torch.Tensor, w: torch.Tensor, *, precision: str = "highest"
) -> GramStats:
    """One streamed-fit fold step, out of place: carry + the chunk's weighted
    stats."""
    return combine_gram_stats(carry, gram_stats_weighted(x, w, precision=precision))


def init_gram_carry(n: int, device: torch.device | str) -> GramStats:
    """Zero f32 GramStats carry on ``device`` for ``gram_fold_step``."""
    new = dict(dtype=torch.float32, device=device)
    return GramStats(torch.zeros((n, n), **new), torch.zeros((n,), **new),
                     torch.zeros((), **new))


def gram_fold_step(precision: str = "highest"):
    """The streamed fit's fold step ``step(carry, x, w) -> carry``: adds the
    chunk's weighted stats into ``carry`` **in place** and returns it. This
    is the counterpart of the JAX step's donated carry: a stream of any
    length keeps one set of carry buffers, and every update is queued on the
    current stream without a sync."""
    if precision not in ("highest", "high"):
        raise _unported_precision(precision)

    def step(carry: GramStats, x: torch.Tensor, w: torch.Tensor) -> GramStats:
        stats = gram_stats_weighted(x, w, precision=precision)
        carry.xtx.add_(stats.xtx)
        carry.col_sum.add_(stats.col_sum)
        carry.count.add_(stats.count)
        return carry

    return step


def covariance_from_stats(stats: GramStats, *, mean_centering: bool) -> torch.Tensor:
    """Scatter-form covariance: XᵀX, or XᵀX − s·sᵀ/count when centering. No
    1/(n−1) scaling, as in the reference."""
    if not mean_centering:
        return stats.xtx
    denom = torch.clamp(stats.count, min=1.0)
    return stats.xtx - torch.outer(stats.col_sum, stats.col_sum) / denom


def standardized_cov_from_stats(
    stats: GramStats,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(scatter of the standardized X, mean, sample std) from raw GramStats:
    with Xs = (X − μ)/σ, XsᵀXs = D⁻¹(XᵀX − m·μμᵀ)D⁻¹, D = diag(σ), so the
    fused StandardScaler → PCA pipeline needs no second pass over the data.
    μ and σ come from ``scaler.finalize_moments`` on (count, col_sum,
    diag(XᵀX)); zero-variance features are left unscaled."""
    mean, std = S.finalize_moments(
        S.MomentStats(stats.count, stats.col_sum, torch.diagonal(stats.xtx))
    )
    m = torch.clamp(stats.count, min=1.0)
    safe = torch.where(std > 0, std, torch.ones_like(std))
    centered = stats.xtx - m * torch.outer(mean, mean)
    return centered / torch.outer(safe, safe), mean, std


def sign_flip(u: torch.Tensor) -> torch.Tensor:
    """Negate each column whose largest-magnitude element is negative."""
    idx = torch.argmax(torch.abs(u), dim=0)
    anchors = torch.gather(u, 0, idx[None, :])[0]
    signs = torch.where(anchors < 0, -torch.ones_like(anchors), torch.ones_like(anchors))
    return u * signs[None, :]


def refine_eigh(
    a: torch.Tensor, v: torch.Tensor, evals: torch.Tensor, *, iters: int = 2
) -> tuple[torch.Tensor, torch.Tensor]:
    """First-order (Ogita–Aishima style) refinement of an approximate
    symmetric eigendecomposition, each sweep followed by one Newton–Schulz
    re-orthonormalisation. Near-degenerate pairs (gap below √eps·‖A‖) are
    left uncorrected."""
    _require_f32_matmul()
    eps = torch.finfo(v.dtype).eps
    eye = torch.eye(v.shape[1], dtype=v.dtype, device=v.device)
    for _ in range(iters):
        b = v.T @ (a @ v)
        d = torch.diagonal(b)
        gap = d[None, :] - d[:, None]
        scale = torch.max(torch.abs(d)) + eps
        safe = torch.abs(gap) > (eps ** 0.5) * scale
        z = torch.where(safe, b / torch.where(safe, gap, torch.ones_like(gap)), 0.0)
        z = z - torch.diag(torch.diagonal(z))
        v = v + v @ z
        v = v @ (1.5 * eye - 0.5 * (v.T @ v))
    av = a @ v
    evals = torch.sum(v * av, dim=0) / torch.sum(v * v, dim=0)
    return v, evals


def eigh_descending(
    cov: torch.Tensor, *, refine_iters: int = 2
) -> tuple[torch.Tensor, torch.Tensor]:
    """(components [n, n], singular values [n]) in descending eigenvalue
    order, components sign-flipped, singular values √max(λ, 0)."""
    evals, evecs = torch.linalg.eigh(cov)  # ascending
    if refine_iters:
        evecs, evals = refine_eigh(cov, evecs, evals, iters=refine_iters)
        # refinement may reorder near-ties; stable ascending then reversed
        order = torch.argsort(evals, stable=True).flip(0)
        evals = evals[order]
        evecs = evecs[:, order]
    else:
        evals = evals.flip(0)
        evecs = evecs.flip(1)
    singular_values = torch.sqrt(torch.clamp(evals, min=0.0))
    return sign_flip(evecs), singular_values


def explained_variance(singular_values: torch.Tensor, k: int) -> torch.Tensor:
    """sᵢ/Σs over the FULL spectrum, truncated to the first k (the
    reference's definition)."""
    total = torch.sum(singular_values)
    safe_total = torch.where(total > 0, total, torch.ones_like(total))
    return (singular_values / safe_total)[:k]


def pca_fit_from_cov(
    cov: torch.Tensor, k: int, *, solver: str = "full"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Covariance → (pc [n, k], explained variance [k])."""
    if solver in ("randomized", "svd", "auto"):
        raise NotImplementedError(
            f"solver {solver!r} is not ported yet (queued as the next "
            "slice); use solver='full'"
        )
    if solver != "full":
        raise ValueError(f"unknown solver {solver!r}")
    components, s = eigh_descending(cov)
    return components[:, :k], explained_variance(s, k)


def pca_fit_local(
    x: torch.Tensor, k: int, *, mean_centering: bool = False,
    precision: str = "highest",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-block fit: rows → (pc, explained variance)."""
    stats = gram_stats(x, precision=precision)
    cov = covariance_from_stats(stats, mean_centering=mean_centering)
    return pca_fit_from_cov(cov, k)


def project(x: torch.Tensor, pc: torch.Tensor) -> torch.Tensor:
    """Transform projection X·PC of a [rows, n] block by [n, k] components."""
    _require_f32_matmul()
    return x @ pc


def min_cosine_vs_f64_oracle(x_host, pc, k: int) -> float:
    """Min per-component |cosine| of fitted components against the f64 host
    oracle (uncentered scatter eigh, descending)."""
    xa = np.asarray(x_host, dtype=np.float64)
    if isinstance(pc, torch.Tensor):
        pc = pc.detach().cpu().numpy()
    pc = np.asarray(pc, dtype=np.float64)
    _, evecs = np.linalg.eigh(xa.T @ xa)
    oracle = evecs[:, ::-1][:, :k]
    cosines = np.abs(np.sum(pc * oracle, axis=0)) / (
        np.linalg.norm(pc, axis=0) * np.linalg.norm(oracle, axis=0)
    )
    return float(cosines.min())
