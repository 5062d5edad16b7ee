"""PCA linear algebra on torch tensors.

Counterpart of ``spark_rapids_ml_tpu/ops/linalg.py`` for the resident fit:
per-partition sufficient statistics, their monoid combine, the covariance,
the refined descending eigensolve with the reference's sign rule, the
explained variance and the projection. Functions take tensors on any device
and compute in their dtype; the estimators pass f32 tensors.

Precision tiers of the Gram pass (``gram_stats``):

- ``"highest"``: an f32 ``torch.matmul`` with TF32 off;
- ``"high"``: the split-bf16 kernel ``ops.gram_moments.fused_gram_moments``;
- ``"default"``: not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.ops.gram_moments import fused_gram_moments

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


def gram_stats(x: torch.Tensor, *, precision: str = "highest") -> GramStats:
    """The sufficient-statistics triple of one partition."""
    count = torch.tensor(x.shape[0], dtype=x.dtype, device=x.device)
    if precision == "highest":
        return GramStats(gram(x), x.sum(dim=0), count)
    if precision == "high":
        xtx, col_sum, _ = fused_gram_moments(x)
        return GramStats(xtx, col_sum, count)
    if precision == "default":
        raise NotImplementedError(
            "precision 'default' (one bf16 pass with an f32 result) is not "
            "ported yet; use 'high' or 'highest'"
        )
    raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")


def combine_gram_stats(a: GramStats, b: GramStats) -> GramStats:
    """Monoid combine: elementwise sum of the triples."""
    return GramStats(a.xtx + b.xtx, a.col_sum + b.col_sum, a.count + b.count)


def covariance_from_stats(stats: GramStats, *, mean_centering: bool) -> torch.Tensor:
    """Scatter-form covariance: XᵀX, or XᵀX − s·sᵀ/count when centering. No
    1/(n−1) scaling, as in the reference."""
    if not mean_centering:
        return stats.xtx
    denom = torch.clamp(stats.count, min=1.0)
    return stats.xtx - torch.outer(stats.col_sum, stats.col_sum) / denom


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
            f"solver {solver!r} is not ported yet (queued after the "
            "streamed-fold slice); use solver='full'"
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
