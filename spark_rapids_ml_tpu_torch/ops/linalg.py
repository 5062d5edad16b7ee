"""PCA linear algebra on torch tensors.

Counterpart of ``spark_rapids_ml_tpu/ops/linalg.py`` for the PCA fit:
per-partition sufficient statistics, their monoid combine, the streamed
fit's fold steps, the covariance (standardized or not), the decomposition
stage with its three solvers (the refined eigensolve, the randomized
subspace iteration and the QR → SVD direct path), the explained variance
and the projection; and the ``int8_dist`` policy's quantized product of
distance cross terms (``int8_quantized_matmul``). Functions take tensors
on any device and compute in their dtype; the estimators pass f32 tensors.

Precision tiers of the Gram pass (``gram_stats`` for the resident fit,
``gram_stats_weighted`` for the streamed fold):

- ``"highest"``: an f32 ``torch.matmul`` with TF32 off;
- ``"high"``: the split-bf16 kernels (three bf16 products),
  ``ops.gram_moments.fused_gram_moments`` resident and
  ``symmetric_gram_moments`` streamed. Their Gram drops loᵀlo, whose
  diagonal Σlo² is one-sided (~2⁻¹⁸ of Σx²) and would bias σ by
  (μ² + σ²)/σ² times that for a feature far from zero; so the diagonal is
  replaced by the kernels' Σ(hi + lo)², which drops nothing one-sided;
- ``"default"``: one bf16 pass with an f32 result, the same kernels'
  one-product instances (``products=1``): hiᵀhi with hi = bf16(x). Its
  diagonal Σhi² = Σx²(1 + 2δ + δ²), with δ the relative rounding of x, has
  the one-sided part Σx²δ² (about 2⁻¹⁸·Σx²/3 for RNE). σ reads only the
  diagonal, so for a standardized fit (``exact_diagonal=True``, the
  default of these functions) the diagonal is replaced by the kernels'
  exact f32 Σx². The unstandardized PCA fit passes
  ``exact_diagonal=False`` and keeps Σhi²: the Gram of hi is then one PSD
  matrix, and its explainedVariance lies nearer f64 than that of the
  mixed matrix (``tests/test_torch_pca.py::
  test_default_diagonal_rule_against_f64``), as in the JAX package.

The fold's precision policy (``TPU_ML_PRECISION_POLICY``,
``autotune/policy.py``) ``bf16_f32acc`` rounds the fold's matmul operands to
bf16 whatever the tier: the same function as ``"default"``, so it runs the
same instances. ``policy_matmul`` computes it for what the kernels do not
take (weights other than 1).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.autotune.policy import (
    FOLD_POLICIES,
    PrecisionPolicy,
    resolve_policy,
    validate_policy,
)
from spark_rapids_ml_tpu_torch.ops import scaler as S
from spark_rapids_ml_tpu_torch.ops.gram_moments import (
    fused_gram_moments,
    symmetric_gram_moments,
)

PRECISIONS = ("highest", "high", "default")
# the kernels' count of products for each tier they compute
_KERNEL_PRODUCTS = {"high": 3, "default": 1}

DEFAULT_POLICY = PrecisionPolicy.F32.value
_BF16_F32ACC = PrecisionPolicy.BF16_F32ACC.value


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


def policy_matmul(
    a: torch.Tensor, b: torch.Tensor, *, policy: str = DEFAULT_POLICY
) -> torch.Tensor:
    """The policy-aware product a·b. ``f32``: an f32 matmul with TF32 off.
    ``bf16_f32acc``: the operands rounded to bf16, their products (exact in
    f32) summed in f32 and the result in ``a``'s dtype, which is what the
    JAX package's ``preferred_element_type=f32`` product of bf16 operands
    computes. The port's kernels compute the unit-weight Gram under this
    policy; this product serves the rest (weighted folds)."""
    _require_f32_matmul()
    policy = validate_policy(policy, allowed=FOLD_POLICIES)
    if policy == _BF16_F32ACC:
        return (a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()).to(a.dtype)
    return a @ b


def quantize_int8(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(int8 tensor, its f32 scale): the per-tensor max-abs scale maps ``t``
    onto [−127, 127], then round half to even and clip, as the JAX
    package's ``int8_quantized_matmul`` quantizes."""
    amax = t.abs().max()
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    return torch.clamp(torch.round(t / scale), -127.0, 127.0).to(torch.int8), scale


def int8_matmul(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """The exact int32 product of int8 [m, K] and [K, N]. On the card it is
    ``torch._int_mm``, which takes more than 16 rows and an inner and outer
    dimension that are multiples of 8: zero padding brings the operands
    there and leaves every dot product unchanged. On the CPU it is an int32
    matmul."""
    if qa.device.type == "cpu":
        return qa.to(torch.int32) @ qb.to(torch.int32)
    (m, kk), n = qa.shape, qb.shape[1]
    pm, pk, pn = max(m, 17) - m, -kk % 8, -n % 8
    if pm or pk:
        qa = torch.nn.functional.pad(qa, (0, pk, 0, pm))
    if pk or pn:
        qb = torch.nn.functional.pad(qb, (0, pn, 0, pk))
    return torch._int_mm(qa, qb)[:m, :n]


def int8_quantized_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Symmetric per-tensor int8 quantized ``a·b``: the ``int8_dist``
    policy's cross term of k-means and k-NN scoring, never of a Gram. The
    int8 product accumulates in int32 and is dequantized by the product of
    the two scales."""
    qa, sa = quantize_int8(a)
    qb, sb = quantize_int8(b)
    return int8_matmul(qa, qb).to(a.dtype) * (sa * sb)


def _check_precision(precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")


def _kernel_gram(
    x: torch.Tensor, precision: str, *, symmetric: bool, exact_diagonal: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """(XᵀX, column sums) from the Gram kernel instance of a kernel tier
    (``"high"`` or ``"default"``), the diagonal replaced by the kernel's
    Σx² of that tier, except at ``"default"`` without ``exact_diagonal``
    (see the module note)."""
    kernel = symmetric_gram_moments if symmetric else fused_gram_moments
    xtx, col_sum, sum_sq = kernel(x, products=_KERNEL_PRODUCTS[precision])
    if exact_diagonal or precision != "default":
        xtx.diagonal().copy_(sum_sq)
    return xtx, col_sum


def gram_stats(x: torch.Tensor, *, precision: str = "highest",
               exact_diagonal: bool = True) -> GramStats:
    """The sufficient-statistics triple of one partition (``exact_diagonal``:
    the module note's rule at ``"default"``)."""
    _check_precision(precision)
    count = torch.tensor(x.shape[0], dtype=x.dtype, device=x.device)
    if precision == "highest":
        return GramStats(gram(x), x.sum(dim=0), count)
    return GramStats(*_kernel_gram(x, precision, symmetric=False,
                                   exact_diagonal=exact_diagonal), count)


def _gram_cost(x: torch.Tensor, *_, **__) -> tuple[float, float]:
    """Analytical cost of the Gram statistics of a [rows, n] block (the
    ``cost`` that ``telemetry.costmodel.capture`` reads): 2·rows·n² + 2·rows·n
    operations, and the block read once plus the f32 XᵀX, column sums and
    Σx² written once, rows·n·itemsize + (n² + 2n)·4 bytes. The same at every
    tier: it counts the function, not the kernel's bf16 passes."""
    rows, n = x.shape
    return 2.0 * rows * n * n + 2.0 * rows * n, float(rows * n * x.element_size() + (n * n + 2 * n) * 4)


gram_stats.cost = _gram_cost


def combine_gram_stats(a: GramStats, b: GramStats) -> GramStats:
    """Monoid combine: elementwise sum of the triples."""
    return GramStats(a.xtx + b.xtx, a.col_sum + b.col_sum, a.count + b.count)


def _fold_tier(precision: str, policy: str) -> str:
    """The tier a fold computes: ``bf16_f32acc`` rounds the operands to bf16
    whatever the tier, which is the one pass of ``"default"``."""
    _check_precision(precision)
    policy = validate_policy(policy, allowed=FOLD_POLICIES)
    return "default" if policy == _BF16_F32ACC else precision


def _split_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·b from the split's three products: hi = bf16(v) and lo = bf16(v −
    hi) of each operand, hiᵀhi + hiᵀlo + loᵀhi, each an f32 product of the
    bf16 values with TF32 off (exact products, f32 sums); loᵀlo (~2⁻¹⁶
    relative) is dropped. This is ``lax.Precision.HIGH``'s bf16×3, which
    ``torch.set_float32_matmul_precision("high")`` (TF32) is not."""
    _require_f32_matmul()
    a_hi = a.to(torch.bfloat16).float()
    a_lo = (a - a_hi).to(torch.bfloat16).float()
    b_hi = b.to(torch.bfloat16).float()
    b_lo = (b - b_hi).to(torch.bfloat16).float()
    return a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi


def gram_stats_weighted(
    x: torch.Tensor, w: torch.Tensor, *, precision: str = "highest",
    policy: str = DEFAULT_POLICY, exact_diagonal: bool = True,
) -> GramStats:
    """GramStats of one chunk under the masking convention: ``w`` carries
    instance weights on true rows and 0.0 on pad rows, so xᵀ(x·w), the
    weighted column sums and the weight-sum count are exact over padded
    chunks. The policy ``bf16_f32acc`` makes any tier the one-pass tier.

    - ``"highest"``: that arithmetic, with an f32 matmul; ``w`` may lie on
      the host and is copied to ``x``'s device.
    - ``"high"`` and ``"default"`` with unit weights (pass only the chunk's
      true rows with weight 1; PCA has no weight column): the symmetric
      kernel's instance of the tier (``exact_diagonal``: the module note's
      rule). The weights are read where they lie: a host tensor costs no
      device sync, which is why the streamed fold keeps them on the host.
    - ``"high"`` with other weights: xᵀ(x·w) from the split's three products
      (``_split_product``), outside any kernel as in the JAX package (whose
      weighted fold is an XLA product at ``Precision.HIGH``); its diagonal is
      the f32 Σw·x², by the module note's rule.
    - ``"default"`` with other weights: xᵀ(x·w) by ``policy_matmul``'s bf16
      product.
    """
    tier = _fold_tier(precision, policy)
    if tier == "highest":
        _require_f32_matmul()
        w = w.to(device=x.device, dtype=x.dtype, non_blocking=True)
        xw = x * w[:, None]
        return GramStats(x.T @ xw, xw.sum(dim=0), w.sum())
    if w.shape == (x.shape[0],) and bool(torch.all(w == 1)):  # tpulint: disable=TPL002 -- one read per fit picks the unweighted Gram
        xtx, col_sum = _kernel_gram(x, tier, symmetric=True, exact_diagonal=exact_diagonal)
        count = torch.full((), float(x.shape[0]), dtype=x.dtype, device=x.device)
        return GramStats(xtx, col_sum, count)
    if w.shape != (x.shape[0],):
        raise ValueError(
            f"got weights of shape {tuple(w.shape)} for {x.shape[0]} rows: pass one "
            "weight per row (unit weights take the kernel's instance)"
        )
    w = w.to(device=x.device, dtype=x.dtype, non_blocking=True)
    xw = x * w[:, None]
    if tier == "high":
        xtx = _split_product(x.T, xw)
        xtx.diagonal().copy_((x * xw).sum(dim=0))
    else:
        xtx = policy_matmul(x.T, xw, policy=_BF16_F32ACC)
    return GramStats(xtx, xw.sum(dim=0), w.sum())


def fold_gram_stats(
    carry: GramStats, x: torch.Tensor, w: torch.Tensor, *, precision: str = "highest",
    policy: str = DEFAULT_POLICY,
) -> GramStats:
    """One streamed-fit fold step, out of place: carry + the chunk's weighted
    stats."""
    return combine_gram_stats(
        carry, gram_stats_weighted(x, w, precision=precision, policy=policy)
    )


def init_gram_carry(n: int, device: torch.device | str) -> GramStats:
    """Zero f32 GramStats carry on ``device`` for ``gram_fold_step``."""
    new = dict(dtype=torch.float32, device=device)
    return GramStats(torch.zeros((n, n), **new), torch.zeros((n,), **new),
                     torch.zeros((), **new))


def gram_fold_step(precision: str = "highest", policy: str | None = None, *,
                   exact_diagonal: bool = True):
    """The streamed fit's fold step ``step(carry, x, w) -> carry``: adds the
    chunk's weighted stats into ``carry`` **in place** and returns it. This
    is the counterpart of the JAX step's donated carry: a stream of any
    length keeps one set of carry buffers, and every update is queued on the
    current stream without a sync. ``policy=None`` is the process default
    (``TPU_ML_PRECISION_POLICY``), resolved here, once, when the step is
    made. ``exact_diagonal``: the module note's rule."""
    _check_precision(precision)
    policy = resolve_policy(policy, allowed=FOLD_POLICIES)

    def step(carry: GramStats, x: torch.Tensor, w: torch.Tensor) -> GramStats:
        stats = gram_stats_weighted(x, w, precision=precision, policy=policy,
                                    exact_diagonal=exact_diagonal)
        carry.xtx.add_(stats.xtx)
        carry.col_sum.add_(stats.col_sum)
        carry.count.add_(stats.count)
        return carry

    step.cost = lambda carry, x, w: _gram_cost(x)
    return step


def gram_fold_xtx_step(precision: str = "highest", policy: str | None = None):
    """The fold step of the bare [n, n] Gram ``step(carry, x) -> carry``,
    in place (the JAX package's TruncatedSVD accumulator: no column sums or
    count; pad rows are zero, so no mask). The tiers and the policy as in
    ``gram_fold_step``: ``"highest"`` an f32 matmul, the others the symmetric
    kernel's instance."""
    _check_precision(precision)
    tier = _fold_tier(precision, resolve_policy(policy, allowed=FOLD_POLICIES))

    def step(carry: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        if tier == "highest":
            return carry.add_(gram(x))
        return carry.add_(_kernel_gram(x, tier, symmetric=True)[0])

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


def randomized_eigh_descending(
    cov: torch.Tensor,
    k: int,
    *,
    oversample: int = 10,
    power_iters: int = 2,
    seed: int = 0,
    omega: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Randomized top-k eigendecomposition of a PSD matrix, descending
    (Halko–Martinsson–Tropp subspace iteration): Y = A·Ω, then
    ``power_iters`` times Q ← qr(A·Q), and Rayleigh–Ritz on the l = k +
    oversample columns, O(n²·l) instead of the full eigh's O(n³).

    Ω [n, l] is standard normal from a ``torch.Generator`` on ``cov``'s
    device seeded with ``seed``; it cannot reproduce the JAX package's
    ``jax.random`` stream, so a caller that needs a given sketch passes it
    as ``omega``. The subspace, and so the result, does not depend on the
    signs QR chooses. Matmuls are f32 with TF32 off.

    Returns (components [n, k] sign-flipped, singular values √max(λ, 0) of
    all l Ritz values, tail_count = n − l)."""
    _require_f32_matmul()
    n = cov.shape[0]
    l = min(n, k + oversample)
    if omega is None:
        gen = torch.Generator(device=cov.device).manual_seed(seed)
        omega = torch.randn((n, l), generator=gen, dtype=cov.dtype, device=cov.device)
    elif tuple(omega.shape) != (n, l):
        raise ValueError(f"omega must be [{n}, {l}], got {tuple(omega.shape)}")
    omega = omega.to(device=cov.device, dtype=cov.dtype)
    q = torch.linalg.qr(cov @ omega).Q
    for _ in range(power_iters):
        q = torch.linalg.qr(cov @ q).Q
    b = q.T @ (cov @ q)
    b = 0.5 * (b + b.T)
    evals, v = torch.linalg.eigh(b)  # ascending
    evals = evals.flip(0)
    v = v.flip(1)[:, :k]
    u = sign_flip(q @ v)
    singular_values = torch.sqrt(torch.clamp(evals, min=0.0))
    return u, singular_values, torch.tensor(n - l, dtype=cov.dtype, device=cov.device)


def explained_variance_from_partial(
    singular_values: torch.Tensor, trace: torch.Tensor, tail_count: torch.Tensor
) -> torch.Tensor:
    """The reference's explainedVariance from a partial spectrum: the unseen
    tail's Σ√λ is estimated from the leftover trace as √(tail_count · Σλ_tail)
    (by concavity an upper bound, exact for a flat tail). Ratios for all
    given values; callers cut to k."""
    top_sum = torch.sum(singular_values)
    top_eval_sum = torch.sum(singular_values**2)
    tail_eval_sum = torch.clamp(trace - top_eval_sum, min=0.0)
    tail_sum = torch.sqrt(tail_eval_sum * torch.clamp(tail_count, min=0.0))
    total = top_sum + tail_sum
    safe_total = torch.where(total > 0, total, torch.ones_like(total))
    return singular_values / safe_total


def randomized_profitable(n: int, k: int, *, oversample: int = 10) -> bool:
    """The ``"auto"`` solver's rule, the JAX package's predicate unchanged:
    the subspace iteration is taken when n ≥ 256 and the captured subspace
    l = k + oversample is at most n/4."""
    return n >= 256 and (k + oversample) * 4 <= n


SOLVERS = ("full", "randomized", "svd", "auto")


def pca_fit_from_cov(
    cov: torch.Tensor,
    k: int,
    *,
    solver: str = "full",
    oversample: int = 10,
    power_iters: int = 2,
    seed: int = 0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Decomposition stage: covariance → (pc [n, k], explained variance [k]).

    - ``"full"``: the refined eigensolve (``eigh_descending``);
    - ``"randomized"``: ``randomized_eigh_descending``, explained variance
      with the trace-based tail estimate;
    - ``"auto"``: randomized where ``randomized_profitable``, else full.
    """
    n = cov.shape[0]
    if solver == "auto":
        solver = "randomized" if randomized_profitable(n, k, oversample=oversample) else "full"
    if solver == "randomized":
        u, s, tail_count = randomized_eigh_descending(
            cov, k, oversample=oversample, power_iters=power_iters, seed=seed
        )
        return u, explained_variance_from_partial(s, torch.trace(cov), tail_count)[:k]
    if solver != "full":
        raise ValueError(f"unknown solver {solver!r}")
    components, s = eigh_descending(cov)
    return components[:, :k], explained_variance(s, k)


def pca_fit_local(
    x: torch.Tensor, k: int, *, mean_centering: bool = False,
    precision: str = "highest",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-block fit: rows → (pc, explained variance), the Gram pass at
    ``precision``."""
    stats = gram_stats(x, precision=precision)
    cov = covariance_from_stats(stats, mean_centering=mean_centering)
    return pca_fit_from_cov(cov, k)


def qr_r(x: torch.Tensor) -> torch.Tensor:
    """R factor [n, n] of a row block (RᵀR = XᵀX, without squaring the
    condition number). A block of fewer than n rows is zero-padded to n,
    which leaves R's content unchanged."""
    rows, n = x.shape
    if rows < n:
        x = torch.cat([x, x.new_zeros((n - rows, n))])
    return torch.linalg.qr(x, mode="r").R


def combine_r(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Associative combine of R factors: R of the stacked pair, so
    RᵀR sums as the Gram does."""
    return torch.linalg.qr(torch.cat([a, b]), mode="r").R


def svd_components_from_r(r: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """R → (components [n, k] sign-flipped, singular values [n]), both of X:
    R's singular values are X's."""
    _, s, vh = torch.linalg.svd(r, full_matrices=False)  # descending
    return sign_flip(vh.T[:, :k]), s


def svd_from_r(r: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Decomposition stage of the direct path: R → (pc [n, k], explained
    variance [k]) by the reference's definition, without forming XᵀX."""
    components, s = svd_components_from_r(r, k)
    return components, explained_variance(s, k)


def pca_fit_local_svd(
    x: torch.Tensor, k: int, *, mean_centering: bool = False
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-block direct fit: rows → QR → SVD(R) → (pc, explained
    variance), at cond(X) rather than the Gram's cond(X)²."""
    if mean_centering:
        x = x - x.mean(dim=0, keepdim=True)
    return svd_from_r(qr_r(x), k)


def project(x: torch.Tensor, pc: torch.Tensor) -> torch.Tensor:
    """Transform projection X·PC of a [rows, n] block by [n, k] components."""
    _require_f32_matmul()
    return x @ pc


def _project_cost(x: torch.Tensor, pc: torch.Tensor) -> tuple[float, float]:
    """2·rows·n·k operations; X and PC read once and X·PC written once."""
    (rows, n), k = x.shape, pc.shape[1]
    return 2.0 * rows * n * k, float((rows * n + n * k + rows * k) * x.element_size())


project.cost = _project_cost


def min_cosine_vs_f64_oracle(x_host, pc, k: int) -> float:
    """Min per-component |cosine| of fitted components against the f64 host
    oracle (uncentered scatter eigh, descending)."""
    xa = np.asarray(x_host, dtype=np.float64)
    if isinstance(pc, torch.Tensor):
        pc = pc.detach().cpu().numpy()  # tpulint: disable=TPL002 -- a host check against the f64 oracle, off the fit path
    pc = np.asarray(pc, dtype=np.float64)
    _, evecs = np.linalg.eigh(xa.T @ xa)
    oracle = evecs[:, ::-1][:, :k]
    cosines = np.abs(np.sum(pc * oracle, axis=0)) / (
        np.linalg.norm(pc, axis=0) * np.linalg.norm(oracle, axis=0)
    )
    return float(cosines.min())
