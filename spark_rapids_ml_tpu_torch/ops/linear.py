"""Linear-model statistics and solves on torch tensors: normal equations,
elastic net by FISTA, and Newton (IRLS) for the logistic, squared-hinge and
softmax losses.

Counterpart of ``spark_rapids_ml_tpu/ops/linear.py``, function by function.
Each fit is a commutative monoid of per-partition statistics, summed across
partitions, then a small solve:

- **LinearRegression**: (XᵀX, Xᵀy, Σx, Σy, Σy², m), one pass;
- **LogisticRegression / LinearSVC**: each Newton iteration's (XᵀWX,
  Xᵀr, loss, m), W and r from the loss at the current parameters;
- **softmax**: the full [C·d, C·d] Fisher information as C(C+1)/2 [d, d]
  blocks, each one product, and its gradient and loss.

The intercept rides as an appended column of ones (``augment``), exempt
from every penalty.

Dtypes. The statistics functions compute in their inputs' dtype: the
estimators pass f32 rows, so every product over the rows is an f32 matmul
with TF32 off (``linalg._require_f32_matmul``), or under
``policy="bf16_f32acc"`` the bf16-operand product of
``linalg.policy_matmul``. The estimators promote the normal equations'
statistics to f64 (``as_f64``) and keep the Newton parameters in f64, so
the [n, n] solves, the Newton parameters and the streamed fit's carry
(``init_linear_carry``) are f64 on the card: the products over the rows
stay f32, and the sums of many chunk partials and the centred moments
A = XᵀX − m·μμᵀ lose nothing more to f32 rounding (the JAX package's
streamed carry is its f64 wire dtype too). The Newton statistics stay
in their products' dtype, which sizes the solve's ridge; the solve runs
in the parameters' dtype.

The JAX package's jitted ``lax.while_loop``s become Python loops with a
host read of the stop test each iteration, and its value-level fallbacks
(``jnp.where`` between a Cholesky solve and ``lstsq``) become branches on
``torch.linalg.cholesky_ex``'s status: the same results, and a wait for the
device per decision, which these [n, n] problems can afford.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from spark_rapids_ml_tpu_torch.autotune.policy import FOLD_POLICIES, resolve_policy
from spark_rapids_ml_tpu_torch.ops.linalg import (
    DEFAULT_POLICY,
    _require_f32_matmul,
    policy_matmul,
)


def augment(x: torch.Tensor) -> torch.Tensor:
    """Append an all-ones intercept column: [rows, n] → [rows, n+1]."""
    return torch.cat([x, x.new_ones((x.shape[0], 1))], dim=1)


def as_f64(stats: NamedTuple) -> NamedTuple:
    """The same statistics with every field in f64 (the solves' dtype)."""
    return type(stats)(*(v.double() for v in stats))


# ---------------------------------------------------------------------------
# Linear regression (normal equations)
# ---------------------------------------------------------------------------


class LinearStats(NamedTuple):
    """Sufficient statistics for (optionally intercepted, L2) least squares."""

    xtx: torch.Tensor    # [n, n]
    xty: torch.Tensor    # [n]
    x_sum: torch.Tensor  # [n]
    y_sum: torch.Tensor  # []
    y_sq: torch.Tensor   # []
    count: torch.Tensor  # []


def linear_stats(
    x: torch.Tensor,
    y: torch.Tensor,
    weights: torch.Tensor | None = None,
    *,
    policy: str = DEFAULT_POLICY,
) -> LinearStats:
    """One-pass statistics over a row block; ``weights`` carries instance
    weights (0 masks a row). ``policy="bf16_f32acc"`` rounds only the XᵀX
    and Xᵀy operands to bf16; the sums and the count stay in ``x``'s
    dtype."""
    if weights is not None:
        weights = weights.to(device=x.device, dtype=x.dtype)
        xw = x * weights[:, None]
        yw = y * weights
        count = weights.sum()
    else:
        xw, yw = x, y
        count = torch.tensor(float(x.shape[0]), dtype=x.dtype, device=x.device)
    return LinearStats(
        xtx=policy_matmul(x.T, xw, policy=policy),
        xty=policy_matmul(x.T, yw[:, None], policy=policy)[:, 0],
        x_sum=xw.sum(dim=0),
        y_sum=yw.sum(),
        y_sq=(yw * y).sum(),
        count=count,
    )


def combine_linear_stats(a: LinearStats, b: LinearStats) -> LinearStats:
    return LinearStats(*(av + bv for av, bv in zip(a, b)))


def fold_linear_stats(
    carry: LinearStats,
    x: torch.Tensor,
    y: torch.Tensor,
    w: torch.Tensor,
    *,
    policy: str = DEFAULT_POLICY,
) -> LinearStats:
    """One streamed-fit fold step, out of place: carry + the chunk's
    weighted statistics (``w``: instance weights, 0 on pad rows)."""
    return combine_linear_stats(carry, linear_stats(x, y, w, policy=policy))


def linear_fold_step(policy: str | None = None):
    """The streamed fit's fold step ``step(carry, x, y, w) -> carry``: the
    chunk's statistics (products in ``x``'s dtype) added into ``carry`` **in
    place**, in the carry's dtype: the counterpart of the JAX step's donated
    carry, one set of buffers for a stream of any length and no sync.
    ``policy=None`` resolves ``TPU_ML_PRECISION_POLICY`` here, once."""
    policy = resolve_policy(policy, allowed=FOLD_POLICIES)

    def step(carry: LinearStats, x: torch.Tensor, y: torch.Tensor,
             w: torch.Tensor) -> LinearStats:
        for acc, value in zip(carry, linear_stats(x, y, w, policy=policy)):
            acc.add_(value)
        return carry

    def cost(carry: LinearStats, x: torch.Tensor, y: torch.Tensor, w: torch.Tensor):
        """``gram_stats``'s cost in the same form (``telemetry.costmodel``):
        XᵀX, Xᵀy and the weighted sums, 2·rows·n² + 4·rows·n operations;
        x, y and w read once and the carry's six statistics written once."""
        rows, n = x.shape
        written = (n * n + 2 * n + 3) * carry.xtx.element_size()
        return (2.0 * rows * n * n + 4.0 * rows * n,
                float(rows * (n + 2) * x.element_size() + written))

    step.cost = cost
    return step


def init_linear_carry(
    n: int, device: torch.device | str, dtype: torch.dtype = torch.float64
) -> LinearStats:
    """Zero LinearStats carry for ``linear_fold_step`` on ``device``, f64
    unless ``dtype`` says otherwise (see the module note)."""
    new = dict(dtype=dtype, device=device)
    z = torch.zeros
    return LinearStats(z((n, n), **new), z((n,), **new), z((n,), **new),
                       z((), **new), z((), **new), z((), **new))


def _centered(stats: LinearStats, fit_intercept: bool):
    """(m ≥ 1, A, b): the normal equations' matrix and right side, on
    centred moments with an intercept."""
    m = torch.clamp(stats.count, min=1.0)
    if not fit_intercept:
        return m, stats.xtx, stats.xty
    mu = stats.x_sum / m
    ybar = stats.y_sum / m
    return m, stats.xtx - m * torch.outer(mu, mu), stats.xty - m * mu * ybar


def _intercept(stats: LinearStats, m: torch.Tensor, coef: torch.Tensor,
               fit_intercept: bool) -> torch.Tensor:
    if not fit_intercept:
        return torch.zeros((), dtype=coef.dtype, device=coef.device)
    return stats.y_sum / m - torch.dot(stats.x_sum / m, coef)


def _cholesky_solve(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor | None:
    """The solution of a·x = b for a positive definite ``a``, or None where
    the factorization fails (the JAX package's NaN result)."""
    chol, info = torch.linalg.cholesky_ex(a)
    if int(info) != 0:
        return None
    return torch.cholesky_solve(b[:, None], chol)[:, 0]


def solve_normal(
    stats: LinearStats, *, reg_param: float = 0.0, fit_intercept: bool = True
) -> tuple[torch.Tensor, torch.Tensor]:
    """(coefficients [n], intercept []) from reduced statistics.

    With an intercept the normal equations are solved on centred moments
    (A = XᵀX − m·μμᵀ, b = Xᵀy − m·μȳ), which never penalizes the
    intercept; λ scales with the row count (Spark ML's convention: the
    result is ``sklearn.linear_model.Ridge(alpha=λ·m)``'s). A rank-deficient
    design (constant or collinear columns at λ = 0) fails the Cholesky
    solve or gives a non-finite one; it falls back to the min-norm
    least-squares solution (``torch.linalg.pinv``, whose cut-off
    eps·n·σ_max is ``jnp.linalg.lstsq``'s; ``torch.linalg.lstsq`` on the
    card takes full-rank systems only)."""
    m, a, b = _centered(stats, fit_intercept)
    a = a + reg_param * m * torch.eye(a.shape[0], dtype=a.dtype, device=a.device)
    coef = _cholesky_solve(a, b)
    if coef is None or not bool(torch.isfinite(coef).all()):
        coef = torch.linalg.pinv(a, hermitian=True) @ b
    return coef, _intercept(stats, m, coef, fit_intercept)


def _soft_threshold(v: torch.Tensor, thresh) -> torch.Tensor:
    return torch.sign(v) * torch.clamp(torch.abs(v) - thresh, min=0.0)


def _power_lam_max(a: torch.Tensor) -> torch.Tensor:
    """λmax estimate of PSD ``a`` by 32 power iterations, made safe for
    FISTA's step 1/L: ‖a·v‖ of the final unit iterate (≥ the Rayleigh
    quotient), inflated by 5%, and clamped into the PSD envelope
    [trace/n, trace]; an estimate below trace/n (a collapsed iteration)
    falls back to the trace."""
    n = a.shape[0]
    v = torch.full((n,), 1.0 / n ** 0.5, dtype=a.dtype, device=a.device)
    for _ in range(32):
        v = a @ v
        v = v / torch.clamp(torch.linalg.norm(v), min=1e-30)
    est = 1.05 * torch.linalg.norm(a @ v)
    tr = torch.trace(a)
    return torch.where(est >= tr / n, torch.minimum(est, tr), tr)


def _fista(grad, thresh, eta, w0: torch.Tensor, max_iter: int, tol: float) -> torch.Tensor:
    """Beck–Teboulle accelerated proximal gradient: minimizes smooth(w) +
    ‖thresh/eta ⊙ w‖₁ given the smooth part's ``grad`` and step ``eta``;
    stops once the relative coefficient change is at most ``tol`` (a NaN
    change stops it too) or after ``max_iter`` iterations."""
    w = z = w0
    t = 1.0
    for _ in range(max_iter):
        w_new = _soft_threshold(z - eta * grad(z), thresh)
        t_new = 0.5 * (1.0 + (1.0 + 4.0 * t * t) ** 0.5)
        z = w_new + ((t - 1.0) / t_new) * (w_new - w)
        delta = torch.max(torch.abs(w_new - w)) / torch.clamp(
            torch.max(torch.abs(w_new)), min=1e-12
        )
        w, t = w_new, t_new
        if not float(delta) > tol:
            break
    return w


def _check_alpha(elastic_net_param: float) -> None:
    if not 0.0 <= elastic_net_param <= 1.0:
        raise ValueError(
            f"elastic_net_param must be in [0, 1], got {elastic_net_param}"
        )


def solve_elastic_net(
    stats: LinearStats,
    *,
    reg_param: float,
    elastic_net_param: float,
    fit_intercept: bool = True,
    max_iter: int = 500,
    tol: float = 1e-8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(coefficients [n], intercept []) for the elastic-net objective

        1/(2m)·‖y − Xw − b₀‖² + λ·(α‖w‖₁ + (1−α)/2·‖w‖²)

    (``sklearn.linear_model.ElasticNet(alpha=λ, l1_ratio=α)``), from the
    same reduced statistics as the closed form: FISTA on the [n, n]
    problem, gradient (Aw − b)/m + λ(1−α)w, step 1/L with L =
    λmax(A)/m + λ(1−α) (``_power_lam_max``). No further pass over the
    data."""
    _check_alpha(elastic_net_param)
    m, a, b = _centered(stats, fit_intercept)
    lam1 = reg_param * elastic_net_param
    lam2 = reg_param * (1.0 - elastic_net_param)
    lip = _power_lam_max(a) / m + lam2
    eta = 1.0 / torch.clamp(lip, min=1e-30)

    def grad(w):
        return (a @ w - b) / m + lam2 * w

    w0 = torch.zeros(a.shape[0], dtype=a.dtype, device=a.device)
    coef = _fista(grad, eta * lam1, eta, w0, max_iter, tol)
    return coef, _intercept(stats, m, coef, fit_intercept)


def solve_from_stats(
    stats: LinearStats,
    *,
    reg_param: float = 0.0,
    elastic_net_param: float = 0.0,
    fit_intercept: bool = True,
    max_iter: int = 500,
    tol: float = 1e-8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The linear solve on reduced statistics: the closed-form normal
    equations for pure L2 (α = 0), FISTA for any L1 mixture."""
    if elastic_net_param == 0.0:
        return solve_normal(stats, reg_param=reg_param, fit_intercept=fit_intercept)
    return solve_elastic_net(
        stats, reg_param=reg_param, elastic_net_param=elastic_net_param,
        fit_intercept=fit_intercept, max_iter=max_iter, tol=tol,
    )


def predict_linear(x: torch.Tensor, coef: torch.Tensor, intercept: torch.Tensor) -> torch.Tensor:
    """x·coef + intercept, an f32 product with TF32 off for f32 ``x``."""
    _require_f32_matmul()
    return x @ coef + intercept


# ---------------------------------------------------------------------------
# Logistic regression and LinearSVC (IRLS / Newton)
# ---------------------------------------------------------------------------


class NewtonStats(NamedTuple):
    """One Newton iteration's sufficient statistics over a row block."""

    hess: torch.Tensor   # [d, d]: XᵀWX
    grad: torch.Tensor   # [d]: Xᵀr, the ascent direction
    loss: torch.Tensor   # []
    count: torch.Tensor  # []


def combine_newton_stats(a: NewtonStats, b: NewtonStats) -> NewtonStats:
    return NewtonStats(*(av + bv for av, bv in zip(a, b)))


def _mask(x_aug: torch.Tensor, weights: torch.Tensor | None) -> torch.Tensor:
    if weights is None:
        return torch.ones(x_aug.shape[0], dtype=x_aug.dtype, device=x_aug.device)
    return weights.to(device=x_aug.device, dtype=x_aug.dtype)


def _weighted_gram(x_aug: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Xᵀ diag(v) X, one f32 product."""
    return x_aug.T @ (x_aug * v[:, None])


def logistic_newton_stats(
    x_aug: torch.Tensor,
    y: torch.Tensor,
    w_full: torch.Tensor,
    weights: torch.Tensor | None = None,
) -> NewtonStats:
    """Gradient, Hessian and log-loss at ``w_full`` [d] over an augmented
    block ``x_aug`` [rows, d], in ``x_aug``'s dtype (``w_full`` is cast to
    it)."""
    _require_f32_matmul()
    z = x_aug @ w_full.to(x_aug.dtype)
    p = torch.sigmoid(z)
    mask = _mask(x_aug, weights)
    y = y.to(x_aug.dtype)
    # log-loss through logaddexp for stability: log(1 + e^z) − y·z
    loss = torch.sum((torch.logaddexp(torch.zeros_like(z), z) - y * z) * mask)
    return NewtonStats(
        hess=_weighted_gram(x_aug, p * (1.0 - p) * mask),
        grad=x_aug.T @ ((y - p) * mask),
        loss=loss,
        count=mask.sum(),
    )


def svc_newton_stats(
    x_aug: torch.Tensor,
    y: torch.Tensor,
    w_full: torch.Tensor,
    weights: torch.Tensor | None = None,
) -> NewtonStats:
    """Squared-hinge (L2-SVM, LinearSVC) Newton statistics: labels 0/1 map
    to ŷ = ±1; with margin mᵢ = max(1 − ŷᵢzᵢ, 0) and the active set mᵢ > 0,
    loss Σcᵢmᵢ², gradient Σ2cᵢŷᵢmᵢxᵢ, Hessian Σ2cᵢxᵢxᵢᵀ over the active
    rows: the logistic path's monoid, so the same Newton loop fits it."""
    _require_f32_matmul()
    z = x_aug @ w_full.to(x_aug.dtype)
    yy = 2.0 * y.to(x_aug.dtype) - 1.0
    c = _mask(x_aug, weights)
    margin = torch.clamp(1.0 - yy * z, min=0.0)
    return NewtonStats(
        hess=_weighted_gram(x_aug, 2.0 * c * (margin > 0)),
        grad=x_aug.T @ (2.0 * c * yy * margin),
        loss=torch.sum(c * margin * margin),
        count=c.sum(),
    )


def _regularized_newton_solve(
    w: torch.Tensor,
    hess: torch.Tensor,
    grad: torch.Tensor,
    pen: torch.Tensor,
    m: torch.Tensor,
    reg_param: float,
    elastic_net_param: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The Newton step's tail for the binary and softmax paths: a Cholesky
    solve at α = 0, a warm-started FISTA prox step otherwise; ``hess`` and
    ``grad`` carry the L2 fold and the eps ridge already.

    Divergence guard: a non-finite proposal (separable data without a
    penalty, whose iterates grow until the solve overflows) is rejected for
    the incoming iterate with the step norm NaN as a sentinel, so the loop's
    ``not step > tol`` stops there; ``check_newton_outcome`` tells a first
    step from zero (non-finite data) from that divergence."""
    nan = torch.full((), float("nan"), dtype=w.dtype, device=w.device)
    if elastic_net_param == 0.0:
        delta = _cholesky_solve(hess, grad)
        if delta is None:
            return w, nan
        new_w, step = w + delta, torch.linalg.norm(delta)
    else:
        lam1 = reg_param * elastic_net_param * m
        eta = 1.0 / torch.clamp(_power_lam_max(hess), min=1e-30)

        def sub_grad(z):
            return hess @ (z - w) - grad

        new_w = _fista(sub_grad, eta * lam1 * pen, eta, w, 200, 1e-10)
        step = torch.linalg.norm(new_w - w)
    if bool(torch.isfinite(step)) and bool(torch.isfinite(new_w).all()):
        return new_w, step
    return w, nan


def check_newton_outcome(step_norm, w) -> None:
    """Host decode of a Newton loop's final (step, w): a NaN step with
    all-zero parameters means the first step from the zero start was
    already non-finite, so the data holds NaN or Inf: raise. A NaN step with
    non-zero parameters is the separable divergence, whose last finite
    iterate is the accepted model."""
    import numpy as np

    if isinstance(step_norm, torch.Tensor):
        step_norm = step_norm.item()
    if isinstance(w, torch.Tensor):
        w = w.cpu().numpy()
    if np.isnan(float(step_norm)) and not np.asarray(w).any():
        raise ValueError(
            "the first Newton step produced non-finite statistics from the "
            "zero initialization — the features, labels, or instance "
            "weights contain NaN/Inf values; clean or impute them before "
            "fit"
        )


def _penalized(w: torch.Tensor, stats, pen: torch.Tensor, reg_param: float,
               elastic_net_param: float):
    """(hess, grad, m) in ``w``'s dtype, with the L2 term folded in and the
    √eps·trace/d ridge that keeps the solve well posed where classes
    separate or, for softmax, along the class-shift flat direction, where
    the rounding of the Hessian's products leaves it slightly indefinite
    (about −5e-5 relative in f32). eps is that of the statistics' dtype,
    the products': f32 statistics solved in f64 keep their f32 rounding,
    which an f64 ridge would not cover."""
    eps = torch.finfo(stats.hess.dtype).eps ** 0.5
    hess, grad, m = (v.to(w.dtype) for v in (stats.hess, stats.grad, stats.count))
    m = torch.clamp(m, min=1.0)
    lam2 = reg_param * (1.0 - elastic_net_param) * m * pen
    hess = hess + torch.diag(lam2)
    grad = grad - lam2 * w
    d = w.shape[0]
    ridge = eps * torch.trace(hess) / d
    return hess + ridge * torch.eye(d, dtype=hess.dtype, device=hess.device), grad, m


def newton_update(
    w_full: torch.Tensor,
    stats: NewtonStats,
    *,
    reg_param: float = 0.0,
    elastic_net_param: float = 0.0,
    fit_intercept: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One Newton (α = 0) or proximal-Newton (α > 0) step on the objective
    (1/m)·Σ loss + λ·(α‖w‖₁ + (1−α)/2·‖w‖²), the intercept coordinate (last,
    with ``fit_intercept``) exempt: (new w, step norm). Solves in
    ``w_full``'s dtype, the ridge sized by ``stats``' (``_penalized``)."""
    _check_alpha(elastic_net_param)
    d = w_full.shape[0]
    pen = torch.ones(d, dtype=w_full.dtype, device=w_full.device)
    if fit_intercept:
        pen[-1] = 0.0
    hess, grad, m = _penalized(w_full, stats, pen, reg_param, elastic_net_param)
    return _regularized_newton_solve(w_full, hess, grad, pen, m, reg_param, elastic_net_param)


def predict_logistic_proba(x: torch.Tensor, coef: torch.Tensor,
                           intercept: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(predict_linear(x, coef, intercept))


# ---------------------------------------------------------------------------
# Multinomial (softmax) logistic regression — full-Newton IRLS
# ---------------------------------------------------------------------------


class SoftmaxStats(NamedTuple):
    """One softmax-Newton iteration's statistics over a row block: the full
    [C·d, C·d] Fisher information, C(C+1)/2 distinct [d, d] blocks
    H[c,c'] = Xᵀ diag(w·p_c(δ_cc' − p_c')) X (at C = 10, d = 513: 55
    products and a 5,130² matrix)."""

    hess: torch.Tensor   # [C·d, C·d]
    grad: torch.Tensor   # [C·d], flattened [C, d]
    loss: torch.Tensor   # []
    count: torch.Tensor  # []


def combine_softmax_stats(a: SoftmaxStats, b: SoftmaxStats) -> SoftmaxStats:
    return SoftmaxStats(*(av + bv for av, bv in zip(a, b)))


def softmax_newton_stats(
    x_aug: torch.Tensor,
    y_idx: torch.Tensor,
    w_flat: torch.Tensor,
    n_classes: int,
    weights: torch.Tensor | None = None,
) -> SoftmaxStats:
    """Gradient, Hessian and NLL of the softmax model at ``w_flat`` [C·d]
    over ``x_aug`` [rows, d] with integer labels ``y_idx`` in [0, C). The
    Hessian is written block by block into one [C·d, C·d] tensor, the upper
    blocks from one product each and the lower ones as their transposes: no
    [rows, C, C] intermediate, and one [rows, d] scaled copy of the rows at
    a time."""
    _require_f32_matmul()
    rows, d = x_aug.shape
    c = n_classes
    w = w_flat.to(x_aug.dtype).reshape(c, d)
    mask = _mask(x_aug, weights)
    logits = x_aug @ w.T  # [rows, C]
    logz = torch.logsumexp(logits, dim=1)
    p = torch.exp(logits - logz[:, None])
    onehot = torch.nn.functional.one_hot(y_idx.long(), c).to(x_aug.dtype)
    loss = torch.sum((logz - torch.sum(onehot * logits, dim=1)) * mask)
    grad = ((onehot - p) * mask[:, None]).T @ x_aug
    hess = torch.empty((c * d, c * d), dtype=x_aug.dtype, device=x_aug.device)
    for ci in range(c):
        for cj in range(ci, c):
            delta = 1.0 if ci == cj else 0.0
            blk = _weighted_gram(x_aug, mask * p[:, ci] * (delta - p[:, cj]))
            hess[ci * d:(ci + 1) * d, cj * d:(cj + 1) * d] = blk
            if ci != cj:
                hess[cj * d:(cj + 1) * d, ci * d:(ci + 1) * d] = blk.T
    return SoftmaxStats(hess=hess, grad=grad.reshape(-1), loss=loss, count=mask.sum())


def softmax_newton_update(
    w_flat: torch.Tensor,
    stats: SoftmaxStats,
    n_classes: int,
    *,
    reg_param: float = 0.0,
    elastic_net_param: float = 0.0,
    fit_intercept: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One Newton / proximal-Newton step on the flattened [C·d] parameter:
    L2 on every coordinate but the per-class intercepts, the √eps ridge
    pinning the class-shift flat direction, FISTA for α > 0 (the L1 prox is
    elementwise on the flat vector). Dtypes as ``newton_update``'s."""
    _check_alpha(elastic_net_param)
    cd = w_flat.shape[0]
    d = cd // n_classes
    pen = torch.ones((n_classes, d), dtype=w_flat.dtype, device=w_flat.device)
    if fit_intercept:
        pen[:, -1] = 0.0
    pen = pen.reshape(-1)
    hess, grad, m = _penalized(w_flat, stats, pen, reg_param, elastic_net_param)
    return _regularized_newton_solve(w_flat, hess, grad, pen, m, reg_param, elastic_net_param)


def predict_softmax_proba(x: torch.Tensor, coef: torch.Tensor,
                          intercept: torch.Tensor) -> torch.Tensor:
    """[rows, C] class probabilities; ``coef`` [C, n], ``intercept`` [C]."""
    _require_f32_matmul()
    return torch.softmax(x @ coef.T + intercept[None, :], dim=1)
