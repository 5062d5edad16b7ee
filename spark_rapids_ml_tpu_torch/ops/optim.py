"""Full-batch optimizers on one flat parameter tensor: the port's own
reproductions of the optax 0.2.6 transforms that the JAX package's MLP and
FM fits run (``optax.sgd``, ``optax.adamw``, ``optax.lbfgs()``).

The JAX package runs each fit as one ``lax.while_loop``; here the loop is
Python over device tensors, with autograd for the gradients:

- ``minimize`` is the loop of both fits and its stop rule: iterate while
  ``it < max_iter`` and ``|prev − cur| > tol``, where ``prev`` is the loss
  before a step and ``cur`` the loss after it (one extra forward per
  iteration). Each iteration reads its two losses to the host in one read;
- ``sgd_step`` and ``AdamW`` follow optax's order of operations: AdamW's
  moments, bias corrections, ``mhat/(sqrt(nhat)+eps)``, then the decoupled
  ``weight_decay·param``, then ``param − lr·u``;
- ``LBFGS`` is ``optax.lbfgs()`` at its defaults: memory 10, the scaled
  identity (``scale_init_precond``; the first step capped at 1/‖g‖), and
  the zoom line search ``scale_by_zoom_linesearch(max_linesearch_steps=20,
  initial_guess_strategy="one")`` with its default tolerances. The
  two-loop recursion and the trial points stay on the device; the line
  search's decisions are host arithmetic on the values and slopes it reads
  (one read of two scalars per trial point), in f64 where optax mixes f32
  and f64 scalars. The value and gradient at the accepted step are kept
  and reused by the next iteration, as ``optax.value_and_grad_from_state``
  does. ``torch.optim.LBFGS`` is a different algorithm (its own strong
  Wolfe search, memory update and stop rules) and is not used.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

LossFn = Callable[[torch.Tensor], torch.Tensor]


def value_and_grad(fn: LossFn, flat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(fn(flat) detached, ∇fn(flat)) by autograd."""
    with torch.enable_grad():
        p = flat.detach().requires_grad_(True)
        value = fn(p)
        (grad,) = torch.autograd.grad(value, p)
    return value.detach(), grad


def minimize(
    loss_fn: LossFn,
    flat0: torch.Tensor,
    step: Callable[[torch.Tensor], tuple[torch.Tensor, torch.Tensor]],
    *,
    max_iter: int,
    tol: float,
    callback: Callable[[int, torch.Tensor, float], None] | None = None,
) -> tuple[torch.Tensor, float, int]:
    """The JAX package's training loop: ``step(flat) -> (new flat, loss at
    flat)`` while ``it < max_iter`` and ``|prev − cur| > tol`` (compared in
    the parameters' dtype), ``cur`` the loss at the new flat. Returns
    (flat, final loss, iterations). ``callback(it, flat, cur)`` sees every
    iterate."""
    dtype = {torch.float32: np.float32, torch.float64: np.float64}[flat0.dtype]
    with torch.no_grad():
        flat = flat0
        prev, cur = dtype(np.inf), dtype(loss_fn(flat).item())  # tpulint: disable=TPL002 -- the convergence test reads the loss on the host, as optax's loop does
        it = 0
        while it < max_iter and np.abs(prev - cur) > tol:
            flat, value = step(flat)
            prev, cur = (dtype(v) for v in torch.stack([value, loss_fn(flat)]).tolist())  # tpulint: disable=TPL002 -- the convergence test reads the loss on the host, once per iteration
            it += 1
            if callback is not None:
                callback(it, flat, float(cur))
    return flat, float(cur), it


def sgd_step(loss_fn: LossFn, lr: float):
    """``optax.sgd(lr)`` as a ``minimize`` step."""

    def step(flat):
        value, grad = value_and_grad(loss_fn, flat)
        return flat + (-lr) * grad, value

    return step


class AdamW:
    """``optax.adamw(lr, weight_decay=wd)`` at optax's moments: ``update(grad,
    params)`` returns the update that is added to params."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, lr: float, weight_decay: float = 0.0):
        self.lr, self.wd = lr, weight_decay
        self.count = 0
        self.mu = self.nu = None

    def update(self, grad: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
        if self.mu is None:
            self.mu, self.nu = torch.zeros_like(params), torch.zeros_like(params)
        self.mu = (1 - self.b1) * grad + self.b1 * self.mu
        self.nu = (1 - self.b2) * (grad * grad) + self.b2 * self.nu
        self.count += 1
        mhat = self.mu / (1 - self.b1**self.count)
        nhat = self.nu / (1 - self.b2**self.count)
        u = mhat / (torch.sqrt(nhat) + self.eps)
        u = u + self.wd * params
        return (-self.lr) * u


def _nan_max(a: float, b: float) -> float:
    """jnp.maximum on host floats: NaN wins."""
    return math.nan if math.isnan(a) or math.isnan(b) else max(a, b)


def _nan_min(a: float, b: float) -> float:
    return math.nan if math.isnan(a) or math.isnan(b) else min(a, b)


def _cubicmin(a, fa, fpa, b, fb, c, fc) -> float:
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a (optax's ``_cubicmin``); NaN where it has none."""
    with np.errstate(all="ignore"):
        a, fa, fpa, b, fb, c, fc = (np.float64(v) for v in (a, fa, fpa, b, fb, c, fc))
        C = fpa
        db, dc = b - a, c - a
        denom = (db * dc) ** 2 * (db - dc)
        v0, v1 = fb - fa - C * db, fc - fa - C * dc
        A = (dc**2 * v0 - db**2 * v1) / denom
        B = (-(dc**3) * v0 + db**3 * v1) / denom
        radical = B * B - 3.0 * A * C
        return float(a + (-B + np.sqrt(radical)) / (3.0 * A))


def _quadmin(a, fa, fpa, b, fb) -> float:
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a (optax's ``_quadmin``)."""
    with np.errstate(all="ignore"):
        a, fa, fpa, b, fb = (np.float64(v) for v in (a, fa, fpa, b, fb))
        db = b - a
        B = (fb - fa - fpa * db) / (db**2)
        return float(a - fpa / (2.0 * B))


class LBFGS:
    """``optax.lbfgs()`` with its defaults, on one flat tensor: ``step(flat)
    -> (new flat, loss at flat)`` for ``minimize``."""

    # optax's defaults: memory_size; scale_by_zoom_linesearch's
    # max_linesearch_steps, slope_rtol, curv_rtol, approx_dec_rtol,
    # stepsize_precision and increase_factor
    m = 10
    max_ls = 20
    slope_rtol, curv_rtol, approx_dec_rtol = 1e-4, 0.9, 1e-6
    interval_threshold = 1e-5
    increase_factor = 2.0

    def __init__(self, loss_fn: LossFn):
        self.fn = loss_fn
        self.count = 0
        self._value = math.inf   # the line search's value at the accepted step
        self._grad = None

    # -- the direction: scale_by_lbfgs then scale(−1) -----------------------
    def _direction(self, flat: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
        m = self.m
        if self.count == 0:
            n = flat.numel()
            self._dw = torch.zeros((m, n), dtype=flat.dtype, device=flat.device)
            self._du = torch.zeros_like(self._dw)
            self._rho = torch.zeros((m,), dtype=flat.dtype, device=flat.device)
            self._live = [False] * m
        memory_idx = self.count % m
        prev_idx = (self.count - 1) % m
        if self.count > 0:
            dp = flat - self._params
            du = grad - self._updates
            vd = torch.dot(du, dp)
            self._dw[prev_idx] = dp
            self._du[prev_idx] = du
            self._rho[prev_idx] = torch.where(vd == 0.0, torch.zeros_like(vd), 1.0 / vd)
            self._live[prev_idx] = True
            den = torch.dot(du, du)
            scale = torch.where(den > 0.0, vd / den, torch.ones_like(den))
        else:
            scale = torch.clamp(1.0 / torch.linalg.vector_norm(grad), max=1.0)
        # two-loop recursion over the memory, oldest slot at memory_idx; an
        # unwritten slot (zero pair, zero weight) changes nothing and is
        # skipped
        order = [(memory_idx + i) % m for i in range(m)]
        order = [i for i in order if self._live[i]]
        vec = grad
        alphas = {}
        for i in reversed(order):
            alphas[i] = self._rho[i] * torch.dot(self._dw[i], vec)
            vec = vec - alphas[i] * self._du[i]
        vec = scale * vec
        for i in order:
            beta = self._rho[i] * torch.dot(self._du[i], vec)
            vec = vec + (alphas[i] - beta) * self._dw[i]
        self.count += 1
        self._params, self._updates = flat, grad
        return -1.0 * vec

    # -- the zoom line search ----------------------------------------------
    def _on_line(self, flat, d, stepsize: float):
        value, grad = value_and_grad(self.fn, flat + stepsize * d)
        v, slope = torch.stack([value, torch.dot(grad, d)]).tolist()  # tpulint: disable=TPL002 -- the line search's Wolfe test reads value and slope per trial step
        return v, grad, slope

    def _decrease_error(self, stepsize, value, slope, value_init, slope_init) -> float:
        de = value - value_init - self.slope_rtol * stepsize * slope_init
        approx = slope - (2 * self.slope_rtol - 1.0) * slope_init
        delta = value - value_init - self.approx_dec_rtol * abs(value_init)
        de = _nan_max(_nan_min(_nan_max(approx, delta), de), 0.0)
        return math.inf if math.isnan(de) else de

    def _curvature_error(self, slope, slope_init) -> float:
        ce = _nan_max(abs(slope) - self.curv_rtol * abs(slope_init), 0.0)
        return math.inf if math.isnan(ce) else ce

    def _linesearch(self, flat, d, value: float, grad):
        """(stepsize, value, grad) of the accepted step."""
        slope0 = torch.dot(d, grad).item()  # tpulint: disable=TPL002 -- the line search starts from the host slope
        s = dict(count=0, stepsize=0.0, value=value, grad=grad, slope=slope0,
                 decrease_error=math.inf, interval_found=False, done=False, failed=False,
                 low=0.0, value_low=value, slope_low=slope0,
                 high=0.0, value_high=value, slope_high=slope0,
                 cubic_ref=0.0, value_cubic_ref=value,
                 safe_stepsize=0.0, safe_value=value, safe_grad=grad)
        vi, si = value, slope0
        while not (s["done"] or s["failed"]):
            if s["interval_found"]:
                self._zoom_step(s, flat, d, vi, si)
            else:
                self._search_step(s, flat, d, vi, si)
            if s["failed"] and (s["safe_stepsize"] > 0.0 or math.isinf(s["decrease_error"])):
                s["stepsize"], s["value"], s["grad"] = (
                    s["safe_stepsize"], s["safe_value"], s["safe_grad"])
        return s["stepsize"], s["value"], s["grad"]

    def _search_step(self, s, flat, d, vi, si) -> None:
        new = 1.0 if s["count"] == 0 else self.increase_factor * s["stepsize"]
        val, grad, slope = self._on_line(flat, d, new)
        de = self._decrease_error(new, val, slope, vi, si)
        err = _nan_max(de, self._curvature_error(slope, si))
        if de <= 0.0:
            s["safe_stepsize"], s["safe_value"], s["safe_grad"] = new, val, grad
        high_to_new = de > 0.0 or (val >= s["value"] and s["count"] > 0)
        low_to_new = slope >= 0.0 and not high_to_new
        prev = (s["stepsize"], s["value"], s["slope"])
        cur = (new, val, slope)
        lo, hi = (cur, prev) if low_to_new else (prev, cur)
        s["low"], s["value_low"], s["slope_low"] = lo
        s["high"], s["value_high"], s["slope_high"] = hi
        s["interval_found"] = high_to_new or low_to_new or err <= 0.0
        s["done"] = err <= 0.0
        s["failed"] = s["count"] + 1 >= self.max_ls and not s["done"]
        s["count"] += 1
        s["stepsize"], s["value"], s["grad"], s["slope"] = new, val, grad, slope
        s["decrease_error"] = de
        s["cubic_ref"], s["value_cubic_ref"] = s["low"], s["value_low"]

    def _zoom_step(self, s, flat, d, vi, si) -> None:
        low, vlow, slow = s["low"], s["value_low"], s["slope_low"]
        high, vhigh, shigh = s["high"], s["value_high"], s["slope_high"]
        delta = abs(high - low)
        left, right = min(high, low), max(high, low)
        too_small = delta <= self.interval_threshold
        cubic = _cubicmin(low, vlow, slow, high, vhigh, s["cubic_ref"], s["value_cubic_ref"])
        if left + 0.2 * delta < cubic < right - 0.2 * delta:
            middle = cubic
        else:
            quad = _quadmin(low, vlow, slow, high, vhigh)
            middle = quad if left + 0.1 * delta < quad < right - 0.1 * delta else (low + high) / 2.0
        val, grad, slope = self._on_line(flat, d, middle)
        de = self._decrease_error(middle, val, slope, vi, si)
        err = _nan_max(de, self._curvature_error(slope, si))
        if de <= 0.0 and val < s["safe_value"]:
            s["safe_stepsize"], s["safe_value"], s["safe_grad"] = middle, val, grad
        done = err <= 0.0
        high_to_middle = de > 0.0 or val >= vlow
        high_to_low = slope * (high - low) >= 0.0 and not high_to_middle
        if high_to_middle:
            s["high"], s["value_high"], s["slope_high"] = middle, val, slope
        if high_to_low:
            s["high"], s["value_high"], s["slope_high"] = low, vlow, slow
        if not high_to_middle:
            s["low"], s["value_low"], s["slope_low"] = middle, val, slope
        if high_to_middle or high_to_low:
            s["cubic_ref"], s["value_cubic_ref"] = high, vhigh
        else:
            s["cubic_ref"], s["value_cubic_ref"] = low, vlow
        presumably_failed = s["count"] + 1 >= self.max_ls or (
            too_small and s["safe_stepsize"] > 0.0)
        s["done"] = done
        s["failed"] = presumably_failed and not done
        s["count"] += 1
        s["stepsize"], s["value"], s["grad"], s["slope"] = middle, val, grad, slope
        s["decrease_error"] = de

    def step(self, flat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        if math.isfinite(self._value):
            value_t = torch.tensor(self._value, dtype=flat.dtype, device=flat.device)
            grad = self._grad
        else:
            value_t, grad = value_and_grad(self.fn, flat)
        d = self._direction(flat, grad)
        lr, self._value, self._grad = self._linesearch(flat, d, value_t.item(), grad)  # tpulint: disable=TPL002 -- the line search starts from the host value
        return flat + lr * d, value_t
