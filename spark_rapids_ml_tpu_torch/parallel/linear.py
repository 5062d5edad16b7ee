"""Sharded GLM training over the port's device mesh: normal equations and
Newton steps as shard programs.

Counterpart of ``spark_rapids_ml_tpu/parallel/linear.py``. The statistics
monoid is computed on each data shard and summed by one ``psum`` in shard
order (``parallel/backend.py``); the small solve runs replicated on the
mesh's first device:

- LinearRegression: one pass of ``ops.linear.linear_stats`` a shard, one
  psum, ``solve_from_stats`` (the closed form, or FISTA for an elastic
  net);
- Newton fits (binary logistic, squared hinge, softmax): the JAX package
  runs the whole loop as one ``lax.while_loop`` inside ``shard_map``; the
  port runs a host loop whose iteration is every shard's statistics at the
  replicated parameters, one psum, and the replicated f64 update, as the
  port's one-device fit does (``models/linear.py::_newton_loop``). The
  host reads one scalar an iteration, the step norm, for the stop test.
  It comes from the reduced statistics and the replicated parameters
  only, so every rank of a process mesh takes the same decision and the
  group's loops stay in step.

A chunk (``make_distributed_logreg_chunk``) runs at most ``chunk_iters``
iterations from carried parameters; the whole-loop fit is one chunk with
the full budget, so the chunked-resume trajectory is the whole-loop one by
construction. ``run_chunked_newton`` is the host loop of the checkpointed
fits, shared by the mesh-local estimators and the barrier bodies.

Inputs: ``x_aug`` [rows, d] data-sharded with the intercept column already
appended when ``fit_intercept`` (``spark.ingest.stream_to_mesh(...,
augment_intercept=True)``); ``y`` and the weight vector ``w`` (instance
weights on true rows, 0 on pad rows) sharded alike. Parameters are f64 on
the mesh's first device; the statistics are f32 products, as the
one-device fit's.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.ops import linear as LIN
from spark_rapids_ml_tpu_torch.parallel import backend as B
from spark_rapids_ml_tpu_torch.parallel.mesh import Mesh

_XYW = (B.MATRIX_SPEC, B.VECTOR_SPEC, B.VECTOR_SPEC)
_LOSSES = ("logistic", "squared_hinge")


def sharded_linear_stats(x: Any, y: Any, mesh: Mesh) -> LIN.LinearStats:
    """LinearStats over data-sharded (X [rows, n], y [rows]), replicated
    out on the mesh's first device."""
    return B.mapreduce_data_axis(
        lambda xl, yl: LIN.linear_stats(xl, yl), mesh, in_specs=(B.MATRIX_SPEC, B.VECTOR_SPEC),
    )(x, y)


def sharded_linear_stats_weighted(x: Any, y: Any, w: Any, mesh: Mesh) -> LIN.LinearStats:
    """Weighted LinearStats over data-sharded operands: ``w`` carries
    instance weights on true rows and 0 on pad rows, so padded shards
    reduce exactly."""
    return B.mapreduce_data_axis(LIN.linear_stats, mesh, in_specs=_XYW)(x, y, w)


def distributed_linreg_fit(
    x: Any,
    y: Any,
    mesh: Mesh,
    *,
    reg_param: float = 0.0,
    elastic_net_param: float = 0.0,
    fit_intercept: bool = True,
    max_iter: int = 500,
    tol: float = 1e-8,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The distributed least-squares or elastic-net fit: (coef,
    intercept). α > 0 changes only the replicated solve."""
    stats = sharded_linear_stats(x, y, mesh)
    return LIN.solve_from_stats(stats, reg_param=reg_param, elastic_net_param=elastic_net_param,
                                fit_intercept=fit_intercept, max_iter=max_iter, tol=tol)


def make_distributed_linreg_fit(mesh: Mesh, **options):
    """``distributed_linreg_fit`` with the mesh and options bound."""

    def fit(x, y):
        return distributed_linreg_fit(x, y, mesh, **options)

    return fit


def sharded_newton_stats(x_aug: Any, y: Any, w_full: torch.Tensor, mesh: Mesh) -> LIN.NewtonStats:
    """One logistic Newton statistics pass: X and y data-sharded, the
    parameters replicated."""
    return B.mapreduce_data_axis(
        LIN.logistic_newton_stats, mesh,
        in_specs=(B.MATRIX_SPEC, B.VECTOR_SPEC, B.REPLICATED_SPEC),
    )(x_aug, y, w_full)


def distributed_newton_step(
    x_aug: Any,
    y: Any,
    w_full: torch.Tensor,
    mesh: Mesh,
    *,
    reg_param: float = 0.0,
    elastic_net_param: float = 0.0,
    fit_intercept: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One distributed IRLS or proximal-Newton iteration: (new w, step)."""
    w_full = _replicated_params(w_full, mesh)
    stats = sharded_newton_stats(x_aug, y, w_full, mesh)
    return LIN.newton_update(w_full, stats, reg_param=reg_param,
                             elastic_net_param=elastic_net_param, fit_intercept=fit_intercept)


def make_distributed_newton_step(mesh: Mesh, **options):
    def step(x_aug, y, w_full):
        return distributed_newton_step(x_aug, y, w_full, mesh, **options)

    return step


def _replicated_params(w, mesh: Mesh) -> torch.Tensor:
    """Parameters as an f64 tensor on the mesh's first device."""
    return torch.as_tensor(np.asarray(w) if not isinstance(w, torch.Tensor) else w,
                           dtype=torch.float64).to(mesh.first_device)


def _newton_chunk(mesh: Mesh, stats_fn, update_fn, chunk_iters: int, tol: float):
    """``run(x_aug, y, w_vec, w0, budget) -> (w, done, step)``: at most
    ``min(chunk_iters, budget)`` iterations from ``w0``, each the shards'
    ``stats_fn(x, y, w, weights)``, one psum and ``update_fn(w, stats)``;
    the loop stops early once the step norm is not above ``tol`` (NaN, the
    divergence sentinel, stops too). The operands are sharded once per
    call."""

    def run(x_aug, y, w_vec, w0, budget):
        local = B.shard_operands(mesh, (x_aug, y, w_vec), _XYW)
        w = _replicated_params(w0, mesh)
        limit = min(int(chunk_iters), int(budget))
        step = torch.full((), float("inf"), dtype=torch.float64, device=w.device)
        it = 0
        while it < limit and float(step) > tol:
            stats = B.psum_tree(mesh, [stats_fn(xl, yl, w.to(xl.device), wl)
                                       for xl, yl, wl in local])
            w, step = update_fn(w, stats)
            it += 1
        return w, it, step

    return run


def make_distributed_logreg_chunk(
    mesh: Mesh,
    *,
    reg_param: float = 0.0,
    elastic_net_param: float = 0.0,
    fit_intercept: bool = True,
    chunk_iters: int = 5,
    tol: float = 1e-6,
    loss: str = "logistic",
):
    """Up to ``chunk_iters`` binary Newton iterations from carried
    parameters: ``run(x_aug, y, w_vec, w0, budget) -> (w, done, step)``,
    the resumable block of the checkpointed mesh fit. ``loss`` is
    ``"logistic"`` (IRLS) or ``"squared_hinge"`` (LinearSVC): both give
    the NewtonStats monoid, so the loop, psum and solve are shared."""
    if loss not in _LOSSES:
        raise ValueError(f"loss must be 'logistic' or 'squared_hinge', got {loss!r}")
    stats_fn = LIN.logistic_newton_stats if loss == "logistic" else LIN.svc_newton_stats

    def update(w, stats):
        return LIN.newton_update(w, stats, reg_param=reg_param,
                                 elastic_net_param=elastic_net_param, fit_intercept=fit_intercept)

    return _newton_chunk(mesh, stats_fn, update, chunk_iters, tol)


def make_distributed_softmax_chunk(
    mesh: Mesh,
    n_classes: int,
    *,
    reg_param: float = 0.0,
    elastic_net_param: float = 0.0,
    fit_intercept: bool = True,
    chunk_iters: int = 5,
    tol: float = 1e-6,
):
    """The C-class sibling of ``make_distributed_logreg_chunk``: ``run(x_aug,
    y, w_vec, w0_flat, budget) -> (w_flat, done, step)``; ``y`` holds the
    float labels, cast to class indices on each shard."""

    def stats_fn(xl, yl, w, wl):
        return LIN.softmax_newton_stats(xl, yl.to(torch.int64), w, n_classes, wl)

    def update(w, stats):
        return LIN.softmax_newton_update(w, stats, n_classes, reg_param=reg_param,
                                         elastic_net_param=elastic_net_param,
                                         fit_intercept=fit_intercept)

    return _newton_chunk(mesh, stats_fn, update, chunk_iters, tol)


def make_distributed_logreg_fit(mesh: Mesh, *, max_iter: int = 25, tol: float = 1e-6,
                                **options):
    """The whole binary Newton loop over the mesh: ``fit(x_aug, y, w_vec)
    -> (w [d], iterations, final step)``, one full-budget chunk of
    ``make_distributed_logreg_chunk`` from zero (``options``: its
    regularization and ``loss``)."""
    chunk = make_distributed_logreg_chunk(mesh, chunk_iters=max_iter, tol=tol, **options)

    def fit(x_aug, y, w_vec):
        d = x_aug.shape[1]
        return chunk(x_aug, y, w_vec, torch.zeros(d, dtype=torch.float64), max_iter)

    return fit


def make_distributed_softmax_fit(mesh: Mesh, n_classes: int, *, max_iter: int = 25,
                                 tol: float = 1e-6, **options):
    """The whole softmax Newton loop: ``fit(x_aug, y, w_vec) -> (w_flat
    [C·d], iterations, final step)``, one full-budget chunk of
    ``make_distributed_softmax_chunk``."""
    chunk = make_distributed_softmax_chunk(mesh, n_classes, chunk_iters=max_iter, tol=tol,
                                           **options)

    def fit(x_aug, y, w_vec):
        cd = n_classes * x_aug.shape[1]
        return chunk(x_aug, y, w_vec, torch.zeros(cd, dtype=torch.float64), max_iter)

    return fit


def run_chunked_newton(chunk_fn, x, y, w_vec, w0, *, start_iter: int, max_iter: int,
                       tol: float, ckpt) -> tuple[torch.Tensor, int]:
    """The host loop of the chunked, checkpointed Newton fits. ``ckpt`` is a
    ``TrainingCheckpointer`` or None (the ranks of a barrier stage other
    than 0 pass None and run the same loop, so the replicated parameters
    and the stop decision stay group-consistent). Three rules, as in the
    JAX package: a NaN step (the divergence sentinel) stops the loop; the
    non-finite-data check runs before the save, so a rejected fit leaves
    no checkpoint to resume from; the save's index is ``it - 1``, the last
    iteration done. Returns (w on the mesh's first device, iterations
    done)."""
    w = w0
    it = start_iter
    while it < max_iter:
        w, done, step = chunk_fn(x, y, w_vec, w, max_iter - it)
        it += int(done)
        stop = not float(step) > tol
        if stop:
            LIN.check_newton_outcome(step, w)
        if ckpt is not None:
            ckpt.save(it - 1, {"w": w.cpu().numpy()}, {})  # tpulint: disable=TPL002 -- a checkpoint is written from the host
        if stop:
            break
    return torch.as_tensor(w), it
