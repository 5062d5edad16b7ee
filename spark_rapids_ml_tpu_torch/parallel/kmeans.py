"""Sharded KMeans over the port's device mesh: Lloyd iterations and the
k-means‖ seeding as shard programs.

Counterpart of ``spark_rapids_ml_tpu/parallel/kmeans.py``. Each data shard
runs ``ops.kmeans.kmeans_stats`` on its rows, one ``psum`` in shard order
combines the KMeansStats monoid, and the centre update runs replicated.
The JAX package runs the loop as one ``lax.while_loop`` inside
``shard_map``; the port runs a host loop of (shards' statistics, psum,
update) that reads one scalar an iteration, the largest squared centre
shift, computed from the reduced statistics: every rank of a process mesh
takes the same stop decision.

The k-means‖ seeding (``make_distributed_kmeans_parallel_init``) keeps the
whole init on the mesh: each round every shard scores its rows by w·D²
against the replicated candidate buffer, draws a fixed ``s`` rows by
Gumbel-top-s (sampling without replacement ∝ w·D², ndev·s ≥ 2k), and an
``all_gather`` appends the round's candidates in shard order. ``jax.random``
has no torch counterpart: each shard draws from its own ``torch.Generator``
seeded from (seed, round, shard), so the draws repeat from run to run and
on every rank, but they are not the JAX package's.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.ops import kmeans as KM
from spark_rapids_ml_tpu_torch.parallel import backend as B
from spark_rapids_ml_tpu_torch.parallel.mesh import DATA_AXIS, Mesh

_XW = (B.MATRIX_SPEC, B.VECTOR_SPEC)


def sharded_kmeans_stats(x: Any, centers: Any, mesh: Mesh, *, weights: Any = None,
                         block_rows: int = KM.DEFAULT_BLOCK_ROWS) -> KM.KMeansStats:
    """One Lloyd accumulation pass over a data-sharded [rows, n] X, the
    centres replicated; replicated statistics out. ``weights`` masks pad
    rows (0) and carries instance weights."""
    local = B.shard_operands(mesh, (x, weights), _XW)
    centers = torch.as_tensor(centers)
    return B.psum_tree(mesh, [
        KM.kmeans_stats(xl, centers.to(xl.device), wl, block_rows=min(block_rows, xl.shape[0]))
        for xl, wl in local
    ])


def distributed_lloyd_step(x: Any, centers: Any, mesh: Mesh, *, weights: Any = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """One distributed Lloyd iteration: (new centres, cost)."""
    centers = torch.as_tensor(centers).to(mesh.first_device)
    stats = sharded_kmeans_stats(x, centers, mesh, weights=weights)
    return KM.update_centers(stats, centers), stats.cost


def make_distributed_lloyd(mesh: Mesh):
    def step(x, centers):
        return distributed_lloyd_step(x, centers, mesh)

    return step


def make_distributed_kmeans_chunk(mesh: Mesh, *, chunk_iters: int = 5, tol: float = 1e-4,
                                  block_rows: int = KM.DEFAULT_BLOCK_ROWS):
    """Up to ``chunk_iters`` Lloyd iterations from carried centres, the
    resumable block of the checkpointed mesh fit: ``run(x, w, centers0,
    budget) -> (centers, cost, done, shift_sq)``. The loop stops early once
    the largest squared centre shift is ≤ tol²; the operands are sharded
    once per call."""
    tol_sq = tol * tol

    def run(x, w, centers0, budget):
        local = B.shard_operands(mesh, (x, w), _XW)
        centers = torch.as_tensor(centers0).to(mesh.first_device)
        limit = min(int(chunk_iters), int(budget))
        dtype, dev = centers.dtype, centers.device
        cost = torch.full((), float("inf"), dtype=dtype, device=dev)
        shift = torch.full((), float("inf"), dtype=dtype, device=dev)
        it = 0
        while it < limit and float(shift) > tol_sq:
            stats = B.psum_tree(mesh, [
                KM.kmeans_stats(xl, centers.to(xl.device), wl,
                                block_rows=min(block_rows, xl.shape[0]))
                for xl, wl in local
            ])
            new = KM.update_centers(stats, centers)
            shift = KM.center_shift_sq(centers, new)
            centers, cost = new, stats.cost
            it += 1
        return centers, cost, it, shift

    return run


def make_distributed_kmeans_fit(mesh: Mesh, *, max_iter: int = 20, tol: float = 1e-4,
                                block_rows: int = KM.DEFAULT_BLOCK_ROWS):
    """The whole Lloyd loop over the mesh: ``fit(x, w, centers0) ->
    (centers, cost, iterations)``, one full-budget chunk of
    ``make_distributed_kmeans_chunk``. It stops when the largest squared
    centre movement is ≤ tol² or after ``max_iter`` iterations."""
    chunk = make_distributed_kmeans_chunk(mesh, chunk_iters=max_iter, tol=tol,
                                          block_rows=block_rows)

    def fit(x, w, centers0):
        centers, cost, done, _ = chunk(x, w, centers0, max_iter)
        return centers, cost, done

    return fit


def _shard_generator(seed: int, tag: int, shard: int, device: torch.device) -> torch.Generator:
    """A generator for one shard's draws, seeded from (seed, tag, shard)."""
    state = np.random.SeedSequence([int(seed) & 0xFFFFFFFF, tag, shard]).generate_state(
        1, dtype=np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state) >> 1)


def _gumbel(gen: torch.Generator, rows: int, like: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel variates, −log(−log U), U uniform in (0, 1)."""
    tiny = torch.finfo(like.dtype).tiny
    u = torch.rand(rows, generator=gen, dtype=like.dtype, device=like.device)
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def _masked_min_d2(x: torch.Tensor, buf: torch.Tensor, valid: torch.Tensor,
                   block_rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(min squared distance, argmin) of each row over the valid slots of
    ``buf``, a block of rows at a time; invalid slots sit at +inf, a mask
    no data magnitude can defeat."""
    rows = x.shape[0]
    mins = torch.empty(rows, dtype=x.dtype, device=x.device)
    arg = torch.empty(rows, dtype=torch.int64, device=x.device)
    inf = torch.tensor(float("inf"), dtype=x.dtype, device=x.device)
    for lo in range(0, rows, block_rows):
        d2 = torch.where(valid[None, :], KM.pairwise_sq_dists(x[lo:lo + block_rows], buf), inf)
        mins[lo:lo + block_rows], arg[lo:lo + block_rows] = torch.min(d2, dim=1)
    return mins, arg


def make_distributed_kmeans_parallel_init(mesh: Mesh, k: int, *, init_steps: int = 2,
                                          block_rows: int = KM.DEFAULT_BLOCK_ROWS):
    """k-means‖ oversampling over the mesh: ``run(x, w, seed) ->
    (candidates [cap, n], counts [cap])`` replicated, ``cap = 1 +
    init_steps·ndev·s`` with ``s = ⌈2k / ndev⌉``. The first candidate is
    drawn ∝ w over all rows (each shard's Gumbel-max, the best of the
    gathered scores); each round then draws ``s`` rows a shard ∝ w·D²; a
    final assignment pass psums the weighted ownership counts. Slots never
    filled carry count 0, so ``ops.kmeans.weighted_kmeans_plus_plus_init``
    takes the buffers as they are. Zero-weight rows are never drawn."""
    ndev = mesh.shape[DATA_AXIS]
    s = max(1, -(-2 * k // ndev))
    cap = 1 + init_steps * ndev * s

    def run(x, w, seed):
        local = B.shard_operands(mesh, (x, w), _XW)
        shards = mesh.data_indices()
        rows, n = local[0][0].shape
        s_eff = min(s, rows)
        dtype = local[0][0].dtype
        dev = mesh.first_device
        tiny = torch.finfo(dtype).tiny
        neg_inf = float("-inf")

        # first candidate: weight-proportional over all rows (Gumbel-max a
        # shard, then the best of the gathered maxima, in shard order)
        best_scores, best_rows = [], []
        for shard, (xl, wl) in zip(shards, local):
            g = _gumbel(_shard_generator(seed, 17, shard, xl.device), rows, xl)
            score = torch.where(wl > 0, torch.log(torch.clamp(wl, min=tiny)) + g,
                                torch.full_like(g, neg_inf))
            bi = torch.argmax(score)
            best_scores.append(score[bi].reshape(1))
            best_rows.append(xl[bi].reshape(1, n))
        all_best = torch.cat([v.to(dev) for v in B.all_gather(mesh, best_scores)])
        all_rows = torch.cat([v.to(dev) for v in B.all_gather(mesh, best_rows)])
        buf = torch.zeros((cap, n), dtype=dtype, device=dev)
        valid = torch.zeros(cap, dtype=torch.bool, device=dev)
        buf[0] = all_rows[torch.argmax(all_best)]
        valid[0] = True

        for r in range(init_steps):
            picked, picked_ok = [], []
            for shard, (xl, wl) in zip(shards, local):
                d2, _ = _masked_min_d2(xl, buf.to(xl.device), valid.to(xl.device),
                                       min(block_rows, rows))
                score = torch.where((wl > 0) & (d2 > 0),
                                    torch.log(torch.clamp(wl * d2, min=tiny)),
                                    torch.full_like(d2, neg_inf))
                score = score + _gumbel(_shard_generator(seed, 100 + r, shard, xl.device),
                                        rows, xl)
                top_vals, top_idx = torch.topk(score, s_eff)
                picked.append(xl[top_idx])
                picked_ok.append(top_vals > neg_inf)
            at = 1 + r * ndev * s_eff
            got = B.all_gather(mesh, picked)
            ok = B.all_gather(mesh, picked_ok)
            buf[at:at + ndev * s_eff] = torch.cat([v.to(dev) for v in got])
            valid[at:at + ndev * s_eff] = torch.cat([v.to(dev) for v in ok])

        # ownership counts: invalid slots can never win, zero-weight rows
        # add nothing
        counts = []
        for xl, wl in local:
            _, lab = _masked_min_d2(xl, buf.to(xl.device), valid.to(xl.device),
                                    min(block_rows, rows))
            c = torch.zeros(cap, dtype=dtype, device=xl.device)
            counts.append(c.index_add_(0, lab, wl.to(dtype)))
        total = B.psum(mesh, counts)[0].to(dev)
        return buf, torch.where(valid, total, torch.zeros_like(total))

    return run


def run_chunked_lloyd(chunk_fn, x, w_vec, centers0, *, start_iter: int, max_iter: int,
                      tol: float, ckpt, cost0: float = math.inf):
    """The host loop of the chunked, checkpointed Lloyd fits (see
    ``parallel.linear.run_chunked_newton``; ``ckpt`` None on the ranks that
    do not write). Returns (centres, cost, iterations)."""
    c = centers0
    it, cost, tol_sq = start_iter, cost0, tol * tol
    while it < max_iter:
        c, cost_j, done, shift = chunk_fn(x, w_vec, c, max_iter - it)
        it += int(done)
        cost = float(cost_j)
        if ckpt is not None:
            ckpt.save(it - 1, {"centers": c.cpu().numpy()}, {"cost": cost})  # tpulint: disable=TPL002 -- a checkpoint is written from the host
        if float(shift) <= tol_sq:
            break
    return torch.as_tensor(c), cost, it
