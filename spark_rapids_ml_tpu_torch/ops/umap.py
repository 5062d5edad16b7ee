"""UMAP on torch tensors: the fuzzy k-NN graph's calibration and the SGD
layout on the device; the graph's union, the curve fit and the spectral
init on the host.

Counterpart of ``spark_rapids_ml_tpu/ops/umap.py`` (McInnes et al.,
arXiv:1802.03426):

- ``smooth_knn_calibration``: per-row (rho, sigma) by 64 fixed bisection
  halvings of Σ_j exp(−max(0, d_ij − rho_i)/σ_i) = log2(k) for all rows at
  once, sigma floored at ``MIN_K_DIST_SCALE`` × the mean distance;
- ``membership_strengths``: exp(−max(0, d − rho)/sigma), 1 at d = 0;
- ``fuzzy_union_edges``, ``find_ab_params`` and ``spectral_init``: numpy
  and scipy on the host, copied from the JAX package unchanged;
- ``optimize_layout``: the force layout as a Python loop over epochs on the
  device, in the JAX package's order within an epoch: the attractive update
  of the due edges (scattered to ``heads``, then its negation to ``tails``),
  a re-read of ``y[heads]``, the repulsive update against ``n_neg``
  negatives per edge (masked where a negative is the head itself, a unit
  kick at zero distance), every force clipped to ±4, the learning rate
  ``initial_lr·(1 − epoch/n_epochs)``, and the ``next_due`` schedule.

The scatters are ``index_add_``. On the card its float adds are atomics in
the order the hardware picks, so a layout is not bit-for-bit repeatable
there; on the CPU it adds in edge order, as the JAX package's segment sums
do there. The negatives come from a ``torch.Generator`` on the device
(the JAX package folds the epoch into a ``jax.random`` key, which torch
cannot reproduce), or from a caller's ``neg_fn(epoch) -> [E, n_neg]``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

SMOOTH_K_TARGET_ITERS = 64
MIN_K_DIST_SCALE = 1e-3
_GRAD_CLIP = 4.0


def smooth_knn_calibration(knn_dists: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(rho [n], sigma [n]) of [n, k] ascending neighbour distances:
    umap-learn's smooth_knn_dist, vectorized. rho_i is the smallest
    POSITIVE distance; sigma_i solves the mass equation by bisection."""
    n, k = knn_dists.shape
    dt, dev = knn_dists.dtype, knn_dists.device
    target = torch.log2(torch.tensor(float(k), dtype=dt, device=dev))
    inf = torch.tensor(float("inf"), dtype=dt, device=dev)
    rho = torch.amin(torch.where(knn_dists > 0, knn_dists, inf), dim=1)
    rho = torch.where(torch.isfinite(rho), rho, torch.zeros_like(rho))
    d = torch.clamp(knn_dists - rho[:, None], min=0.0)
    lo = torch.full((n,), 1e-12, dtype=dt, device=dev)
    hi = torch.full((n,), 1e4, dtype=dt, device=dev)
    for _ in range(SMOOTH_K_TARGET_ITERS):
        mid = 0.5 * (lo + hi)
        too_small = torch.sum(torch.exp(-d / mid[:, None]), dim=1) < target
        lo, hi = torch.where(too_small, mid, lo), torch.where(too_small, hi, mid)
    sigma = 0.5 * (lo + hi)
    return rho, torch.maximum(sigma, MIN_K_DIST_SCALE * torch.mean(knn_dists))


def membership_strengths(knn_dists: torch.Tensor, rho: torch.Tensor,
                         sigma: torch.Tensor) -> torch.Tensor:
    """[n, k] directed fuzzy membership exp(−max(0, d−rho)/sigma)."""
    d = torch.clamp(knn_dists - rho[:, None], min=0.0)
    w = torch.exp(-d / sigma[:, None])
    return torch.where(knn_dists > 0, w, torch.ones_like(w))  # self/duplicate → full


def fuzzy_union_edges(
    knn_idx: np.ndarray,  # [n, k]
    weights: np.ndarray,  # [n, k]
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Symmetrize the directed graph (w ∪ wᵀ: a+b−ab) into an edge list
    (heads [E], tails [E], weights [E]), each pair once, self-edges
    dropped. Host numpy/scipy, once per fit."""
    import scipy.sparse as sp

    n, k = knn_idx.shape
    heads = np.repeat(np.arange(n, dtype=np.int64), k)
    tails = knn_idx.reshape(-1).astype(np.int64)
    vals = weights.reshape(-1).astype(np.float64)
    keep = heads != tails
    heads, tails, vals = heads[keep], tails[keep], vals[keep]
    A = sp.coo_matrix((vals, (heads, tails)), shape=(n, n)).tocsr()
    A.sum_duplicates()
    At = A.T.tocsr()
    U = A + At - A.multiply(At)  # fuzzy set union
    Uc = U.tocoo()
    keep = Uc.row < Uc.col  # undirected: keep each pair once
    return (
        Uc.row[keep].astype(np.int32),
        Uc.col[keep].astype(np.int32),
        Uc.data[keep].astype(np.float64),
    )


def find_ab_params(spread: float, min_dist: float) -> tuple[float, float]:
    """(a, b) of 1/(1+a·x^{2b}) fitted to the target membership curve:
    umap-learn's find_ab_params, by scipy curve_fit."""
    from scipy.optimize import curve_fit

    xv = np.linspace(0, spread * 3, 300)
    yv = np.where(xv < min_dist, 1.0, np.exp(-(xv - min_dist) / spread))
    params, _ = curve_fit(
        lambda x, a, b: 1.0 / (1.0 + a * x ** (2 * b)), xv, yv, maxfev=5000,
    )
    return float(params[0]), float(params[1])


def optimize_layout(
    embedding: torch.Tensor,          # [n, dim] init
    heads: torch.Tensor,              # [E] int64
    tails: torch.Tensor,              # [E] int64
    epochs_per_sample: torch.Tensor,  # [E]
    a: float,
    b: float,
    *,
    n_epochs: int,
    n_neg: int = 5,
    initial_lr: float = 1.0,
    move_tails: bool = True,
    generator: torch.Generator | None = None,
    neg_fn: Callable[[int], torch.Tensor] | None = None,
) -> torch.Tensor:
    """The UMAP SGD layout, one epoch after another on ``embedding``'s
    device: every edge computes its force each epoch, masked by its
    ``next_due`` counter (edge e fires when next_due ≤ epoch, then waits
    epochs_per_sample more). ``move_tails`` False (transform) holds the
    tails fixed. Negatives: ``neg_fn(epoch)`` if given, else uniform ids
    from ``generator``."""
    n = embedding.shape[0]
    E = heads.shape[0]
    dev = embedding.device
    eps = 1e-3
    y = embedding.clone()
    next_due = epochs_per_sample.clone()
    for epoch in range(n_epochs):
        alpha = initial_lr * (1.0 - epoch / n_epochs)
        due = next_due <= epoch  # [E]

        diff = y[heads] - y[tails]
        d2 = torch.sum(diff * diff, dim=1)
        # attractive: −2ab·d^{2(b−1)} / (1 + a·d^{2b})
        grad_coeff = torch.where(
            d2 > 0, (-2.0 * a * b * d2 ** (b - 1.0)) / (a * d2**b + 1.0), torch.zeros_like(d2)
        )
        g = torch.clamp(grad_coeff[:, None] * diff, -_GRAD_CLIP, _GRAD_CLIP)
        g = torch.where(due[:, None], g, torch.zeros_like(g)) * alpha
        y.index_add_(0, heads, g)
        if move_tails:
            y.index_add_(0, tails, -g)

        # negative samples: n_neg uniform points per due edge
        neg = (neg_fn(epoch) if neg_fn is not None
               else torch.randint(0, n, (E, n_neg), generator=generator, device=dev))
        neg = neg.to(device=dev, dtype=torch.int64)
        diffn = y[heads][:, None, :] - y[neg]  # re-read after the attractive update
        d2n = torch.sum(diffn * diffn, dim=2)
        rep = (2.0 * b) / ((eps + d2n) * (a * d2n**b + 1.0))
        gn = torch.clamp(rep[:, :, None] * diffn, -_GRAD_CLIP, _GRAD_CLIP)
        # zero-distance negatives get the reference's unit kick
        gn = torch.where(d2n[:, :, None] > 0, gn, torch.full_like(gn, _GRAD_CLIP))
        keep = (due[:, None] & (neg != heads[:, None]))[:, :, None]
        gn = torch.where(keep, gn, torch.zeros_like(gn))
        y.index_add_(0, heads, alpha * torch.sum(gn, dim=1))

        next_due = torch.where(due, next_due + epochs_per_sample, next_due)
    return y


def spectral_init(
    heads: np.ndarray,
    tails: np.ndarray,
    weights: np.ndarray,
    n: int,
    dim: int,
    seed: int,
) -> np.ndarray:
    """Symmetric-normalized-Laplacian eigenvector init (umap-learn's
    'spectral') by scipy's sparse ``eigsh`` on the host, scaled to about
    [−10, 10] and jittered; scaled uniform noise if ``eigsh`` fails."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spl

    rng = np.random.default_rng(seed)
    try:
        W = sp.coo_matrix(
            (
                np.concatenate([weights, weights]),
                (np.concatenate([heads, tails]), np.concatenate([tails, heads])),
            ),
            shape=(n, n),
        ).tocsr()
        deg = np.asarray(W.sum(axis=1)).reshape(-1)
        dinv = 1.0 / np.sqrt(np.maximum(deg, 1e-12))
        L = sp.identity(n) - sp.diags(dinv) @ W @ sp.diags(dinv)
        k_eig = dim + 1
        vals, vecs = spl.eigsh(
            L, k=k_eig, which="SM", tol=1e-4, maxiter=n * 5, v0=rng.normal(size=n),
        )
        order = np.argsort(vals)[1:dim + 1]  # drop the trivial 0-vector
        emb = vecs[:, order]
        expansion = 10.0 / np.abs(emb).max()
        return emb * expansion + rng.normal(scale=1e-4, size=emb.shape)
    except Exception:
        return rng.uniform(-10, 10, size=(n, dim))
