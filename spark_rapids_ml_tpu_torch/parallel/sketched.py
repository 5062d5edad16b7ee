"""Sketched (randomized range-finder) PCA that never forms XᵀX.

Counterpart of ``spark_rapids_ml_tpu/parallel/sketched.py``: the HMT
randomized SVD laid out over the (data, feat) mesh, with the TSQR butterfly
(``parallel/tsqr.py``) as the orthonormalization, so no n×n object exists:

    Y = XΩ           [rows, l]   l = k + oversample    (psum over feat)
    power iters      Y ← X(XᵀQ), Q from TSQR of Y      (psum data + feat)
    B  = QᵀX         [l, n]      feature-sharded       (psum over data)
    BBᵀ              [l, l]      replicated eigh       (psum over feat)
    V  = Bᵀ·U_B·S⁻¹  [n, k]      feature-sharded: the components

Ω's feature block j is standard normal from a ``torch.Generator`` seeded
from (``seed``, j). It is not ``jax.random``'s draw, so the fit agrees with
the JAX package's by subspace, not draw for draw. Products run at the
precision tier's arithmetic (``gram.block_product``), TF32 off.

Every cell's work runs feature-sharded; the fit returns its components and
a projection returns its rows joined on the mesh's first device. These
programs run on a mesh of this process.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.ops import linalg as L
from spark_rapids_ml_tpu_torch.parallel import backend as B
from spark_rapids_ml_tpu_torch.parallel.gram import block_product
from spark_rapids_ml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    FEAT_AXIS,
    Mesh,
    center_columns_shard,
    shard,
)
from spark_rapids_ml_tpu_torch.parallel.tsqr import merge_r


def _require_local(mesh: Mesh) -> None:
    if mesh.distributed:
        raise NotImplementedError("the sketched programs run on a mesh of this process")


def _omega_block(seed: int, j: int, rows: int, l: int, dtype, device) -> torch.Tensor:
    """Feature block j of the sketch: its own generator, so the blocks are
    independent and no [n, l] Ω exists anywhere."""
    state = int(np.random.SeedSequence([seed, j]).generate_state(1)[0])
    gen = torch.Generator().manual_seed(state)
    return torch.randn((rows, l), generator=gen, dtype=dtype).to(device)


def _orthonormalize(ys: list[torch.Tensor], precision: str) -> list[torch.Tensor]:
    """Q of the data-sharded Y via TSQR: Y·R⁺ with the merged R. R⁺, not
    R⁻¹: when rank(X) < l, R is singular, and the pseudo-inverse maps its
    null directions to zero columns of Q instead of dividing by zero."""
    r = merge_r([L.qr_r(y) for y in ys])
    u, s, vt = torch.linalg.svd(r)
    cutoff = torch.finfo(s.dtype).eps * s.shape[0] * torch.max(s)
    keep = s > cutoff
    sinv = torch.where(keep, 1.0 / torch.where(keep, s, torch.ones_like(s)), torch.zeros_like(s))
    pinv = block_product(vt.T * sinv[None, :], u.T, precision)
    return [block_product(y, pinv.to(y.device), precision) for y in ys]


def _sum_to(parts: list[torch.Tensor], device) -> torch.Tensor:
    total = parts[0].to(device)
    for p in parts[1:]:
        total = total + p.to(device)
    return total


def sketched_pca_fit(
    x: Any,
    k: int,
    mesh: Mesh,
    *,
    oversample: int = 10,
    power_iters: int = 2,
    seed: int = 0,
    mean_centering: bool = False,
    precision: str = "highest",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k PCA of a (data, feat)-sharded [rows, n] matrix with no n×n
    object: ``(components [n, k], explained variance [k])``. The explained
    variance keeps the reference's sᵢ/Σs with the trace-based tail estimate
    (the trace is one psum of Σx²); signs follow the reference rule over the
    whole [n, l] (the largest |value| across every feature block)."""
    _require_local(mesh)
    x = shard(x, mesh, feature_sharded=True)
    n = x.shape[1]
    l = min(n, k + oversample)
    n_data, n_feat = mesh.shape[DATA_AXIS], mesh.shape[FEAT_AXIS]
    mm = lambda a, b: block_product(a, b, precision)  # noqa: E731
    xs = [[x.block(i, j) for j in range(n_feat)] for i in range(n_data)]
    if mean_centering:
        cols = [center_columns_shard([xs[i][j] for i in range(n_data)], mesh)
                for j in range(n_feat)]
        xs = [[cols[j][i] for j in range(n_feat)] for i in range(n_data)]
    row_dev = [mesh.device(i, 0) for i in range(n_data)]
    col_dev = [mesh.device(0, j) for j in range(n_feat)]
    omega = [_omega_block(seed, j, xs[0][j].shape[1], l, x.dtype, col_dev[j])
             for j in range(n_feat)]

    def sketch(z):  # y_i = Σ_j X_ij·z_j, psum over feat
        return [_sum_to([mm(xs[i][j], z[j].to(xs[i][j].device)) for j in range(n_feat)],
                        row_dev[i]) for i in range(n_data)]

    def back(q):  # z_j = Σ_i X_ijᵀ·q_i, psum over data
        return [_sum_to([mm(xs[i][j].T, q[i].to(xs[i][j].device)) for i in range(n_data)],
                        col_dev[j]) for j in range(n_feat)]

    y = sketch(omega)
    for _ in range(power_iters):
        y = sketch(back(_orthonormalize(y, precision)))
    q = _orthonormalize(y, precision)
    b = [zj.T for zj in back(q)]  # B's feature blocks [l, c]
    core = _sum_to([mm(bj, bj.T) for bj in b], mesh.first_device)  # BBᵀ [l, l]
    evals, u_b = torch.linalg.eigh(core)  # ascending
    evals, u_b = evals.flip(0), u_b.flip(1)
    s_vals = torch.sqrt(torch.clamp(evals, min=0.0))
    safe = torch.where(s_vals > 0, s_vals, torch.ones_like(s_vals))
    dev = mesh.first_device
    v = torch.cat([mm(bj.T, (u_b / safe[None, :]).to(bj.device)).to(dev) for bj in b])
    v = L.sign_flip(v)
    trace = _sum_to([(xs[i][j] * xs[i][j]).sum() for i in range(n_data) for j in range(n_feat)],
                    dev)
    ev = L.explained_variance_from_partial(
        s_vals, trace, torch.tensor(float(n - l), dtype=x.dtype, device=dev))
    return v[:, :k], ev[:k]


def sharded_column_means(x: Any, mesh: Mesh) -> torch.Tensor:
    """Column means of a (data, feat)-sharded X, each feature block reduced
    over ``data``: the μ a centered sketched fit needs at transform time."""
    _require_local(mesh)
    x = shard(x, mesh, feature_sharded=True)
    n_data, n_feat = mesh.shape[DATA_AXIS], mesh.shape[FEAT_AXIS]
    dev = mesh.first_device
    means = []
    for j in range(n_feat):
        s = B.psum(mesh, [x.block(i, j).sum(dim=0) for i in range(n_data)])[0]
        means.append((s / float(x.shape[0])).to(dev))
    return torch.cat(means)


def sharded_project(x: Any, components: torch.Tensor, mesh: Mesh, *,
                    mean: torch.Tensor | None = None, precision: str = "highest") -> torch.Tensor:
    """Y = (X − μ)·V with V [n, k] split by block-row over ``feat``: each
    cell contracts its feature block, one psum over ``feat`` completes the
    row shard's projection, and the rows are joined on the first device.
    ``mean`` is required for components of a centered fit (its omission
    offsets every projection by μ·V); the centering rides the same psum."""
    _require_local(mesh)
    x = shard(x, mesh, feature_sharded=True)
    n_data, n_feat = mesh.shape[DATA_AXIS], mesh.shape[FEAT_AXIS]
    c = x.shape[1] // n_feat
    v = torch.as_tensor(components)
    mu = None if mean is None else torch.as_tensor(mean)
    dev = mesh.first_device
    rows = []
    for i in range(n_data):
        parts = []
        for j in range(n_feat):
            xl = x.block(i, j)
            if mu is not None:
                xl = xl - mu[j * c:(j + 1) * c].to(xl.device, xl.dtype)[None, :]
            parts.append(block_product(xl, v[j * c:(j + 1) * c].to(xl.device, xl.dtype),
                                       precision))
        rows.append(_sum_to(parts, dev))
    return torch.cat(rows)


def make_sharded_project(mesh: Mesh, *, centered: bool = False):
    """``sharded_project`` bound to the mesh: ``f(x, components)``, or
    ``f(x, components, mean)`` with ``centered=True``."""
    if centered:
        return lambda x, components, mean: sharded_project(x, components, mesh, mean=mean)
    return lambda x, components: sharded_project(x, components, mesh)


def make_sketched_fit(mesh: Mesh, k: int, *, oversample: int = 10, power_iters: int = 2,
                      seed: int = 0, mean_centering: bool = False, precision: str = "highest"):
    """``sketched_pca_fit`` bound to the mesh and options."""
    return lambda x: sketched_pca_fit(
        x, k, mesh, oversample=oversample, power_iters=power_iters, seed=seed,
        mean_centering=mean_centering, precision=precision,
    )

