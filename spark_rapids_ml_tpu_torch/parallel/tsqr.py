"""Distributed tall-skinny QR (TSQR) and the direct-SVD fit on the mesh.

Counterpart of ``spark_rapids_ml_tpu/parallel/tsqr.py``. The Gram route
squares the condition number before the eigensolver runs; TSQR reduces R
factors instead: each data shard QRs its rows, then the R factors merge
pairwise in a butterfly over the ``data`` axis (log₂D rounds of a QR of the
stacked pair, lower index first), and the SVD of the final n×n R gives the
components at cond(X) rather than cond(X)² accuracy (Demmel et al.'s
communication-avoiding QR).

The QRs and the SVD of R are ``torch.linalg``'s. R is unique only up to the
signs of its rows, so R factors of two programs agree after a sign
normalisation; the components are sign-flipped by the reference's rule
either way.

On a mesh of this process each pair's QR runs once, on the lower shard's
device, and both partners take it. On a process mesh every rank gathers
the shards' R factors (``backend.all_gather``) and runs the same butterfly
in the same order, so every rank holds the bits of the in-process result.
"""

from __future__ import annotations

from typing import Any

import torch

from spark_rapids_ml_tpu_torch.ops import linalg as L
from spark_rapids_ml_tpu_torch.parallel import backend as B
from spark_rapids_ml_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    Mesh,
    center_columns_shard,
    shard,
    vector_sharding,
)


def _butterfly_r(rs: list[torch.Tensor]) -> list[torch.Tensor]:
    """At round t shard i merges with shard i ^ t: the QR of the stacked
    pair in canonical (lower index first) order, so both partners hold the
    identical R. After log₂D rounds every shard holds the same R, with RᵀR
    = Σᵢ RᵢᵀRᵢ."""
    rs = list(rs)
    t = 1
    while t < len(rs):
        merged = list(rs)
        for i in range(len(rs)):
            if i & t == 0:
                m = L.combine_r(rs[i], rs[i ^ t].to(rs[i].device))
                merged[i], merged[i ^ t] = m, m.to(rs[i ^ t].device)
        rs = merged
        t *= 2
    return rs


def merge_r(rs: list[torch.Tensor], n_data: int | None = None) -> torch.Tensor:
    """Every data shard's R (in shard order) merged into the one R: the
    butterfly when the data axis is a power of two, one QR of the [D·n, n]
    stack otherwise. The result lies on the first shard's device."""
    n_data = len(rs) if n_data is None else n_data
    if n_data == 1:
        return rs[0]
    if n_data & (n_data - 1) == 0:
        return _butterfly_r(rs)[0]
    dev = rs[0].device
    return L.qr_r(torch.cat([r.to(dev) for r in rs]))


def _merged(mesh: Mesh, local_rs: list[torch.Tensor]) -> torch.Tensor:
    return merge_r(B.all_gather(mesh, local_rs), mesh.shape[DATA_AXIS]).to(mesh.first_device)


def tsqr_r(x: Any, mesh: Mesh) -> torch.Tensor:
    """R factor of a [rows, n] matrix row-sharded over ``data``."""
    x = shard(x, mesh)
    return _merged(mesh, [L.qr_r(b) for b in x.data_blocks()])


def distributed_pca_fit_svd(x: Any, k: int, mesh: Mesh, *, mean_centering: bool = False
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The direct-SVD fit: sharded rows → (pc, explained variance). With
    centering, the global mean is one psum over the data axis, applied to
    each shard before its QR."""
    x = shard(x, mesh)
    blocks = x.data_blocks()
    if mean_centering:
        blocks = center_columns_shard(blocks, mesh)
    return L.svd_from_r(_merged(mesh, [L.qr_r(b) for b in blocks]), k)


def make_distributed_fit_svd(mesh: Mesh, k: int, *, mean_centering: bool = False):
    """``distributed_pca_fit_svd`` with the mesh and options bound."""
    return lambda x: distributed_pca_fit_svd(x, k, mesh, mean_centering=mean_centering)


def make_distributed_fit_svd_masked(mesh: Mesh, k: int, *, mean_centering: bool = False):
    """The TSQR fit for padded shards (the barrier path pads every process to
    a common shard shape): ``fit(x, w)`` with ``w`` the 1/0 pad mask. Zero
    pad rows are exact for the uncentered QR, but centering would make them
    −μ rows, so the mean uses the true row count (a psum of the mask) and
    the centered rows are masked again: (x − μ)·w."""

    def fit(x, w):
        xs, ws = shard(x, mesh), vector_sharding(mesh).shard(w)
        blocks = xs.data_blocks()
        if mean_centering:
            masks = [m.to(b.device, b.dtype) for m, b in zip(ws.data_blocks(), blocks)]
            col_sum = B.psum(mesh, [b.sum(dim=0) for b in blocks])
            count = B.psum(mesh, [m.sum() for m in masks])
            blocks = [(b - (s / torch.clamp(c, min=1.0))[None, :]) * m[:, None]
                      for b, s, c, m in zip(blocks, col_sum, count, masks)]
        return L.svd_from_r(_merged(mesh, [L.qr_r(b) for b in blocks]), k)

    return fit
