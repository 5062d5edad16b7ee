"""The KMeans assignment on the card, held to f64 and to the whole distance
tile.

``ops.kmeans.assign_block`` takes each row's argmin of ‖c‖² − 2·x·cᵀ
straight from the product and adds ‖x‖² to the minima alone;
``pairwise_sq_dists`` still builds every distance. On the card, at the
config-5 widths (128 features, k = 1000) over 1,000,000 rows in the
estimator's 65,536-row blocks, the argmin path's labels equal the f64
labels except at near ties, and its cost is within 1e-6 of the cost that
the whole tile's minima give. This file imports no JAX, so that the card's
run collects it.
"""

from __future__ import annotations

import pytest
import torch

from spark_rapids_ml_tpu_torch.ops import kmeans as KM

ROWS, N, K = 1_000_000, 128, 1000
BLOCK = 65_536


def _near_tie_bound(n: int) -> float:
    """``chip_smoke.f32_dist_error_bound``: |f32 − exact| of one expanded
    squared distance, relative to ‖x‖² + ‖c‖²."""
    return 2.0 * (n + 2) * 2.0**-24


@pytest.mark.cuda
def test_argmin_path_on_the_card_matches_f64_and_the_whole_tile():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the product runs in cuBLAS")
    card = torch.device("cuda", 0)
    old_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        gen = torch.Generator(device=card).manual_seed(7)
        truth = torch.randn((K, N), generator=gen, device=card)
        pick = torch.randint(0, K, (ROWS,), generator=gen, device=card)
        x = truth[pick] + torch.randn((ROWS, N), generator=gen, device=card)
        centers = x[torch.randperm(ROWS, generator=gen, device=card)[:K]].clone()

        labels, dists = KM.assign_blocks(x, centers, block_rows=BLOCK)
        c64 = centers.double()
        c_sq64 = (c64 * c64).sum(1)
        tie = 2.0 * _near_tie_bound(N)
        bad = near = differ = 0
        cost_old = torch.zeros((), dtype=torch.float64, device=card)
        for lo in range(0, ROWS, BLOCK):
            xb = x[lo:lo + BLOCK]
            cost_old += torch.min(KM.pairwise_sq_dists(xb, centers), dim=1).values.double().sum()
            x64 = xb.double()
            x_sq64 = (x64 * x64).sum(1)
            d = (x_sq64[:, None] + c_sq64[None, :]) - 2.0 * (x64 @ c64.T)
            top = torch.topk(d, 2, dim=1, largest=False)
            is_near = (top.values[:, 1] - top.values[:, 0]) < tie * (x_sq64 + c_sq64.max())
            wrong = labels[lo:lo + BLOCK].long() != top.indices[:, 0]
            bad += int((wrong & ~is_near).sum())
            near += int(is_near.sum())
            differ += int(wrong.sum())
        cost_new = float(dists.double().sum())
        assert bad == 0, f"{differ} labels off f64, {bad} of them not at a near tie ({near})"
        assert abs(cost_new / float(cost_old) - 1.0) <= 1e-6, (cost_new, float(cost_old))
        assert labels.dtype == torch.int32 and (dists >= 0).all()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old_tf32
