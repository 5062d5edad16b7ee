"""The port's split-bf16 Gram + moments against the Pallas kernels.

The plain PyTorch versions (what the wrappers run for a CPU tensor) are held
against ``spark_rapids_ml_tpu.ops.pallas_gram.fused_gram_moments`` and
``symmetric_gram_moments`` in interpret mode on the same f32 input, and both
against an f64 oracle. The CUDA kernels themselves run only on the card
(the ``cuda`` tests below).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.ops.pallas_gram import fused_gram_moments as pallas_fused
from spark_rapids_ml_tpu.ops.pallas_gram import symmetric_gram_moments as pallas_symmetric
from spark_rapids_ml_tpu_torch.ops import gram_moments as G

# the shapes and blocks of tests/test_pallas_gram.py
CASES = [
    pytest.param((2048, 256), 512, 128, id="block_aligned"),
    pytest.param((700, 128), 512, 128, id="row_padding"),
    pytest.param((512, 200), 256, 128, id="col_padding"),
    pytest.param((512, 384), 256, 128, id="multi_col_blocks"),
]


@pytest.mark.parametrize("shape,block_rows,block_cols", CASES)
def test_plain_version_matches_pallas_and_oracle(rng, shape, block_rows, block_cols):
    x = rng.normal(size=shape).astype(np.float32)
    pg, pcs, psq = (
        np.asarray(a)
        for a in pallas_fused(
            jnp.asarray(x), block_rows=block_rows, block_cols=block_cols, interpret=True
        )
    )
    tg, tcs, tsq = (t.numpy() for t in G.fused_gram_moments(torch.from_numpy(x)))

    xf = x.astype(np.float64)
    exact = xf.T @ xf
    scale = np.abs(exact).max()
    # port vs Pallas: the same bf16 products, f32 sums in another order
    np.testing.assert_allclose(tg, pg, atol=1e-5 * scale)
    np.testing.assert_allclose(tcs, pcs, atol=1e-5 * np.sqrt(shape[0]))
    np.testing.assert_allclose(tsq, psq, rtol=1e-5, atol=1e-5 * np.sqrt(shape[0]))
    # both vs the f64 oracle: split-bf16 carries ~16 mantissa bits
    rows = shape[0]
    for g, cs, sq in ((tg, tcs, tsq), (pg, pcs, psq)):
        np.testing.assert_allclose(g, exact, atol=3e-5 * scale)
        np.testing.assert_allclose(cs, xf.sum(0), rtol=1e-4, atol=2e-4 * np.sqrt(rows))
        np.testing.assert_allclose(sq, (xf**2).sum(0), rtol=1e-4, atol=2e-4 * np.sqrt(rows))


def test_split_precision_beats_bf16(rng):
    x = rng.normal(size=(1024, 128)).astype(np.float32)
    g, _, _ = G.fused_gram_moments(torch.from_numpy(x))
    exact = x.astype(np.float64).T @ x.astype(np.float64)
    bf = torch.from_numpy(x).to(torch.bfloat16).double().numpy()
    err_split = np.abs(g.double().numpy() - exact).max()
    err_bf16 = np.abs(bf.T @ bf - exact).max()
    assert err_split < err_bf16 / 20


def test_reference_blocks_agree(rng, monkeypatch):
    """The plain version's row blocks change only the f32 summation order."""
    x = torch.from_numpy(rng.normal(size=(3000, 96)).astype(np.float32))
    monkeypatch.setattr(G, "REFERENCE_BLOCK_ROWS", 4096)
    one = G.fused_gram_moments_reference(x)
    monkeypatch.setattr(G, "REFERENCE_BLOCK_ROWS", 256)
    blocked = G.fused_gram_moments_reference(x)
    scale = one[0].abs().max().item()
    torch.testing.assert_close(blocked[0], one[0], rtol=0, atol=1e-5 * scale)
    torch.testing.assert_close(blocked[1], one[1], rtol=1e-5, atol=1e-5 * 3000 ** 0.5)
    torch.testing.assert_close(blocked[2], one[2], rtol=1e-5, atol=1e-5 * 3000 ** 0.5)


@pytest.mark.parametrize(
    "shape", [pytest.param((700, 300), id="three_tiles"), pytest.param((512, 128), id="one_tile")]
)
def test_symmetric_plain_version_matches_pallas_and_oracle(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    pg, pcs, psq = (
        np.asarray(a)
        for a in pallas_symmetric(jnp.asarray(x), block_rows=256, block_cols=128, interpret=True)
    )
    tg, tcs, tsq = (t.numpy() for t in G.symmetric_gram_moments(torch.from_numpy(x)))

    xf = x.astype(np.float64)
    exact = xf.T @ xf
    scale = np.abs(exact).max()
    for g in (tg, pg):
        np.testing.assert_allclose(g, exact, atol=3e-5 * scale)
    np.testing.assert_allclose(tg, pg, atol=3e-5 * scale)
    # tests/test_pallas_gram.py's moment tolerances
    for cs, sq in ((tcs, tsq), (pcs, psq)):
        np.testing.assert_allclose(cs, xf.sum(0), rtol=1e-4, atol=6e-3)
        np.testing.assert_allclose(sq, (xf**2).sum(0), rtol=1e-4, atol=6e-3)
    # strict upper tiles mirrored bit-equal, as in the Pallas kernel
    np.testing.assert_array_equal(tg[128:, :128], tg[:128, 128:].T)
    np.testing.assert_array_equal(tg[256:, 128:256], tg[128:256, 256:].T)


def test_symmetric_plain_version_is_the_fused_one_mirrored(rng):
    x = torch.from_numpy(rng.normal(size=(300, 260)).astype(np.float32))
    sg, scs, ssq = G.symmetric_gram_moments_reference(x)
    fg, fcs, fsq = G.fused_gram_moments_reference(x)
    upper = (torch.arange(260) // G.TILE)[:, None] <= (torch.arange(260) // G.TILE)[None, :]
    assert torch.equal(sg[upper], fg[upper])
    assert torch.equal(sg, torch.where(upper, sg, sg.T))
    assert torch.equal(scs, fcs) and torch.equal(ssq, fsq)


@pytest.mark.parametrize("kernel", ["fused_gram_moments", "symmetric_gram_moments"])
def test_cpu_tensor_does_not_count_a_launch(rng, kernel):
    before = (G.launches, G.symmetric_launches)
    getattr(G, kernel)(torch.from_numpy(rng.normal(size=(64, 16)).astype(np.float32)))
    assert (G.launches, G.symmetric_launches) == before


@pytest.mark.parametrize("kernel", ["fused_gram_moments", "symmetric_gram_moments"])
@pytest.mark.parametrize(
    "make,error",
    [
        pytest.param(lambda: torch.zeros((8, 4), dtype=torch.float64), TypeError, id="f64"),
        pytest.param(lambda: torch.zeros((4, 8), dtype=torch.float32).T, ValueError,
                     id="non_contiguous"),
        pytest.param(lambda: torch.zeros((8,), dtype=torch.float32), ValueError, id="1d"),
    ],
)
def test_wrapper_rejects_bad_input(make, error, kernel):
    with pytest.raises(error):
        getattr(G, kernel)(make())


def test_split_rows_fills_the_card():
    # 65,536 x 512 on 132 SMs: 16 tiles, at least two blocks per SM
    splits, per_split = G._split_rows(65_536, 16, 132)
    assert splits * 16 >= 2 * 132
    assert per_split % G.STEP == 0 and splits * per_split >= 65_536
    assert (splits - 1) * per_split < 65_536  # no empty split
    assert G._split_rows(0, 16, 132)[0] >= 1


@pytest.mark.parametrize("n,tiles", [(512, 10), (2048, 136), (300, 6), (7, 1), (129, 3)])
def test_symmetric_splits_come_from_the_upper_tiles(n, tiles):
    assert G.upper_tiles(n) == tiles
    # 65,536 x 512: 10 upper tiles need 27 splits for two blocks per SM,
    # where the fused kernel's 16 tiles need 17
    splits, per_split = G._split_rows(65_536, G.upper_tiles(n), 132)
    assert (splits - 1) * per_split < 65_536 <= splits * per_split
    if n == 512:
        assert splits == 27 and G._split_rows(65_536, 16, 132)[0] == 17


@pytest.mark.cuda
def test_symmetric_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    for rows, n in ((65_536, 512), (38_528, 512), (1_000, 300), (33, 7)):
        x = torch.randn((rows, n), generator=gen, device="cuda")
        before = G.symmetric_launches
        g, cs, sq = G.symmetric_gram_moments(x)
        again = G.symmetric_gram_moments(x)
        torch.cuda.synchronize()
        assert G.symmetric_launches == before + 2
        rg, rcs, rsq = G.symmetric_gram_moments_reference(x)
        scale = rg.abs().max().item()
        torch.testing.assert_close(g, rg, rtol=0, atol=1e-5 * scale)
        atol = 1e-5 * rows ** 0.5 * x.abs().max().item()
        torch.testing.assert_close(cs, rcs, rtol=1e-5, atol=atol)
        torch.testing.assert_close(sq, rsq, rtol=1e-5, atol=atol)
        tile = torch.arange(n, device="cuda") // G.TILE
        lower = tile[:, None] > tile[None, :]
        assert torch.equal(g[lower], g.T[lower])  # the mirror is bit-equal
        for a, b in zip((g, cs, sq), again):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    for rows, n in ((65_536, 512), (1_000, 300), (33, 7)):
        x = torch.randn((rows, n), generator=gen, device="cuda")
        before = G.launches
        g, cs, sq = G.fused_gram_moments(x)
        again = G.fused_gram_moments(x)
        torch.cuda.synchronize()
        assert G.launches == before + 2
        rg, rcs, rsq = G.fused_gram_moments_reference(x)
        scale = rg.abs().max().item()
        torch.testing.assert_close(g, rg, rtol=0, atol=1e-5 * scale)
        atol = 1e-5 * rows ** 0.5 * x.abs().max().item()
        torch.testing.assert_close(cs, rcs, rtol=1e-5, atol=atol)
        torch.testing.assert_close(sq, rsq, rtol=1e-5, atol=atol)
        # split sums in a fixed order: two calls are bit-equal
        for a, b in zip((g, cs, sq), again):
            assert torch.equal(a, b)
