"""The port's bf16 Gram + moments against the Pallas kernels and JAX.

The plain PyTorch versions (what the wrappers run for a CPU tensor) of the
three-product (split-bf16) instances are held against
``spark_rapids_ml_tpu.ops.pallas_gram.fused_gram_moments`` and
``symmetric_gram_moments`` in interpret mode on the same f32 input, and both
against an f64 oracle. The one-product instances have no Pallas kernel:
their plain versions are held against the one-bf16-pass product written in
JAX (bf16 operands, ``preferred_element_type=f32``) and against the JAX
package's ``policy_matmul(..., policy="bf16_f32acc")``. The CUDA kernels
themselves run only on the card (the ``cuda`` tests below).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.ops import linalg as JL
from spark_rapids_ml_tpu.ops.pallas_gram import fused_gram_moments as pallas_fused
from spark_rapids_ml_tpu.ops.pallas_gram import symmetric_gram_moments as pallas_symmetric
from spark_rapids_ml_tpu_torch.ops import _build
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


COUNTERS = ("launches", "symmetric_launches", "launches_1pass", "symmetric_launches_1pass")


def _counts():
    return tuple(getattr(G, c) for c in COUNTERS)


@pytest.mark.parametrize("kernel", ["fused_gram_moments", "symmetric_gram_moments"])
def test_cpu_tensor_does_not_count_a_launch(rng, kernel):
    before = _counts()
    getattr(G, kernel)(torch.from_numpy(rng.normal(size=(64, 16)).astype(np.float32)))
    getattr(G, kernel)(torch.from_numpy(rng.normal(size=(64, 16)).astype(np.float32)), products=1)
    assert _counts() == before


@pytest.mark.parametrize("shape,block_rows,block_cols", CASES)
@pytest.mark.parametrize("kernel", ["fused_gram_moments", "symmetric_gram_moments"])
def test_one_pass_plain_version_matches_jax_one_pass(rng, shape, block_rows, block_cols, kernel):
    """hiᵀhi with hi = bf16(x): every product of two bf16 values is exact in
    f32, so the port's plain version and JAX's bf16 product with f32
    accumulation differ only in the f32 summation order (1e-5·max|G|, the
    tolerance of the three-product instances). The moments are Σx and Σx² of
    x itself, held to the f64 sums at rtol 1e-5 and 1e-5·√rows·max|x|."""
    x = rng.normal(size=shape).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    one_pass = np.asarray(jnp.matmul(xb.T, xb, preferred_element_type=jnp.float32))
    policy = np.asarray(JL.policy_matmul(jnp.asarray(x).T, jnp.asarray(x), policy="bf16_f32acc"))
    g, cs, sq = (t.numpy() for t in getattr(G, kernel)(torch.from_numpy(x), products=1))
    scale = np.abs(one_pass).max()
    np.testing.assert_allclose(g, one_pass, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(g, policy, rtol=0, atol=1e-5 * scale)
    hi = np.asarray(xb.astype(jnp.float64))
    np.testing.assert_allclose(g, hi.T @ hi, rtol=0, atol=1e-5 * scale)
    xf = x.astype(np.float64)
    atol = 1e-5 * np.sqrt(shape[0]) * np.abs(x).max()
    np.testing.assert_allclose(cs, xf.sum(0), rtol=1e-5, atol=atol)
    np.testing.assert_allclose(sq, (xf**2).sum(0), rtol=1e-5, atol=atol)
    if kernel == "symmetric_gram_moments" and shape[1] > 128:
        np.testing.assert_array_equal(g[128:, :128], g[:128, 128:].T)


def test_one_pass_is_the_tier_between(rng):
    """One bf16 pass carries ~8 mantissa bits: its Gram is further from the
    f64 one than the split's, and closer than nothing (bf16 rounding of the
    f64 Gram's scale)."""
    x = rng.normal(size=(1024, 128)).astype(np.float32)
    exact = x.astype(np.float64).T @ x.astype(np.float64)
    split = G.fused_gram_moments(torch.from_numpy(x))[0].double().numpy()
    one = G.fused_gram_moments(torch.from_numpy(x), products=1)[0].double().numpy()
    err_split, err_one = np.abs(split - exact).max(), np.abs(one - exact).max()
    assert err_split < err_one / 20
    assert err_one < 2.0**-7 * np.abs(exact).max()


def test_symmetric_one_pass_plain_version_is_the_fused_one_mirrored(rng):
    x = torch.from_numpy(rng.normal(size=(300, 260)).astype(np.float32))
    sg, scs, ssq = G.symmetric_gram_moments_reference(x, products=1)
    fg, fcs, fsq = G.fused_gram_moments_reference(x, products=1)
    upper = (torch.arange(260) // G.TILE)[:, None] <= (torch.arange(260) // G.TILE)[None, :]
    assert torch.equal(sg[upper], fg[upper])
    assert torch.equal(sg, torch.where(upper, sg, sg.T))
    assert torch.equal(scs, fcs) and torch.equal(ssq, fsq)
    assert torch.equal(fcs, torch.stack([b.sum(0) for b in torch.split(x, 1024)]).sum(0))


@pytest.mark.parametrize("products", [0, 2, "3"])
def test_products_must_be_one_or_three(products):
    x = torch.zeros((8, 4))
    for fn in (G.fused_gram_moments, G.symmetric_gram_moments,
               G.fused_gram_moments_reference, G.symmetric_gram_moments_reference):
        with pytest.raises(ValueError, match="products"):
            fn(x, products=products)


class _CudaLooking(torch.Tensor):
    """A CPU tensor that reports a CUDA device: what a wrapper sees for a
    tensor on the card, here where there is none."""

    @property
    def device(self):
        return torch.device("cuda", 0)


@pytest.mark.parametrize("products", [1, 3])
@pytest.mark.parametrize("kernel", ["fused_gram_moments", "symmetric_gram_moments"])
def test_wrapper_raises_instead_of_falling_back(monkeypatch, kernel, products):
    """A tensor on the card launches the kernel or raises: when the library
    does not load, neither the plain version nor a library product runs in
    its place, and no launch is counted."""
    def fail(name):
        raise OSError(f"cannot load the {name} library")

    def no_fallback(*args, **kwargs):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(_build, "load_library", fail)
    monkeypatch.setattr(G, "_entries", {})
    monkeypatch.setattr(G, "fused_gram_moments_reference", no_fallback)
    monkeypatch.setattr(G, "symmetric_gram_moments_reference", no_fallback)
    monkeypatch.setattr(torch.Tensor, "__matmul__", no_fallback)
    x = torch.zeros((64, 16)).as_subclass(_CudaLooking)
    before = _counts()
    with pytest.raises(OSError, match="gram_moments"):
        getattr(G, kernel)(x, products=products)
    assert _counts() == before


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
    # 65,536 x 512 on 132 SMs: one persistent block per SM, none idle, each
    # with 248 or 249 of the 16 tiles x 2,048 steps
    plan = G.schedule(65_536, 512, False, 132)
    assert plan.blocks == 132
    steps = plan.steps_per_block()
    assert sum(steps) == 16 * 65_536 // G.STEP and (min(steps), max(steps)) == (248, 249)
    assert G.schedule(0, 16, False, 132).blocks == 0  # no rows: no partial kernel


@pytest.mark.parametrize("n,tiles", [(512, 10), (2048, 136), (300, 6), (7, 1), (129, 3)])
def test_symmetric_splits_come_from_the_upper_tiles(n, tiles):
    pairs = G.tile_pairs(n, True)
    nt = -(-n // G.TILE)
    assert len(pairs) == tiles and all(bi <= bj < nt for bi, bj in pairs)
    plan = G.schedule(65_536, n, True, 132)
    assert [tuple(t[:2]) for t in plan.tiles.tolist()] == pairs
    # the symmetric line is tiles x 2,048 steps, where the fused one is nt² x 2,048
    assert sum(plan.steps_per_block()) == tiles * 65_536 // G.STEP
    if n == 512:
        assert len(plan.items) == 140 and len(G.schedule(65_536, n, False, 132).items) == 144


# chip_smoke.py's kernel shapes, and ragged ones
SCHEDULE_SHAPES = [
    (65_536, 512), (38_528, 512), (131_072, 2_048), (65_536, 129), (1_000, 300),
    (33, 7), (1, 1), (95, 257), (4_097, 640),
]


@pytest.mark.parametrize("symmetric", [False, True], ids=["fused", "symmetric"])
@pytest.mark.parametrize("rows,n", SCHEDULE_SHAPES)
def test_schedule_covers_every_tile_step_once(rows, n, symmetric):
    plan = G.schedule(rows, n, symmetric, 132)
    steps = -(-rows // G.STEP)
    pairs = G.tile_pairs(n, symmetric)
    seen = {}
    for bi, bj, s0, s1 in plan.items.tolist():
        assert 0 <= s0 < s1 <= steps
        for s in range(s0, s1):
            seen[(bi, bj, s)] = seen.get((bi, bj, s), 0) + 1
    assert set(seen) == {(bi, bj, s) for bi, bj in pairs for s in range(steps)}
    assert set(seen.values()) == {1}
    # each tile's items are contiguous and in row order: the reduce order
    for (bi, bj, first, end), pair in zip(plan.tiles.tolist(), pairs):
        assert (bi, bj) == pair
        run = plan.items[first:end]
        assert (run[:, :2] == pair).all()
        assert run[0, 2] == 0 and run[-1, 3] == steps
        assert (run[1:, 2] == run[:-1, 3]).all()


@pytest.mark.parametrize("symmetric", [False, True], ids=["fused", "symmetric"])
@pytest.mark.parametrize("rows,n", SCHEDULE_SHAPES)
def test_schedule_balances_the_sms_to_one_step(rows, n, symmetric):
    plan = G.schedule(rows, n, symmetric, 132)
    steps = plan.steps_per_block()
    assert plan.blocks == min(132, len(G.tile_pairs(n, symmetric)) * -(-rows // G.STEP))
    assert max(steps) - min(steps) <= 1 and min(steps) >= 1
    # a block's items cross at most the tile ends inside its share
    assert (np.diff(plan.block_items) >= 1).all()
    assert len(plan.items) <= plan.blocks + len(plan.tiles) - 1


def test_schedule_is_deterministic():
    for args in ((131_072, 2_048, True, 132), (4_097, 640, False, 7)):
        a, b = G.schedule.__wrapped__(*args), G.schedule.__wrapped__(*args)
        for x, y in zip(a, b):
            assert x.dtype == np.int32 and np.array_equal(x, y)


@pytest.mark.parametrize("x_cols,expected", [(512, "tma"), (300, "tma"), (129, "plain"), (7, "plain")])
def test_load_route_follows_the_tensor_map_rules(x_cols, expected):
    assert G.load_route(torch.zeros((8, x_cols))) == expected
    # a view that starts 4 bytes in is not 16-byte aligned
    assert G.load_route(torch.zeros((9, 512)).view(-1)[1:1 + 8 * 512].view(8, 512)) == "plain"


def _emulate(x, symmetric, sm_count, products=3):
    """The kernel's arithmetic in plain PyTorch, item by item: each step's
    three products of the split (f32 sums of exact bf16 products), added
    into the item's f32 partial, moments (of hi + lo) per step then into the
    item's sums, and each tile's items summed in the reduce pass's order;
    the symmetric instance writes each strict upper tile to its mirror. One
    product: ``_emulate_1pass``, the kernels both wrappers launch."""
    if products == 1:
        return _emulate_1pass(x, sm_count)
    rows, n = x.shape
    plan = G.schedule(rows, n, symmetric, sm_count)
    steps = -(-rows // G.STEP)
    n_pad = -(-n // G.TILE) * G.TILE
    xp = torch.zeros((steps * G.STEP, n_pad))
    xp[:rows, :n] = x
    hi = xp.to(torch.bfloat16).float()
    lo = (xp - hi).to(torch.bfloat16).float()

    def block(t, b, s0, s1):
        return t[s0 * G.STEP:s1 * G.STEP, b * G.TILE:(b + 1) * G.TILE].reshape(
            s1 - s0, G.STEP, G.TILE)

    partials, moments = [], []
    for bi, bj, s0, s1 in plan.items.tolist():
        ah, al, bh, bl = (block(t, b, s0, s1) for t, b in ((hi, bi), (lo, bi), (hi, bj), (lo, bj)))
        prods = ah.transpose(1, 2) @ bh
        if products == 3:
            prods = prods + ah.transpose(1, 2) @ bl + al.transpose(1, 2) @ bh
        acc = torch.zeros((G.TILE, G.TILE))
        for p in prods:
            acc += p
        v = bh + bl if products == 3 else block(xp, bj, s0, s1)
        cs, sq = torch.zeros(G.TILE), torch.zeros(G.TILE)
        for step_v in v:
            cs += step_v.sum(0)
            sq += (step_v * step_v).sum(0)
        partials.append(acc)
        moments.append((cs, sq))
    gram = torch.zeros((n_pad, n_pad))
    col_sum, sum_sq = torch.zeros(n_pad), torch.zeros(n_pad)
    for bi, bj, first, end in plan.tiles.tolist():
        tile = torch.zeros((G.TILE, G.TILE))
        cs, sq = torch.zeros(G.TILE), torch.zeros(G.TILE)
        for it in range(first, end):
            tile += partials[it]
            cs += moments[it][0]
            sq += moments[it][1]
        i, j = bi * G.TILE, bj * G.TILE
        gram[i:i + G.TILE, j:j + G.TILE] = tile
        if symmetric and bi < bj:
            gram[j:j + G.TILE, i:i + G.TILE] = tile.T
        if (bi == bj) if symmetric else (bi == 0):
            col_sum[j:j + G.TILE], sum_sq[j:j + G.TILE] = cs, sq
    return gram[:n, :n], col_sum[:n], sum_sq[:n]


def _emulate_1pass(x, sm_count, promote_steps=None):
    """The one-product kernels' arithmetic in plain PyTorch. Gram pass: the
    items of ``schedule_1pass`` at ``STEP_1PASS``-row steps of hi = bf16(x) (each
    step's product an f32 sum of exact bf16 products), ``promote_steps``
    steps summed into a run (from the item's start; the item's last run may
    be shorter), each run added into the item's f32 partial; the reduce
    pass sums each tile's items (``tile_items``) in row order and mirrors
    the strict upper tiles. Moments: each pre-pass row block sums its rows
    ``PREPASS_UNROLL`` at a time, then into its running sums; the reduce
    pass's lane l of 32 sums row blocks l, l + 32, ... in order, then the
    lanes in order."""
    promote_steps = promote_steps or G.PROMOTE_STEPS
    rows, n = x.shape
    plan = G.schedule_1pass(rows, n, sm_count)
    step = G.STEP_1PASS
    steps = -(-rows // step)
    n_pad = G.padded_cols(n)
    xp = torch.zeros((steps * step, n_pad))
    xp[:rows, :n] = x
    hi = xp.to(torch.bfloat16).float()

    def block(b, s0, s1):
        return hi[s0 * step:s1 * step, b * G.TILE:(b + 1) * G.TILE].reshape(s1 - s0, step, G.TILE)

    partials = []
    for bi, bj, s0, s1 in plan.items.tolist():
        prods = block(bi, s0, s1).transpose(1, 2) @ block(bj, s0, s1)
        acc = torch.zeros((G.TILE, G.TILE))
        for run in torch.split(prods, promote_steps):
            part = run[0].clone()
            for p in run[1:]:
                part += p
            acc += part
        partials.append(acc)
    gram = torch.zeros((n_pad, n_pad))
    for bi, bj, first, end in plan.tiles.tolist():
        tile = torch.zeros((G.TILE, G.TILE))
        for it in plan.tile_items[first:end].tolist():
            tile += partials[it]
        i, j = bi * G.TILE, bj * G.TILE
        gram[i:i + G.TILE, j:j + G.TILE] = tile
        if bi < bj:
            gram[j:j + G.TILE, i:i + G.TILE] = tile.T

    row_blocks, per_block = G.prepass_layout(rows, n, sm_count)
    parts = []
    for b in range(row_blocks):
        cs, sq = torch.zeros(n), torch.zeros(n)
        for group in torch.split(x[b * per_block:(b + 1) * per_block], G.PREPASS_UNROLL):
            cs += group.sum(0)
            sq += (group * group).sum(0)
        parts.append(torch.stack([cs, sq]))
    moments = torch.zeros((2, n))
    for lane in range(32):
        lane_sum = torch.zeros((2, n))
        for part in parts[lane::32]:
            lane_sum += part
        moments += lane_sum
    return gram[:n, :n], moments[0], moments[1]


@pytest.mark.parametrize("symmetric", [False, True], ids=["fused", "symmetric"])
@pytest.mark.parametrize("rows,n,sm_count", [(700, 300, 132), (2_000, 260, 7), (33, 7, 132)])
def test_emulated_schedule_matches_the_plain_version(rng, rows, n, sm_count, symmetric):
    _check_emulated_schedule(rng, rows, n, sm_count, symmetric, products=3)


@pytest.mark.parametrize("symmetric", [False, True], ids=["fused", "symmetric"])
@pytest.mark.parametrize("rows,n,sm_count", [(700, 300, 132), (2_000, 260, 7), (33, 7, 132)])
def test_emulated_one_pass_schedule_matches_the_plain_version(rng, rows, n, sm_count, symmetric):
    _check_emulated_schedule(rng, rows, n, sm_count, symmetric, products=1)


@pytest.mark.parametrize("promote_steps", [1, 3, 64])
@pytest.mark.parametrize("rows,n,sm_count", [(3_000, 200, 5), (700, 300, 132)])
def test_emulated_one_pass_promotion_matches_the_plain_version(rng, rows, n, sm_count,
                                                               promote_steps):
    """The promotion interval changes only the f32 summation order: every
    interval stays within the kernel check's tolerances of the plain
    version, and the mirror is bit-equal."""
    x = torch.from_numpy(rng.normal(size=(rows, n)).astype(np.float32))
    g, cs, sq = _emulate_1pass(x, sm_count, promote_steps)
    rg, rcs, rsq = G.symmetric_gram_moments_reference(x, products=1)
    scale = rg.abs().max().item()
    torch.testing.assert_close(g, rg, rtol=0, atol=1e-5 * scale)
    atol = 1e-5 * rows ** 0.5 * x.abs().max().item()
    torch.testing.assert_close(cs, rcs, rtol=1e-5, atol=atol)
    torch.testing.assert_close(sq, rsq, rtol=1e-5, atol=atol)
    assert torch.equal(g, g.T) or torch.equal(
        g[G.TILE:, :G.TILE], g[:G.TILE, G.TILE:].T)


@pytest.mark.parametrize("rows,n", SCHEDULE_SHAPES)
def test_one_pass_schedule_covers_every_upper_tile_step_once(rows, n):
    """Both one-product wrappers' work list: every upper tile pair and every
    64-row step exactly once; ``tile_items`` lists each tile's items in row
    order, back to back."""
    plan = G.schedule_1pass(rows, n, 132)
    steps = -(-rows // G.STEP_1PASS)
    pairs = G.tile_pairs(n, True)
    seen = {}
    for bi, bj, s0, s1 in plan.items.tolist():
        assert bi <= bj and 0 <= s0 < s1 <= steps
        for s in range(s0, s1):
            seen[(bi, bj, s)] = seen.get((bi, bj, s), 0) + 1
    assert set(seen) == {(bi, bj, s) for bi, bj in pairs for s in range(steps)}
    assert set(seen.values()) == {1}
    assert sorted(plan.tile_items.tolist()) == list(range(len(plan.items)))
    for (bi, bj, first, end), pair in zip(plan.tiles.tolist(), pairs):
        run = plan.items[plan.tile_items[first:end]]
        assert (bi, bj) == pair and (run[:, :2] == pair).all()
        assert run[0, 2] == 0 and run[-1, 3] == steps and (run[1:, 2] == run[:-1, 3]).all()


@pytest.mark.parametrize("rows,n", SCHEDULE_SHAPES)
def test_one_pass_schedule_walks_the_rows_together(rows, n):
    """Every tile is cut at the same row cuts, and the k-th items of all
    blocks are parts of one row sweep: their parts never go back from one
    k to the next, and within a k they are as long to within a step, so
    the blocks read the same rows at the same time. Each block's steps are
    within one part of every other's."""
    plan = G.schedule_1pass(rows, n, 132)
    cuts = sorted({int(c) for c in plan.items[:, 2:].ravel()})
    assert {tuple(r) for r in plan.items[:, 2:].tolist()} <= set(zip(cuts, cuts[1:]))
    part = {c: k for k, c in enumerate(cuts)}
    slots = {}
    for b in range(plan.blocks):
        for k, (bi, bj, s0, s1) in enumerate(plan.items[plan.block_items[b]:plan.block_items[b + 1]]
                                             .tolist()):
            slots.setdefault(k, []).append((part[s0], s1 - s0))
    for k in range(len(slots) - 1):
        assert max(p for p, _ in slots[k]) <= min(p for p, _ in slots[k + 1])
    for entries in slots.values():
        lengths = [length for _, length in entries]
        assert max(lengths) - min(lengths) <= 1
    steps = plan.steps_per_block()
    longest_part = max(b - a for a, b in zip(cuts, cuts[1:]))
    assert max(steps) - min(steps) <= longest_part and min(steps) >= 1


@pytest.mark.parametrize("rows,n,blocks,items", [
    (65_536, 512, 130, 130),       # 10 tiles x 13 parts, one a block
    (131_072, 2_048, 132, 1_360),  # 136 tiles x 10 parts, 11 rounds
    (65_536, 129, 129, 129),       # 3 tiles x 43 parts
    (33, 7, 1, 1),
])
def test_one_pass_schedule_at_the_kernel_shapes(rows, n, blocks, items):
    plan = G.schedule_1pass(rows, n, 132)
    assert (plan.blocks, len(plan.items)) == (blocks, items)


def test_one_pass_schedule_is_deterministic_and_apart_from_the_three_product_one():
    for rows, n, sm in ((131_072, 2_048, 132), (4_097, 640, 7)):
        a = G.schedule_1pass.__wrapped__(rows, n, sm)
        b = G.schedule_1pass.__wrapped__(rows, n, sm)
        for x, y in zip(a, b):
            assert x.dtype == np.int32 and np.array_equal(x, y)
    # the three-product kernels keep their 32-row steps and contiguous shares
    assert sum(G.schedule(65_536, 512, True, 132).steps_per_block()) == 10 * 2_048
    assert sum(G.schedule_1pass(65_536, 512, 132).steps_per_block()) == 10 * 1_024
    assert G.schedule_1pass(0, 16, 132).blocks == 0  # no rows: no Gram pass


@pytest.mark.parametrize("n,padded", [(1, 128), (7, 128), (128, 128), (129, 256), (300, 384),
                                      (512, 512), (2_048, 2_048)])
def test_one_pass_scratch_stride_is_padded_to_whole_tiles(n, padded):
    """hi's row stride: whole 128-feature tiles, so every TMA box of the
    Gram pass lies inside the copy and its stride (256 bytes a tile) is a
    multiple of 16 bytes at every n."""
    assert G.padded_cols(n) == padded
    assert (G.padded_cols(n) * 2) % 16 == 0


@pytest.mark.parametrize("rows,n", SCHEDULE_SHAPES + [(0, 5), (65_536, 2_048)])
def test_prepass_layout_covers_the_rows(rows, n):
    row_blocks, per_block = G.prepass_layout(rows, n, 132)
    if rows == 0:
        assert (row_blocks, per_block) == (0, 0)
        return
    assert per_block % G.PREPASS_UNROLL == 0
    assert row_blocks * per_block >= rows > (row_blocks - 1) * per_block
    col_blocks = -(-G.padded_cols(n) // G.PREPASS_COLS)
    # about PREPASS_BLOCKS_PER_SM blocks an SM where the rows allow
    assert row_blocks * col_blocks <= G.PREPASS_BLOCKS_PER_SM * 132 + col_blocks
    assert G.prepass_layout(rows, n, 132) == (row_blocks, per_block)


def _check_emulated_schedule(rng, rows, n, sm_count, symmetric, products):
    x = torch.from_numpy(rng.normal(size=(rows, n)).astype(np.float32))
    g, cs, sq = _emulate(x, symmetric, sm_count, products)
    plain = G.symmetric_gram_moments_reference if symmetric else G.fused_gram_moments_reference
    rg, rcs, rsq = plain(x, products=products)
    scale = rg.abs().max().item()
    torch.testing.assert_close(g, rg, rtol=0, atol=1e-5 * scale)
    atol = 1e-5 * rows ** 0.5 * x.abs().max().item()
    torch.testing.assert_close(cs, rcs, rtol=1e-5, atol=atol)
    torch.testing.assert_close(sq, rsq, rtol=1e-5, atol=atol)
    if symmetric:
        tile = torch.arange(n) // G.TILE
        lower = tile[:, None] > tile[None, :]
        assert torch.equal(g[lower], g.T[lower])


@pytest.mark.cuda
def test_symmetric_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    for rows, n in ((65_536, 512), (38_528, 512), (65_536, 129), (1_000, 300), (33, 7)):
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
    for rows, n in ((65_536, 512), (65_536, 129), (1_000, 300), (33, 7)):
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


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["fused_gram_moments", "symmetric_gram_moments"])
def test_one_pass_kernel_matches_plain_version_on_card(kernel):
    """Both load routes (TMA at 512 and 300 columns, plain loads at 129 and
    7) at the tolerances of the three-product kernels' card tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    wrapper = getattr(G, kernel)
    plain = getattr(G, f"{kernel}_reference")
    counter = "symmetric_launches_1pass" if kernel.startswith("symmetric") else "launches_1pass"
    gen = torch.Generator(device="cuda").manual_seed(0)
    for rows, n in ((65_536, 512), (38_528, 512), (65_536, 129), (1_000, 300), (33, 7)):
        x = torch.randn((rows, n), generator=gen, device="cuda")
        before = dict(zip(COUNTERS, _counts()))
        g, cs, sq = wrapper(x, products=1)
        again = wrapper(x, products=1)
        torch.cuda.synchronize()
        assert dict(zip(COUNTERS, _counts())) == {**before, counter: before[counter] + 2}
        rg, rcs, rsq = plain(x, products=1)
        scale = rg.abs().max().item()
        torch.testing.assert_close(g, rg, rtol=0, atol=1e-5 * scale)
        atol = 1e-5 * rows ** 0.5 * x.abs().max().item()
        torch.testing.assert_close(cs, rcs, rtol=1e-5, atol=atol)
        torch.testing.assert_close(sq, rsq, rtol=1e-5, atol=atol)
        if kernel.startswith("symmetric"):
            tile = torch.arange(n, device="cuda") // G.TILE
            lower = tile[:, None] > tile[None, :]
            assert torch.equal(g[lower], g.T[lower])
        for a, b in zip((g, cs, sq), again):
            assert torch.equal(a, b)
