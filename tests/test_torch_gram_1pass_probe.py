"""The one-product kernel's diagnostics script (``gram_1pass_probe.py``)
on the CPU: the pieces that do not need the card."""

import numpy as np
import pytest
import torch

import gram_1pass_probe as P
from spark_rapids_ml_tpu_torch.ops import gram_moments as G


def test_probe_refuses_to_run_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert P.main([]) == 1
    assert '"probe"' not in capsys.readouterr().out


@pytest.mark.parametrize("rows,n", [(65_536, 512), (131_072, 2_048), (1_000, 300), (33, 7)])
def test_contiguous_shares_cover_every_upper_tile_step_once(rows, n):
    """The comparison work list: contiguous shares of the upper tiles'
    line at the one-product step, balanced to a step, each tile's items in
    row order."""
    plan = P.contiguous_shares(rows, n, 132)
    steps = -(-rows // G.STEP_1PASS)
    pairs = G.tile_pairs(n, True)
    seen = sorted((bi, bj, s) for bi, bj, s0, s1 in plan.items.tolist() for s in range(s0, s1))
    assert seen == sorted((bi, bj, s) for bi, bj in pairs for s in range(steps))
    per_block = plan.steps_per_block()
    assert max(per_block) - min(per_block) <= 1
    for (bi, bj, first, end) in plan.tiles.tolist():
        run = plan.items[plan.tile_items[first:end]]
        assert (run[:, :2] == (bi, bj)).all() and (run[1:, 2] == run[:-1, 3]).all()
    assert np.array_equal(plan.tile_items, np.arange(len(plan.items)))


def test_variant_sources_leave_out_what_they_name():
    """Each variant differs from the kernel's source only in the Gram pass:
    no wgmma issued, or no TMA load issued."""
    sources = P._variant_sources()
    kernel, no_mma, no_tma = sources["kernel"], sources["no_wgmma"], sources["no_tma"]
    gram_pass = "gram_1pass_kernel(const __grid_constant__"
    assert kernel.count("wgmma_m64n128k16(part,") == 1
    assert no_mma.count("wgmma_m64n128k16(part,") == 0
    assert kernel.count("tma_load_2d(b_dst + atom * k1Atom") == 1
    assert no_tma.count("tma_load_2d(b_dst + atom * k1Atom") == 0
    for variant in (no_mma, no_tma):
        assert variant[:variant.index(gram_pass)] == kernel[:kernel.index(gram_pass)]
