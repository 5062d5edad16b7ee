"""chip_smoke.py's phases on the CPU at a tiny size.

On the CPU the kernel wrappers run their plain versions, so this checks the
script's shapes, control flow and checks, not the kernels; the script itself
refuses to run without a card.
"""

import jax  # noqa: F401  (imported at the top of every port test file)
import numpy as np
import pytest
import torch

import chip_smoke

CPU = torch.device("cpu")


def test_kernel_check_phase_on_cpu():
    results = chip_smoke.phase_kernel_check([(300, 40), (33, 7)], CPU)
    assert set(results) == {(300, 40), (33, 7)}
    for entry in results.values():
        assert entry["max_abs_err"] <= entry["tol"]
        assert entry["max_abs_err_vs_f64"] <= entry["tol"]


def test_main_path_phase_on_cpu():
    result = chip_smoke.phase_main_path(3000, 96, 5, 3, CPU)
    assert result["launches"] == {"gram_moments": 0}  # plain version on the CPU
    assert result["min_cosine_vs_f64_oracle"] >= chip_smoke.COSINE_BAR
    assert result["transform_max_abs_err"] <= result["transform_tol"]


def test_bound_at_main_shape():
    bound_ms, bound_by = chip_smoke.gram_bound(65_536, 512)
    assert bound_by == "operations"
    assert bound_ms == pytest.approx(65_536 * 512 * (3 * 512 + 1) / 989e12 * 1e3)


def test_workload_is_seeded_f32():
    a, b = chip_smoke.bench_workload(50, 70), chip_smoke.bench_workload(50, 70)
    assert a.dtype == np.float32 and a.shape == (50, 70)
    np.testing.assert_array_equal(a, b)


def test_main_refuses_to_run_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out
