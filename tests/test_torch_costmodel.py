"""The port's analytical cost model against its formulas and the JAX
package's rollup.

The port reads each kernel's cost from the callable's ``cost`` (shapes and
dtypes only), where the JAX package reads XLA's ``cost_analysis``; so the
per-call numbers are checked against their formulas, and the rollup
(``window_summary``) against the JAX function on the same counter values,
with ``TPU_ML_PEAK_TFLOPS`` pinned for both. Fits and transforms run on the
CPU at a small size, f32 rows made with numpy from a seed.
"""

import jax  # noqa: F401  (imported at the top of every port test file)
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.telemetry import costmodel as jax_costmodel
from spark_rapids_ml_tpu.telemetry.registry import MetricsRegistry as JaxRegistry
from spark_rapids_ml_tpu_torch import PCA
from spark_rapids_ml_tpu_torch.ops import linalg as L
from spark_rapids_ml_tpu_torch.ops import linear as LIN
from spark_rapids_ml_tpu_torch.telemetry import costmodel
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY, MetricsRegistry

CPU = torch.device("cpu")
ROWS, N, K = 900, 24, 4


@pytest.fixture(autouse=True)
def _fresh_cost_tables():
    costmodel.reset()
    jax_costmodel.reset()
    yield
    costmodel.reset()
    jax_costmodel.reset()


@pytest.fixture(scope="module")
def x():
    rng = np.random.default_rng(5)
    return (rng.normal(size=(ROWS, 8)) @ rng.normal(size=(8, N))
            + 0.1 * rng.normal(size=(ROWS, N))).astype(np.float32)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("rows,n,dtype", [(1024, 24, torch.float32), (65_536, 512, torch.float32),
                                          (128, 7, torch.float64)])
def test_gram_costs_follow_their_formula(rows, n, dtype):
    """gram_stats and the fold step: 2·rows·n² + 2·rows·n operations,
    rows·n·itemsize + (n² + 2n)·4 bytes, at every tier."""
    item = torch.empty((), dtype=dtype).element_size()
    want = (2.0 * rows * n * n + 2.0 * rows * n, float(rows * n * item + (n * n + 2 * n) * 4))
    x = _meta(rows, n, dtype=dtype)
    for precision in L.PRECISIONS:
        assert L.gram_stats.cost(x, precision=precision) == want
        step = L.gram_fold_step(precision)
        carry = L.GramStats(_meta(n, n), _meta(n), _meta())
        assert step.cost(carry, x, _meta(rows)) == want


@pytest.mark.parametrize("rows,n,k", [(1024, 24, 4), (65_536, 512, 50)])
def test_project_cost_follows_its_formula(rows, n, k):
    assert L.project.cost(_meta(rows, n), _meta(n, k)) == (
        2.0 * rows * n * k, float((rows * n + n * k + rows * k) * 4))


@pytest.mark.parametrize("carry_dtype", [torch.float64, torch.float32])
def test_linear_fold_cost_is_in_the_same_form(carry_dtype):
    rows, n = 4096, 33
    step = LIN.linear_fold_step()
    carry = LIN.LinearStats(*(_meta(*s, dtype=carry_dtype)
                              for s in ((n, n), (n,), (n,), (), (), ())))
    item = torch.empty((), dtype=carry_dtype).element_size()
    assert step.cost(carry, _meta(rows, n), _meta(rows), _meta(rows)) == (
        2.0 * rows * n * n + 4.0 * rows * n,
        float(rows * (n + 2) * 4 + (n * n + 2 * n + 3) * item))


def test_capture_books_the_counters_and_memoizes(x):
    calls = []

    def fn(a):
        return a

    def cost(a):
        calls.append(tuple(a.shape))
        assert a.device.type == "meta"  # the cost never sees the data
        return 10.0, 20.0

    fn.cost = cost
    t = torch.from_numpy(x)
    s0 = REGISTRY.snapshot()
    for _ in range(3):
        entry = costmodel.capture("test.kernel", fn, t)
    costmodel.capture("test.kernel", fn, t[:100])
    d = REGISTRY.snapshot().delta(s0)
    assert calls == [(ROWS, N), (100, N)]  # once per shape signature
    assert entry == {"flops": 10.0, "bytes_accessed": 20.0, "argument_bytes": t.nbytes,
                     "output_bytes": 0}
    assert d.counter("costmodel.calls", kernel="test.kernel") == 4
    assert d.counter("costmodel.flops", kernel="test.kernel") == 40.0
    assert d.counter("costmodel.bytes", kernel="test.kernel") == 80.0
    assert costmodel.kernel_costs()["test.kernel"]["flops"] == 10.0


def test_a_callable_without_cost_books_nothing_and_never_raises(x):
    def bare(a):
        return a

    def broken(a):
        return a

    broken.cost = lambda a: 1 / 0
    t = torch.from_numpy(x)
    s0 = REGISTRY.snapshot()
    assert costmodel.capture("test.bare", bare, t) is None
    assert costmodel.capture("test.broken", broken, t) is None
    assert costmodel.capture("test.broken", broken, t) is None
    assert REGISTRY.snapshot().delta(s0).counter("costmodel.calls") == 0
    assert costmodel.kernel_costs() == {}


def _window(registry, counters):
    s0 = registry.snapshot()
    for (name, kernel), value in counters.items():
        registry.counter_inc(name, value, kernel=kernel)
    return registry.snapshot().delta(s0)


@pytest.mark.parametrize("wall", [0.0, 1e-3, 2.5])
@pytest.mark.parametrize("peak", ["197.0", "989.4", "1e-6"])
def test_window_summary_equals_the_jax_rollup(monkeypatch, wall, peak):
    monkeypatch.setenv("TPU_ML_PEAK_TFLOPS", peak)
    counters = {
        ("costmodel.calls", "linalg.gram_stats"): 8,
        ("costmodel.flops", "linalg.gram_stats"): 8 * 3.4e10,
        ("costmodel.bytes", "linalg.gram_stats"): 8 * 1.3e8,
        ("costmodel.calls", "linalg.project"): 1,
        ("costmodel.flops", "linalg.project"): 2.56e10,
        ("costmodel.bytes", "linalg.project"): 1.1e9,
    }
    port = costmodel.window_summary(_window(MetricsRegistry(), counters), wall)
    ref = jax_costmodel.window_summary(_window(JaxRegistry(), counters), wall)
    assert port == ref and port["peak_flops"] == float(peak) * 1e12
    assert ("roofline_utilization" in port) == (wall > 0)


def test_window_summary_is_empty_without_captures():
    assert costmodel.window_summary(_window(MetricsRegistry(), {}), 1.0) == {}


def test_default_peak_is_the_cards(monkeypatch):
    monkeypatch.delenv("TPU_ML_PEAK_TFLOPS", raising=False)
    assert costmodel.peak_flops() == 989.4e12
    monkeypatch.setenv("TPU_ML_PEAK_TFLOPS", "not a number")
    assert costmodel.peak_flops() == 989.4e12


@pytest.mark.parametrize("partitions", [1, 3])
def test_a_fits_report_books_gram_stats_once_a_partition(x, partitions):
    model = PCA(device=CPU).setK(K).fit(x, num_partitions=partitions)
    cost = model.fit_report.cost_model
    gram = cost["kernels"]["linalg.gram_stats"]
    padded = max(128, 1 << int(np.ceil(np.log2(-(-ROWS // partitions)))))
    assert gram["calls"] == partitions
    assert gram["flops"] == 2.0 * padded * N * N + 2.0 * padded * N
    assert cost["analytical_flops"] == partitions * gram["flops"]
    assert 0 < cost["roofline_utilization"] < 1
    model.transform(x)
    project = model.transform_report.cost_model["kernels"]["linalg.project"]
    assert project["calls"] == 1
    assert project["flops"] == 2.0 * max(128, 1 << int(np.ceil(np.log2(ROWS)))) * N * K


def test_a_streamed_fits_report_books_every_fold(x, monkeypatch):
    monkeypatch.setenv("TPU_ML_STREAM_FIT_MAX_RESIDENT_BYTES", "1")
    monkeypatch.setenv("TPU_ML_STREAM_CHUNK_ROWS", "128")
    monkeypatch.setenv("TPU_ML_AUTOTUNE", "off")
    model = PCA(device=CPU).setK(K).fit(x)
    cost = model.fit_report.cost_model
    fold = cost["kernels"]["stream.fold_step"]
    assert fold["calls"] == model.stream_report.chunks == -(-ROWS // 128)
    # each fold books its own rows: seven full chunks and a 4-row tail
    chunks = [128] * (ROWS // 128) + [ROWS % 128]
    assert cost["analytical_flops"] == sum(2.0 * r * N * N + 2.0 * r * N for r in chunks)
    # the table's entry is the largest call, a full chunk, updated in place
    assert costmodel.kernel_costs()["stream.fold_step"]["flops"] == 2.0 * 128 * N * (N + 1)
    assert fold["output_bytes"] == 0
    assert model.fit_report.tuning == {}  # the tuner is off
