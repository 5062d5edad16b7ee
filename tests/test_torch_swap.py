"""The port's hot swap, rollback, shadow gate, fault sites and hedged
dispatch against the JAX package's, on the CPU.

Both registries serve the same JAX-fitted models (carried across with
``convert.model_from_arrays``) on the ladder 8, 16, 32, 64
(``TPU_ML_SERVE_MAX_BATCH_ROWS=64``); the port's runs with device="cpu",
where the kernel runs eagerly under the bucket's dispatch lock. Tolerances:

- the shadow divergence of one live/candidate pair on one sample: within
  1e-6 of the JAX package's (the JAX side computes in f64 here, the test
  session enabling x64), and the refuse/accept decision the same at a
  tolerance 1e-5 either side of it;
- answers after a rollback: bit for bit the prior's, and within 1e-5 × max
  |expected| of the JAX package's;
- version numbers, refusals and fault outcomes: equal.

The hedge test holds the primary's dispatch lock, as a replay stuck on the
card would, and the hedge must still answer: a resend on the primary's
own rung would wait on that lock, which the companion case shows.
"""

from __future__ import annotations

import threading

import jax  # noqa: F401  (imported at the top of every port test file)
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.models.linear import LinearRegression as JaxLinearRegression
from spark_rapids_ml_tpu.models.pca import PCA as JaxPCA
from spark_rapids_ml_tpu.resilience import faults as jfaults
from spark_rapids_ml_tpu.serving import batcher as jbatcher
from spark_rapids_ml_tpu.serving import registry as jregistry
from spark_rapids_ml_tpu.telemetry.registry import REGISTRY as JREGISTRY
from spark_rapids_ml_tpu_torch.convert import model_from_arrays
from spark_rapids_ml_tpu_torch.resilience import faults
from spark_rapids_ml_tpu_torch.serving import batcher as batcher_mod
from spark_rapids_ml_tpu_torch.serving import hbm
from spark_rapids_ml_tpu_torch.serving import registry as registry_mod
from spark_rapids_ml_tpu_torch.serving.server import serve_summary
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY

N = 6
BUCKETS = (8, 16, 32)
DIVERGENCE_ATOL = 1e-6
DECISION_MARGIN = 1e-5
REL_TOL = 1e-5


@pytest.fixture(autouse=True)
def serve_env(monkeypatch):
    monkeypatch.setenv("TPU_ML_SERVE_MIN_BUCKET", "8")
    monkeypatch.setenv("TPU_ML_SERVE_MAX_BATCH_ROWS", "64")
    monkeypatch.delenv("TPU_ML_SERVE_HBM_BUDGET_BYTES", raising=False)
    monkeypatch.delenv("TPU_ML_FAULT_PLAN", raising=False)
    faults.reset_faults()
    jfaults.reset_faults()
    yield
    faults.reset_faults()
    jfaults.reset_faults()
    registry_mod.reset_for_tests()
    jregistry.reset_for_tests()


def _xy(rows: int, seed: int, n: int = N):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, n)) * np.linspace(3.0, 0.5, n)).astype(np.float32)
    return x, (x @ np.arange(1.0, n + 1.0) + 0.5).astype(np.float32)


def _jax_fit(family: str, seed: int, target_scale: float = 1.0, n: int = N):
    x, y = _xy(256, seed, n)
    if family == "linear":
        return JaxLinearRegression().fit((x, target_scale * y))
    return JaxPCA().setK(3).fit(x)


def _port(jmodel):
    return model_from_arrays(type(jmodel).__name__, jmodel._saveData(), device="cpu")


def _both(live, cand):
    """A JAX registry and the port's, each with ``live`` and ``cand``
    registered over ``BUCKETS``."""
    jreg, preg = jregistry.ModelRegistry(), registry_mod.ModelRegistry("cpu")
    for name, model in (("live", live), ("cand", cand)):
        jreg.register(name, model, bucket_list=BUCKETS)
        preg.register(name, _port(model), bucket_list=BUCKETS)
    return jreg, preg


def _divergence(reg, sample) -> float:
    return reg._shadow_divergence(
        reg._run_entry(reg.get("live"), sample), reg._run_entry(reg.get("cand"), sample)
    )


# -- the shadow gate ---------------------------------------------------------


@pytest.mark.parametrize("family", ["linear", "pca"])
def test_shadow_divergence_and_decisions_match_jax(family):
    live, cand = _jax_fit(family, 0), _jax_fit(family, 1)
    jreg, preg = _both(live, cand)
    sample = _xy(24, 9)[0]
    d_jax, d_port = _divergence(jreg, sample), _divergence(preg, sample)
    assert 0.0 < d_jax < np.inf
    assert abs(d_port - d_jax) <= DIVERGENCE_ATOL, (d_port, d_jax)
    # just below the divergence both refuse, just above both publish
    for reg, model in ((jreg, cand), (preg, _port(cand))):
        with pytest.raises((registry_mod.SwapRefused, jregistry.SwapRefused), match="shadow gate"):
            reg.swap("live", model, shadow_sample=sample, tolerance=d_jax - DECISION_MARGIN)
        assert reg.current_version("live") == 1
        entry = reg.swap("live", model, shadow_sample=sample, tolerance=d_jax + DECISION_MARGIN)
        assert entry.version == reg.current_version("live") == 2


def test_shadow_divergence_of_a_shape_mismatch_or_nan_is_infinite():
    a = np.ones((4, 3), np.float32)
    for reg in (jregistry.ModelRegistry, registry_mod.ModelRegistry):
        div = reg._shadow_divergence
        assert div(a, a[:, :2]) == np.inf
        assert div(a, np.full_like(a, np.nan)) == np.inf
        assert div(a, a) == 0.0


def test_shadow_tolerance_knob_matches_jax(monkeypatch):
    jreg, preg = jregistry.ModelRegistry(), registry_mod.ModelRegistry("cpu")
    for raw in ("", "0.05", "bad", "3"):
        monkeypatch.setenv("TPU_ML_SWAP_SHADOW_TOLERANCE", raw)
        assert preg.shadow_tolerance() == jreg.shadow_tolerance()


# -- versions, rollback, prune ------------------------------------------------


def _lifecycle(reg, models):
    """swap → swap → rollback → prune → rollback: every step's version and
    retained prior, and the outcome of the failing steps."""
    out = []
    reg.register("lin", models[0], bucket_list=BUCKETS)
    out.append(("register", reg.current_version("lin"), reg.prior_entry("lin")))
    for m in models[1:]:
        reg.swap("lin", m, tolerance=100.0)
        out.append(("swap", reg.current_version("lin"), reg.prior_entry("lin").version))
    out.append(("rollback", reg.rollback("lin").version, reg.prior_entry("lin")))
    out.append(("prune", reg.prune_prior("lin"), reg.current_version("lin")))
    reg.swap("lin", models[-1], tolerance=100.0)
    out.append(("swap", reg.current_version("lin"), reg.prior_entry("lin").version))
    out.append(("prune", reg.prune_prior("lin"), reg.prior_entry("lin")))
    out.append(("prune", reg.prune_prior("lin"), reg.current_version("lin")))
    with pytest.raises(KeyError) as err:
        reg.rollback("lin")
    out.append(("rollback", str(err.value)))
    return out


def test_version_sequence_matches_jax(monkeypatch):
    jmodels = [_jax_fit("linear", s) for s in range(3)]
    port = _lifecycle(registry_mod.ModelRegistry("cpu"), [_port(m) for m in jmodels])
    ref = _lifecycle(jregistry.ModelRegistry(), jmodels)
    assert port == ref
    assert [s[:2] for s in port[:3]] == [("register", 1), ("swap", 2), ("swap", 3)]


@pytest.mark.parametrize("family", ["linear", "pca"])
def test_rollback_answers_bit_equal_to_the_prior(family):
    old, new = _jax_fit(family, 0), _jax_fit(family, 1)
    reg = registry_mod.ModelRegistry("cpu")
    reg.register("m", _port(old), bucket_list=BUCKETS)
    x = _xy(11, 9)[0]
    before = reg.predict("m", x)
    reg.swap("m", _port(new), tolerance=100.0)
    swapped = reg.predict("m", x)
    assert not np.array_equal(swapped, before)
    prior = reg.rollback("m")
    assert prior.version == 1 and not prior.released
    assert np.array_equal(reg.predict("m", x), before)
    # the JAX package's answer of the same model
    jreg = jregistry.ModelRegistry()
    jreg.register("m", old, bucket_list=BUCKETS)
    expected = np.asarray(jreg.predict("m", x), np.float64)
    got = np.asarray(before, np.float64)
    assert got.shape == expected.shape
    assert np.abs(got - expected).max() <= REL_TOL * np.abs(expected).max()


def test_prune_and_rollback_release_the_version_they_drop():
    reg = registry_mod.ModelRegistry("cpu")
    reg.register("m", _port(_jax_fit("linear", 0)), bucket_list=BUCKETS)
    v1 = reg.get("m")
    v2 = reg.swap("m", _port(_jax_fit("linear", 1)), tolerance=100.0)
    reg.rollback("m")
    assert v2.released and v2.params is None and not v1.released
    v3 = reg.swap("m", _port(_jax_fit("linear", 2)), tolerance=100.0)
    assert reg.prune_prior("m") and v1.released and not v3.released
    # a dispatch that still holds a released entry runs on the slot's version
    padded = np.zeros((8, N), np.float32)
    padded[0] = 1.0
    assert np.array_equal(
        reg.dispatch_padded(v1, padded, 8), reg.dispatch_padded(v3, padded, 8)
    )


def test_prior_booking_is_never_paged_out(monkeypatch):
    monkeypatch.setenv("TPU_ML_SERVE_HBM_BUDGET_BYTES", "1")
    reg = registry_mod.ModelRegistry("cpu")
    reg.register("a", _port(_jax_fit("linear", 0)), bucket_list=BUCKETS)
    reg.swap("a", _port(_jax_fit("linear", 1)), tolerance=100.0)
    prior = reg.prior_entry("a")
    reg.register("b", _port(_jax_fit("linear", 2)), bucket_list=BUCKETS)
    models = hbm.get_fleet().stats()["models"]
    assert models["a@prior"]["resident"] and prior.resident
    assert not models["a"]["resident"]  # the live one is LRU and pages
    reg.rollback("a")
    assert "a@prior" not in hbm.get_fleet().stats()["models"]
    assert prior.resident


# -- refusals ------------------------------------------------------------------


def test_shape_mismatch_and_unknown_name_raise_as_jax():
    live, narrow = _jax_fit("linear", 0), _jax_fit("linear", 1, n=4)
    errors = []
    for reg, conv in ((registry_mod.ModelRegistry("cpu"), _port),
                      (jregistry.ModelRegistry(), lambda m: m)):
        reg.register("lin", conv(live), bucket_list=BUCKETS)
        with pytest.raises((registry_mod.SwapRefused, jregistry.SwapRefused)) as shape:
            reg.swap("lin", conv(narrow))
        with pytest.raises(KeyError) as unknown:
            reg.swap("ghost", conv(live))
        assert reg.current_version("lin") == 1
        errors.append((str(shape.value), str(unknown.value)))
    assert errors[0] == errors[1]
    assert "n_features 4 != live 6" in errors[0][0]


def test_refusals_book_their_reasons():
    reg = registry_mod.ModelRegistry("cpu")
    reg.register("lin", _port(_jax_fit("linear", 0)), bucket_list=BUCKETS)
    s0 = REGISTRY.snapshot()
    with pytest.raises(registry_mod.SwapRefused):
        reg.swap("lin", _port(_jax_fit("linear", 1, n=4)))
    with pytest.raises(registry_mod.SwapRefused):
        reg.swap("lin", _port(_jax_fit("linear", 1, target_scale=-2.0)),
                 shadow_sample=_xy(16, 9)[0], tolerance=1e-3)
    d = REGISTRY.snapshot().delta(s0)
    assert d.counter("serve.swap_refused", model="lin", reason="shape") == 1
    assert d.counter("serve.swap_refused", model="lin", reason="shadow") == 1
    assert d.counter("serve.swaps") == 0
    summary = serve_summary(d)["fleet"]
    assert summary["swap_refused"] == 2 and summary["swaps"] == 0


# -- the fault sites -----------------------------------------------------------


def test_swap_io_plan_never_tears_the_slot(monkeypatch):
    old, new = _jax_fit("linear", 0), _jax_fit("linear", 1)
    x = _xy(5, 9)[0]
    outcomes = []
    for reg, conv, err in ((registry_mod.ModelRegistry("cpu"), _port, faults.FaultInjected),
                           (jregistry.ModelRegistry(), lambda m: m, jfaults.FaultInjected)):
        monkeypatch.delenv("TPU_ML_FAULT_PLAN", raising=False)
        reg.register("lin", conv(old), bucket_list=BUCKETS)
        before = reg.predict("lin", x)
        monkeypatch.setenv("TPU_ML_FAULT_PLAN", "serve.swap:io:1")
        with pytest.raises(err):
            reg.swap("lin", conv(new), tolerance=100.0)
        assert np.array_equal(reg.predict("lin", x), before)
        outcomes.append((reg.current_version("lin"), reg.prior_entry("lin")))
        # the retry passes the site's first occurrence and publishes
        outcomes.append(reg.swap("lin", conv(new), tolerance=100.0).version)
    assert outcomes == [(1, None), 2, (1, None), 2]


def test_swap_hang_plan_keeps_the_old_version_serving(monkeypatch):
    old, new = _port(_jax_fit("linear", 0)), _port(_jax_fit("linear", 1))
    reg = registry_mod.ModelRegistry("cpu")
    reg.register("lin", old, bucket_list=BUCKETS)
    x = _xy(5, 9)[0]
    before = reg.predict("lin", x)
    monkeypatch.setenv("TPU_ML_FAULT_PLAN", "serve.swap:hang:1:0.5")
    done = threading.Event()
    swapper = threading.Thread(
        target=lambda: (reg.swap("lin", new, tolerance=100.0), done.set())
    )
    swapper.start()
    answered = 0
    while not done.is_set():
        # every answer during the hang is the old version's, whole
        assert np.array_equal(reg.predict("lin", x), before)
        answered += 1
        done.wait(0.02)
    swapper.join()
    assert answered > 0 and reg.current_version("lin") == 2
    fresh = registry_mod.ModelRegistry("cpu")
    fresh.register("n", new, bucket_list=BUCKETS)
    assert np.array_equal(reg.predict("lin", x), fresh.predict("n", x))


def _batcher_outcomes(batcher, x, requests: int) -> list[str]:
    out = []
    for _ in range(requests):
        try:
            batcher.submit("lin", x).result(timeout=10)
            out.append("ok")
        except Exception as e:  # noqa: BLE001 - the outcome is the finding
            out.append(type(e).__name__)
    return out


def test_dispatch_io_plan_costs_one_request(monkeypatch):
    model = _jax_fit("linear", 0)
    x = _xy(3, 9)[0]
    # hedging off in both batchers: a hedge re-dispatch passes the
    # serve.dispatch site again, so a primary slowed by a loaded host would
    # shift which request meets occurrence 3 (the hedge has its own tests)
    monkeypatch.setenv("TPU_ML_HEDGE_FACTOR", "0")
    monkeypatch.setenv("TPU_ML_FAULT_PLAN", "serve.dispatch:io:3")
    results = []
    for reg, conv, mod in ((registry_mod.ModelRegistry("cpu"), _port, batcher_mod),
                           (jregistry.ModelRegistry(), lambda m: m, jbatcher)):
        reg.register("lin", conv(model), bucket_list=BUCKETS)
        b = mod.MicroBatcher(reg, max_delay_s=0.0).start()
        try:
            results.append(_batcher_outcomes(b, x, 5))
        finally:
            b.stop()
    assert results[0] == ["ok", "ok", "InjectedTransientIOError", "ok", "ok"]
    assert results[0] == results[1]


# -- hedged dispatch -------------------------------------------------------------


@pytest.fixture
def hedging(monkeypatch):
    monkeypatch.setenv("TPU_ML_HEDGE_FACTOR", "4")
    monkeypatch.setenv("TPU_ML_SERVE_HEDGE_FLOOR_US", "20000")
    model = _jax_fit("linear", 0)
    reg = registry_mod.ModelRegistry("cpu")
    reg.register("lin", _port(model), bucket_list=BUCKETS)
    b = batcher_mod.MicroBatcher(reg, max_delay_s=0.0).start()
    x = _xy(1, 9)[0]
    for _ in range(3):  # the EWMA the threshold scales (no hedge before it)
        b.submit("lin", x).result(timeout=10)
    yield reg, b, model, x
    b.stop()


def test_warm_hedge_count_matches_jax(hedging):
    reg, _, model, _ = hedging
    jreg = jregistry.ModelRegistry()
    jreg.register("lin", model, bucket_list=BUCKETS)
    # the test session has 8 virtual JAX devices: a second device exists
    assert reg.warm_hedge("lin") == jreg.warm_hedge("lin") == len(BUCKETS)
    assert reg.warm_hedge("lin", bucket_list=(8, 64)) == jreg.warm_hedge(
        "lin", bucket_list=(8, 64)) == 1


def test_hedge_answers_a_primary_stalled_on_its_rung_lock(hedging):
    reg, b, _, x = hedging
    reg.warm_hedge("lin")
    entry = reg.get("lin")
    expected = reg.predict("lin", x)
    s0 = REGISTRY.snapshot()
    with entry.dispatch_lock(8):
        # the primary waits on this lock for as long as the test holds it
        out = b.submit("lin", x).result(timeout=10)
    assert np.array_equal(out, expected)
    d = REGISTRY.snapshot().delta(s0)
    assert d.counter("serve.hedges", model="lin") == 1
    assert d.counter("serve.hedge_wins", model="lin", winner="hedge") == 1
    summary = serve_summary(d)
    assert summary["hedges"] == 1 and summary["hedge_wins"] == {"hedge": 1}


def test_a_same_rung_hedge_waits_on_the_stalled_primary(hedging, monkeypatch):
    reg, b, _, x = hedging
    reg.warm_hedge("lin")
    monkeypatch.setattr(reg, "hedge_dispatch_padded", reg.dispatch_padded)
    lock = reg.get("lin").dispatch_lock(8)
    with lock:
        future = b.submit("lin", x)
        with pytest.raises(TimeoutError):
            future.result(timeout=1.0)
    future.result(timeout=10)


def test_no_hedge_without_a_warm_hedge_rung(hedging):
    reg, b, _, x = hedging
    s0 = REGISTRY.snapshot()
    entry = reg.get("lin")
    with pytest.raises(RuntimeError, match="no warm hedge rung"):
        reg.hedge_dispatch_padded(entry, np.zeros((8, N), np.float32), 8)
    b.submit("lin", x).result(timeout=10)
    assert REGISTRY.snapshot().delta(s0).counter("serve.hedges") == 0


@pytest.mark.parametrize("raw", ["", "500", "0", "-3", "bad"])
def test_serve_hedge_floor_matches_jax(monkeypatch, raw):
    monkeypatch.setenv("TPU_ML_SERVE_HEDGE_FLOOR_US", raw)
    assert batcher_mod.serve_hedge_floor_s() == jbatcher.serve_hedge_floor_s()


def test_the_swap_books_the_jax_series():
    reg = registry_mod.ModelRegistry("cpu")
    reg.register("lin", _port(_jax_fit("linear", 0)), bucket_list=BUCKETS)
    s0, j0 = REGISTRY.snapshot(), JREGISTRY.snapshot()
    reg.swap("lin", _port(_jax_fit("linear", 1)), tolerance=100.0)
    reg.rollback("lin")
    d = REGISTRY.snapshot().delta(s0)
    assert d.counter("serve.swaps", model="lin") == 1
    assert d.counter("serve.rollback", model="lin") == 1
    assert d.hist("serve.swap_blackout_seconds").count == 1
    assert d.gauges[("serve.model_version", (("model", "lin"),))] == 1
    # the port books nothing in the JAX package's registry
    assert JREGISTRY.snapshot().delta(j0).counter("serve.swaps") == 0
