"""The port's tuner (``autotune/search.py``) against the JAX package's.

``successive_halving`` and ``candidate_grid`` are held to the JAX functions
on injected timings; ``resolve`` runs under each mode and its journal is
drained into ``FitReport.tuning``; a streamed CPU fit under ``search`` is
held bit for bit to the same fit with the winner's chunk rows as a static
knob. Each test starts and ends with empty tuning caches in both packages,
so no winner leaks into another test's streamed fit.
"""

import jax  # noqa: F401  (imported at the top of every port test file)
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.autotune import cache as jax_cache
from spark_rapids_ml_tpu.autotune import search as jax_search
from spark_rapids_ml_tpu_torch import PCA, autotune
from spark_rapids_ml_tpu_torch.autotune import cache
from spark_rapids_ml_tpu_torch.autotune.policy import TuningConfig
from spark_rapids_ml_tpu_torch.ops import linalg as L
from spark_rapids_ml_tpu_torch.resilience import faults
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY

CPU = torch.device("cpu")
ROWS, N, K, CHUNK = 1500, 16, 4, 128


@pytest.fixture(autouse=True)
def _fresh_caches(monkeypatch):
    monkeypatch.delenv("TPU_ML_TUNING_CACHE_PATH", raising=False)
    monkeypatch.delenv("TPU_ML_AUTOTUNE_TRIALS", raising=False)
    cache.reset()
    jax_cache.reset()
    yield
    cache.reset()
    jax_cache.reset()
    faults.reset_faults()


@pytest.fixture(scope="module")
def x():
    rng = np.random.default_rng(9)
    return (rng.normal(size=(ROWS, 6)) @ rng.normal(size=(6, N))
            + 0.1 * rng.normal(size=(ROWS, N))).astype(np.float32)


@pytest.fixture
def streamed(monkeypatch):
    monkeypatch.setenv("TPU_ML_STREAM_FIT_MAX_RESIDENT_BYTES", "1")
    monkeypatch.setenv("TPU_ML_STREAM_CHUNK_ROWS", str(CHUNK))


# seconds by (candidate index, trial number of that candidate); None raises
TIMINGS = {
    "fastest first": lambda i, t: 1.0 + i,
    "fastest last": lambda i, t: 10.0 - i,
    "noisy": lambda i, t: [3.0, 1.0, 2.5, 2.0, 4.0, 1.5][i] + 0.7 * t * (-1) ** i,
    "ties": lambda i, t: 1.0,
    "a raising trial": lambda i, t: None if i == 1 else 5.0 - i,
    "all raise": lambda i, t: None,
}


def _run(search_mod, candidates, timing, budget):
    seen = {}

    def measure(config):
        i = [c.to_dict() for c in candidates].index(config.to_dict())
        t = seen[i] = seen.get(i, -1) + 1
        value = timing(i, t)
        if value is None:
            raise RuntimeError("trial died")
        return value

    winner, trials = search_mod.successive_halving(candidates, measure, budget=budget)
    return (None if winner is None else winner.to_dict()), trials


@pytest.mark.parametrize("budget", [1, 3, 9, 20])
@pytest.mark.parametrize("timing", list(TIMINGS))
def test_successive_halving_is_the_jax_functions(timing, budget):
    for layouts in (("row",), ("row", "col")):
        port = autotune.candidate_grid(4096, layouts=layouts)
        ref = jax_search.candidate_grid(4096, layouts=layouts)
        assert _run(autotune.search, port, TIMINGS[timing], budget) == _run(
            jax_search, ref, TIMINGS[timing], budget)


@pytest.mark.parametrize("base,floor", [(65_536, 8), (4096, 8), (9, 8), (3, 8), (1, 1), (100, 64)])
def test_candidate_grid_has_the_jax_chunk_sizes(base, floor):
    port = [c.chunk_rows for c in autotune.candidate_grid(base, floor=floor)]
    ref = [c.chunk_rows for c in jax_search.candidate_grid(base, floor=floor, layouts=("row",))]
    assert port == ref
    # the port searches row-major staging only (its kernels read rows)
    assert {c.layout for c in autotune.candidate_grid(base, floor=floor)} == {"row"}


def test_mode_and_budget_read_the_environment(monkeypatch):
    monkeypatch.delenv("TPU_ML_AUTOTUNE", raising=False)
    assert autotune.mode() == jax_search.mode() == "cache"
    for value in ("off", "search", "bogus"):
        monkeypatch.setenv("TPU_ML_AUTOTUNE", value)
        assert autotune.mode() == jax_search.mode()
    for value in ("3", "0", "x"):
        monkeypatch.setenv("TPU_ML_AUTOTUNE_TRIALS", value)
        assert autotune.trial_budget() == jax_search.trial_budget()


def test_a_faulted_trial_drops_its_candidate(monkeypatch):
    monkeypatch.setenv("TPU_ML_FAULT_PLAN", "autotune.trial:io:2")
    faults.reset_faults()
    s0 = REGISTRY.snapshot()
    timings = {32: 3.0, 64: 1.0, 128: 2.0}
    winner, trials = autotune.successive_halving(
        autotune.candidate_grid(64), lambda c: timings[c.chunk_rows], budget=9)
    d = REGISTRY.snapshot().delta(s0)
    # the 64-row candidate's trial was the faulted one: 128 wins
    assert winner.chunk_rows == 128 and d.counter("autotune.trial_failures") == 1
    assert d.counter("autotune.trials") == trials


@pytest.mark.parametrize("mode", ["off", "cache", "search"])
def test_resolve_under_each_mode(monkeypatch, mode):
    monkeypatch.setenv("TPU_ML_AUTOTUNE", mode)
    grid = autotune.candidate_grid(64)
    seq = cache.decision_seq()
    got = autotune.resolve("k", n=8, rows=100, dtype="float32", device="cpu/cpu",
                           measure=lambda c: 1.0 / c.chunk_rows, candidates=grid)
    decisions = cache.decisions_since(seq)
    if mode == "off":
        assert got is None and decisions == []
        return
    want = {"cache": None, "search": grid[-1]}[mode]
    assert got == want
    assert [d["source"] for d in decisions] == ["default" if mode == "cache" else "search"]
    assert decisions[0]["key"] == "k|n8/rows128|float32|cpu/cpu"
    again = autotune.resolve("k", n=8, rows=120, dtype="float32", device="cpu/cpu")
    assert again == want  # a hit in the same shape bucket after a search
    assert cache.decisions_since(seq)[-1]["source"] == ("cache" if want else "default")


def test_the_journal_is_bounded_and_drains_after_its_watermark():
    first = cache.record_decision(kernel="a", key="ka", source="default", config=None)
    seq = cache.decision_seq()
    cache.record_decision(kernel="b", key="kb", source="cache",
                          config=TuningConfig(chunk_rows=64))
    assert first == {"kernel": "a", "key": "ka", "source": "default", "cache_hit": False,
                     "config": None}
    assert [d["kernel"] for d in cache.decisions_since(seq)] == ["b"]
    assert cache.decisions_since(seq)[0]["cache_hit"]
    for i in range(cache.MAX_JOURNAL_EVENTS + 5):
        cache.record_decision(kernel=str(i), key="k", source="default", config=None)
    assert len(cache.decisions_since(0)) == cache.MAX_JOURNAL_EVENTS


@pytest.mark.parametrize("mode", ["off", "cache", "search"])
def test_streamed_fit_reports_its_tuning(x, streamed, monkeypatch, mode):
    monkeypatch.setenv("TPU_ML_AUTOTUNE", mode)
    model = PCA(device=CPU).setK(K).fit(x)
    tuning = model.fit_report.tuning
    if mode == "off":
        assert tuning == {}
        return
    assert tuning["source"] == ("default" if mode == "cache" else "search")
    assert tuning["decisions"][-1]["kernel"] == "stream.fold_step"
    assert tuning["decisions"][-1]["key"] == f"stream.fold_step|n{N}/rowsANY|float32|cpu/cpu"
    if mode == "search":
        again = PCA(device=CPU).setK(K).fit(x)
        assert again.fit_report.tuning["source"] == "cache"
        assert again.fit_report.tuning["cache_hit"]
        assert again.fit_report.tuning["config"] == tuning["config"]
        assert np.array_equal(again.pc, model.pc)
    # a resident fit resolves nothing
    monkeypatch.setenv("TPU_ML_STREAM_FIT_MAX_RESIDENT_BYTES", str(1 << 40))
    assert PCA(device=CPU).setK(K).fit(x).fit_report.tuning == {}


def test_searched_fit_is_the_fit_at_the_winners_static_chunk(x, streamed, monkeypatch, tmp_path):
    path = tmp_path / "tuning.json"
    monkeypatch.setenv("TPU_ML_TUNING_CACHE_PATH", str(path))
    monkeypatch.setenv("TPU_ML_AUTOTUNE", "search")
    s0 = REGISTRY.snapshot()
    searched = PCA(device=CPU).setK(K).fit(x)
    d = REGISTRY.snapshot().delta(s0)
    winner = searched.fit_report.tuning["config"]["chunk_rows"]
    assert winner in (64, 128, 256) and path.exists()
    assert 1 <= d.counter("autotune.trials") <= autotune.trial_budget()
    assert searched.stream_report.chunks == -(-ROWS // winner)
    monkeypatch.setenv("TPU_ML_AUTOTUNE", "off")
    monkeypatch.setenv("TPU_ML_STREAM_CHUNK_ROWS", str(winner))
    static = PCA(device=CPU).setK(K).fit(x)
    assert static.stream_report.chunks == searched.stream_report.chunks
    assert np.array_equal(static.pc, searched.pc)
    assert np.array_equal(static.explainedVariance, searched.explainedVariance)
    # the file serves a later process: a fresh in-process tier reads it
    cache.reset()
    monkeypatch.setenv("TPU_ML_AUTOTUNE", "cache")
    monkeypatch.setenv("TPU_ML_STREAM_CHUNK_ROWS", str(CHUNK))
    hit = PCA(device=CPU).setK(K).fit(x)
    assert hit.fit_report.tuning["source"] == "cache"
    assert hit.stream_report.chunks == searched.stream_report.chunks


def test_stream_fold_measure_never_touches_the_carry():
    carry = L.init_gram_carry(N, CPU)
    carry.xtx.fill_(7.0)
    measure = autotune.stream_fold_measure(L.gram_fold_step("highest"), carry, N, CPU, reps=2)
    for rows in (32, 64):
        seconds = measure(TuningConfig(chunk_rows=rows))
        assert seconds > 0
    assert torch.all(carry.xtx == 7.0) and torch.all(carry.count == 0)
