"""The port's streamed fold under fault plans, against the JAX fold under the
same plans.

The same f32 partitions (1,100 × 12 in four uneven parts, 128-row chunks)
go through ``spark_rapids_ml_tpu.spark.ingest.stream_fold`` with the JAX
fold step and through the port's ``stream_fold`` with its own, on the CPU,
under one ``TPU_ML_FAULT_PLAN``. Held equal: the counters both book
(``fault.injected``, ``retry.attempts``, ``chunk.bisections``,
``stream.checkpoints``, ``stream.resumes``), the chunk counts, and the
resume and bisection flags. The port's carry under a retried or resumed
plan is bit-equal to its clean fold (the same chunks in the same order);
under a bisection it is within f32 rounding of it (other chunk sums:
1e-5·max|G|), and the count is exact.
"""

import jax.numpy as jnp  # noqa: F401  (the JAX fold runs below)
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.ops import linalg as JL
from spark_rapids_ml_tpu.resilience import faults as JF
from spark_rapids_ml_tpu.spark import ingest as JI
from spark_rapids_ml_tpu.telemetry.registry import REGISTRY as JREG
from spark_rapids_ml_tpu.utils.checkpoint import TrainingCheckpointer as JCkpt
from spark_rapids_ml_tpu_torch.ops import linalg as TL
from spark_rapids_ml_tpu_torch.resilience import faults as PF
from spark_rapids_ml_tpu_torch.resilience import retry as PR
from spark_rapids_ml_tpu_torch.spark import ingest as TI
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY as PREG
from spark_rapids_ml_tpu_torch.utils.checkpoint import TrainingCheckpointer

pytestmark = pytest.mark.chaos

CPU = torch.device("cpu")
ROWS, N, CHUNK = 1100, 12, 128
COUNTERS = ("fault.injected", "retry.attempts", "chunk.bisections", "stream.checkpoints",
            "stream.resumes")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("TPU_ML_AUTOTUNE", "off")
    monkeypatch.delenv("TPU_ML_FAULT_PLAN", raising=False)
    JF.reset_faults()
    PF.reset_faults()
    yield
    JF.reset_faults()
    PF.reset_faults()


@pytest.fixture(scope="module")
def parts():
    rng = np.random.default_rng(31)
    x = rng.normal(size=(ROWS, N)).astype(np.float32)
    return np.split(x, [100, 550, 900])


def _port(parts, **kw):
    return TI.stream_fold(iter(parts), TL.gram_fold_step("highest"), n=N,
                          init=TL.init_gram_carry(N, CPU), device=CPU, chunk_rows=CHUNK, **kw)


def _jax(parts, **kw):
    return JI.stream_fold(iter(parts), JL.gram_fold_step(), n=N,
                          init=JL.init_gram_carry(N, np.float32), rows=ROWS,
                          chunk_rows=CHUNK, **kw)


def _both(monkeypatch, parts, plan, port_kw=None, jax_kw=None):
    """(port result or exception, JAX result or exception, port counters,
    JAX counters) under ``plan``."""
    out = []
    for run, reg, faults, kw in ((_port, PREG, PF, port_kw), (_jax, JREG, JF, jax_kw)):
        faults.reset_faults()
        if plan:
            monkeypatch.setenv("TPU_ML_FAULT_PLAN", plan)
        s0 = reg.snapshot()
        try:
            res = run(parts, **(kw or {}))
        except Exception as e:  # noqa: BLE001 - compared below
            res = e
        monkeypatch.delenv("TPU_ML_FAULT_PLAN", raising=False)
        d = reg.snapshot().delta(s0)
        out.append((res, {c: d.counter(c) for c in COUNTERS}))
    (p, pc), (j, jc) = out
    return p, j, pc, jc


def _equal(a, b):
    for x, y in zip(a.carry, b.carry):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.fixture(scope="module")
def clean(parts):
    return _port(parts)


@pytest.mark.parametrize("plan", [
    "ingest.chunk:io:2", "fold.dispatch:io:4", "ingest.chunk:io:1,fold.dispatch:io:3",
    "fold.dispatch:io:2,fold.dispatch:io:3",
])
def test_transient_faults_retry_bit_equal_with_jax_counters(monkeypatch, parts, clean, plan):
    p, j, pc, jc = _both(monkeypatch, parts, plan)
    assert pc == jc and pc["retry.attempts"] == len(plan.split(","))
    assert p.chunks == j.chunks == clean.chunks and not p.bisections
    _equal(p, clean)


@pytest.mark.parametrize("plan", ["fold.dispatch:oom:3", "fold.dispatch:oom:1,fold.dispatch:oom:2"])
def test_oom_bisects_like_jax(monkeypatch, parts, clean, plan):
    p, j, pc, jc = _both(monkeypatch, parts, plan)
    assert pc == jc and p.bisections == j.bisections == pc["chunk.bisections"] >= 1
    # every chunk after the first split is at most half the size
    assert p.chunks == j.chunks and p.chunks > clean.chunks
    assert float(p.carry.count) == ROWS
    scale = float(clean.carry.xtx.abs().max())
    torch.testing.assert_close(p.carry.xtx, clean.carry.xtx, rtol=0, atol=1e-5 * scale)
    torch.testing.assert_close(p.carry.col_sum, clean.carry.col_sum, rtol=1e-5, atol=1e-5)


def test_bisection_stops_at_the_floor_like_jax(monkeypatch, parts):
    plan = ",".join(f"fold.dispatch:oom:{i}" for i in range(1, 40))
    p, j, pc, jc = _both(monkeypatch, parts, plan, {"min_chunk_rows": 64}, {"min_chunk_rows": 64})
    assert isinstance(p, PF.InjectedResourceExhausted)
    assert isinstance(j, JF.InjectedResourceExhausted)
    assert pc == jc


def test_preempted_fold_resumes_bit_equal_with_jax_counters(monkeypatch, parts, clean, tmp_path):
    kw_p = {"checkpointer": TrainingCheckpointer(tmp_path / "p"), "checkpoint_every": 2}
    kw_j = {"checkpointer": JCkpt(tmp_path / "j"), "checkpoint_every": 2}
    p, j, pc, jc = _both(monkeypatch, parts, "fold.dispatch:preempt:6", kw_p, kw_j)
    assert isinstance(p, PF.InjectedPreemption) and isinstance(j, JF.InjectedPreemption)
    assert pc == jc and pc["stream.checkpoints"] == 2
    p, j, pc, jc = _both(monkeypatch, parts, "", kw_p, kw_j)
    assert p.resumed and j.resumed and pc == jc and pc["stream.resumes"] == 1
    assert p.chunks == j.chunks == clean.chunks and p.rows == ROWS
    _equal(p, clean)


def test_resume_after_a_bisection_keeps_the_smaller_chunks(monkeypatch, parts, clean, tmp_path):
    kw = {"checkpointer": TrainingCheckpointer(tmp_path / "c"), "checkpoint_every": 2}
    monkeypatch.setenv("TPU_ML_FAULT_PLAN", "fold.dispatch:oom:2,fold.dispatch:preempt:7")
    with pytest.raises(PF.InjectedPreemption):
        _port(parts, **kw)
    monkeypatch.delenv("TPU_ML_FAULT_PLAN")
    res = _port(parts, **kw)
    assert res.resumed and float(res.carry.count) == ROWS
    PF.reset_faults()
    monkeypatch.setenv("TPU_ML_FAULT_PLAN", "fold.dispatch:oom:2")
    uninterrupted = _port(parts)
    assert res.chunks == uninterrupted.chunks
    _equal(res, uninterrupted)


def test_resume_with_skipped_rows_keeps_the_rows_after_the_cursor(monkeypatch, parts, tmp_path):
    """A bad row after the checkpoint's cursor, in the same source item, is
    not counted as consumed: the resumed fold folds every good row once."""
    bad = [p.copy() for p in parts]
    bad[1][300, 4] = np.nan  # in the second item, after the cursor of chunk 2
    kw = {"checkpointer": TrainingCheckpointer(tmp_path / "s"), "checkpoint_every": 2,
          "nonfinite": "skip"}
    monkeypatch.setenv("TPU_ML_FAULT_PLAN", "fold.dispatch:preempt:4")
    with pytest.raises(PF.InjectedPreemption):
        _port(bad, **kw)
    monkeypatch.delenv("TPU_ML_FAULT_PLAN")
    res = _port(bad, **kw)
    clean = _port(bad, nonfinite="skip")
    assert res.rows == clean.rows == ROWS - 1 and res.skipped_rows == clean.skipped_rows == 1
    _equal(res, clean)
    # the JAX fold's cursor counts the whole item's skipped rows, the one
    # after the cursor too, so its resume drops one good row (ROADMAP Queue C)
    jkw = {"checkpointer": JCkpt(tmp_path / "j"), "checkpoint_every": 2, "nonfinite": "skip"}
    monkeypatch.setenv("TPU_ML_FAULT_PLAN", "fold.dispatch:preempt:4")
    with pytest.raises(JF.InjectedPreemption):
        _jax(bad, **jkw)
    monkeypatch.delenv("TPU_ML_FAULT_PLAN")
    assert _jax(bad, **jkw).rows == ROWS - 2


@pytest.mark.parametrize("plan,timeout,hangs", [
    ("fold.wait:hang:1:0.1", 30.0, False), ("fold.wait:hang:1:3.0", 0.3, True),
    ("fold.wait:io:1", 0.0, False),
])
def test_bounded_wait_like_jax(monkeypatch, parts, clean, plan, timeout, hangs):
    kw = {"fold_wait_timeout_s": timeout}
    p, j, pc, jc = _both(monkeypatch, parts, plan, kw, kw)
    assert pc == jc
    if hangs:
        assert isinstance(p, PR.FoldHangTimeout) and "hung, not slow" in str(p)
        assert type(j).__name__ == "FoldHangTimeout"
        assert PR.classify(p) is PR.ErrorClass.POISONED
    elif "io" in plan:
        assert isinstance(p, PF.InjectedTransientIOError)
        assert isinstance(j, JF.InjectedTransientIOError)
    else:
        _equal(p, clean)


def test_heartbeat_and_counters(monkeypatch, parts, capsys):
    monkeypatch.setenv("TPU_ML_PROGRESS", "1e-9")
    s0 = PREG.snapshot()
    res = _port(parts)
    d = PREG.snapshot().delta(s0)
    err = capsys.readouterr().err
    assert err.count("[tpu-ml progress") == ROWS // CHUNK
    assert f"chunks={ROWS // CHUNK} chunk_rows={CHUNK} retries=0 bisections=0" in err
    assert d.counter("ingest.rows") == ROWS and d.counter("ingest.bytes") == ROWS * N * 4
    assert d.hist("ingest.chunk_rows").count == len(parts) and res.chunks == -(-ROWS // CHUNK)
    monkeypatch.setenv("TPU_ML_PROGRESS", "soon")
    with pytest.raises(ValueError, match="must be a number of seconds"):
        _port(parts)
