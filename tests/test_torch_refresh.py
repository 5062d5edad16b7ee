"""The port's refresh daemon against the JAX package's, on the CPU.

The same seeded batches go through a JAX ``RefreshDaemon`` (over a JAX
registry) and the port's (over a registry with device="cpu"), verb for
verb. Tolerances:

- the status sequences (``registered``, ``waiting``, ``swapped``,
  ``probation``, ``rolled_back``, ``promoted``, ``refused``) and the
  versions they name: equal;
- the finalized candidates: IncrementalLinearRegression's coefficients
  within 1e-5 × max |coefficient| (f32 carry against the JAX package's f64
  here), IncrementalPCA's components min |cosine| ≥ 0.9999;
- IncrementalKMeans, fed f64 rows (the JAX estimator refuses f32 rows with
  x64 on; ROADMAP Queue C), folded, checkpointed and resumed in both:
  centres within 1e-5 × the data's scale;
- a resumed daemon's candidate against an uninterrupted one: bit for bit.
"""

from __future__ import annotations

import os

import jax  # noqa: F401  (imported at the top of every port test file)
import numpy as np
import pytest

from spark_rapids_ml_tpu.models import incremental as JI
from spark_rapids_ml_tpu.refresh import RefreshDaemon as JaxRefreshDaemon
from spark_rapids_ml_tpu.serving import registry as jregistry
from spark_rapids_ml_tpu.telemetry.registry import REGISTRY as JREGISTRY
from spark_rapids_ml_tpu_torch.models import incremental as TI
from spark_rapids_ml_tpu_torch.refresh import RefreshDaemon
from spark_rapids_ml_tpu_torch.resilience import faults
from spark_rapids_ml_tpu_torch.serving import registry as registry_mod
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY

N = 6
COEF_RTOL = 1e-5
COSINE_BAR = 0.9999
KMEANS_ATOL = 1e-5 * 3.0
IMPOSSIBLE_SLO = "serve.latency:p99:0.001"


@pytest.fixture(autouse=True)
def serve_env(monkeypatch):
    monkeypatch.setenv("TPU_ML_SERVE_MIN_BUCKET", "8")
    monkeypatch.setenv("TPU_ML_SERVE_MAX_BATCH_ROWS", "64")
    monkeypatch.delenv("TPU_ML_FAULT_PLAN", raising=False)
    faults.reset_faults()
    yield
    faults.reset_faults()
    registry_mod.reset_for_tests()
    jregistry.reset_for_tests()


def _xy(rows: int, seed: int, target_scale: float = 1.0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, N)) * np.linspace(3.0, 0.5, N)).astype(np.float32)
    return x, (target_scale * (x @ np.arange(1.0, N + 1.0)) + 0.5).astype(np.float32)


ESTIMATORS = {
    "linear": (lambda: TI.IncrementalLinearRegression(device="cpu"),
               lambda: JI.IncrementalLinearRegression(), True),
    "pca": (lambda: TI.IncrementalPCA(device="cpu", k=3), lambda: JI.IncrementalPCA(k=3), False),
}


def _batch(family: str, rows: int, seed: int, target_scale: float = 1.0):
    x, y = _xy(rows, seed, target_scale)
    return (x, y) if ESTIMATORS[family][2] else x


def _scenario(daemon, family: str, book_latency) -> list[tuple]:
    """register → wait → swap → probation → burn, rolled back → swap →
    promoted → refused, each step's status and version."""
    out = []

    def step(res):
        out.append((res["status"], res.get("version")))

    daemon.fold(_batch(family, 64, 0))
    step(daemon.try_swap())
    daemon.fold(_batch(family, 8, 1))
    step(daemon.try_swap())                 # 8 rows < min_rows
    daemon.fold(_batch(family, 64, 2))
    step(daemon.try_swap())
    step(daemon.probation_check())          # no traffic yet: no verdict
    for _ in range(8):
        book_latency()
    step(daemon.probation_check())          # the burn rolls back
    daemon.probation_s = 0.0
    daemon.fold(_batch(family, 64, 3))
    step(daemon.try_swap())
    step(daemon.try_swap())                 # in probation: the check promotes
    daemon.tolerance = 1e-9
    daemon.fold(_batch(family, 64, 4))
    step(daemon.try_swap())
    return out


def _daemons(family: str, tmp_path):
    make_port, make_jax, _ = ESTIMATORS[family]
    kw = dict(min_rows=32, shadow_rows=16, tolerance=100.0, probation_s=3600.0,
              probation_burn=1, probation_slo=IMPOSSIBLE_SLO)
    port = RefreshDaemon("m", make_port(), registry=registry_mod.ModelRegistry("cpu"),
                         checkpoint_dir=str(tmp_path / "port"), **kw)
    ref = JaxRefreshDaemon("m", make_jax(), registry=jregistry.ModelRegistry(),
                           checkpoint_dir=str(tmp_path / "jax"), **kw)
    return port, ref


@pytest.mark.parametrize("family", ["linear", "pca"])
def test_status_sequence_and_candidates_match_jax(family, tmp_path):
    port, ref = _daemons(family, tmp_path)
    got = _scenario(port, family,
                    lambda: REGISTRY.histogram_record("serve.latency", 0.5, model="m"))
    want = _scenario(ref, family,
                     lambda: JREGISTRY.histogram_record("serve.latency", 0.5, model="m"))
    assert got == want
    assert [s for s, _ in got] == ["registered", "waiting", "swapped", "probation",
                                   "rolled_back", "swapped", "promoted", "refused"]
    assert port.registry.current_version("m") == ref.registry.current_version("m") == 2
    a, b = port.estimator.finalize(), ref.estimator.finalize()
    if family == "linear":
        ca, cb = np.asarray(a.coefficients), np.asarray(b.coefficients)
        assert np.abs(ca - cb).max() <= COEF_RTOL * np.abs(cb).max()
        assert abs(a.intercept - b.intercept) <= COEF_RTOL * np.abs(cb).max()
    else:
        pa, pb = np.asarray(a.pc, np.float64), np.asarray(b.pc, np.float64)
        cos = np.abs((pa * pb).sum(0)) / (np.linalg.norm(pa, axis=0) * np.linalg.norm(pb, axis=0))
        assert cos.min() >= COSINE_BAR


def test_the_cycle_books_the_jax_series(tmp_path):
    s0 = REGISTRY.snapshot()
    d = RefreshDaemon("lr", TI.IncrementalLinearRegression(device="cpu"), device="cpu",
                      checkpoint_dir=str(tmp_path), min_rows=32, shadow_rows=16,
                      tolerance=100.0, probation_s=0.0, probation_slo="serve.latency:p99:10")
    d.fold(_xy(64, 0))
    d.checkpoint()
    assert d.try_swap() == {"status": "registered", "version": 1}
    d.fold(_xy(64, 1))
    d.checkpoint()
    res = d.try_swap()
    assert res["status"] == "swapped" and res["version"] == 2 and res["refresh_lag_s"] >= 0
    assert d.probation_check() == {"status": "promoted", "version": 2}
    assert d.registry is registry_mod.get_registry("cpu")
    assert d.registry.prior_entry("lr") is None
    dlt = REGISTRY.snapshot().delta(s0)
    for name, value in (("refresh.folds", 2), ("refresh.rows", 128), ("refresh.checkpoints", 2),
                        ("refresh.finalizes", 2), ("serve.swaps", 1)):
        assert dlt.counter(name) == value, name


def test_fault_plans_leave_the_fold_and_the_checkpoint_retryable(tmp_path, monkeypatch):
    d = RefreshDaemon("lr", TI.IncrementalLinearRegression(device="cpu"),
                      registry=registry_mod.ModelRegistry("cpu"),
                      checkpoint_dir=str(tmp_path), shadow_rows=0)
    monkeypatch.setenv("TPU_ML_FAULT_PLAN", "refresh.fold:io:1,refresh.checkpoint:io:1")
    with pytest.raises(faults.FaultInjected):
        d.fold(_xy(32, 0))
    assert d.rows_pending == 0 and d.estimator.n_rows_seen == 0
    d.fold(_xy(32, 0))
    with pytest.raises(faults.FaultInjected):
        d.checkpoint()
    assert d.checkpointer.latest() is None
    assert d.checkpoint() == 1
    assert d.checkpointer.latest()[2]["rows_pending"] == 32


# -- resume ----------------------------------------------------------------------


def _model_arrays(model) -> list[np.ndarray]:
    out = [np.asarray(getattr(model, a)) for a in
           ("pc", "explainedVariance", "coefficients", "clusterCenters")
           if getattr(model, a, None) is not None]
    if hasattr(model, "intercept"):
        out.append(np.asarray(model.intercept))
    assert out
    return out


PORT_ESTIMATORS = {
    "linear": (lambda: TI.IncrementalLinearRegression(device="cpu"), True),
    "pca": (lambda: TI.IncrementalPCA(device="cpu", k=3), False),
    "kmeans": (lambda: TI.IncrementalKMeans(device="cpu", k=3, initMode="random",
                                            seedRows=16), False),
}


@pytest.mark.parametrize("family", sorted(PORT_ESTIMATORS))
def test_resume_finalizes_bitwise(family, tmp_path):
    make, labeled = PORT_ESTIMATORS[family]

    def batch(rows, seed):
        x, y = _xy(rows, seed)
        return (x, y) if labeled else x

    kw = dict(registry=registry_mod.ModelRegistry("cpu"), checkpoint_dir=str(tmp_path),
              min_rows=1, shadow_rows=8)
    d1 = RefreshDaemon("m", make(), **kw)
    d1.fold(batch(64, 0))
    d1.checkpoint()
    # the daemon dies here; the continuation it never made
    oracle = make().partial_fit(batch(64, 0)).partial_fit(batch(32, 1))
    d2 = RefreshDaemon("m", make(), **kw)
    assert d2.resume() is True
    assert d2.rows_pending == 64 and len(d2._shadow) == 8
    d2.fold(batch(32, 1))
    for a, b in zip(_model_arrays(d2.estimator.finalize()), _model_arrays(oracle.finalize())):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_a_corrupt_checkpoint_is_skipped(tmp_path):
    kw = dict(registry=registry_mod.ModelRegistry("cpu"), checkpoint_dir=str(tmp_path),
              min_rows=1, shadow_rows=0, keep=3)
    d1 = RefreshDaemon("lr", TI.IncrementalLinearRegression(device="cpu"), **kw)
    d1.fold(_xy(40, 0))
    assert d1.checkpoint() == 1
    d1.fold(_xy(24, 1))
    assert d1.checkpoint() == 2
    newest = os.path.join(str(tmp_path), sorted(os.listdir(tmp_path))[-1])
    for name in os.listdir(newest):
        with open(os.path.join(newest, name), "wb") as f:
            f.write(b"truncated")
    d2 = RefreshDaemon("lr", TI.IncrementalLinearRegression(device="cpu"), **kw)
    assert d2.resume() is True
    assert d2.rows_pending == 40 and d2.estimator.n_rows_seen == 40
    empty = RefreshDaemon("lr", TI.IncrementalLinearRegression(device="cpu"),
                          registry=kw["registry"], checkpoint_dir=str(tmp_path / "none"))
    assert empty.resume() is False


def test_kmeans_daemons_fold_checkpoint_and_resume_as_jax(tmp_path):
    """IncrementalKMeans has no serve contract, so its daemons fold,
    checkpoint and resume; both are fed the same f64 rows."""
    rng = np.random.default_rng(5)
    rows = [rng.normal(size=(m, N)) * 3.0 for m in (40, 30, 50)]
    kw = dict(k=3, initMode="random", seed=2, seedRows=16)
    out = []
    for daemon_cls, make, reg, sub in (
        (RefreshDaemon, lambda: TI.IncrementalKMeans(device="cpu", **kw),
         registry_mod.ModelRegistry("cpu"), "port"),
        (JaxRefreshDaemon, lambda: JI.IncrementalKMeans(**kw), jregistry.ModelRegistry(), "jax"),
    ):
        args = dict(registry=reg, checkpoint_dir=str(tmp_path / sub), shadow_rows=0)
        d1 = daemon_cls("km", make(), **args)
        d1.fold(rows[0]).fold(rows[1])
        d1.checkpoint()
        d2 = daemon_cls("km", make(), **args)
        assert d2.resume() and d2.rows_pending == 70
        d2.fold(rows[2])
        out.append(np.asarray(d2.estimator.finalize().clusterCenters, np.float64))
    np.testing.assert_allclose(out[0], out[1], rtol=0, atol=KMEANS_ATOL)


def test_feed_and_run_once_drive_the_same_verbs(tmp_path):
    d = RefreshDaemon("lr", TI.IncrementalLinearRegression(device="cpu"),
                      registry=registry_mod.ModelRegistry("cpu"), checkpoint_dir=str(tmp_path),
                      min_rows=1, shadow_rows=0, tolerance=100.0, probation_s=0.0,
                      probation_slo="serve.latency:p99:10")
    d.feed(_xy(32, 0))
    d.feed(_xy(32, 1))
    assert d.run_once() == {"status": "registered", "version": 1}
    assert d.rows_pending == 0 and d.checkpointer.latest()[2]["rows_pending"] == 64
    d.feed(_xy(32, 2))
    assert d.run_once()["status"] == "swapped"
    assert d.run_once()["status"] == "promoted"
    d.start(interval_s=0.01)
    d.feed(_xy(32, 3))
    try:
        for _ in range(500):
            if d.registry.current_version("lr") == 3:
                break
            d._stop.wait(0.01)
    finally:
        d.stop()
    assert d.registry.current_version("lr") == 3
