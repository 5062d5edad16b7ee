"""The port's TrainingCheckpointer and KMeans checkpoint/resume, against the
JAX package's.

A checkpoint directory written by either package must read in the other
(the arrays bit for bit, the state equal), and a KMeans fit interrupted and
resumed in the port must end at exactly the centres of an uninterrupted
port fit (the f32 sums are a product, the same bits on every run). A JAX
checkpoint resumes in the port: it skips the done iterations and ends within
the random-init fit tolerance (centres rtol 1e-4) of the JAX package's
uninterrupted fit.
"""

import json

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (imported at the top of every port test file)

from spark_rapids_ml_tpu.models.kmeans import KMeans as JaxKMeans
from spark_rapids_ml_tpu.utils.checkpoint import TrainingCheckpointer as JaxCheckpointer
from spark_rapids_ml_tpu_torch import KMeans
from spark_rapids_ml_tpu_torch.ops import kmeans as KM
from spark_rapids_ml_tpu_torch.utils.checkpoint import TrainingCheckpointer

CPU = torch.device("cpu")


@pytest.fixture
def blobs():
    # unstructured rows: Lloyd keeps moving, so no fit converges early
    return np.random.default_rng(42).uniform(size=(400, 5)).astype(np.float32)


@pytest.mark.parametrize("writer,reader", [
    (TrainingCheckpointer, JaxCheckpointer),
    (JaxCheckpointer, TrainingCheckpointer),
])
def test_directories_cross_between_packages(tmp_path, writer, reader):
    c = np.random.default_rng(0).normal(size=(4, 3)).astype(np.float32)
    w = writer(tmp_path / "ck")
    w.save(3, {"centers": c}, {"cost": 1.5})
    w.save(4, {"centers": c + 1}, {"cost": 0.5})
    step, arrays, state = reader(tmp_path / "ck").latest()
    assert step == 4 and state == {"step": 4, "cost": 0.5}
    np.testing.assert_array_equal(arrays["centers"], c + 1)
    assert arrays["centers"].dtype == np.float32


def test_retention_and_stale_staging_sweep(tmp_path):
    ck = TrainingCheckpointer(tmp_path / "ck", keep=2)
    for step in range(4):
        ck.save(step, {"a": np.arange(step + 1)})
    assert ck.steps() == [2, 3]
    (tmp_path / "ck" / ".tmp-9").mkdir()  # a writer killed mid-save
    ck.save(4, {"a": np.zeros(2)})
    assert not (tmp_path / "ck" / ".tmp-9").exists()
    assert ck.steps() == [3, 4]
    with pytest.raises(ValueError, match="keep"):
        TrainingCheckpointer(tmp_path / "x", keep=0)


def test_unreadable_step_is_skipped_and_empty_dir_is_none(tmp_path):
    ck = TrainingCheckpointer(tmp_path / "ck")
    assert ck.latest() is None
    ck.save(1, {"a": np.ones(3)}, {"cost": 2.0})
    bad = tmp_path / "ck" / "step-000000002"
    bad.mkdir()
    (bad / "state.json").write_text(json.dumps({"step": 2}))  # no arrays.npz
    step, arrays, _ = ck.latest()
    assert step == 1 and arrays["a"].tolist() == [1.0, 1.0, 1.0]


def test_interrupted_port_fit_resumes_to_the_same_centres(blobs, tmp_path, monkeypatch):
    def mk():
        return KMeans(device=CPU, k=8, seed=1, maxIter=12, tol=0.0)

    full = mk().fit(blobs, num_partitions=2)

    calls = {"n": 0}
    real = KM.kmeans_stats

    def dies_at_iteration_5(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] > 2 * 4:  # two partitions per iteration
            raise KeyboardInterrupt("preempted")
        return real(*args, **kwargs)

    monkeypatch.setattr(KM, "kmeans_stats", dies_at_iteration_5)
    with pytest.raises(KeyboardInterrupt):
        mk().fit(blobs, num_partitions=2, checkpoint_dir=str(tmp_path / "ck"))
    assert TrainingCheckpointer(tmp_path / "ck").steps() == [2, 3]
    monkeypatch.setattr(KM, "kmeans_stats", real)

    est = mk()
    monkeypatch.setattr(est, "_init_centers", lambda *a: pytest.fail("resume must not seed"))
    resumed = est.fit(blobs, num_partitions=2, checkpoint_dir=str(tmp_path / "ck"))
    # exactly the uninterrupted fit's centres and cost
    np.testing.assert_array_equal(resumed.clusterCenters, full.clusterCenters)
    assert resumed.trainingCost == full.trainingCost


def test_jax_checkpoint_resumes_in_the_port(blobs, tmp_path, monkeypatch):
    kw = dict(k=8, seed=1, initMode="random", maxIter=12, tol=0.0)
    full = JaxKMeans(**kw).fit(blobs)
    JaxKMeans(**{**kw, "maxIter": 3}).fit(blobs, checkpoint_dir=str(tmp_path / "ck"))
    est = KMeans(device=CPU, **kw)
    seen = []
    real = KM.kmeans_stats

    def count(*args, **kwargs):
        seen.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(KM, "kmeans_stats", count)
    resumed = est.fit(blobs, checkpoint_dir=str(tmp_path / "ck"))
    assert len(seen) == 12 - 3  # the JAX package's 3 iterations are not redone
    np.testing.assert_allclose(resumed.clusterCenters, full.clusterCenters, rtol=1e-4, atol=1e-5)
    assert TrainingCheckpointer(tmp_path / "ck").steps() == [10, 11]


def test_checkpoint_every_and_k_mismatch(blobs, tmp_path):
    KMeans(device=CPU, k=8, seed=1, maxIter=6, tol=0.0).fit(
        blobs, checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=3
    )
    assert TrainingCheckpointer(tmp_path / "ck").steps() == [2, 5]
    with pytest.raises(ValueError, match="8 centers but k=5"):
        KMeans(device=CPU, k=5).fit(blobs, checkpoint_dir=str(tmp_path / "ck"))
