"""The streamed IVF index's mesh-sharded Lloyd fold (``ann/index.py``)
against the port's one-device fold and the JAX package's mesh fold.

The JAX package builds on its mesh whenever it sees more than one device:
on the suite's 8 virtual CPU devices its ``_lloyd`` runs
``_lloyd_mesh_fold_prog``. The port's ``_mesh_or_none`` is patched to four
CPU shards. All three get the same f32 corpus in 333-row chunks, the same
initial centres and 128-row streamed chunks; the final centres agree
within 1e-5 of their largest entry. The mesh build's fold books one
allreduce a pass of its three stacked leaves.
"""

import jax  # noqa: F401  (imported at the top of every port test file)
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.ann import index as jindex
from spark_rapids_ml_tpu_torch import ann
from spark_rapids_ml_tpu_torch.ann import index as pindex
from spark_rapids_ml_tpu_torch.parallel import mesh as M
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY

CPU = torch.device("cpu")
ROWS, N, NLIST = 2000, 8, 12


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(17)
    centres = rng.normal(size=(NLIST, N)) * 6.0
    x = (centres[rng.integers(0, NLIST, ROWS)] + rng.normal(size=(ROWS, N))).astype(np.float32)
    return [x[lo:lo + 333] for lo in range(0, ROWS, 333)], x


@pytest.fixture
def small_chunks(monkeypatch):
    monkeypatch.setenv("TPU_ML_STREAM_CHUNK_ROWS", "128")  # both packages read it


def _close(got, ref, tol=1e-5):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=0,
                               atol=tol * np.abs(ref).max())


def test_mesh_lloyd_fold_matches_one_device_and_jax(corpus, small_chunks, monkeypatch):
    chunks, x = corpus
    centers = x[np.random.default_rng(5).choice(ROWS, NLIST, replace=False)].copy()
    est = ann.IVFFlatIndex(device=CPU, maxIter=4)
    assert est._mesh_or_none() is None  # a CPU estimator builds on one device
    one = est._lloyd(lambda: iter(chunks), centers, N, x[:500])
    monkeypatch.setattr(pindex.IVFFlatIndex, "_mesh_or_none",
                        lambda self: M.create_mesh(devices=[CPU] * 4))
    s0 = REGISTRY.snapshot()
    got = est._lloyd(lambda: iter(chunks), centers, N, x[:500])
    booked = REGISTRY.snapshot().delta(s0).counter("collective.count", kind="allreduce")
    assert booked == 3 * 4  # three stacked leaves, one allreduce a pass, 4 passes
    jest = jindex.IVFFlatIndex(maxIter=4)
    assert jest._mesh_or_none() is not None  # the JAX package's mesh fold
    ref = jest._lloyd(lambda: iter(chunks), centers, N, ROWS, np.dtype(np.float32), x[:500])
    _close(got, one)
    _close(got, ref)


def test_mesh_index_build_answers_as_the_one_device_build(corpus, small_chunks, monkeypatch):
    chunks, x = corpus
    params = dict(k=5, nlist=NLIST, nprobe=NLIST, maxIter=3, seed=4)
    one = ann.IVFFlatIndex(device=CPU, **params).fit(chunks)
    monkeypatch.setattr(pindex.IVFFlatIndex, "_mesh_or_none",
                        lambda self: M.create_mesh(devices=[CPU] * 4))
    got = ann.IVFFlatIndex(device=CPU, **params).fit(chunks)
    _close(got.centroids, one.centroids)
    queries = x[:20] + 0.01
    np.testing.assert_array_equal(got.search(queries)[1], one.search(queries)[1])
