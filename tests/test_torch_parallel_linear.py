"""``parallel/linear.py`` of the port against the JAX package's, and the
intercept column of ``spark/ingest.py``'s mesh ingest and streamed fold.

The JAX programs run on 4 of the suite's 8 virtual CPU devices
(``create_mesh(data=4)``); the port's mesh is four CPU shards and, where
named, one. Both get the same seeded f32 rows, 1,001 of them: the JAX
inputs are zero-padded to a multiple of 4 with weight 0 (the port pads its
own). Bounds, of the largest entry: the statistics 1e-5 (counts exact);
converged Newton parameters 1e-5 at ``regParam`` 0.1, where unconverged f32
steps would differ by about 2e-5; the closed-form and elastic-net solves
1e-5. A chunked Newton run killed after its first chunk and resumed from
its checkpoint is bit-equal to the uninterrupted chunked run.
"""

import jax  # noqa: F401  (imported at the top of every port test file)
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from spark_rapids_ml_tpu.parallel import linear as JPL
from spark_rapids_ml_tpu.parallel import mesh as JM
from spark_rapids_ml_tpu_torch.ops import linear as LIN
from spark_rapids_ml_tpu_torch.parallel import gram as G
from spark_rapids_ml_tpu_torch.parallel import linear as PL
from spark_rapids_ml_tpu_torch.parallel import mesh as M
from spark_rapids_ml_tpu_torch.spark import ingest
from spark_rapids_ml_tpu_torch.utils.checkpoint import TrainingCheckpointer

CPU = torch.device("cpu")
ROWS, N, C = 1001, 6, 3


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(ROWS, N)) * np.linspace(2.0, 0.5, N) + 0.3).astype(np.float32)
    beta = rng.normal(size=N)
    y_reg = (x @ beta + 0.1 * rng.normal(size=ROWS)).astype(np.float32)
    y_bin = (x @ beta + rng.normal(size=ROWS) > 0.3).astype(np.float32)
    y_cls = np.argmax(x[:, :C] + rng.gumbel(size=(ROWS, C)), axis=1).astype(np.float32)
    w = rng.uniform(0.5, 2.0, ROWS).astype(np.float32)
    return x, y_reg, y_bin, y_cls, w


@pytest.fixture(scope="module")
def jax_mesh():
    return JM.create_mesh(data=4)


@pytest.fixture(scope="module")
def mesh():
    return M.create_mesh(data=4, devices=[CPU] * 4)


def _close(got, ref, tol=1e-5):
    ref = np.asarray(ref, np.float64)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-30))


def _augment(x):
    return np.concatenate([x, np.ones((len(x), 1), np.float32)], axis=1)


def _jax_sharded(jm, *arrays):
    """Arrays zero-padded to a multiple of 4 rows and data-sharded on the
    JAX mesh (a pad row weighs 0 wherever a weight vector is passed)."""
    out = []
    for a in arrays:
        a = np.concatenate([a, np.zeros((-len(a) % 4,) + a.shape[1:], a.dtype)])
        spec = P(JM.DATA_AXIS, None) if a.ndim == 2 else P(JM.DATA_AXIS)
        out.append(jax.device_put(jnp.asarray(a), NamedSharding(jm, spec)))
    return out


def test_sharded_linear_stats_match_jax(data, jax_mesh, mesh):
    x, y, _, _, w = data
    jx, jy, jw = _jax_sharded(jax_mesh, x, y, w)
    ref = JPL.sharded_linear_stats_weighted(jx, jy, jw, jax_mesh)
    got = PL.sharded_linear_stats_weighted(x, y, w, mesh)
    for a, b in zip(got, ref):
        _close(a, b)
    assert got.count.item() == float(ref.count) == float(w.sum(dtype=np.float32))
    # unweighted, over rows the shards split evenly
    ref = JPL.sharded_linear_stats(*_jax_sharded(jax_mesh, x[:1000], y[:1000]), jax_mesh)
    got = PL.sharded_linear_stats(x[:1000], y[:1000], mesh)
    for a, b in zip(got, ref):
        _close(a, b)
    assert got.count.item() == 1000.0


@pytest.mark.parametrize("elastic_net", [0.0, 0.5])
def test_distributed_linreg_fit_matches_jax(data, jax_mesh, mesh, elastic_net):
    x, y, *_ = data
    opts = dict(reg_param=0.1, elastic_net_param=elastic_net)
    jx, jy = _jax_sharded(jax_mesh, x[:1000], y[:1000])
    ref_coef, ref_b = JPL.make_distributed_linreg_fit(jax_mesh, **opts)(jx, jy)
    coef, b = PL.make_distributed_linreg_fit(mesh, **opts)(x[:1000], y[:1000])
    _close(coef, ref_coef)
    np.testing.assert_allclose(float(b), float(ref_b), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(ref_coef)).max())


def test_newton_step_matches_jax(data, jax_mesh, mesh):
    x, _, y, *_ = data
    xa = _augment(x[:1000])
    w0 = np.linspace(-0.2, 0.2, N + 1).astype(np.float32)
    jx, jy = _jax_sharded(jax_mesh, xa, y[:1000])
    ref = JPL.sharded_newton_stats(jx, jy, jnp.asarray(w0), jax_mesh)
    got = PL.sharded_newton_stats(xa, y[:1000], torch.from_numpy(w0), mesh)
    for a, b in zip(got, ref):
        _close(a, b)
    ref_w, _ = JPL.make_distributed_newton_step(jax_mesh, reg_param=0.1)(jx, jy, jnp.asarray(w0))
    got_w, _ = PL.make_distributed_newton_step(mesh, reg_param=0.1)(xa, y[:1000], w0)
    _close(got_w, ref_w)


@pytest.mark.parametrize("loss,shards", [("logistic", 4), ("squared_hinge", 4),
                                         ("logistic", 1)])
def test_binary_newton_fit_matches_jax(data, jax_mesh, loss, shards):
    x, _, y, _, w = data
    xa = _augment(x)
    jx, jy, jw = _jax_sharded(jax_mesh, xa, y, w)
    ref, ref_it, _ = JPL.make_distributed_logreg_fit(
        jax_mesh, reg_param=0.1, max_iter=50, tol=1e-6, loss=loss)(jx, jy, jw)
    mesh = M.create_mesh(data=shards, devices=[CPU] * shards)
    got, it, step = PL.make_distributed_logreg_fit(
        mesh, reg_param=0.1, max_iter=50, tol=1e-6, loss=loss)(xa, y, w)
    assert float(step) <= 1e-6 and it < 50
    _close(got, ref)
    # the port's one-device Newton loop on the same rows
    one = LIN.newton_update
    w1 = torch.zeros(N + 1, dtype=torch.float64)
    stats_fn = LIN.logistic_newton_stats if loss == "logistic" else LIN.svc_newton_stats
    for _ in range(it):
        w1, _ = one(w1, stats_fn(torch.from_numpy(xa), torch.from_numpy(y), w1,
                                 torch.from_numpy(w)), reg_param=0.1)
    _close(got, w1.numpy())


def test_softmax_fit_matches_jax(data, jax_mesh, mesh):
    x, _, _, y, w = data
    xa = _augment(x)
    jx, jy, jw = _jax_sharded(jax_mesh, xa, y, w)
    ref, _, _ = JPL.make_distributed_softmax_fit(jax_mesh, C, reg_param=0.1, max_iter=50,
                                                 tol=1e-6)(jx, jy, jw)
    got, it, step = PL.make_distributed_softmax_fit(mesh, C, reg_param=0.1, max_iter=50,
                                                    tol=1e-6)(xa, y, w)
    # converged to the f32 noise floor of the statistics (the step norm
    # stalls near 3e-5, above tol, as the one-device fit's does)
    assert float(step) <= 1e-4
    # adding one vector to every class changes no probability, and only the
    # √eps ridge pins the unpenalized intercepts along it: compare the
    # parameters with their class mean taken out
    def centred(v):
        v = np.asarray(v, np.float64).reshape(C, N + 1)
        return v - v.mean(axis=0)

    _close(centred(got.numpy()), centred(ref))


class _Killed(RuntimeError):
    pass


@pytest.mark.parametrize("classes", [2, C])
def test_chunked_newton_resume_is_bit_equal(data, mesh, tmp_path, classes):
    x, _, y_bin, y_cls, w = data
    xa = _augment(x)
    y = y_bin if classes == 2 else y_cls
    d = N + 1 if classes == 2 else C * (N + 1)
    if classes == 2:
        chunk = PL.make_distributed_logreg_chunk(mesh, reg_param=0.1, chunk_iters=2, tol=1e-12)
    else:
        chunk = PL.make_distributed_softmax_chunk(mesh, C, reg_param=0.1, chunk_iters=2,
                                                  tol=1e-12)
    full, it_full = PL.run_chunked_newton(chunk, xa, y, w, np.zeros(d), start_iter=0,
                                          max_iter=6, tol=1e-12, ckpt=None)
    calls = {"n": 0}

    def dies_after_one(*args):
        calls["n"] += 1
        if calls["n"] == 2:
            raise _Killed("killed after the first chunk")
        return chunk(*args)

    with pytest.raises(_Killed):
        PL.run_chunked_newton(dies_after_one, xa, y, w, np.zeros(d), start_iter=0, max_iter=6,
                              tol=1e-12, ckpt=TrainingCheckpointer(tmp_path))
    step, arrays, _ = TrainingCheckpointer(tmp_path).latest()
    assert step == 1  # the save index is it − 1
    resumed, it = PL.run_chunked_newton(chunk, xa, y, w, arrays["w"], start_iter=step + 1,
                                        max_iter=6, tol=1e-12,
                                        ckpt=TrainingCheckpointer(tmp_path))
    assert it == it_full == 6
    assert torch.equal(resumed, full)


def test_non_finite_rows_raise_before_any_save(data, mesh, tmp_path):
    x, _, y, _, w = data
    xa = _augment(x)
    xa[5, 0] = np.nan
    chunk = PL.make_distributed_logreg_chunk(mesh, chunk_iters=2)
    with pytest.raises(ValueError, match="non-finite"):
        PL.run_chunked_newton(chunk, xa, y, w, np.zeros(N + 1), start_iter=0, max_iter=4,
                              tol=1e-6, ckpt=TrainingCheckpointer(tmp_path))
    assert TrainingCheckpointer(tmp_path).latest() is None


class _Frame:
    """A DataFrame stand-in that ``spark.ingest`` streams (a localspark
    frame's ``_parts``), over Arrow batches of [features, label, weight]."""

    def __init__(self, x, y, w, parts=3):
        self.batches = [
            pa.RecordBatch.from_pydict({
                "features": pa.array(list(xb.astype(np.float64))),
                "label": pa.array(yb.astype(np.float64)), "weight": pa.array(wb.astype(np.float64)),
            })
            for xb, yb, wb in zip(np.array_split(x, parts), np.array_split(y, parts),
                                  np.array_split(w, parts))
        ]

    def count(self):
        return sum(b.num_rows for b in self.batches)

    def _parts(self):
        return [self.batches]


def test_stream_to_mesh_appends_the_intercept_column(data, mesh):
    x, y, _, _, w = data
    ing = ingest.stream_to_mesh(_Frame(x, y, w), features_col="features", n=N, mesh=mesh,
                                label_col="label", weight_col="weight",
                                augment_intercept=True)
    got = ing.xs.join().numpy()
    assert got.shape == (ing.padded_rows, N + 1)
    np.testing.assert_array_equal(got[:ROWS], _augment(x))
    assert not got[ROWS:].any()  # pad rows: zero, the intercept column too
    np.testing.assert_array_equal(ing.ws.join().numpy()[:ROWS], w)
    assert not ing.ws.join().numpy()[ROWS:].any()


def test_stream_fold_appends_the_intercept_column(data, mesh):
    """The per-shard linear fold over augmented chunks equals the
    statistics of the augmented rows."""
    x, y, _, _, w = data
    res = ingest.stream_fold(
        _Frame(x, y, w), lambda c, xc, yc, wc: G.sharded_linear_fold(c, xc, yc, wc, mesh),
        features_col="features", label_col="label", weight_col="weight", n=N,
        init=G.init_chunk_carry(LIN.init_linear_carry(N + 1, "meta"), mesh), device=CPU,
        chunk_rows=G.stream_chunk_rows_for_mesh(mesh), put_fn=G.chunk_put(mesh),
        min_chunk_rows=4, augment_intercept=True,
    )
    got = G.finalize_chunk_fold(res.carry, mesh)
    want = LIN.linear_stats(torch.from_numpy(_augment(x)).double(), torch.from_numpy(y).double(),
                            torch.from_numpy(w).double())
    for a, b in zip(got, want):
        _close(a, b.numpy())
