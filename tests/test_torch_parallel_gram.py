"""``parallel/gram.py`` of the port against the JAX package's.

The JAX programs run on the suite's 8 virtual CPU devices as
``create_mesh(data=4, feat=2)`` (``data=4`` for the chunk folds, whose
carry stacks over the data axis); the port's mesh is the same grid of CPU
shards. Both get the same seeded f32 rows. Tolerances, of the largest
entry: 1e-5 for the f32 statistics (shard order differs), 3e-5 at
``"high"`` (the split's three bf16 products against the JAX CPU backend's
f32 product); ranges and counts exact; components by min |cosine| ≥ 0.9999
and explained variance at rtol 1e-4; collective payloads exactly the JAX
package's bookings.
"""

import jax  # noqa: F401  (imported at the top of every port test file)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from spark_rapids_ml_tpu.ops import linalg as JL
from spark_rapids_ml_tpu.ops import scaler as JS
from spark_rapids_ml_tpu.parallel import gram as JG
from spark_rapids_ml_tpu.parallel import mesh as JM
from spark_rapids_ml_tpu.telemetry.registry import REGISTRY as JREGISTRY
from spark_rapids_ml_tpu_torch.ops import linalg as TL
from spark_rapids_ml_tpu_torch.ops import scaler as TS
from spark_rapids_ml_tpu_torch.parallel import gram as G
from spark_rapids_ml_tpu_torch.parallel import mesh as M
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY

CPU = torch.device("cpu")
ROWS, N, K = 1024, 32, 4
JAX_PRECISION = {"highest": lax.Precision.HIGHEST, "high": lax.Precision.HIGH}
TOL = {"highest": 1e-5, "high": 3e-5}


@pytest.fixture(scope="module")
def x():
    rng = np.random.default_rng(7)
    base = rng.normal(size=(ROWS, 8)) @ rng.normal(size=(8, N)) * 3.0
    return (base + 0.1 * rng.normal(size=(ROWS, N)) + 1.0).astype(np.float32)


@pytest.fixture(scope="module")
def meshes():
    return JM.create_mesh(data=4, feat=2), M.create_mesh(data=4, feat=2, devices=[CPU] * 8)


def _close(got, ref, tol=1e-5):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-30))


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (np.abs((a * b).sum(0)) / (np.linalg.norm(a, axis=0) * np.linalg.norm(b, axis=0))).min()


def _jx(x, jm, feature_sharded=False):
    return jax.device_put(jnp.asarray(x), JM.data_sharding(jm, feature_sharded=feature_sharded))


def _collectives(registry, kind):
    snap = registry.snapshot()
    return snap.counter("collective.count", kind=kind), snap.counter("collective.bytes", kind=kind)


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_sharded_gram_stats_matches_jax(x, meshes, precision):
    jm, pm = meshes
    ref = JG.sharded_gram_stats(_jx(x, jm), jm, precision=JAX_PRECISION[precision])
    got = G.sharded_gram_stats(x, pm, precision=precision)
    _close(got.xtx.numpy(), ref.xtx, TOL[precision])
    _close(got.col_sum.numpy(), ref.col_sum, 1e-5)
    assert got.count.item() == float(ref.count) == ROWS


def test_sharded_moment_stats_matches_jax(x, meshes):
    jm, pm = meshes
    ref = JG.sharded_moment_stats(_jx(x, jm), jm)
    got = G.sharded_moment_stats(x, pm)
    for f in ("total", "total_sq"):
        _close(getattr(got, f).numpy(), getattr(ref, f))
    assert got.count.item() == float(ref.count) == ROWS


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_ring_gram_matches_jax(x, meshes, precision):
    jm, pm = meshes
    ref = JG.ring_gram(_jx(x, jm, True), jm, precision=JAX_PRECISION[precision])
    got = G.ring_gram(x, pm, precision=precision)
    _close(got[0].numpy(), ref[0], TOL[precision])
    _close(got[1].numpy(), ref[1])
    assert got[2].item() == float(ref[2]) == ROWS
    # the ring's Gram is the data-parallel one
    _close(got[0].numpy(), G.sharded_gram_stats(x, pm, precision=precision).xtx.numpy(),
           TOL[precision])


def test_collective_payloads_are_the_jax_bookings(x, meshes):
    jm, pm = meshes
    calls = [
        (lambda: JG.sharded_gram_stats(_jx(x, jm), jm), lambda: G.sharded_gram_stats(x, pm)),
        (lambda: JG.sharded_moment_stats(_jx(x, jm), jm), lambda: G.sharded_moment_stats(x, pm)),
        (lambda: JG.ring_gram(_jx(x, jm, True), jm), lambda: G.ring_gram(x, pm)),
    ]
    for jcall, pcall in calls:
        for kind in ("psum", "ppermute"):
            j0, p0 = _collectives(JREGISTRY, kind), _collectives(REGISTRY, kind)
            jcall()
            pcall()
            j1, p1 = _collectives(JREGISTRY, kind), _collectives(REGISTRY, kind)
            assert (p1[0] - p0[0], p1[1] - p0[1]) == (j1[0] - j0[0], j1[1] - j0[1])


@pytest.mark.parametrize("feature_sharded", [False, True])
@pytest.mark.parametrize("mean_centering", [False, True])
def test_distributed_pca_fit_matches_jax(x, meshes, feature_sharded, mean_centering):
    jm, pm = meshes
    for solver in ("full", "randomized", "auto"):
        ref_pc, ref_ev = JG.make_distributed_fit(
            jm, K, mean_centering=mean_centering, feature_sharded=feature_sharded,
            solver=solver)(_jx(x, jm, feature_sharded))
        pc, ev = G.make_distributed_fit(pm, K, mean_centering=mean_centering,
                                        feature_sharded=feature_sharded, solver=solver)(x)
        assert _cos(pc.numpy(), ref_pc) >= 0.9999, solver
        np.testing.assert_allclose(ev.numpy(), np.asarray(ref_ev), rtol=1e-4)
        direct = G.distributed_pca_fit(x, K, pm, mean_centering=mean_centering,
                                       feature_sharded=feature_sharded, solver=solver)
        torch.testing.assert_close(direct[0], pc, rtol=0, atol=0)


def test_range_stats_and_histogram_match_jax(x, meshes):
    """A pad-masked input: 24 zero rows of weight 0, which neither the
    ranges nor the histogram may see."""
    jm, pm = meshes
    xp = np.concatenate([x[:1000], np.zeros((24, N), np.float32)])
    w = np.concatenate([np.ones(1000, np.float32), np.zeros(24, np.float32)])
    jw = jax.device_put(jnp.asarray(w), jax.sharding.NamedSharding(
        jm, jax.sharding.PartitionSpec(JM.DATA_AXIS)))
    ref = JG.sharded_range_stats(_jx(xp, jm), jw, jm)
    got = G.sharded_range_stats(xp, w, pm)
    for f in ("count", "min", "max", "max_abs"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)))
    np.testing.assert_array_equal(got.min.numpy(), x[:1000].min(0))
    ref_h = JG.sharded_histogram(_jx(xp, jm), jw, ref.min, ref.max, bins=16, mesh=jm)
    got_h = G.sharded_histogram(xp, w, got.min, got.max, bins=16, mesh=pm)
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(ref_h))
    assert (got_h.sum(1) == 1000).all()


@pytest.fixture(scope="module")
def fold_meshes():
    return JM.create_mesh(data=4, feat=1), M.create_mesh(data=4, devices=[CPU] * 4)


def _jax_fold(x, jm, fold, example, chunk, extra=()):
    carry = JG.init_chunk_carry(example, jm)
    put = JG.chunk_put(jm)
    for lo in range(0, len(x), chunk):
        xc = np.zeros((chunk, x.shape[1]), x.dtype)
        wc = np.zeros(chunk, x.dtype)
        take = min(chunk, len(x) - lo)
        xc[:take], wc[:take] = x[lo:lo + take], 1.0
        args = [put(xc)] + [put(np.resize(e[lo:lo + take], chunk) * (wc > 0)) for e in extra]
        carry = fold(carry, *args, put(wc))
    return JG.finalize_chunk_fold(carry, jm)


def _port_fold(x, pm, fold, example, chunk, extra=()):
    carry = G.init_chunk_carry(example, pm)
    put = G.chunk_put(pm)
    for lo in range(0, len(x), chunk):
        xc = torch.from_numpy(x[lo:lo + chunk])
        args = [put(xc)] + [put(torch.from_numpy(e[lo:lo + chunk])) for e in extra]
        carry = fold(carry, *args, put(torch.ones(len(xc))))
    return G.finalize_chunk_fold(carry, pm)


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_sharded_gram_fold_matches_jax(x, fold_meshes, precision):
    jm, pm = fold_meshes
    ex = JL.GramStats(jax.ShapeDtypeStruct((N, N), jnp.float32),
                      jax.ShapeDtypeStruct((N,), jnp.float32), jax.ShapeDtypeStruct((), jnp.float32))
    ref = _jax_fold(x, jm, lambda c, xc, wc: JG.sharded_gram_fold(
        c, xc, wc, jm, precision=JAX_PRECISION[precision]), ex, 96)
    got = _port_fold(x, pm, lambda c, xc, wc: G.sharded_gram_fold(c, xc, wc, pm, precision=precision),
                     TL.init_gram_carry(N, "meta"), 96)
    _close(got.xtx.numpy(), ref.xtx, TOL[precision])
    _close(got.col_sum.numpy(), ref.col_sum)
    assert got.count.item() == float(ref.count) == ROWS


def test_weighted_high_fold_matches_jax_gram_stats_weighted(x, fold_meshes):
    """Weights other than 1 at "high": the split's three products outside
    the kernel, against the JAX package's ``gram_stats_weighted`` at
    ``Precision.HIGH`` (3e-5 of max|G|)."""
    _, pm = fold_meshes
    w = np.random.default_rng(2).uniform(0.5, 2.0, ROWS).astype(np.float32)
    ref = JL.gram_stats_weighted(jnp.asarray(x), jnp.asarray(w), precision=lax.Precision.HIGH)
    carry = G.init_chunk_carry(TL.init_gram_carry(N, "meta"), pm)
    put = G.chunk_put(pm)
    carry = G.sharded_gram_fold(carry, put(torch.from_numpy(x)), put(torch.from_numpy(w)), pm,
                                precision="high")
    got = G.finalize_chunk_fold(carry, pm)
    _close(got.xtx.numpy(), ref.xtx, 3e-5)
    _close(got.col_sum.numpy(), ref.col_sum)
    np.testing.assert_allclose(got.count.item(), float(ref.count), rtol=1e-6)


def test_moment_and_linear_folds_match_jax(x, fold_meshes):
    from spark_rapids_ml_tpu.ops import linear as JLIN

    jm, pm = fold_meshes
    f32 = jnp.float32
    ex = JS.MomentStats(count=jax.ShapeDtypeStruct((), f32), total=jax.ShapeDtypeStruct((N,), f32),
                        total_sq=jax.ShapeDtypeStruct((N,), f32))
    ref = _jax_fold(x, jm, lambda c, xc, wc: JG.sharded_moment_fold(c, xc, wc, jm), ex, 128)
    got = _port_fold(x, pm, lambda c, xc, wc: G.sharded_moment_fold(c, xc, wc, pm),
                     TS.init_moment_carry(N, "meta"), 128)
    for f in ("total", "total_sq"):
        _close(getattr(got, f).numpy(), getattr(ref, f))
    assert got.count.item() == float(ref.count) == ROWS
    y = (x @ np.linspace(-1, 1, N)).astype(np.float32)
    lex = JLIN.LinearStats(*(jax.ShapeDtypeStruct(s, f32)
                             for s in ((N, N), (N,), (N,), (), (), ())))
    ref = _jax_fold(x, jm, lambda c, xc, yc, wc: JG.sharded_linear_fold(c, xc, yc, wc, jm), lex,
                    128, extra=(y,))
    from spark_rapids_ml_tpu_torch.ops import linear as TLIN

    pex = TLIN.LinearStats(*(torch.empty(s, device="meta") for s in ((N, N), (N,), (N,), (), (), ())))
    got = _port_fold(x, pm, lambda c, xc, yc, wc: G.sharded_linear_fold(c, xc, yc, wc, pm), pex,
                     128, extra=(y,))
    for a, b in zip(got, ref):
        _close(a.numpy(), b)


def test_chunk_rows_and_carry_layout_match_jax(fold_meshes, monkeypatch):
    jm, pm = fold_meshes
    for rows in ("100", "65536", "7"):
        monkeypatch.setenv("TPU_ML_STREAM_CHUNK_ROWS", rows)
        assert G.stream_chunk_rows_for_mesh(pm) == JG.stream_chunk_rows_for_mesh(jm)
    carry = G.init_chunk_carry(TL.init_gram_carry(N, "meta"), pm)
    assert [leaf.join().shape for leaf in carry] == [(4, N, N), (4, N), (4,)]
    put = G.chunk_put(pm)(torch.arange(10.0))
    assert [b.shape[0] for b in put.data_blocks()] == [3, 3, 2, 2]  # no pad row


def test_finalize_retries_a_transient_collective_fault(fold_meshes, monkeypatch):
    from spark_rapids_ml_tpu_torch.resilience import faults

    _, pm = fold_meshes
    carry = G.init_chunk_carry(TL.init_gram_carry(3, "meta"), pm)
    carry.count.block(1)[0].fill_(5.0)
    monkeypatch.setenv("TPU_ML_FAULT_PLAN", "collective:io:1")
    faults.reset_faults()
    try:
        total = G.finalize_chunk_fold(carry, pm)
    finally:
        monkeypatch.delenv("TPU_ML_FAULT_PLAN")
        faults.reset_faults()
    assert total.count.item() == 5.0


@pytest.mark.cuda
def test_mesh_gram_programs_on_card():
    """On the card, four shards of cuda:0: ``sharded_gram_stats`` at "high"
    launches ``fused_gram_moments`` once a shard and the per-shard chunk
    fold ``symmetric_gram_moments`` once a shard a chunk, each against the
    same program over CPU shards (the kernels' plain versions: 1e-5 of
    max); the ring Gram and the distributed fit against the CPU mesh's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the Gram kernels have no CPU mode")
    from spark_rapids_ml_tpu_torch.ops import gram_moments as GM
    from spark_rapids_ml_tpu_torch.spark import ingest

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(200_000, 8)) @ rng.normal(size=(8, 256)) + 0.1 * rng.normal(
        size=(200_000, 256)) + 1.0).astype(np.float32)
    card = M.create_mesh(data=4, devices=[torch.device("cuda", 0)] * 4)
    host = M.create_mesh(data=4, devices=[CPU] * 4)
    xd = torch.from_numpy(x).cuda()
    before = GM.launches
    got = G.sharded_gram_stats(xd, card, precision="high")
    torch.cuda.synchronize()
    assert GM.launches == before + 4
    want = G.sharded_gram_stats(x, host, precision="high")
    _close(got.xtx.cpu().numpy(), want.xtx.numpy())
    _close(got.col_sum.cpu().numpy(), want.col_sum.numpy())
    ring = G.ring_gram(xd, M.create_mesh(data=2, feat=2, devices=[torch.device("cuda", 0)] * 4),
                       precision="high")
    _close(ring[0].cpu().numpy(), want.xtx.numpy(), 3e-5)
    pc, _ = G.distributed_pca_fit(xd, 4, card, precision="high")
    ref_pc, _ = G.distributed_pca_fit(x, 4, host, precision="high")
    assert _cos(pc.cpu().numpy(), ref_pc.numpy()) >= 0.9999
    before = GM.symmetric_launches

    def fold(mesh, device):
        res = ingest.stream_fold(
            [x], lambda c, xc, wc: G.sharded_gram_fold(c, xc, wc, mesh, precision="high"),
            n=256, init=G.init_chunk_carry(TL.init_gram_carry(256, "meta"), mesh), device=device,
            chunk_rows=65_536, put_fn=G.chunk_put(mesh), min_chunk_rows=4)
        return G.finalize_chunk_fold(res.carry, mesh)

    on_card = fold(card, torch.device("cuda", 0))
    torch.cuda.synchronize()
    assert GM.symmetric_launches == before + 4 * 4  # 4 chunks, 4 shards
    _close(on_card.xtx.cpu().numpy(), fold(host, CPU).xtx.numpy())
