"""The port's device mesh and collectives against the JAX package's.

The JAX side runs on the suite's 8 virtual CPU devices
(``create_mesh(data=4, feat=2)``); the port's mesh is the same grid of CPU
shards. The same seeded f32 rows go to both. Layouts (grids, blocks,
factorizations) must be equal; sums agree to 1e-5 of their largest entry
(the port sums shards in a fixed order, XLA in its own); min/max and the
gathers are exact. The process mesh runs as two spawned gloo ranks whose
results must be bit-equal to the in-process mesh's.
"""

import multiprocessing as mp

import jax  # noqa: F401  (imported at the top of every port test file)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

from spark_rapids_ml_tpu.ops import linalg as JL
from spark_rapids_ml_tpu.parallel import backend as JB
from spark_rapids_ml_tpu.parallel import mesh as JM
from spark_rapids_ml_tpu_torch.ops import linalg as TL
from spark_rapids_ml_tpu_torch.parallel import backend as B
from spark_rapids_ml_tpu_torch.parallel import mesh as M

CPU = torch.device("cpu")
ROWS, N = 512, 16


@pytest.fixture(scope="module")
def x():
    return np.random.default_rng(3).normal(size=(ROWS, N)).astype(np.float32) + 2.0


@pytest.fixture(scope="module")
def meshes():
    return JM.create_mesh(data=4, feat=2), M.create_mesh(data=4, feat=2, devices=[CPU] * 8)


def _ids(jax_mesh):
    return np.vectorize(lambda d: d.id)(jax_mesh.devices)


def _close(got, ref, tol=1e-5):
    ref = np.asarray(ref, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-30))


def test_create_mesh_and_factor_mesh_match_jax():
    devices = [torch.device("cpu", i) for i in range(8)]
    for data, feat in ((4, 2), (None, 2), (2, 1), (None, 4), (1, 8)):
        ref = JM.create_mesh(data=data, feat=feat)
        got = M.create_mesh(data=data, feat=feat, devices=devices)
        assert got.shape == dict(ref.shape) and got.axis_names == ref.axis_names
        assert got.size == ref.size
        np.testing.assert_array_equal(np.vectorize(lambda d: d.index)(got.devices), _ids(ref))
    for bad in (dict(feat=3), dict(data=5, feat=2)):
        with pytest.raises(ValueError) as e_ref:
            JM.create_mesh(**bad)
        with pytest.raises(ValueError) as e_got:
            M.create_mesh(devices=devices, **bad)
        assert str(e_got.value) == str(e_ref.value)
    for n in range(1, 33):
        assert M.factor_mesh(n) == JM.factor_mesh(n)


def test_create_mesh_needs_a_card_or_devices(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        M.create_mesh()


def test_hybrid_mesh_places_groups_like_jax():
    devices = [torch.device("cpu", i) for i in range(8)]
    groups = [[4, 5, 6, 7], [0, 1, 2, 3]]
    for feat in (1, 2, 4):
        ref = JM.create_hybrid_mesh(feat=feat, slice_groups=groups)
        got = M.create_hybrid_mesh(feat=feat, slice_groups=groups, devices=devices)
        np.testing.assert_array_equal(np.vectorize(lambda d: d.index)(got.devices), _ids(ref))
    # no groups and one host: the flat mesh
    flat = M.create_hybrid_mesh(feat=2, devices=devices)
    np.testing.assert_array_equal(np.vectorize(lambda d: d.index)(flat.devices),
                                  _ids(JM.create_hybrid_mesh(feat=2)))
    for bad in ([[0, 1], [2]], [[0, 1], [1, 2]]):
        with pytest.raises(ValueError) as e_ref:
            JM.create_hybrid_mesh(slice_groups=bad)
        with pytest.raises(ValueError) as e_got:
            M.create_hybrid_mesh(slice_groups=bad, devices=devices)
        assert str(e_got.value) == str(e_ref.value)
    with pytest.raises(ValueError, match="must divide"):
        M.create_hybrid_mesh(feat=3, slice_groups=groups, devices=devices)


@pytest.mark.parametrize("feature_sharded", [False, True])
def test_data_sharding_blocks_are_jax_shards(x, meshes, feature_sharded):
    jm, pm = meshes
    jx = jax.device_put(jnp.asarray(x), JM.data_sharding(jm, feature_sharded=feature_sharded))
    xs = M.data_sharding(pm, feature_sharded=feature_sharded).shard(x)
    by_device = {s.device.id: np.asarray(s.data) for s in jx.addressable_shards}
    grid = _ids(jm)
    for (i, j), block in xs.blocks.items():
        np.testing.assert_array_equal(block.numpy(), by_device[grid[i, j]])
    # a data-only spec keeps one block per data shard (its feat replicas
    # would compute the same thing)
    assert len(xs.blocks) == (8 if feature_sharded else 4)
    np.testing.assert_array_equal(xs.join().numpy(), x)


def test_sharding_pads_rows_with_zeros_and_joins_back():
    pm = M.create_mesh(data=4, devices=[CPU] * 4)
    x = np.arange(30, dtype=np.float32).reshape(10, 3)
    xs = M.shard(x, pm)
    assert xs.shape == (12, 3) and xs.rows == 10
    assert [b.shape[0] for b in xs.data_blocks()] == [3, 3, 3, 3]
    joined = xs.join().numpy()
    np.testing.assert_array_equal(joined[:10], x)
    assert not joined[10:].any()
    assert M.shard(xs, pm) is xs  # already so: a no-op
    rep = M.replicated(pm).shard(x)
    np.testing.assert_array_equal(rep.join().numpy(), x)
    with pytest.raises(ValueError, match="do not split"):
        M.data_sharding(M.create_mesh(data=2, feat=2, devices=[CPU] * 4),
                        feature_sharded=True).shard(x)


def test_sharded_repr_reads_no_block():
    """A streamed fold books each chunk against the cost model, which keys
    on its arguments' repr: printing a block would copy it from the card
    every chunk (phase 21 (b)'s fold ran 3.2x slower so)."""
    pm = M.create_mesh(data=2, devices=[CPU] * 2)
    xs = M.shard(torch.full((4096, 64), 7.0), pm)
    text = repr(xs)
    assert "7." not in text and len(text) < 120
    assert "(4096, 64)" in text and "torch.float32" in text


def test_center_columns_shard_matches_jax(x, meshes):
    jm, pm = meshes

    @jax.jit
    def jax_center(v):
        return JM.shard_map(JM.center_columns_shard, mesh=jm, in_specs=JP(JM.DATA_AXIS, None),
                            out_specs=JP(JM.DATA_AXIS, None), check_rep=False)(v)

    ref = jax_center(jax.device_put(jnp.asarray(x), JM.data_sharding(jm)))
    got = M.center_columns_shard(M.shard(x, pm).data_blocks(), pm)
    _close(torch.cat(got).numpy(), ref)


def test_mapreduce_data_axis_matches_jax(x, meshes):
    jm, pm = meshes
    jx = jax.device_put(jnp.asarray(x), JM.data_sharding(jm))
    ref = jax.jit(JB.mapreduce_data_axis(lambda v: JL.gram_stats(v), jm))(jx)
    got = B.mapreduce_data_axis(lambda v: TL.gram_stats(v), pm)(x)
    assert isinstance(got, TL.GramStats)
    for a, b in zip(got, ref):
        _close(a.numpy(), b)
    # replicated and vector operands
    w = np.linspace(0.5, 1.5, ROWS).astype(np.float32)
    shift = np.ones(N, np.float32)
    ref = jax.jit(JB.mapreduce_data_axis(
        lambda v, wv, s: {"s": jnp.sum((v + s) * wv[:, None], 0)}, jm,
        in_specs=(JP(JM.DATA_AXIS, None), JP(JM.DATA_AXIS), JP())))(
        jx, jax.device_put(jnp.asarray(w), NamedSharding(jm, JP(JM.DATA_AXIS))), jnp.asarray(shift))
    got = B.mapreduce_data_axis(
        lambda v, wv, s: {"s": ((v + s) * wv[:, None]).sum(0)}, pm,
        in_specs=(B.MATRIX_SPEC, B.VECTOR_SPEC, B.REPLICATED_SPEC))(x, w, shift)
    _close(got["s"].numpy(), ref["s"])


def test_allreduce_and_allgather_match_jax(meshes):
    jm, pm = meshes
    stacked = np.random.default_rng(4).normal(size=(8, 5)).astype(np.float32)
    for axis in (JM.DATA_AXIS,):  # stacked partials shard over data only
        ref_r = JB.allreduce(jax.device_put(jnp.asarray(stacked),
                                            NamedSharding(jm, JP(axis))), jm, axis)
        ref_g = JB.allgather(jax.device_put(jnp.asarray(stacked),
                                            NamedSharding(jm, JP(axis))), jm, axis)
        _close(B.allreduce(stacked, pm, axis).numpy(), ref_r)
        np.testing.assert_array_equal(B.allgather(stacked, pm, axis).numpy(), np.asarray(ref_g))
    for fn in (B.allreduce, B.allgather):
        with pytest.raises(ValueError, match="shard over"):
            fn(stacked, pm, M.FEAT_AXIS)


def test_host_reduce_broadcast_and_process_info():
    parts = [np.full(3, float(i)) for i in range(5)]
    got = B.host_reduce(parts, lambda a, b: a + b)
    np.testing.assert_array_equal(got, JB.host_reduce(parts, lambda a, b: a + b))
    assert B.broadcast_host({"k": 1}) == JB.broadcast_host({"k": 1}) == {"k": 1}
    info = B.process_info()
    ref = JB.process_info()
    assert (info["process_index"], info["process_count"]) == (
        ref["process_index"], ref["process_count"]) == (0, 1)
    B.initialize()  # no address: one process, nothing to join
    assert not torch.distributed.is_initialized()


def test_psum_is_bit_equal_run_to_run_and_in_shard_order():
    pm = M.create_mesh(data=4, devices=[CPU] * 4)
    parts = [torch.from_numpy(np.random.default_rng(i).normal(size=64).astype(np.float32) * 1e3)
             for i in range(4)]
    first = B.psum(pm, parts)
    assert all(t is first[0] for t in first)  # one device: one copy shared
    ordered = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    torch.testing.assert_close(first[0], ordered, rtol=0, atol=0)
    torch.testing.assert_close(B.psum(pm, parts)[0], first[0], rtol=0, atol=0)
    lo = B.preduce(pm, parts, "min")[0]
    torch.testing.assert_close(lo, torch.stack(parts).amin(0), rtol=0, atol=0)
    perm = B.ppermute(parts, [(k, (k - 1) % 4) for k in range(4)], [CPU] * 4)
    assert perm[3] is parts[0] and perm[0] is parts[1]


def _rank_main(rank, init, q):
    torch.set_float32_matmul_precision("highest")
    B.initialize(init, 2, rank, device="cpu")
    try:
        mesh = B.process_mesh("cpu")
        x = np.random.default_rng(9).normal(size=(64, 6)).astype(np.float32)
        mine = M.shard(x[rank * 32:(rank + 1) * 32], mesh)
        stats = B.mapreduce_data_axis(lambda v: TL.gram_stats(v), mesh)(mine)
        gathered = B.all_gather(mesh, [torch.full((3,), float(rank))])
        # a column-major R, through both gathers (the broadcast one is
        # gloo's route for CUDA tensors)
        r = torch.linalg.qr(torch.from_numpy(x[rank * 32:(rank + 1) * 32]), mode="r").R
        assert not r.is_contiguous()
        rs = [B.all_gather(mesh, [r]), B._gather_by_broadcast(r, rank)]
        info = B.process_info()
        q.put((rank, [t.numpy() for t in stats], [g.numpy() for g in gathered],
               info["process_count"], B.broadcast_host(f"from {rank}"),
               [[g.numpy() for g in route] for route in rs]))
    finally:
        B.shutdown()


def test_process_mesh_collectives_equal_the_in_process_mesh(tmp_path):
    """Two gloo ranks (a file store under tmp_path: no port to race for)
    each own half the rows; every rank's psum is bit-equal to the
    in-process mesh of the same two shards, and both gathers move a
    column-major R factor intact."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    init = f"file://{tmp_path / 'store'}"
    procs = [ctx.Process(target=_rank_main, args=(r, init, q)) for r in range(2)]
    for p in procs:
        p.start()
    results = sorted((q.get(timeout=120) for _ in procs), key=lambda r: r[0])
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    x = np.random.default_rng(9).normal(size=(64, 6)).astype(np.float32)
    local = B.mapreduce_data_axis(lambda v: TL.gram_stats(v),
                                  M.create_mesh(data=2, devices=[CPU] * 2))(x)
    own_r = [torch.linalg.qr(torch.from_numpy(x[r * 32:(r + 1) * 32]), mode="r").R.numpy()
             for r in range(2)]
    for rank, stats, gathered, count, msg, rs in results:
        for a, b in zip(stats, local):
            np.testing.assert_array_equal(a, b.numpy())
        np.testing.assert_array_equal(np.stack(gathered), [[0.0] * 3, [1.0] * 3])
        assert count == 2 and msg == "from 0"
        for route in rs:
            for got, want in zip(route, own_r):
                np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
def test_process_mesh_on_one_card_over_gloo(tmp_path):
    """Two ranks on cuda:0 over gloo, which takes CUDA tensors for
    broadcasts: the gather rides ``_gather_by_broadcast`` and every rank's
    psum is bit-equal to the in-process mesh of the same two shards."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    init = f"file://{tmp_path / 'store'}"
    procs = [ctx.Process(target=_card_rank_main, args=(r, init, q)) for r in range(2)]
    for p in procs:
        p.start()
    results = sorted((q.get(timeout=180) for _ in procs), key=lambda r: r[0])
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(4096, 64)).astype(np.float32))
    local = B.mapreduce_data_axis(lambda v: TL.gram_stats(v, precision="high"),
                                  M.create_mesh(data=2, devices=[torch.device("cuda", 0)] * 2))(
        x.cuda())
    for rank, backend, stats in results:
        assert backend == "gloo"
        for a, b in zip(stats, local):
            np.testing.assert_array_equal(a, b.cpu().numpy())


def _card_rank_main(rank, init, q):
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    B.initialize(init, 2, rank, device=dev)
    try:
        mesh = B.process_mesh(dev)
        x = np.random.default_rng(9).normal(size=(4096, 64)).astype(np.float32)
        mine = M.shard(torch.from_numpy(x[rank * 2048:(rank + 1) * 2048]).cuda(), mesh)
        stats = B.mapreduce_data_axis(lambda v: TL.gram_stats(v, precision="high"), mesh)(mine)
        q.put((rank, B.process_info()["backend"], [t.cpu().numpy() for t in stats]))
    finally:
        B.shutdown()
