"""``parallel/tsqr.py`` and ``parallel/sketched.py`` of the port against the
JAX package's.

The JAX programs run on the suite's 8 virtual CPU devices
(``create_mesh(data=4, feat=2)``, and data=3 for the merge that is not a
butterfly); the port's mesh is the same grid of CPU shards, fed the same
seeded f32 rows. R factors are unique up to the signs of their rows, so
they are compared after making R's diagonal positive, at 1e-5 of max|R|.
Components agree by min |cosine| ≥ 0.9999, explained variance at rtol
1e-4. The sketched fit draws its own Ω (a ``torch.Generator``, not
``jax.random``), so both packages' components are held to the f64
components (≥ 0.9999) and to each other by subspace, on rows whose
spectrum decays past k; projections and means at 1e-5 of their largest
entry.
"""

import jax  # noqa: F401  (imported at the top of every port test file)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as JP

from spark_rapids_ml_tpu.parallel import mesh as JM
from spark_rapids_ml_tpu.parallel import sketched as JSK
from spark_rapids_ml_tpu.parallel import tsqr as JT
from spark_rapids_ml_tpu_torch.ops import linalg as TL
from spark_rapids_ml_tpu_torch.parallel import mesh as M
from spark_rapids_ml_tpu_torch.parallel import sketched as SK
from spark_rapids_ml_tpu_torch.parallel import tsqr as T

CPU = torch.device("cpu")
ROWS, N, K = 1536, 32, 4


@pytest.fixture(scope="module")
def x():
    rng = np.random.default_rng(11)
    scales = np.array([20.0, 12.0, 8.0, 5.0] + [0.2] * (N - 4))
    base = rng.normal(size=(ROWS, N)) * scales
    q, _ = np.linalg.qr(rng.normal(size=(N, N)))
    return (base @ q.T + 0.5).astype(np.float32)


@pytest.fixture(scope="module")
def meshes():
    return JM.create_mesh(data=4, feat=2), M.create_mesh(data=4, feat=2, devices=[CPU] * 8)


def _signed(r):
    r = np.asarray(r, np.float64)
    return r * np.where(np.diag(r) < 0, -1.0, 1.0)[:, None]


def _cos(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return (np.abs((a * b).sum(0)) / (np.linalg.norm(a, axis=0) * np.linalg.norm(b, axis=0))).min()


def _f64_pc(x, k, center):
    x = x.astype(np.float64)
    if center:
        x = x - x.mean(0)
    return np.linalg.svd(x, full_matrices=False)[2][:k].T


def _jx(x, jm, feature_sharded=False):
    return jax.device_put(jnp.asarray(x), JM.data_sharding(jm, feature_sharded=feature_sharded))


@pytest.mark.parametrize("data", [4, 3])
def test_tsqr_r_matches_jax(x, data):
    """The butterfly (4 shards) and the one-QR merge (3 shards)."""
    jm = JM.create_mesh(data=data, feat=1)
    pm = M.create_mesh(data=data, devices=[CPU] * data)
    ref = JT.tsqr_r(_jx(x, jm), jm)
    got = T.tsqr_r(x, pm)
    np.testing.assert_allclose(_signed(got.numpy()), _signed(ref), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(ref)).max())
    # RᵀR is the Gram
    g = x.astype(np.float64).T @ x
    rtr = got.double().T @ got.double()
    np.testing.assert_allclose(rtr.numpy(), g, rtol=0, atol=1e-5 * np.abs(g).max())


def test_merge_r_butterfly_and_gather_agree():
    rng = np.random.default_rng(5)
    rs = [TL.qr_r(torch.from_numpy(rng.normal(size=(40, 6)).astype(np.float32)))
          for _ in range(4)]
    fly = T.merge_r(rs)
    once = TL.qr_r(torch.cat(rs))
    np.testing.assert_allclose(_signed(fly.numpy()), _signed(once.numpy()), rtol=0, atol=1e-4)
    assert T.merge_r(rs[:1]) is rs[0]


@pytest.mark.parametrize("mean_centering", [False, True])
def test_distributed_fit_svd_matches_jax(x, meshes, mean_centering):
    jm, pm = meshes
    ref_pc, ref_ev = JT.make_distributed_fit_svd(jm, K, mean_centering=mean_centering)(_jx(x, jm))
    pc, ev = T.make_distributed_fit_svd(pm, K, mean_centering=mean_centering)(x)
    assert _cos(pc.numpy(), ref_pc) >= 0.9999
    np.testing.assert_allclose(ev.numpy(), np.asarray(ref_ev), rtol=1e-4)
    direct = T.distributed_pca_fit_svd(x, K, pm, mean_centering=mean_centering)
    torch.testing.assert_close(direct[0], pc, rtol=0, atol=0)
    assert _cos(pc.numpy(), _f64_pc(x, K, mean_centering)) >= 0.9999


@pytest.mark.parametrize("mean_centering", [False, True])
def test_masked_fit_svd_matches_jax_on_padded_shards(x, meshes, mean_centering):
    """Shards padded with zero rows of mask 0, as the barrier path pads: the
    masked fit equals the fit of the true rows."""
    jm, pm = meshes
    xp = np.concatenate([x[:1500], np.zeros((36, N), np.float32)])
    w = np.concatenate([np.ones(1500, np.float32), np.zeros(36, np.float32)])
    jw = jax.device_put(jnp.asarray(w), NamedSharding(jm, JP(JM.DATA_AXIS)))
    ref_pc, ref_ev = JT.make_distributed_fit_svd_masked(
        jm, K, mean_centering=mean_centering)(_jx(xp, jm), jw)
    pc, ev = T.make_distributed_fit_svd_masked(pm, K, mean_centering=mean_centering)(xp, w)
    assert _cos(pc.numpy(), ref_pc) >= 0.9999
    np.testing.assert_allclose(ev.numpy(), np.asarray(ref_ev), rtol=1e-4)
    assert _cos(pc.numpy(), _f64_pc(x[:1500], K, mean_centering)) >= 0.9999


@pytest.mark.parametrize("mean_centering", [False, True])
def test_sketched_fit_matches_jax_and_f64(x, meshes, mean_centering):
    jm, pm = meshes
    ref_pc, ref_ev = JSK.make_sketched_fit(jm, K, mean_centering=mean_centering)(
        _jx(x, jm, True))
    pc, ev = SK.make_sketched_fit(pm, K, mean_centering=mean_centering)(x)
    oracle = _f64_pc(x, K, mean_centering)
    assert _cos(pc.numpy(), oracle) >= 0.9999
    assert _cos(np.asarray(ref_pc), oracle) >= 0.9999
    assert _cos(pc.numpy(), ref_pc) >= 0.9999
    np.testing.assert_allclose(ev.numpy(), np.asarray(ref_ev), rtol=1e-4)
    # the same seed draws the same Ω: run to run bit-equal
    again = SK.sketched_pca_fit(x, K, pm, mean_centering=mean_centering)
    torch.testing.assert_close(again[0], pc, rtol=0, atol=0)


def test_column_means_and_projection_match_jax(x, meshes):
    jm, pm = meshes
    jx = _jx(x, jm, True)
    ref_mu = JSK.sharded_column_means(jx, jm)
    mu = SK.sharded_column_means(x, pm)
    np.testing.assert_allclose(mu.numpy(), np.asarray(ref_mu), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(ref_mu)).max())
    comps = np.linalg.qr(np.random.default_rng(1).normal(size=(N, K)))[0].astype(np.float32)
    jc = jax.device_put(jnp.asarray(comps), NamedSharding(jm, JP(JM.FEAT_AXIS, None)))
    for centered in (False, True):
        args = (jx, jc, ref_mu) if centered else (jx, jc)
        ref = np.asarray(JSK.make_sharded_project(jm, centered=centered)(*args))
        pargs = (x, torch.from_numpy(comps), mu) if centered else (x, torch.from_numpy(comps))
        got = SK.make_sharded_project(pm, centered=centered)(*pargs).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_programs_refuse_a_process_mesh():
    mesh = M.Mesh([[CPU]] * 2, rank=0)
    with pytest.raises(NotImplementedError, match="mesh of this process"):
        SK.sketched_pca_fit(np.ones((4, 2), np.float32), 1, mesh)


@pytest.mark.cuda
def test_tsqr_and_sketch_on_card():
    """The TSQR fit over four shards of cuda:0 and the sketch at data = feat
    = 2 against the f64 components (min |cosine| ≥ 0.9999)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    rng = np.random.default_rng(11)
    scales = np.array([20.0, 12.0, 8.0, 5.0] + [0.2] * 60)
    x = ((rng.normal(size=(100_000, 64)) * scales) @ np.linalg.qr(
        rng.normal(size=(64, 64)))[0].T).astype(np.float32)
    dev = torch.device("cuda", 0)
    xd = torch.from_numpy(x).cuda()
    for center in (False, True):
        pc, _ = T.distributed_pca_fit_svd(xd, K, M.create_mesh(data=4, devices=[dev] * 4),
                                          mean_centering=center)
        spc, _ = SK.sketched_pca_fit(xd, K, M.create_mesh(data=2, feat=2, devices=[dev] * 4),
                                     mean_centering=center)
        oracle = _f64_pc(x, K, center)
        assert _cos(pc.cpu().numpy(), oracle) >= 0.9999
        assert _cos(spc.cpu().numpy(), oracle) >= 0.9999
