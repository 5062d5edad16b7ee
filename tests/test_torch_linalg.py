"""Each function of the port's ops/linalg.py against its JAX counterpart.

Inputs are f32 numpy arrays from a seed, handed to both packages. The data
has a separated spectrum (rank-64 mix plus noise), so the leading
components are well determined and comparable: eigenvectors by min
|cosine| >= 0.9999, eigenvalues and explained variance at rtol 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from spark_rapids_ml_tpu.ops import linalg as JL
from spark_rapids_ml_tpu_torch.ops import linalg as TL

ROWS, N, K = 3000, 96, 8
COSINE_BAR = 0.9999


def _workload(rows=ROWS, n=N, seed=7):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(rows, 64)).astype(np.float32)
    mix = rng.normal(size=(64, n)).astype(np.float32)
    return base @ mix + 0.1 * rng.normal(size=(rows, n)).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _min_abs_cosine(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    cos = np.abs((a * b).sum(0)) / (np.linalg.norm(a, axis=0) * np.linalg.norm(b, axis=0))
    return cos.min()


@pytest.fixture(scope="module")
def x():
    return _workload()


@pytest.fixture(scope="module")
def cov(x):
    return (x.T.astype(np.float64) @ x).astype(np.float32)


def test_gram(x):
    ref = np.asarray(JL.gram(jnp.asarray(x)))
    out = TL.gram(_t(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize(
    "precision,jax_precision,tol",
    [
        # f32 products on both sides
        ("highest", lax.Precision.HIGHEST, 1e-5),
        # split-bf16 (~16 mantissa bits) against JAX's f32 on the CPU
        ("high", lax.Precision.HIGH, 3e-5),
    ],
)
def test_gram_stats(x, precision, jax_precision, tol):
    ref = JL.gram_stats(jnp.asarray(x), precision=jax_precision)
    out = TL.gram_stats(_t(x), precision=precision)
    scale = np.abs(np.asarray(ref.xtx)).max()
    np.testing.assert_allclose(out.xtx.numpy(), np.asarray(ref.xtx), rtol=0, atol=tol * scale)
    np.testing.assert_allclose(
        out.col_sum.numpy(), np.asarray(ref.col_sum), rtol=1e-4,
        atol=2e-4 * np.sqrt(ROWS) * np.abs(x).max(),
    )
    assert out.count.item() == float(ref.count) == ROWS
    assert out.xtx.dtype == out.col_sum.dtype == torch.float32


def test_gram_stats_default_tier_not_ported(x):
    with pytest.raises(NotImplementedError, match="default"):
        TL.gram_stats(_t(x), precision="default")
    with pytest.raises(ValueError):
        TL.gram_stats(_t(x), precision="fast")


def test_gram_refuses_tf32(x):
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="f32"):
            TL.gram(_t(x))
    finally:
        torch.set_float32_matmul_precision("highest")


@pytest.mark.parametrize("mean_centering", [False, True])
def test_combine_and_covariance(x, mean_centering):
    a, b = x[:1000], x[1000:]
    jref = JL.covariance_from_stats(
        JL.combine_gram_stats(JL.gram_stats(jnp.asarray(a)), JL.gram_stats(jnp.asarray(b))),
        mean_centering=mean_centering,
    )
    tout = TL.covariance_from_stats(
        TL.combine_gram_stats(TL.gram_stats(_t(a)), TL.gram_stats(_t(b))),
        mean_centering=mean_centering,
    )
    ref = np.asarray(jref)
    np.testing.assert_allclose(tout.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_sign_flip(rng):
    u = rng.normal(size=(20, 7)).astype(np.float32)
    np.testing.assert_array_equal(
        TL.sign_flip(_t(u)).numpy(), np.asarray(JL.sign_flip(jnp.asarray(u)))
    )


def test_refine_eigh(cov):
    evals, evecs = np.linalg.eigh(cov)
    jv, je = JL.refine_eigh(jnp.asarray(cov), jnp.asarray(evecs), jnp.asarray(evals))
    tv, te = TL.refine_eigh(_t(cov), _t(evecs), _t(evals))
    top = slice(N - K, N)  # ascending order: the leading K at the end
    assert _min_abs_cosine(tv.numpy()[:, top], np.asarray(jv)[:, top]) >= COSINE_BAR
    np.testing.assert_allclose(te.numpy()[top], np.asarray(je)[top], rtol=1e-4)


def test_eigh_descending(cov):
    jc, js = JL.eigh_descending(jnp.asarray(cov))
    tc, ts = TL.eigh_descending(_t(cov))
    assert _min_abs_cosine(tc.numpy()[:, :K], np.asarray(jc)[:, :K]) >= COSINE_BAR
    np.testing.assert_allclose(ts.numpy()[:K], np.asarray(js)[:K], rtol=1e-4)
    assert np.all(np.diff(ts.numpy()) <= 0)
    # sign_flip makes the components' signs directly comparable
    np.testing.assert_allclose(tc.numpy()[:, :K], np.asarray(jc)[:, :K], atol=1e-3)


def test_explained_variance(rng):
    s = np.sort(rng.uniform(0.1, 10, size=N).astype(np.float32))[::-1].copy()
    np.testing.assert_allclose(
        TL.explained_variance(_t(s), K).numpy(),
        np.asarray(JL.explained_variance(jnp.asarray(s), K)),
        rtol=1e-6,
    )


def test_pca_fit_from_cov(cov):
    jpc, jev = JL.pca_fit_from_cov(jnp.asarray(cov), K)
    tpc, tev = TL.pca_fit_from_cov(_t(cov), K)
    assert tpc.shape == (N, K) and tev.shape == (K,)
    assert _min_abs_cosine(tpc.numpy(), np.asarray(jpc)) >= COSINE_BAR
    np.testing.assert_allclose(tev.numpy(), np.asarray(jev), rtol=1e-4)


@pytest.mark.parametrize("solver", ["randomized", "svd", "auto"])
def test_pca_fit_from_cov_unported_solvers(cov, solver):
    with pytest.raises(NotImplementedError, match=solver):
        TL.pca_fit_from_cov(_t(cov), K, solver=solver)


@pytest.mark.parametrize("mean_centering", [False, True])
@pytest.mark.parametrize(
    "precision,jax_precision",
    [("highest", lax.Precision.HIGHEST), ("high", lax.Precision.HIGH)],
)
def test_pca_fit_local(x, mean_centering, precision, jax_precision):
    jpc, jev = JL.pca_fit_local(
        jnp.asarray(x), K, mean_centering=mean_centering, precision=jax_precision
    )
    tpc, tev = TL.pca_fit_local(
        _t(x), K, mean_centering=mean_centering, precision=precision
    )
    assert _min_abs_cosine(tpc.numpy(), np.asarray(jpc)) >= COSINE_BAR
    np.testing.assert_allclose(tev.numpy(), np.asarray(jev), rtol=1e-4)


def test_project(x, rng):
    pc = rng.normal(size=(N, K)).astype(np.float32)
    ref = np.asarray(JL.project(jnp.asarray(x), jnp.asarray(pc)))
    out = TL.project(_t(x), _t(pc)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_min_cosine_vs_f64_oracle(x):
    pc, _ = TL.pca_fit_local(_t(x), K, precision="high")
    ours = TL.min_cosine_vs_f64_oracle(x, pc, K)
    assert ours == JL.min_cosine_vs_f64_oracle(x, pc.numpy(), K)
    assert ours >= COSINE_BAR
