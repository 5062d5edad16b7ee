"""Each function of the port's ops/linalg.py against its JAX counterpart.

Inputs are f32 numpy arrays from a seed, handed to both packages. The data
has a separated spectrum (rank-64 mix plus noise), so the leading
components are well determined and comparable: eigenvectors by min
|cosine| >= 0.9999, eigenvalues and explained variance at rtol 1e-4.

The one-bf16-pass tier (``"default"``, and the ``bf16_f32acc`` policy) is
held against the JAX package's ``policy_matmul(..., "bf16_f32acc")``, which
computes that tier's semantics on the CPU (JAX's ``Precision.DEFAULT`` is an
f32 product there). The randomized solver is held against the JAX one given
the JAX one's own sketch Ω (``omega``), since torch cannot draw
``jax.random``'s numbers; QR factors are compared by RᵀR, since the two
libraries may choose other row signs.
"""

import jax
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


# bf16 rounds x by a relative δ with |δ| ≤ 2⁻⁹, so the one-pass diagonal
# Σhi² = Σx²(1 + 2δ + δ²) lies within (2⁻⁸ + 2⁻¹⁸)·Σx² of the port's Σx²
ONE_PASS_DIAG_RTOL = 2.0**-8 + 2.0**-18


def _assert_one_pass_gram(xtx, ref, x64):
    """The port's one-pass XᵀX against JAX's bf16 product: off the diagonal
    both sum the same exact products in f32 (1e-5·max|G|); on it the port
    holds the exact Σx² (ONE_PASS_DIAG_RTOL of JAX's Σhi², and 1e-5 of the
    f64 Σx²)."""
    off = ~np.eye(ref.shape[0], dtype=bool)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(xtx[off], ref[off], rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(np.diag(xtx), np.diag(ref), rtol=ONE_PASS_DIAG_RTOL)
    np.testing.assert_allclose(np.diag(xtx), (x64**2).sum(0), rtol=1e-5)


def test_gram_stats_default_tier_not_ported(x):
    """The ``"default"`` tier, ported: one bf16 pass with an f32 result,
    against the JAX package's bf16_f32acc product (the one-pass semantics
    that JAX's CPU backend does not give ``Precision.DEFAULT``) and its
    ``gram_stats`` column sums and count."""
    ref_xtx = np.asarray(JL.policy_matmul(jnp.asarray(x).T, jnp.asarray(x), policy="bf16_f32acc"))
    ref = JL.gram_stats(jnp.asarray(x), precision=lax.Precision.DEFAULT)
    out = TL.gram_stats(_t(x), precision="default")
    _assert_one_pass_gram(out.xtx.numpy(), ref_xtx, x.astype(np.float64))
    np.testing.assert_allclose(out.col_sum.numpy(), np.asarray(ref.col_sum), rtol=1e-5,
                               atol=1e-5 * np.sqrt(ROWS) * np.abs(x).max())
    assert out.count.item() == float(ref.count) == ROWS
    with pytest.raises(ValueError):
        TL.gram_stats(_t(x), precision="fast")


@pytest.mark.parametrize("policy", ["f32", "bf16_f32acc"])
def test_policy_matmul(x, rng, policy):
    w = rng.uniform(0.5, 2.0, size=ROWS).astype(np.float32)
    xw = x * w[:, None]
    ref = np.asarray(JL.policy_matmul(jnp.asarray(x).T, jnp.asarray(xw), policy=policy))
    out = TL.policy_matmul(_t(x).T, _t(xw), policy=policy)
    assert out.dtype == torch.float32
    # both sum exact products (f32 ones, or bf16 ones exact in f32) in f32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    with pytest.raises(ValueError, match="policy"):
        TL.policy_matmul(_t(x).T, _t(x), policy="int8_dist")


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
def test_pca_fit_from_cov_unported_solvers(cov, x, solver, monkeypatch):
    """The three solvers, ported, against the JAX package.

    - ``randomized``: the port's solver handed the JAX solver's sketch Ω
      (the result depends on Ω here: k + 10 < 64 columns do not converge on
      this rank-64 covariance): components to min |cos| ≥ 0.9999,
      explained variance with its trace-based tail at rtol 1e-4.
    - ``svd`` is not a covariance solver: both packages refuse it here with
      ``ValueError``, and its direct path (``svd_from_r`` of the rows' R)
      agrees with JAX's.
    - ``auto`` at n = 96 < 256 is ``full`` in both, bit-equal in the port.
    """
    tcov = _t(cov)
    if solver == "randomized":
        seeded = TL.randomized_eigh_descending
        omega = _t(_jax_omega(N, K + 10))
        monkeypatch.setattr(TL, "randomized_eigh_descending",
                            lambda *a, **kw: seeded(*a, **kw, omega=omega))
        jpc, jev = JL.pca_fit_from_cov(jnp.asarray(cov), K, solver=solver)
        tpc, tev = TL.pca_fit_from_cov(tcov, K, solver=solver)
        assert _min_abs_cosine(tpc.numpy(), np.asarray(jpc)) >= COSINE_BAR
        np.testing.assert_allclose(tev.numpy(), np.asarray(jev), rtol=1e-4)
    elif solver == "svd":
        with pytest.raises(ValueError, match="solver"):
            JL.pca_fit_from_cov(jnp.asarray(cov), K, solver=solver)
        with pytest.raises(ValueError, match="solver"):
            TL.pca_fit_from_cov(tcov, K, solver=solver)
        jpc, jev = JL.svd_from_r(JL.qr_r(jnp.asarray(x)), K)
        tpc, tev = TL.svd_from_r(TL.qr_r(_t(x)), K)
        assert _min_abs_cosine(tpc.numpy(), np.asarray(jpc)) >= COSINE_BAR
        np.testing.assert_allclose(tev.numpy(), np.asarray(jev), rtol=1e-4)
    else:
        jpc, jev = JL.pca_fit_from_cov(jnp.asarray(cov), K, solver=solver)
        tpc, tev = TL.pca_fit_from_cov(tcov, K, solver=solver)
        assert _min_abs_cosine(tpc.numpy(), np.asarray(jpc)) >= COSINE_BAR
        np.testing.assert_allclose(tev.numpy(), np.asarray(jev), rtol=1e-4)
        fpc, fev = TL.pca_fit_from_cov(tcov, K, solver="full")
        assert torch.equal(tpc, fpc) and torch.equal(tev, fev)


@pytest.mark.parametrize("mean_centering", [False, True])
@pytest.mark.parametrize(
    "precision,jax_precision",
    [("highest", lax.Precision.HIGHEST), ("high", lax.Precision.HIGH)],
)
def test_pca_fit_local(x, mean_centering, precision, jax_precision):
    _check_pca_fit_local(x, mean_centering, precision, jax_precision)


@pytest.mark.parametrize("mean_centering", [False, True])
def test_pca_fit_local_default_precision(x, mean_centering):
    """One bf16 pass against JAX's ``Precision.DEFAULT``, which is an f32
    product on the CPU: the leading components agree to the usual bar, and
    explained variance to rtol 2e-3. The bf16 rounding of x perturbs the
    Gram by about 2⁻⁹·|x|²·√rows per entry, which moves the noise floor's
    32 small eigenvalues (the bulk of Σs over the full spectrum) and so all
    the ratios together: 5.4e-4 measured at this size and seed."""
    jpc, jev = JL.pca_fit_local(jnp.asarray(x), K, mean_centering=mean_centering,
                                precision=lax.Precision.DEFAULT)
    tpc, tev = TL.pca_fit_local(_t(x), K, mean_centering=mean_centering, precision="default")
    assert _min_abs_cosine(tpc.numpy(), np.asarray(jpc)) >= COSINE_BAR
    np.testing.assert_allclose(tev.numpy(), np.asarray(jev), rtol=2e-3)


def _check_pca_fit_local(x, mean_centering, precision, jax_precision):
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


def _decaying_cov(n=N, seed=5):
    """An f32 PSD matrix with a geometric spectrum 100·0.5^i and random
    eigenvectors (the regime randomized solvers target)."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    evals = 100.0 * 0.5 ** np.arange(n)
    return ((q * evals) @ q.T).astype(np.float32)


def _jax_omega(n, l, seed=0):
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), (n, l), dtype=jnp.float32))


@pytest.mark.parametrize("k,power_iters", [(K, 2), (20, 2), (K, 0)])
def test_randomized_eigh_descending_with_jax_sketch(cov, k, power_iters):
    """Given the JAX solver's own Ω, the port runs the same HMT steps: on
    the rank-64 covariance, where k + 10 < 64 columns cannot converge and
    the result depends on Ω, both agree to f32 rounding (components to min
    |cos| ≥ 0.9999 and 1e-4 elementwise after the shared sign rule, all
    l Ritz singular values at rtol 1e-5)."""
    l = k + 10
    ju, js, jt = JL.randomized_eigh_descending(jnp.asarray(cov), k, power_iters=power_iters)
    tu, ts, tt = TL.randomized_eigh_descending(
        _t(cov), k, power_iters=power_iters, omega=_t(_jax_omega(N, l))
    )
    assert tu.shape == (N, k) and ts.shape == (l,)
    assert _min_abs_cosine(tu.numpy(), np.asarray(ju)) >= COSINE_BAR
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5)
    assert float(tt) == float(jt) == N - l


def test_randomized_matches_exact_on_decaying_spectrum():
    """tests/test_linalg.py's check, on the port: with a decaying spectrum
    the top-k subspace and singular values agree with the exact ones
    whatever the sketch (the port's seeded Ω here)."""
    cov = _decaying_cov().astype(np.float64)
    evals, evecs = np.linalg.eigh(cov)
    u, s, tail = TL.randomized_eigh_descending(torch.from_numpy(cov), 5, power_iters=3)
    assert s.shape == (15,)
    np.testing.assert_allclose(s.numpy()[:5] ** 2, evals[::-1][:5], rtol=1e-6)
    np.testing.assert_allclose(np.abs(u.numpy()), np.abs(evecs[:, ::-1][:, :5]), atol=1e-5)
    assert int(tail) == N - 15


def test_randomized_sketch_is_seeded_and_shaped(cov):
    a = TL.randomized_eigh_descending(_t(cov), K, seed=3)
    b = TL.randomized_eigh_descending(_t(cov), K, seed=3)
    assert all(torch.equal(p, q) for p, q in zip(a, b))
    for j in range(K):  # the exact path's orientation rule
        col = a[0][:, j]
        assert col[torch.argmax(col.abs())] > 0
    with pytest.raises(ValueError, match="omega"):
        TL.randomized_eigh_descending(_t(cov), K, omega=torch.zeros((N, K)))


def test_explained_variance_from_partial(rng):
    s = np.sort(rng.uniform(1, 10, size=16))[::-1].astype(np.float32)
    trace, tail = float((s**2).sum() * 1.3), 80.0
    ref = np.asarray(JL.explained_variance_from_partial(
        jnp.asarray(s), jnp.asarray(trace, jnp.float32), jnp.asarray(tail, jnp.float32)))
    out = TL.explained_variance_from_partial(_t(s), torch.tensor(trace), torch.tensor(tail))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6)
    # the √(m·trace_tail) estimate is exact for a flat tail
    evals = np.concatenate([[100.0, 90.0, 80.0, 70.0], np.full(36, 2.0)])
    out = TL.explained_variance_from_partial(
        torch.from_numpy(np.sqrt(evals[:4])), torch.tensor(evals.sum()), torch.tensor(36.0))
    np.testing.assert_allclose(out.numpy(), np.sqrt(evals[:4]) / np.sqrt(evals).sum(), rtol=1e-12)


@pytest.mark.parametrize("n,k,oversample", [
    (512, 50, 10), (512, 50, 20), (512, 120, 10), (256, 54, 10), (255, 10, 10),
    (128, 50, 10), (100, 10, 10), (4096, 1000, 10),
])
def test_randomized_profitable_is_the_jax_rule(n, k, oversample):
    assert TL.randomized_profitable(n, k, oversample=oversample) == JL.randomized_profitable(
        n, k, oversample=oversample)


def test_auto_takes_randomized_above_the_threshold():
    """n = 256, k = 6: l = 16 ≤ 64, so "auto" is "randomized", bit-equal."""
    cov = _t(_decaying_cov(n=256))
    assert TL.randomized_profitable(256, K)
    auto = TL.pca_fit_from_cov(cov, K, solver="auto")
    rand = TL.pca_fit_from_cov(cov, K, solver="randomized")
    assert all(torch.equal(a, b) for a, b in zip(auto, rand))
    with pytest.raises(ValueError, match="bogus"):
        TL.pca_fit_from_cov(cov, K, solver="bogus")


@pytest.mark.parametrize("rows", [500, 50, N])
def test_qr_r_matches_jax_by_rtr(x, rows):
    """R is [n, n] (zero-padded below n rows) and RᵀR = XᵀX; compared by
    RᵀR at 1e-5 of its scale, since the row signs of R are the library's
    choice."""
    a = x[:rows]
    jr = np.asarray(JL.qr_r(jnp.asarray(a)))
    tr = TL.qr_r(_t(a)).numpy()
    assert tr.shape == jr.shape == (N, N)
    assert np.allclose(np.tril(tr, -1), 0.0)
    ref = jr.T.astype(np.float64) @ jr
    np.testing.assert_allclose(tr.T.astype(np.float64) @ tr, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    gram = a.T.astype(np.float64) @ a
    np.testing.assert_allclose(tr.T.astype(np.float64) @ tr, gram, rtol=0,
                               atol=1e-5 * np.abs(gram).max())


def test_combine_r_matches_jax_by_rtr(x):
    a, b = x[:1000], x[1000:2500]
    jr = np.asarray(JL.combine_r(JL.qr_r(jnp.asarray(a)), JL.qr_r(jnp.asarray(b))))
    tr = TL.combine_r(TL.qr_r(_t(a)), TL.qr_r(_t(b))).numpy()
    ref = jr.T.astype(np.float64) @ jr
    np.testing.assert_allclose(tr.T.astype(np.float64) @ tr, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


def test_svd_components_from_r(x):
    r = np.array(JL.qr_r(jnp.asarray(x)))
    jc, js = JL.svd_components_from_r(jnp.asarray(r), K)
    tc, ts = TL.svd_components_from_r(_t(r), K)
    assert tc.shape == (N, K) and ts.shape == (N,)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-4)
    # sign_flip orients both alike
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-4)


@pytest.mark.parametrize("mean_centering", [False, True])
def test_pca_fit_local_svd(x, mean_centering):
    jpc, jev = JL.pca_fit_local_svd(jnp.asarray(x), K, mean_centering=mean_centering)
    tpc, tev = TL.pca_fit_local_svd(_t(x), K, mean_centering=mean_centering)
    assert _min_abs_cosine(tpc.numpy(), np.asarray(jpc)) >= COSINE_BAR
    np.testing.assert_allclose(tev.numpy(), np.asarray(jev), rtol=1e-4)
    # and the Gram path's answer
    gpc, gev = TL.pca_fit_local(_t(x), K, mean_centering=mean_centering)
    assert _min_abs_cosine(tpc.numpy(), gpc.numpy()) >= COSINE_BAR
    np.testing.assert_allclose(tev.numpy(), gev.numpy(), rtol=1e-4)
