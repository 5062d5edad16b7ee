"""The port's scaler moments and standardized covariance against the JAX
package's.

``finalize_moments`` and ``standardized_cov_from_stats`` get the same
statistics on both sides: f64 arrays to JAX (the suite runs it with x64) and
f32 tensors to the port, from f32 data with a constant feature and a feature
whose mean sits 10 standard deviations from zero. Results agree at
rtol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.ops import linalg as JL
from spark_rapids_ml_tpu.ops import scaler as JS
from spark_rapids_ml_tpu_torch.ops import linalg as TL
from spark_rapids_ml_tpu_torch.ops import scaler as TS


@pytest.fixture(scope="module")
def x():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(1000, 6)).astype(np.float32)
    x[:, 1] = 3.0          # constant: zero variance, left unscaled
    x[:, 4] += 10.0        # mean offset of 10
    x[:, 5] *= 4.0
    return x


def _stats(x):
    xd = x.astype(np.float64)
    return float(len(x)), xd.sum(0), xd.T @ xd


def test_finalize_moments_matches_jax(x):
    count, total, gram = _stats(x)
    total_sq = np.diag(gram).copy()
    jm, js = JS.finalize_moments(JS.MomentStats(jnp.asarray(count), jnp.asarray(total),
                                                jnp.asarray(total_sq)))
    tm, ts = TS.finalize_moments(TS.MomentStats(
        torch.tensor(count), torch.from_numpy(total).float(), torch.from_numpy(total_sq).float()
    ))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-5, atol=1e-6)
    assert ts[1].item() == 0.0  # the constant feature, clipped at zero
    # the sample (m − 1) std of StandardScaler
    np.testing.assert_allclose(ts.numpy(), x.astype(np.float64).std(0, ddof=1), rtol=1e-5,
                               atol=1e-6)


def test_finalize_moments_guards_tiny_counts():
    one = TS.MomentStats(torch.tensor(1.0), torch.tensor([2.0]), torch.tensor([4.0]))
    mean, std = TS.finalize_moments(one)
    assert mean.item() == 2.0 and std.item() == 0.0
    empty = TS.MomentStats(torch.tensor(0.0), torch.tensor([0.0]), torch.tensor([0.0]))
    mean, std = TS.finalize_moments(empty)
    assert mean.item() == 0.0 and std.item() == 0.0


def test_standardized_cov_matches_jax(x):
    count, total, gram = _stats(x)
    jcov, jmean, jstd = JL.standardized_cov_from_stats(
        JL.GramStats(jnp.asarray(gram), jnp.asarray(total), jnp.asarray(count))
    )
    tcov, tmean, tstd = TL.standardized_cov_from_stats(TL.GramStats(
        torch.from_numpy(gram).float(), torch.from_numpy(total).float(), torch.tensor(count)
    ))
    np.testing.assert_allclose(tmean.numpy(), np.asarray(jmean), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tstd.numpy(), np.asarray(jstd), rtol=1e-5, atol=1e-6)
    jcov = np.asarray(jcov)
    # f32 cancellation in XᵀX − m·μμᵀ on the offset feature: an absolute
    # error of ~1e-7·m·(μ² + σ²) before scaling, below 1e-5·max|cov| here
    np.testing.assert_allclose(tcov.numpy(), jcov, rtol=1e-5, atol=1e-5 * np.abs(jcov).max())


def test_standardized_cov_is_the_scatter_of_standardized_rows(x):
    count, total, gram = _stats(x)
    cov, mean, std = TL.standardized_cov_from_stats(TL.GramStats(
        torch.from_numpy(gram), torch.from_numpy(total), torch.tensor(count, dtype=torch.float64)
    ))
    xd = x.astype(np.float64)
    sd = xd.std(0, ddof=1)
    xs = (xd - xd.mean(0)) / np.where(sd > 0, sd, 1.0)
    np.testing.assert_allclose(cov.numpy(), xs.T @ xs, rtol=1e-9, atol=1e-9)
