"""The port's linear family against the JAX package's, op by op and fit by
fit.

Both packages get the same f32 rows, made from a numpy seed; the port runs
with device="cpu". The suite runs JAX with x64: its ops compute in f32 where
every input is f32, and its estimators' Newton loops in f64 (their start is
an f64 numpy vector). The port's estimators sum f32 products into f64
statistics and solve in f64. Tolerances, each stated where it is used:

- statistics of one block (``linear_stats``, the Newton and softmax
  statistics) from the same f32 inputs: rtol 1e-5 of each field's largest
  entry (the backends sum the f32 products in different orders);
- solves on the same f64 statistics (``solve_normal``, ``solve_elastic_net``,
  ``newton_update``): atol 1e-9 relative to the solution's largest entry;
- whole fits: coefficients and intercepts atol 2e-5 relative to the
  largest coefficient for LinearRegression (f32 statistics in JAX, f64 sums
  of f32 products here), 1e-5 for the Newton fits (both converge to
  tol 1e-6 on the same objective); multinomial fits are compared by their
  probabilities (atol 1e-5) and their intercepts up to the class-shift
  direction the softmax leaves free.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

from spark_rapids_ml_tpu.models import linear as JM
from spark_rapids_ml_tpu.ops import linear as JLIN
from spark_rapids_ml_tpu.utils import columnar as JC
from spark_rapids_ml_tpu_torch import (
    LinearRegression,
    LinearRegressionModel,
    LinearSVC,
    LinearSVCModel,
    LogisticRegression,
    LogisticRegressionModel,
)
from spark_rapids_ml_tpu_torch.convert import model_from_arrays
from spark_rapids_ml_tpu_torch.models import linear as TM
from spark_rapids_ml_tpu_torch.models.base import Saveable
from spark_rapids_ml_tpu_torch.ops import linear as LIN
from spark_rapids_ml_tpu_torch.utils import columnar as TC

CPU = torch.device("cpu")
STATS_RTOL = 1e-5
SOLVE_RTOL = 1e-9
LINREG_RTOL = 2e-5
NEWTON_ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _reg_data(rows=600, n=7, seed=3, offset=1.5):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(rows, n)) + offset).astype(np.float32)
    beta = rng.normal(size=n)
    y = (x @ beta + 0.7 + 0.1 * rng.normal(size=rows)).astype(np.float32)
    w = rng.uniform(0.2, 2.0, size=rows)
    return x, y, w


def _cls_data(rows=600, n=6, seed=5, classes=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, n)).astype(np.float32)
    if classes == 2:
        y = (x @ rng.normal(size=n) + 0.5 * rng.normal(size=rows) > 0.2).astype(np.float64)
    else:
        logits = x @ rng.normal(size=(n, classes)) + rng.normal(size=(rows, classes))
        y = np.argmax(logits, axis=1).astype(np.float64)
    return x, y, rng.uniform(0.2, 2.0, size=rows)


def _close(got, ref, rtol, scale=None):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max() if scale is None else scale
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * max(scale, 1e-30))


def _stats_close(port, jax_stats, rtol=STATS_RTOL):
    assert port._fields == jax_stats._fields
    for name, got, ref in zip(port._fields, port, jax_stats):
        _close(got.numpy(), np.asarray(ref), rtol), name


# -- columnar ----------------------------------------------------------------


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("partitions", [None, 3])
def test_labeled_partitions_match_jax(weighted, partitions):
    x, y, w = _reg_data(rows=50)
    data = (x, y, w) if weighted else (x, y)
    got = TC.labeled_partitions(data, None, None, partitions)
    ref = JC.labeled_partitions(data, None, None, partitions)
    assert len(got) == len(ref)
    for (gx, gy, gw), (rx, ry, rw) in zip(got, ref):
        np.testing.assert_array_equal(gx, rx)
        np.testing.assert_array_equal(gy, ry)
        assert (gw is None) == (rw is None)
        if gw is not None:
            np.testing.assert_array_equal(gw, rw)


def test_labeled_partitions_from_a_frame_and_their_checks():
    x, y, w = _reg_data(rows=40)
    df = pd.DataFrame({"f": list(x), "label": y, "wt": w})
    got = TC.labeled_partitions(df, "f", "label", 2, weight_col="wt")
    ref = JC.labeled_partitions(df, "f", "label", 2, weight_col="wt")
    for g, r in zip(got, ref):
        for a, b in zip(g, r):
            np.testing.assert_array_equal(a, b)
    for bad, match in [((x, y[:-1]), "labels have"), ((x, y, -w), "non-negative"),
                       ((x, y, 0 * w), "all instance weights are zero")]:
        with pytest.raises(ValueError, match=match):
            TC.labeled_partitions(bad, None, None)
        with pytest.raises(ValueError, match=match):
            JC.labeled_partitions(bad, None, None)


@pytest.mark.parametrize("weighted", [False, True])
def test_pad_labeled_and_batch_match_jax(weighted):
    x, y, w = _reg_data(rows=37)
    sw = w if weighted else None
    for a, b in zip(TC.pad_labeled(x, y, sw), JC.pad_labeled(x, y, sw)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    xi = (x * 10).astype(np.int32)
    for a, b in zip(TC.pad_labeled_batch(xi, y, sw), JC.pad_labeled_batch(xi, y, sw)):
        np.testing.assert_array_equal(a, b)


# -- normal equations ----------------------------------------------------------


def test_augment_matches_jax():
    x, _, _ = _reg_data(rows=9)
    np.testing.assert_array_equal(LIN.augment(_t(x)).numpy(), np.asarray(JLIN.augment(jnp.asarray(x))))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("policy", ["f32", "bf16_f32acc"])
def test_linear_stats_match_jax(weighted, policy):
    x, y, w = _reg_data()
    w32 = w.astype(np.float32)
    got = LIN.linear_stats(_t(x), _t(y), _t(w32) if weighted else None, policy=policy)
    ref = JLIN.linear_stats(jnp.asarray(x), jnp.asarray(y),
                            jnp.asarray(w32) if weighted else None, policy=policy)
    _stats_close(got, ref)


def test_fold_step_is_in_place_and_equals_the_out_of_place_fold():
    x, y, w = _reg_data()
    w32 = _t(w.astype(np.float32))
    carry = LIN.init_linear_carry(x.shape[1], CPU)
    assert all(v.dtype == torch.float64 for v in carry)
    buffers = [v.data_ptr() for v in carry]
    step = LIN.linear_fold_step()
    for lo, hi in [(0, 200), (200, 450), (450, 600)]:
        carry = step(carry, _t(x[lo:hi]), _t(y[lo:hi]), w32[lo:hi])
    assert [v.data_ptr() for v in carry] == buffers
    out = LIN.init_linear_carry(x.shape[1], CPU, dtype=torch.float32)
    for lo, hi in [(0, 200), (200, 450), (450, 600)]:
        out = LIN.fold_linear_stats(out, _t(x[lo:hi]), _t(y[lo:hi]), w32[lo:hi])
    ref = JLIN.init_linear_carry(x.shape[1], jnp.float32)
    for lo, hi in [(0, 200), (200, 450), (450, 600)]:
        ref = JLIN.fold_linear_stats(ref, jnp.asarray(x[lo:hi]), jnp.asarray(y[lo:hi]),
                                     jnp.asarray(w[lo:hi].astype(np.float32)))
    _stats_close(out, ref)
    _stats_close(LIN.as_f64(out), ref)
    _stats_close(carry, ref)


def _f64_stats(x, y, w=None):
    stats = JLIN.linear_stats(jnp.asarray(x, jnp.float64), jnp.asarray(y, jnp.float64),
                              None if w is None else jnp.asarray(w, jnp.float64))
    port = LIN.LinearStats(*(torch.from_numpy(np.asarray(v)) for v in stats))
    return port, stats


@pytest.mark.parametrize("fit_intercept", [True, False])
@pytest.mark.parametrize("reg_param", [0.0, 0.05])
def test_solve_normal_matches_jax(fit_intercept, reg_param):
    x, y, w = _reg_data()
    port, ref = _f64_stats(x, y, w)
    coef, b = LIN.solve_normal(port, reg_param=reg_param, fit_intercept=fit_intercept)
    rcoef, rb = JLIN.solve_normal(ref, reg_param=reg_param, fit_intercept=fit_intercept)
    _close(coef.numpy(), np.asarray(rcoef), SOLVE_RTOL)
    _close(b.numpy(), np.asarray(rb), SOLVE_RTOL, scale=np.abs(np.asarray(rcoef)).max())


@pytest.mark.parametrize("case", ["zero_column", "duplicate_column", "constant_column"])
def test_rank_deficient_design_falls_back_to_min_norm_like_jax(case):
    """A zero column without an intercept fails the Cholesky factorization
    in both packages; a duplicated column, and a constant one beside the
    intercept, make A singular: both packages end at the min-norm
    least-squares solution (pinv here, lstsq there), which splits a
    duplicated column's weight evenly."""
    x, y, _ = _reg_data(rows=200, n=4, offset=0.0)
    fit_intercept = case == "constant_column"
    if case == "zero_column":
        x[:, 2] = 0.0
    elif case == "duplicate_column":
        x[:, 3] = x[:, 1]
    else:
        x[:, 0] = 1.0
    port, ref = _f64_stats(x, y)
    coef, b = LIN.solve_normal(port, fit_intercept=fit_intercept)
    rcoef, rb = JLIN.solve_normal(ref, fit_intercept=fit_intercept)
    assert np.isfinite(coef.numpy()).all()
    _close(coef.numpy(), np.asarray(rcoef), 1e-6)
    _close(b.numpy(), np.asarray(rb), 1e-6, scale=1.0)
    if case == "zero_column":
        assert coef[2] == 0.0
    if case == "duplicate_column":
        assert coef[1].item() == pytest.approx(coef[3].item(), rel=1e-9)


def test_soft_threshold_and_power_lam_max_match_jax():
    rng = np.random.default_rng(0)
    v = rng.normal(size=40)
    np.testing.assert_array_equal(
        LIN._soft_threshold(_t(v), 0.3).numpy(), np.asarray(JLIN._soft_threshold(jnp.asarray(v), 0.3))
    )
    m = rng.normal(size=(30, 12))
    for a in (m.T @ m, np.zeros((5, 5)), np.diag([1.0, -1.0, 0.0]) @ np.diag([1.0, -1.0, 0.0])):
        got = LIN._power_lam_max(_t(a)).item()
        ref = float(JLIN._power_lam_max(jnp.asarray(a)))
        assert got == pytest.approx(ref, rel=1e-12, abs=1e-300)
    # the estimate never falls below λmax (it feeds FISTA's step 1/L)
    assert LIN._power_lam_max(_t(m.T @ m)).item() >= np.linalg.eigvalsh(m.T @ m).max()


@pytest.mark.parametrize("alpha", [0.3, 1.0])
@pytest.mark.parametrize("fit_intercept", [True, False])
def test_solve_elastic_net_matches_jax(alpha, fit_intercept):
    x, y, w = _reg_data()
    port, ref = _f64_stats(x, y, w)
    kw = dict(reg_param=0.05, elastic_net_param=alpha, fit_intercept=fit_intercept)
    coef, b = LIN.solve_elastic_net(port, **kw)
    rcoef, rb = JLIN.solve_elastic_net(ref, **kw)
    _close(coef.numpy(), np.asarray(rcoef), SOLVE_RTOL)
    _close(b.numpy(), np.asarray(rb), SOLVE_RTOL, scale=np.abs(np.asarray(rcoef)).max())
    got = LIN.solve_from_stats(port, **kw)
    np.testing.assert_array_equal(got[0].numpy(), coef.numpy())
    with pytest.raises(ValueError, match="elastic_net_param"):
        LIN.solve_elastic_net(port, reg_param=0.1, elastic_net_param=1.5)


def test_solve_from_stats_dispatches_alpha_zero_to_the_closed_form():
    x, y, _ = _reg_data()
    port, _ = _f64_stats(x, y)
    a = LIN.solve_from_stats(port, reg_param=0.1)
    b = LIN.solve_normal(port, reg_param=0.1)
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())


def test_predict_linear_matches_jax():
    x, _, _ = _reg_data(rows=33)
    coef = np.linspace(-1, 1, x.shape[1]).astype(np.float32)
    got = LIN.predict_linear(_t(x), _t(coef), torch.tensor(0.5)).numpy()
    ref = np.asarray(JLIN.predict_linear(jnp.asarray(x), jnp.asarray(coef), jnp.float32(0.5)))
    _close(got, ref, 1e-6)


# -- Newton ----------------------------------------------------------------------


@pytest.mark.parametrize("loss", ["logistic", "svc"])
@pytest.mark.parametrize("weighted", [False, True])
def test_newton_stats_match_jax(loss, weighted):
    x, y, w = _cls_data()
    xa = np.concatenate([x, np.ones((len(x), 1), np.float32)], axis=1)
    y32 = y.astype(np.float32)
    wf = (0.1 * np.arange(xa.shape[1]) - 0.2).astype(np.float32)
    w32 = w.astype(np.float32) if weighted else None
    port_fn = LIN.logistic_newton_stats if loss == "logistic" else LIN.svc_newton_stats
    jax_fn = JLIN.logistic_newton_stats if loss == "logistic" else JLIN.svc_newton_stats
    got = port_fn(_t(xa), _t(y32), _t(wf), None if w32 is None else _t(w32))
    ref = jax_fn(jnp.asarray(xa), jnp.asarray(y32), jnp.asarray(wf),
                 None if w32 is None else jnp.asarray(w32))
    _stats_close(got, ref)


def _f64_newton_stats(x, y, wf, classes=None):
    xa = np.concatenate([x, np.ones((len(x), 1))], axis=1).astype(np.float64)
    if classes is None:
        ref = JLIN.logistic_newton_stats(jnp.asarray(xa), jnp.asarray(y), jnp.asarray(wf))
        cls = LIN.NewtonStats
    else:
        ref = JLIN.softmax_newton_stats(jnp.asarray(xa), jnp.asarray(y.astype(np.int32)),
                                        jnp.asarray(wf), classes)
        cls = LIN.SoftmaxStats
    return cls(*(torch.from_numpy(np.asarray(v)) for v in ref)), ref


@pytest.mark.parametrize("alpha", [0.0, 0.5])
@pytest.mark.parametrize("fit_intercept", [True, False])
def test_newton_update_matches_jax(alpha, fit_intercept):
    x, y, _ = _cls_data()
    wf = np.linspace(-0.3, 0.3, x.shape[1] + 1)
    port, ref = _f64_newton_stats(x, y, wf)
    kw = dict(reg_param=0.02, elastic_net_param=alpha, fit_intercept=fit_intercept)
    new_w, step = LIN.newton_update(_t(wf), port, **kw)
    rw, rstep = JLIN.newton_update(jnp.asarray(wf), ref, **kw)
    _close(new_w.numpy(), np.asarray(rw), SOLVE_RTOL)
    assert step.item() == pytest.approx(float(rstep), rel=1e-8)


def test_newton_update_rejects_a_non_finite_step_like_jax():
    x, y, _ = _cls_data()
    wf = np.zeros(x.shape[1] + 1)
    port, ref = _f64_newton_stats(x, y, wf)
    bad = port._replace(hess=torch.full_like(port.hess, float("nan")))
    new_w, step = LIN.newton_update(_t(wf), bad)
    rw, rstep = JLIN.newton_update(jnp.asarray(wf), ref._replace(hess=jnp.full_like(ref.hess, jnp.nan)))
    assert np.isnan(step.item()) and np.isnan(float(rstep))
    np.testing.assert_array_equal(new_w.numpy(), np.asarray(rw))
    for check in (LIN.check_newton_outcome, JLIN.check_newton_outcome):
        with pytest.raises(ValueError, match="NaN/Inf"):
            check(float("nan"), np.zeros(3))
        check(float("nan"), np.ones(3))  # separable divergence: accepted
        check(0.0, np.zeros(3))


def test_predict_logistic_proba_matches_jax():
    x, _, _ = _cls_data(rows=40)
    coef = np.linspace(-1, 1, x.shape[1]).astype(np.float32)
    got = LIN.predict_logistic_proba(_t(x), _t(coef), torch.tensor(0.25)).numpy()
    ref = np.asarray(JLIN.predict_logistic_proba(jnp.asarray(x), jnp.asarray(coef), jnp.float32(0.25)))
    _close(got, ref, 1e-6, scale=1.0)


@pytest.mark.parametrize("weighted", [False, True])
def test_softmax_newton_stats_match_jax(weighted):
    classes = 4
    x, y, w = _cls_data(classes=classes)
    xa = np.concatenate([x, np.ones((len(x), 1), np.float32)], axis=1)
    wf = (np.linspace(-0.2, 0.2, classes * xa.shape[1])).astype(np.float32)
    w32 = w.astype(np.float32) if weighted else None
    got = LIN.softmax_newton_stats(_t(xa), _t(y.astype(np.int64)), _t(wf), classes,
                                   None if w32 is None else _t(w32))
    ref = JLIN.softmax_newton_stats(jnp.asarray(xa), jnp.asarray(y.astype(np.int32)),
                                    jnp.asarray(wf), classes,
                                    None if w32 is None else jnp.asarray(w32))
    _stats_close(got, ref)
    # the lower blocks are the upper ones mirrored, bit for bit
    h, d = got.hess.numpy(), xa.shape[1]
    np.testing.assert_array_equal(h[d:2 * d, :d], h[:d, d:2 * d].T)


@pytest.mark.parametrize("alpha", [0.0, 0.5])
def test_softmax_newton_update_matches_jax(alpha):
    classes = 3
    x, y, _ = _cls_data(classes=classes)
    wf = np.linspace(-0.2, 0.2, classes * (x.shape[1] + 1))
    port, ref = _f64_newton_stats(x, y, wf, classes)
    kw = dict(reg_param=0.05, elastic_net_param=alpha)
    new_w, step = LIN.softmax_newton_update(_t(wf), port, classes, **kw)
    rw, rstep = JLIN.softmax_newton_update(jnp.asarray(wf), ref, classes, **kw)
    # the class-shift direction is pinned only by the √eps ridge: the f64
    # solve runs at a condition near 1e8, so 1e-7 instead of SOLVE_RTOL
    _close(new_w.numpy(), np.asarray(rw), 1e-7)
    assert step.item() == pytest.approx(float(rstep), rel=1e-8)


def test_predict_softmax_proba_matches_jax():
    x, _, _ = _cls_data(rows=40)
    rng = np.random.default_rng(1)
    coef = rng.normal(size=(3, x.shape[1])).astype(np.float32)
    b = rng.normal(size=3).astype(np.float32)
    got = LIN.predict_softmax_proba(_t(x), _t(coef), _t(b)).numpy()
    ref = np.asarray(JLIN.predict_softmax_proba(jnp.asarray(x), jnp.asarray(coef), jnp.asarray(b)))
    _close(got, ref, 1e-6, scale=1.0)


def test_combines_add_fieldwise():
    a = LIN.NewtonStats(*(torch.full((2,), float(i)) for i in range(4)))
    got = LIN.combine_newton_stats(a, a)
    assert [v.tolist() for v in got] == [[2.0 * i] * 2 for i in range(4)]
    s = LIN.SoftmaxStats(*a)
    assert [v.tolist() for v in LIN.combine_softmax_stats(s, s)] == [v.tolist() for v in got]
    lin = LIN.LinearStats(*(torch.ones(1) * i for i in range(6)))
    assert [v.item() for v in LIN.combine_linear_stats(lin, lin)] == [2.0 * i for i in range(6)]


# -- estimators ------------------------------------------------------------------


def _coef_close(port_model, jax_model, rtol):
    scale = np.abs(jax_model.coefficients).max()
    _close(port_model.coefficients, jax_model.coefficients, rtol, scale)
    _close(port_model.intercept, jax_model.intercept, rtol, scale)


LINREG_CASES = {
    "ols": {},
    "ridge": {"regParam": 0.1},
    "elastic": {"regParam": 0.05, "elasticNetParam": 0.5},
    "lasso": {"regParam": 0.02, "elasticNetParam": 1.0},
    "no_intercept": {"fitIntercept": False},
}


@pytest.mark.parametrize("case", sorted(LINREG_CASES))
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("streamed", [False, True])
def test_linear_regression_fit_matches_jax(case, weighted, streamed, monkeypatch):
    if streamed:
        monkeypatch.setenv("TPU_ML_STREAM_FIT_MAX_RESIDENT_BYTES", "1")
        monkeypatch.setenv("TPU_ML_STREAM_CHUNK_ROWS", "128")
    x, y, w = _reg_data()
    data = (x, y, w) if weighted else (x, y)
    kw = LINREG_CASES[case]
    port = LinearRegression(device="cpu", **kw).fit(data, num_partitions=3)
    ref = JM.LinearRegression(**kw).fit(data, num_partitions=3)
    _coef_close(port, ref, LINREG_RTOL)
    assert (port.stream_report is not None) == streamed
    if streamed:
        assert port.stream_report.rows == len(x) and port.stream_report.chunks == 5
        assert port.stream_report.max_put_bytes == 128 * (x.shape[1] + 2) * 4
    np.testing.assert_allclose(port.transform(x), np.asarray(ref.transform(x)), rtol=0,
                               atol=1e-4 * np.abs(y).max())
    assert port.predict(x[0]) == pytest.approx(float(port.transform(x[:1])[0]), rel=1e-5)


def test_linear_regression_weight_col_from_a_frame():
    x, y, w = _reg_data()
    df = pd.DataFrame({"features": list(x), "label": y, "wt": w})
    port = LinearRegression(device="cpu", weightCol="wt").fit(df)
    ref = JM.LinearRegression().setWeightCol("wt").fit(df)
    _coef_close(port, ref, LINREG_RTOL)
    out = port.transform(df)
    np.testing.assert_allclose(out["prediction"].to_numpy(), np.asarray(ref.transform(df)["prediction"]),
                               rtol=0, atol=1e-4 * np.abs(y).max())


def test_singular_design_stays_finite_like_jax():
    rng = np.random.default_rng(42)
    x = np.ones((50, 3))
    y = rng.normal(size=50)
    port = LinearRegression(device="cpu").fit((x, y))
    ref = JM.LinearRegression().fit((x, y))
    assert np.isfinite(port.coefficients).all()
    np.testing.assert_allclose(port.transform(x), np.full(50, y.mean()), atol=1e-5)
    np.testing.assert_allclose(port.coefficients, ref.coefficients, atol=1e-6)


def test_streamed_fold_parks_nonfinite_labels_by_policy(monkeypatch):
    monkeypatch.setenv("TPU_ML_STREAM_FIT_MAX_RESIDENT_BYTES", "1")
    monkeypatch.setenv("TPU_ML_STREAM_CHUNK_ROWS", "128")
    x, y, _ = _reg_data()
    y_bad = y.copy()
    y_bad[5] = np.nan
    with pytest.raises(ValueError, match="non-finite"):
        LinearRegression(device="cpu").fit((x, y_bad))
    monkeypatch.setenv("TPU_ML_NONFINITE_POLICY", "skip")
    model = LinearRegression(device="cpu").fit((x, y_bad))
    assert model.stream_report.skipped_rows == 1
    keep = np.arange(len(x)) != 5
    ref = LinearRegression(device="cpu").fit((x[keep], y[keep]))
    _close(model.coefficients, ref.coefficients, 1e-9)


LOGREG_CASES = {
    "plain": {},
    "l2": {"regParam": 0.01},
    "elastic": {"regParam": 0.01, "elasticNetParam": 0.5},
    "no_intercept": {"regParam": 0.01, "fitIntercept": False},
}


@pytest.mark.parametrize("case", sorted(LOGREG_CASES))
@pytest.mark.parametrize("weighted", [False, True])
def test_binary_logistic_fit_matches_jax(case, weighted):
    x, y, w = _cls_data()
    data = (x, y, w) if weighted else (x, y)
    kw = LOGREG_CASES[case]
    port = LogisticRegression(device="cpu", **kw).fit(data, num_partitions=2)
    ref = JM.LogisticRegression(**kw).fit(data, num_partitions=2)
    _coef_close(port, ref, NEWTON_ATOL)
    _close(port.predict_proba_matrix(x), np.asarray(ref.predict_proba_matrix(x)), NEWTON_ATOL, 1.0)
    np.testing.assert_array_equal(port.transform(x), np.asarray(ref.transform(x)))
    assert port.numClasses == 2


@pytest.mark.parametrize("alpha", [0.0, 0.5])
@pytest.mark.parametrize("fit_intercept", [True, False])
def test_multinomial_fit_matches_jax(alpha, fit_intercept):
    x, y, w = _cls_data(classes=4)
    kw = dict(regParam=0.02, elasticNetParam=alpha, fitIntercept=fit_intercept)
    port = LogisticRegression(device="cpu", **kw).fit((x, y, w), num_partitions=3)
    ref = JM.LogisticRegression(**kw).fit((x, y, w), num_partitions=3)
    assert port.numClasses == ref.numClasses == 4 and port.coefficients is None
    _close(port.predict_proba_matrix(x), np.asarray(ref.predict_proba_matrix(x)), NEWTON_ATOL, 1.0)
    _close(port.coefficientMatrix, ref.coefficientMatrix, 1e-4)
    # intercepts up to the class-shift direction the softmax leaves free
    centred = lambda b: np.asarray(b) - np.mean(b)  # noqa: E731
    _close(centred(port.interceptVector), centred(ref.interceptVector), 1e-4, 1.0)
    np.testing.assert_array_equal(port.transform(x), np.asarray(ref.transform(x)))
    assert port.predict(x[3]) == ref.predict(x[3])


@pytest.mark.parametrize("weighted", [False, True])
def test_linear_svc_fit_matches_jax(weighted):
    x, y, w = _cls_data()
    data = (x, y, w) if weighted else (x, y)
    port = LinearSVC(device="cpu", regParam=0.01).fit(data, num_partitions=2)
    ref = JM.LinearSVC().setRegParam(0.01).fit(data, num_partitions=2)
    _coef_close(port, ref, NEWTON_ATOL)
    _close(port.margins(x), np.asarray(ref.margins(x)), NEWTON_ATOL)
    np.testing.assert_array_equal(port.transform(x), np.asarray(ref.transform(x)))


def test_label_checks_match_jax():
    x, y, _ = _cls_data(rows=50)
    for port, ref, labels, match in [
        (LogisticRegression(device="cpu"), JM.LogisticRegression(), y + 0.5, "integer class"),
        (LogisticRegression(device="cpu"), JM.LogisticRegression(), y * 100, "classes"),
        (LinearSVC(device="cpu"), JM.LinearSVC(), y * 2, "binary 0/1"),
    ]:
        with pytest.raises(ValueError, match=match):
            port.fit((x, labels))
        with pytest.raises(ValueError, match=match):
            ref.fit((x, labels))
    with pytest.raises(ValueError, match="checkpoint_every"):
        LogisticRegression(device="cpu").fit((x, y), checkpoint_every=0)


def test_frames_get_both_output_columns_like_jax():
    x, y, _ = _cls_data(rows=80)
    df = pd.DataFrame({"features": list(x), "label": y})
    port = LogisticRegression(device="cpu", regParam=0.01, probabilityCol="probability").fit(df)
    ref = JM.LogisticRegression().setRegParam(0.01).setProbabilityCol("probability").fit(df)
    got, want = port.transform(df), ref.transform(df)
    np.testing.assert_array_equal(got["prediction"].to_numpy(), want["prediction"].to_numpy())
    _close(np.stack(got["probability"]), np.stack(want["probability"]), NEWTON_ATOL, 1.0)
    svc = LinearSVC(device="cpu", regParam=0.01).fit(df)
    jsvc = JM.LinearSVC().setRegParam(0.01).fit(df)
    got, want = svc.transform(df), jsvc.transform(df)
    np.testing.assert_array_equal(got["prediction"].to_numpy(), want["prediction"].to_numpy())
    _close(np.stack(got["rawPrediction"]), np.stack(want["rawPrediction"]), NEWTON_ATOL)


def test_nan_data_raises_before_any_checkpoint(tmp_path):
    x, y, _ = _cls_data()
    x_bad = x.copy()
    x_bad[0, 0] = np.nan
    ck = str(tmp_path / "ck")
    with pytest.raises(ValueError, match="NaN/Inf"):
        LogisticRegression(device="cpu", regParam=0.01).fit((x_bad, y), checkpoint_dir=ck,
                                                             checkpoint_every=1)
    with pytest.raises(ValueError, match="NaN/Inf"):
        JM.LogisticRegression().setRegParam(0.01).fit((x_bad, y))
    fresh = LogisticRegression(device="cpu", regParam=0.01).fit((x, y))
    refit = LogisticRegression(device="cpu", regParam=0.01).fit((x, y), checkpoint_dir=ck,
                                                                checkpoint_every=1)
    np.testing.assert_array_equal(refit.coefficients, fresh.coefficients)


def _interrupted(est, data, ck, stop_at):
    """Fit until ``stop_at`` Newton iterations have checkpointed, by
    capping maxIter, as a killed fit leaves its directory."""
    est.copy().setMaxIter(stop_at).fit(data, checkpoint_dir=ck, checkpoint_every=1)


@pytest.mark.parametrize("kind", ["binary", "multinomial", "svc"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_crosses_between_packages(kind, direction, tmp_path):
    classes = 3 if kind == "multinomial" else 2
    x, y, _ = _cls_data(classes=classes)
    if kind == "svc":
        port, ref = LinearSVC(device="cpu", regParam=0.01), JM.LinearSVC().setRegParam(0.01)
    else:
        port = LogisticRegression(device="cpu", regParam=0.01)
        ref = JM.LogisticRegression().setRegParam(0.01)
    ck = str(tmp_path / "ck")
    full_port = port.copy().fit((x, y))
    full_ref = ref.copy().fit((x, y))
    if direction == "jax_to_port":
        _interrupted(ref, (x, y), ck, 2)
        resumed = port.copy().fit((x, y), checkpoint_dir=ck, checkpoint_every=1)
        want = full_port
    else:
        _interrupted(port, (x, y), ck, 2)
        resumed = ref.copy().fit((x, y), checkpoint_dir=ck, checkpoint_every=1)
        want = full_ref
    if kind == "multinomial":
        _close(np.asarray(resumed.predict_proba_matrix(x)), want.predict_proba_matrix(x),
               NEWTON_ATOL, 1.0)
    else:
        _coef_close(resumed, want, NEWTON_ATOL)


def test_port_resume_equals_the_uninterrupted_fit(tmp_path):
    x, y, _ = _cls_data()
    est = LogisticRegression(device="cpu", regParam=0.01, maxIter=20)
    full = est.copy().fit((x, y))
    ck = str(tmp_path / "ck")
    _interrupted(est, (x, y), ck, 3)
    resumed = est.copy().fit((x, y), checkpoint_dir=ck, checkpoint_every=1)
    np.testing.assert_array_equal(resumed.coefficients, full.coefficients)
    bad = LogisticRegression(device="cpu", fitIntercept=False)
    with pytest.raises(ValueError, match="stale"):
        bad.fit((x[:, :3], y), checkpoint_dir=ck)


def test_params_defaults_match_jax():
    pairs = [(LinearRegression(device="cpu"), JM.LinearRegression()),
             (LogisticRegression(device="cpu"), JM.LogisticRegression()),
             (LinearSVC(device="cpu"), JM.LinearSVC())]
    for port, ref in pairs:
        assert port._defaultParamMap == ref._defaultParamMap
        assert {p.name for p in type(port).params()} == {p.name for p in type(ref).params()}
    with pytest.raises(ValueError, match="elasticNetParam"):
        LinearRegression(device="cpu").setElasticNetParam(2.0)
    with pytest.raises(ValueError, match="elasticNetParam"):
        LogisticRegression(device="cpu", elasticNetParam=-0.1)


@pytest.mark.parametrize("cls", [LinearRegression, LogisticRegression, LinearSVC,
                                 LinearRegressionModel, LogisticRegressionModel, LinearSVCModel])
def test_default_device_is_the_card(cls, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls()


def test_fit_and_transform_reports_book_the_spans():
    x, y, _ = _cls_data()
    reg = LinearRegression(device="cpu").fit((x, y.astype(np.float32)))
    assert {"linreg stats", "linreg solve"} <= set(reg.fit_report.phases)
    assert reg.fit_report.estimator == "LinearRegression"
    log = LogisticRegression(device="cpu").fit((x, y))
    assert "logreg newton" in log.fit_report.phases
    soft = LogisticRegression(device="cpu", regParam=0.1).fit(_cls_data(classes=3)[:2])
    assert "softmax newton" in soft.fit_report.phases
    svc = LinearSVC(device="cpu").fit((x, y))
    assert "svc newton" in svc.fit_report.phases
    svc.transform(x)
    assert svc.transform_report.transformer == "LinearSVCModel"


@pytest.mark.parametrize("kind", ["linreg", "binary", "multinomial", "svc"])
def test_models_cross_between_packages(kind, tmp_path):
    if kind == "linreg":
        x, y, _ = _reg_data()
        ref = JM.LinearRegression().setRegParam(0.01).fit((x, y))
    elif kind == "svc":
        x, y, _ = _cls_data()
        ref = JM.LinearSVC().setRegParam(0.01).fit((x, y))
    else:
        x, y, _ = _cls_data(classes=3 if kind == "multinomial" else 2)
        ref = JM.LogisticRegression().setRegParam(0.01).fit((x, y))
    name = type(ref).__name__
    want = np.asarray(ref.transform(x))

    def same(got, expected=want):
        # one f32 product each, summed in another order: 1e-6 of the largest
        _close(np.asarray(got), expected, 1e-6)

    # a JAX-package save loads in the port
    ref.save(str(tmp_path / "jax"))
    loaded = Saveable.load(str(tmp_path / "jax"), device="cpu")
    assert type(loaded).__name__ == name and loaded.getRegParam() == 0.01
    same(loaded.transform(x))
    # the JAX model's arrays in, the port's arrays out to the JAX package
    conv = model_from_arrays(name, ref._saveData(), "cpu", {"regParam": 0.01})
    same(conv.transform(x))
    back = type(ref)._fromSaved(None, conv._saveData())
    np.testing.assert_array_equal(np.asarray(back.transform(x)), want)
    # a port save round-trips, and its arrays read in the JAX package
    conv.save(str(tmp_path / "port"))
    again = Saveable.load(str(tmp_path / "port"), device="cpu")
    np.testing.assert_array_equal(again.transform(x), conv.transform(x))
    from spark_rapids_ml_tpu.utils.persistence import load_arrays

    crossed = type(ref)._fromSaved(None, load_arrays(str(tmp_path / "port")))
    np.testing.assert_array_equal(np.asarray(crossed.transform(x)), want)


def test_device_parts_add_the_intercept_column_on_the_device():
    x, y, w = _cls_data(rows=30)
    (xd, yd, wd), = TM._device_parts([(x, y, w)], True, CPU)
    np.testing.assert_array_equal(xd.numpy(), JLIN.augment(jnp.asarray(x)))
    np.testing.assert_array_equal(yd.numpy(), y.astype(np.float32))
    np.testing.assert_array_equal(wd.numpy(), w.astype(np.float32))
    (xd, yd, wd), = TM._device_parts([(x, y, None)], False, CPU, label_dtype=torch.int64)
    assert xd.shape == x.shape and yd.dtype == torch.int64 and wd is None


def test_fit_report_counts_a_labeled_tuple():
    x, y, w = _reg_data(rows=120)
    assert TC.dataset_size((x, y)) == (120, x.nbytes + y.nbytes)
    assert TC.dataset_size((x, y, w)) == (120, x.nbytes + y.nbytes + w.nbytes)
    model = LinearRegression(device="cpu").fit((x, y, w))
    assert model.fit_report.rows_ingested == 120
    assert model.fit_report.bytes_ingested == x.nbytes + y.nbytes + w.nbytes
