"""The port's streamed fold against the JAX package's.

The same f32 chunks, partitions of uneven size whose rows do not divide the
chunk, go through ``spark_rapids_ml_tpu.spark.ingest.stream_fold`` with the
JAX fold step and through the port's ``stream_fold`` with its own, on the
CPU. The suite runs JAX with x64, so the JAX carry is f64 under the default
wire dtype; the port's is f32. The carries agree to 1e-5·max|G| at
"highest" (f32 products) and 3e-5·max|G| at "high" (the split-bf16 plain
version, ~16 mantissa bits), with the count exact.

The one-bf16-pass folds (precision "default", or any precision under the
``bf16_f32acc`` policy) are held against the JAX fold under that policy,
which computes the one-pass semantics on the CPU: off the diagonal both sum
the same exact bf16 products (1e-5·max|G|); on it the port holds the exact
Σx², within ONE_PASS_DIAG_RTOL of JAX's Σhi².
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from spark_rapids_ml_tpu.ops import linalg as JL
from spark_rapids_ml_tpu.ops import linear as JLIN
from spark_rapids_ml_tpu.spark import ingest as JI
from spark_rapids_ml_tpu_torch.ops import linalg as TL
from spark_rapids_ml_tpu_torch.ops import linear as TLIN
from spark_rapids_ml_tpu_torch.spark import ingest as TI

CPU = torch.device("cpu")
ROWS, N, CHUNK = 1100, 12, 128
JAX_PRECISION = {
    "highest": lax.Precision.HIGHEST, "high": lax.Precision.HIGH,
    "default": lax.Precision.DEFAULT,
}
TOL = {"highest": 1e-5, "high": 3e-5}
# bf16 rounds x by a relative δ with |δ| ≤ 2⁻⁹: Σhi² = Σx²(1 + 2δ + δ²)
ONE_PASS_DIAG_RTOL = 2.0**-8 + 2.0**-18


@pytest.fixture(autouse=True)
def _static_chunks(monkeypatch):
    # the JAX tuner may not change the chunk geometry under test
    monkeypatch.setenv("TPU_ML_AUTOTUNE", "off")


@pytest.fixture(scope="module")
def parts():
    rng = np.random.default_rng(17)
    x = rng.normal(size=(ROWS, N)).astype(np.float32)
    return np.split(x, [100, 550, 900])  # 100, 450, 350 and 200 rows


def _port_fold(parts, precision="highest", **kw):
    return TI.stream_fold(
        iter(parts), TL.gram_fold_step(precision), n=N,
        init=TL.init_gram_carry(N, CPU), device=CPU, **kw,
    )


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_stream_fold_matches_jax(parts, precision):
    ref = JI.stream_fold(
        iter(parts), JL.gram_fold_step(JAX_PRECISION[precision]), n=N,
        init=JL.init_gram_carry(N, JI.wire_dtype()), chunk_rows=CHUNK,
    )
    out = _port_fold(parts, precision, chunk_rows=CHUNK)
    assert (out.rows, out.chunks) == (ref.rows, ref.chunks) == (ROWS, -(-ROWS // CHUNK))
    xtx = np.asarray(ref.carry.xtx)
    scale = np.abs(xtx).max()
    np.testing.assert_allclose(out.carry.xtx.numpy(), xtx, rtol=0, atol=TOL[precision] * scale)
    np.testing.assert_allclose(
        out.carry.col_sum.numpy(), np.asarray(ref.carry.col_sum),
        rtol=0, atol=TOL[precision] * np.abs(np.concatenate(parts)).sum(0).max(),
    )
    assert out.carry.count.item() == float(ref.carry.count) == ROWS


def test_stream_fold_matches_one_resident_pass(parts):
    """Chunking changes only the f32 summation order."""
    x = torch.from_numpy(np.concatenate(parts))
    out = _port_fold(parts, chunk_rows=CHUNK)
    whole = TL.gram_stats(x)
    scale = whole.xtx.abs().max().item()
    torch.testing.assert_close(out.carry.xtx, whole.xtx, rtol=0, atol=1e-6 * scale)
    torch.testing.assert_close(out.carry.col_sum, whole.col_sum, rtol=1e-5, atol=1e-4)


def test_chunk_rows_default_and_bucketing(monkeypatch):
    for raw in ("65536", "100", "1000", "1"):
        monkeypatch.setenv("TPU_ML_STREAM_CHUNK_ROWS", raw)
        assert TI.stream_chunk_rows() == JI.stream_chunk_rows()
    monkeypatch.delenv("TPU_ML_STREAM_CHUNK_ROWS")
    assert TI.stream_chunk_rows() == JI.stream_chunk_rows() == 65_536
    monkeypatch.setenv("TPU_ML_STREAM_CHUNK_ROWS", "0")
    with pytest.raises(ValueError, match="TPU_ML_STREAM_CHUNK_ROWS"):
        TI.stream_chunk_rows()


@pytest.mark.parametrize("rows,n", [(1000, 512), (524_288, 512), (524_289, 512), (10**7, 512)])
def test_cutover_matches_jax(rows, n):
    assert TI.use_streamed_fit(rows, n) == JI.use_streamed_fit(rows, n)


def test_empty_stream_raises():
    with pytest.raises(ValueError, match="empty"):
        _port_fold([])
    with pytest.raises(ValueError, match="empty"):
        _port_fold([np.zeros((0, N), np.float32)])


def test_changed_width_raises(parts):
    with pytest.raises(ValueError, match="feature dimension"):
        _port_fold([parts[0], np.zeros((5, N + 1), np.float32)])


def _with_nonfinite(parts):
    bad = [p.copy() for p in parts]
    bad[1][3, 2] = np.nan
    bad[2][7, 0] = np.inf
    bad[2][8, 5] = -np.inf
    return bad


def test_nonfinite_rows_raise_by_default(parts):
    with pytest.raises(ValueError, match="non-finite"):
        _port_fold(_with_nonfinite(parts), chunk_rows=CHUNK)


def test_nonfinite_policy_comes_from_the_environment(parts, monkeypatch):
    monkeypatch.setenv("TPU_ML_NONFINITE_POLICY", "skip")
    assert _port_fold(_with_nonfinite(parts), chunk_rows=CHUNK).skipped_rows == 3
    monkeypatch.setenv("TPU_ML_NONFINITE_POLICY", "drop")
    with pytest.raises(ValueError, match="TPU_ML_NONFINITE_POLICY"):
        _port_fold(parts, chunk_rows=CHUNK)


def test_nonfinite_rows_skipped_and_counted(parts):
    bad = _with_nonfinite(parts)
    out = _port_fold(bad, chunk_rows=CHUNK, nonfinite="skip")
    ref = JI.stream_fold(
        iter(bad), JL.gram_fold_step(lax.Precision.HIGHEST), n=N,
        init=JL.init_gram_carry(N, JI.wire_dtype()), chunk_rows=CHUNK, nonfinite="skip",
    )
    assert out.skipped_rows == ref.skipped_rows == 3
    assert out.rows == ref.rows == ROWS - 3
    clean = _port_fold([p[np.isfinite(p).all(axis=1)] for p in bad], chunk_rows=CHUNK)
    assert torch.equal(out.carry.xtx, clean.carry.xtx)
    assert out.carry.count.item() == ROWS - 3


def test_nonfinite_allow_skips_the_scan(parts):
    out = _port_fold(_with_nonfinite(parts), chunk_rows=CHUNK, nonfinite="allow")
    assert out.skipped_rows == 0 and not torch.isfinite(out.carry.xtx).all()


def test_finite_values_whose_sum_overflows_are_kept():
    x = np.full((4, N), 3e38, np.float32)  # finite, but their sum is not
    out = _port_fold([x], chunk_rows=CHUNK, precision="highest")
    assert out.rows == 4 and out.skipped_rows == 0


def test_puts_are_one_chunk(parts):
    out = _port_fold(parts, chunk_rows=CHUNK)
    assert out.max_put_bytes == CHUNK * N * 4  # f32, never the whole set
    assert out.overlapped == 0  # the CPU folds synchronously


def test_host_chunks_of_any_float_dtype_and_layout(parts):
    x = np.concatenate(parts)
    ref = _port_fold([x], chunk_rows=CHUNK)
    for chunks in ([x.astype(np.float64)], [np.asfortranarray(x)], [x[::-1][::-1]]):
        out = _port_fold(chunks, chunk_rows=CHUNK)
        torch.testing.assert_close(out.carry.xtx, ref.carry.xtx, rtol=0, atol=0)
    ro = x.copy()
    ro.flags.writeable = False
    out = _port_fold([ro], chunk_rows=CHUNK)
    assert torch.equal(out.carry.xtx, ref.carry.xtx)


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_gram_stats_weighted_matches_jax(parts, precision):
    x = np.concatenate(parts)[:300]
    w = np.ones(300, np.float32)
    if precision == "highest":
        w = np.random.default_rng(3).uniform(0.5, 2.0, 300).astype(np.float32)
        w[250:] = 0.0  # pad rows
    ref = JL.gram_stats_weighted(jnp.asarray(x), jnp.asarray(w), precision=JAX_PRECISION[precision])
    out = TL.gram_stats_weighted(torch.from_numpy(x), torch.from_numpy(w), precision=precision)
    scale = np.abs(np.asarray(ref.xtx)).max()
    np.testing.assert_allclose(out.xtx.numpy(), np.asarray(ref.xtx), rtol=0,
                               atol=TOL[precision] * scale)
    np.testing.assert_allclose(out.col_sum.numpy(), np.asarray(ref.col_sum), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(out.count.item(), float(ref.count), rtol=1e-6)


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_fold_gram_stats_matches_jax_and_the_in_place_step(parts, precision):
    x0, x1 = (p[:90] for p in parts[:2])
    w = np.ones(90, np.float32)
    jp = JAX_PRECISION[precision]
    ref = JL.init_gram_carry(N, jnp.float32)
    port = TL.init_gram_carry(N, CPU)
    stepped = TL.init_gram_carry(N, CPU)
    step = TL.gram_fold_step(precision)
    for xc in (x0, x1):
        ref = JL.fold_gram_stats(ref, jnp.asarray(xc), jnp.asarray(w), precision=jp)
        port = TL.fold_gram_stats(port, torch.from_numpy(xc), torch.from_numpy(w),
                                  precision=precision)
        out = step(stepped, torch.from_numpy(xc), torch.from_numpy(w))
        assert out is stepped  # updated in place
    scale = np.abs(np.asarray(ref.xtx)).max()
    np.testing.assert_allclose(port.xtx.numpy(), np.asarray(ref.xtx), rtol=0,
                               atol=TOL[precision] * scale)
    assert port.count.item() == float(ref.count) == 180
    for a, b in zip(port, stepped):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize(
    "w", [pytest.param([1.0, 0.5, 1.0], id="fractional"), pytest.param([1.0, 1.0, 0.0], id="pad_row"),
          pytest.param([1.0, 1.0], id="wrong_length")]
)
def test_high_folds_unit_weights_only(w):
    """Unit weights take the symmetric kernel's instance; other weights fold
    at "high" through the split's three products outside the kernel (as the
    JAX package's weighted fold is an XLA product at ``Precision.HIGH``,
    which its CPU backend computes in f32: 3e-5 of max|G|, the split's bound
    against f32), and a weight vector of the wrong length raises."""
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(3, N)) + 3.0).astype(np.float32)
    if len(w) != len(x):
        with pytest.raises(ValueError, match="weights of shape"):
            TL.gram_stats_weighted(torch.from_numpy(x), torch.tensor(w), precision="high")
        with pytest.raises(ValueError, match="weights of shape"):
            TL.gram_fold_step("high")(TL.init_gram_carry(N, CPU), torch.from_numpy(x),
                                      torch.tensor(w))
        return
    wf = np.asarray(w, np.float32)
    ref = JL.gram_stats_weighted(jnp.asarray(x), jnp.asarray(wf), precision=lax.Precision.HIGH)
    got = TL.gram_stats_weighted(torch.from_numpy(x), torch.from_numpy(wf), precision="high")
    scale = np.abs(np.asarray(ref.xtx)).max()
    np.testing.assert_allclose(got.xtx.numpy(), np.asarray(ref.xtx), rtol=0, atol=3e-5 * scale)
    np.testing.assert_allclose(got.col_sum.numpy(), np.asarray(ref.col_sum), rtol=1e-6)
    assert got.count.item() == float(ref.count) == wf.sum()
    stepped = TL.gram_fold_step("high")(TL.init_gram_carry(N, CPU), torch.from_numpy(x),
                                        torch.from_numpy(wf))
    for a, b in zip(stepped, got):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _assert_one_pass_carry(port_xtx, jax_xtx):
    off = ~np.eye(port_xtx.shape[0], dtype=bool)
    scale = np.abs(jax_xtx).max()
    np.testing.assert_allclose(port_xtx[off], jax_xtx[off], rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(np.diag(port_xtx), np.diag(jax_xtx), rtol=ONE_PASS_DIAG_RTOL)


def test_fold_step_rejects_unported_precisions(parts):
    """Precision "default" is ported: the in-place fold step against the JAX
    fold of the same chunks under ``bf16_f32acc`` (the one-pass semantics);
    unknown precisions and non-fold policies still raise."""
    ref = JI.stream_fold(
        iter(parts), JL.gram_fold_step(lax.Precision.DEFAULT, policy="bf16_f32acc"), n=N,
        init=JL.init_gram_carry(N, JI.wire_dtype()), chunk_rows=CHUNK,
    )
    out = _port_fold(parts, "default", chunk_rows=CHUNK)
    _assert_one_pass_carry(out.carry.xtx.numpy(), np.asarray(ref.carry.xtx))
    x = np.concatenate(parts).astype(np.float64)
    np.testing.assert_allclose(out.carry.xtx.numpy().diagonal(), (x**2).sum(0), rtol=1e-5)
    np.testing.assert_allclose(out.carry.col_sum.numpy(), np.asarray(ref.carry.col_sum),
                               rtol=0, atol=1e-5 * np.abs(x).sum(0).max())
    assert out.carry.count.item() == float(ref.carry.count) == ROWS
    with pytest.raises(ValueError, match="precision"):
        TL.gram_fold_step("fast")
    with pytest.raises(ValueError, match="policy"):
        TL.gram_fold_step("highest", policy="int8_dist")


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
def test_stream_fold_under_the_policy_matches_jax(parts, monkeypatch, precision):
    """TPU_ML_PRECISION_POLICY=bf16_f32acc makes every tier's fold one bf16
    pass, in both packages; each fold step resolves it when it is made."""
    monkeypatch.setenv("TPU_ML_PRECISION_POLICY", "bf16_f32acc")
    ref = JI.stream_fold(
        iter(parts), JL.gram_fold_step(JAX_PRECISION[precision]), n=N,
        init=JL.init_gram_carry(N, JI.wire_dtype()), chunk_rows=CHUNK,
    )
    step = TL.gram_fold_step(precision)
    monkeypatch.delenv("TPU_ML_PRECISION_POLICY")  # the step keeps its policy
    out = TI.stream_fold(iter(parts), step, n=N, init=TL.init_gram_carry(N, CPU), device=CPU,
                         chunk_rows=CHUNK)
    _assert_one_pass_carry(out.carry.xtx.numpy(), np.asarray(ref.carry.xtx))
    default = _port_fold(parts, "default", chunk_rows=CHUNK)
    assert torch.equal(out.carry.xtx, default.carry.xtx)
    assert out.carry.count.item() == float(ref.carry.count) == ROWS


def test_policy_knob_reads_the_environment(monkeypatch):
    from spark_rapids_ml_tpu.autotune import policy as JP
    from spark_rapids_ml_tpu_torch.autotune import policy as TP
    from spark_rapids_ml_tpu_torch.utils.config import get_config

    assert TP.POLICIES == JP.POLICIES and TP.FOLD_POLICIES == JP.FOLD_POLICIES
    assert TP.PRECISION_POLICY_VAR == JP.PRECISION_POLICY_VAR
    monkeypatch.delenv("TPU_ML_PRECISION_POLICY", raising=False)
    assert get_config().precision_policy == TP.resolve_policy(None) == "f32"
    monkeypatch.setenv("TPU_ML_PRECISION_POLICY", "bf16_f32acc")
    assert get_config().precision_policy == TP.resolve_policy(None) == JP.resolve_policy(None)
    assert TP.validate_policy(TP.PrecisionPolicy.BF16_F32ACC) == "bf16_f32acc"
    monkeypatch.setenv("TPU_ML_PRECISION_POLICY", "int8_dist")
    assert TP.resolve_policy(None) == "int8_dist"
    with pytest.raises(ValueError, match="policy"):
        TL.gram_fold_step("highest")
    monkeypatch.setenv("TPU_ML_PRECISION_POLICY", "fp4")
    with pytest.raises(ValueError, match="policy"):
        get_config()


def test_weighted_one_pass_fold_matches_jax(parts):
    """Weights other than 1 (and pad rows at 0) at the one-pass tier: the
    port's ``policy_matmul`` of x and x·w, the JAX package's own arithmetic,
    diagonal included."""
    x = np.concatenate(parts)[:300]
    w = np.random.default_rng(3).uniform(0.5, 2.0, 300).astype(np.float32)
    w[250:] = 0.0
    ref = JL.gram_stats_weighted(jnp.asarray(x), jnp.asarray(w), policy="bf16_f32acc")
    for precision, policy in (("default", "f32"), ("highest", "bf16_f32acc")):
        out = TL.gram_stats_weighted(torch.from_numpy(x), torch.from_numpy(w),
                                     precision=precision, policy=policy)
        scale = np.abs(np.asarray(ref.xtx)).max()
        np.testing.assert_allclose(out.xtx.numpy(), np.asarray(ref.xtx), rtol=0, atol=1e-5 * scale)
        np.testing.assert_allclose(out.col_sum.numpy(), np.asarray(ref.col_sum), rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_allclose(out.count.item(), float(ref.count), rtol=1e-6)
    with pytest.raises(ValueError, match="unit weights"):
        TL.gram_stats_weighted(torch.from_numpy(x), torch.ones(299), precision="default")


@pytest.mark.parametrize("precision,policy", [
    ("highest", None), ("high", None), ("default", None), ("highest", "bf16_f32acc"),
])
def test_gram_fold_xtx_step_matches_jax(parts, precision, policy):
    """The bare-Gram fold step, in place, against the JAX one (its carry
    f64 under x64): "highest" at 1e-5·max|G|, "high" at 3e-5·max|G|, the
    one-pass tier off the diagonal at 1e-5·max|G| and on it at
    ONE_PASS_DIAG_RTOL."""
    jstep = JL.gram_fold_xtx_step(JAX_PRECISION[precision],
                                  policy="bf16_f32acc" if precision == "default" else policy)
    tstep = TL.gram_fold_xtx_step(precision, policy=policy)
    ref = jnp.zeros((N, N), jnp.float64)
    carry = torch.zeros((N, N))
    for p in parts:
        ref = jstep(ref, jnp.asarray(p))
        assert tstep(carry, torch.from_numpy(p)) is carry
    ref = np.asarray(ref)
    if precision == "default" or policy == "bf16_f32acc":
        _assert_one_pass_carry(carry.numpy(), ref)
    else:
        np.testing.assert_allclose(carry.numpy(), ref, rtol=0,
                                   atol=TOL[precision] * np.abs(ref).max())


# -- labels and weights (the supervised fits' fold) ----------------------------
#
# The labeled fold against the JAX package's: (x, y) and (x, y, w) partitions
# through ``linear_fold_step`` in both. JAX's carry is the f64 wire dtype, the
# port's f64 too; the chunk products are f32 in both, so the carries agree to
# 1e-5 of each field's largest entry, with the count exact.


def _labeled_parts(parts, weighted):
    rng = np.random.default_rng(3)
    out = []
    for p in parts:
        y = (p @ np.linspace(-1, 1, N) + 0.5).astype(np.float32)
        w = rng.uniform(0.1, 2.0, len(p)) if weighted else None
        out.append((p, y, w) if weighted else (p, y))
    return out


def _port_labeled_fold(items, **kw):
    return TI.stream_fold(
        iter(items), TLIN.linear_fold_step(), n=N, label_col="y",
        init=TLIN.init_linear_carry(N, CPU), device=CPU, chunk_rows=CHUNK, **kw,
    )


@pytest.mark.parametrize("weighted", [False, True])
def test_labeled_fold_matches_jax(parts, weighted):
    items = _labeled_parts(parts, weighted)
    ref = JI.stream_fold(
        iter(items), JLIN.linear_fold_step(), n=N, label_col="y",
        init=JLIN.init_linear_carry(N, JI.wire_dtype()), chunk_rows=CHUNK,
    )
    out = _port_labeled_fold(items)
    assert (out.rows, out.chunks) == (ref.rows, ref.chunks)
    # x, then y and w beside it: N + 2 f32 columns a staged row
    assert out.max_put_bytes == CHUNK * (N + 2) * 4
    for name, got, want in zip(out.carry._fields, out.carry, ref.carry):
        want = np.asarray(want)
        assert got.dtype == torch.float64, name
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * max(np.abs(want).max(), 1.0), err_msg=name)
    weights = np.concatenate([i[2] for i in items]) if weighted else np.ones(ROWS)
    assert out.carry.count.item() == pytest.approx(weights.sum(), rel=1e-6)


def test_labeled_fold_drops_nonfinite_labels_and_weights(parts):
    items = _labeled_parts(parts, True)
    bad = [(x.copy(), y.copy(), w.copy()) for x, y, w in items]
    bad[0][1][4] = np.nan
    bad[2][2][9] = np.inf
    with pytest.raises(ValueError, match="non-finite"):
        _port_labeled_fold(bad)
    out = _port_labeled_fold(bad, nonfinite="skip")
    ref = JI.stream_fold(
        iter(bad), JLIN.linear_fold_step(), n=N, label_col="y",
        init=JLIN.init_linear_carry(N, JI.wire_dtype()), chunk_rows=CHUNK, nonfinite="skip",
    )
    assert out.skipped_rows == ref.skipped_rows == 2 and out.rows == ROWS - 2
    want = np.asarray(ref.carry.xtx)
    np.testing.assert_allclose(out.carry.xtx.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_labeled_fold_checks_labels_and_weights(parts):
    with pytest.raises(ValueError, match="label column missing"):
        _port_labeled_fold([parts[0]])
    x, y = parts[0], np.zeros(len(parts[0]), np.float32)
    with pytest.raises(ValueError, match="non-negative"):
        _port_labeled_fold([(x, y, -np.ones(len(x)))])
    # a chunk of zero weights alone is allowed: the fit's check is global
    out = _port_labeled_fold([(x, y, np.zeros(len(x))), (x, y)])
    assert out.carry.count.item() == len(x)
