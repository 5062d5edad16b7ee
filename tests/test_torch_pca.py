"""The port's PCA against the JAX package's, through fit and transform.

Both estimators get the same f32 data in the same container; the port runs
with device="cpu". Components must agree to min |cosine| >= 0.9999,
explainedVariance to rtol 1e-4, and transforms to 1e-4·max|out| (sign_flip
orients both sides' components the same way). Streamed fits are forced by
dropping the resident cutover (the JAX package's config and the port's
environment variable) and run 128-row chunks; a standardize fit's mean and
std agree at rtol 1e-5.

Solver "randomized" (and "auto" where it picks it) depends on its sketch Ω,
which torch cannot draw as ``jax.random`` does: the port's solver is handed
the JAX package's Ω here (``_jax_sketch``). Precision "default" is one bf16
pass in the port; the JAX package's CPU backend computes it as an f32
product, so explainedVariance agrees there at rtol 2e-3 (the bf16 Gram's
perturbation moves the noise floor's eigenvalues, the bulk of the full
spectrum's Σs, and with them every ratio: 5.4e-4 measured at this size).
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

import jax
import jax.numpy as jnp

from spark_rapids_ml_tpu import PCA as JaxPCA
from spark_rapids_ml_tpu.utils import persistence as jax_persistence
from spark_rapids_ml_tpu.utils.config import get_config as jax_config
from spark_rapids_ml_tpu.utils.config import set_config as set_jax_config
from spark_rapids_ml_tpu_torch import PCA, PCAModel
from spark_rapids_ml_tpu_torch.convert import pca_model_from_arrays
from spark_rapids_ml_tpu_torch.ops import linalg as TL

ROWS, N, K = 900, 96, 6
COSINE_BAR = 0.9999


def _workload(rows=ROWS, n=N, seed=7):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(rows, 64)).astype(np.float32)
    mix = rng.normal(size=(64, n)).astype(np.float32)
    return base @ mix + 0.1 * rng.normal(size=(rows, n)).astype(np.float32)


def _container(x, kind):
    if kind == "ndarray":
        return x
    if kind == "pandas":
        return pd.DataFrame({"features": list(x)})
    values = pa.array(x.reshape(-1))
    return pa.table({"features": pa.FixedSizeListArray.from_arrays(values, x.shape[1])})


def _output(out, kind):
    if kind == "ndarray":
        return np.asarray(out)
    if kind == "pandas":
        return np.stack(out["pca_features"].to_numpy())
    return np.asarray(out.column("pca_features").combine_chunks().flatten()).reshape(
        out.num_rows, -1
    )


def _min_abs_cosine(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    cos = np.abs((a * b).sum(0)) / (np.linalg.norm(a, axis=0) * np.linalg.norm(b, axis=0))
    return cos.min()


EV_RTOL = {"highest": 1e-4, "high": 1e-4, "default": 2e-3}  # see the module note


def _assert_models_agree(port, ref, ev_rtol=1e-4, n=N):
    assert port.pc.shape == ref.pc.shape == (n, K)
    assert _min_abs_cosine(port.pc, ref.pc) >= COSINE_BAR
    np.testing.assert_allclose(port.explainedVariance, ref.explainedVariance, rtol=ev_rtol)


def _jax_sketch(monkeypatch, n, dtype=jnp.float32):
    """Hand the port's randomized solver the sketch the JAX package's draws
    for an [n, n] covariance of ``dtype`` (seed 0, l = K + 10)."""
    omega = torch.from_numpy(np.array(
        jax.random.normal(jax.random.PRNGKey(0), (n, K + 10), dtype=dtype), dtype=np.float32))
    seeded = TL.randomized_eigh_descending
    monkeypatch.setattr(TL, "randomized_eigh_descending",
                        lambda *a, **kw: seeded(*a, **kw, omega=omega))


def _assert_transform_is_the_projection(model, x):
    out = model.transform(x)
    expected = x.astype(np.float64) @ model.pc.astype(np.float64)
    assert out.shape == (x.shape[0], K)
    np.testing.assert_allclose(out, expected, rtol=0, atol=1e-5 * np.abs(expected).max())


@pytest.fixture(scope="module")
def x():
    return _workload()


@pytest.mark.parametrize("kind", ["ndarray", "pandas", "arrow"])
@pytest.mark.parametrize("partitions", [1, 3])
@pytest.mark.parametrize("center", [False, True])
@pytest.mark.parametrize("precision", ["highest", "high"])
def test_fit_transform_matches_jax(x, kind, partitions, center, precision):
    data = _container(x, kind)
    ref = (
        JaxPCA().setInputCol("features").setK(K).setMeanCentering(center)
        .setPrecision(precision).fit(data, num_partitions=partitions)
    )
    port = (
        PCA(device="cpu").setInputCol("features").setK(K).setMeanCentering(center)
        .setPrecision(precision).fit(data, num_partitions=partitions)
    )
    _assert_models_agree(port, ref)
    out = _output(port.transform(data), kind)
    expected = _output(ref.transform(data), kind)
    assert out.shape == (ROWS, K)
    np.testing.assert_allclose(out, expected, rtol=0, atol=1e-4 * np.abs(expected).max())


def test_transform_rows_matches_jax(x):
    ref = JaxPCA().setInputCol("features").setK(K).fit(x)
    port = pca_model_from_arrays(ref._saveData(), device="cpu")
    rows = list(x[:5])
    for a, b in zip(port.transform_rows(rows), ref.transform_rows(rows)):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * np.abs(b).max())


@pytest.mark.parametrize("standardize", [False, True])
def test_model_from_jax_arrays_transforms_alike(x, standardize):
    ref = (
        JaxPCA().setInputCol("features").setOutputCol("pca_features").setK(K)
        .setStandardize(standardize).fit(x)
    )
    port = pca_model_from_arrays(ref._saveData(), device="cpu")
    assert isinstance(port, PCAModel) and port.device.type == "cpu"
    port.setInputCol("features")
    expected = np.asarray(ref.transform(x))
    out = port.transform(x)
    np.testing.assert_allclose(out, expected, rtol=0, atol=1e-4 * np.abs(expected).max())


def test_model_from_arrays_rejects_partial_state():
    with pytest.raises(KeyError):
        pca_model_from_arrays({"pc": np.eye(3)}, device="cpu")
    with pytest.raises(KeyError):
        pca_model_from_arrays(
            {"pc": np.eye(3), "explainedVariance": np.ones(3), "mean": np.zeros(3)},
            device="cpu",
        )


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PCA()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PCAModel(pc=np.eye(3), explainedVariance=np.ones(3))


def test_params_match_jax():
    port, ref = PCA(device="cpu"), JaxPCA()
    for name in ("meanCentering", "standardize", "outputCol", "precision", "solver"):
        assert port.getOrDefault(name) == ref.getOrDefault(name)
    assert {p.name for p in PCA.params()} == {p.name for p in JaxPCA.params()}
    assert PCA(k=3, device="cpu").getK() == 3
    with pytest.raises(ValueError, match="precision"):
        PCA(device="cpu").setPrecision("fast")
    with pytest.raises(ValueError, match="solver"):
        PCA(device="cpu").setSolver("qr")


def test_k_larger_than_features_raises(x):
    with pytest.raises(ValueError, match="k="):
        PCA(device="cpu").setK(N + 1).fit(x)


@pytest.fixture
def streamed(monkeypatch):
    """Every fit of both packages streams, in 128-row chunks (the rows do
    not divide them), with the JAX tuner off."""
    monkeypatch.setenv("TPU_ML_STREAM_FIT_MAX_RESIDENT_BYTES", "1")
    monkeypatch.setenv("TPU_ML_STREAM_CHUNK_ROWS", "128")
    monkeypatch.setenv("TPU_ML_AUTOTUNE", "off")
    old = jax_config().stream_fit_max_resident_bytes
    set_jax_config(stream_fit_max_resident_bytes=1)
    yield
    set_jax_config(stream_fit_max_resident_bytes=old)


def _fit_both(x, precision, partitions=3, **params):
    ref = JaxPCA(**params).setInputCol("features").setK(K).setPrecision(precision).fit(
        x, num_partitions=partitions
    )
    port = PCA(device="cpu", **params).setInputCol("features").setK(K).setPrecision(
        precision
    ).fit(x, num_partitions=partitions)
    return port, ref


@pytest.mark.parametrize("center", [False, True])
@pytest.mark.parametrize("precision", ["highest", "high"])
def test_streamed_fit_matches_jax_and_the_resident_fit(x, streamed, center, precision):
    port, ref = _fit_both(x, precision, meanCentering=center)
    assert port.stream_report is not None
    assert port.stream_report.chunks == -(-ROWS // 128) and port.stream_report.rows == ROWS
    _assert_models_agree(port, ref)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TPU_ML_STREAM_FIT_MAX_RESIDENT_BYTES", str(1 << 31))
        resident = PCA(device="cpu").setK(K).setMeanCentering(center).setPrecision(
            precision
        ).fit(x, num_partitions=3)
    assert resident.stream_report is None
    _assert_models_agree(port, resident)


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_streamed_fit_counts_skipped_rows(x, streamed, monkeypatch, precision):
    bad = x.copy()
    bad[[5, 400]] = np.nan
    monkeypatch.setenv("TPU_ML_NONFINITE_POLICY", "skip")
    port = PCA(device="cpu").setK(K).setPrecision(precision).fit(bad, num_partitions=3)
    clean = PCA(device="cpu").setK(K).setPrecision(precision).fit(
        np.delete(x, [5, 400], axis=0), num_partitions=3
    )
    assert port.stream_report.skipped_rows == 2 and port.stream_report.rows == ROWS - 2
    _assert_models_agree(port, clean)
    monkeypatch.setenv("TPU_ML_NONFINITE_POLICY", "raise")
    with pytest.raises(ValueError, match="non-finite"):
        PCA(device="cpu").setK(K).setPrecision(precision).fit(bad, num_partitions=3)


def _assert_standardized_agree(port, ref, x):
    _assert_models_agree(port, ref)
    # at "high" the port's column sums are Σ(hi + lo), the kernel's, which
    # carries 16 mantissa bits: off Σx by at most 2⁻¹⁷·Σ|x|
    np.testing.assert_allclose(port.mean, ref.mean, rtol=1e-5,
                               atol=2.0**-17 * np.abs(x).mean(axis=0).max())
    np.testing.assert_allclose(port.std, ref.std, rtol=1e-5)
    out = port.transform(x)
    expected = np.asarray(ref.transform(x))
    np.testing.assert_allclose(out, expected, rtol=0, atol=1e-4 * np.abs(expected).max())


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_standardize_matches_jax(x, precision):
    port, ref = _fit_both(x, precision, standardize=True)
    assert port.stream_report is None
    _assert_standardized_agree(port, ref, x)


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_streamed_standardize_matches_jax(x, streamed, precision):
    port, ref = _fit_both(x, precision, standardize=True)
    assert port.stream_report is not None
    _assert_standardized_agree(port, ref, x)


def test_standardize_leaves_constant_features_unscaled(x):
    xc = x.copy()
    xc[:, 3] = 2.0
    xc[:, 7] += 10.0
    port, ref = _fit_both(xc, "highest", standardize=True)
    assert port.std[3] == 0.0
    _assert_standardized_agree(port, ref, xc)


FAR_ROWS, FAR_N, FAR_K = 65_536, 4, 3


@pytest.mark.parametrize("path", ["resident", "streamed"])
def test_high_standardize_of_a_feature_far_from_zero_matches_jax(path, monkeypatch):
    """σ at "high" for a feature whose mean lies 10σ from zero.

    The split-bf16 Gram drops Σlo², where lo = bf16(x − bf16(x)) is up to
    2⁻⁹|x|: a one-sided cut of about 2⁻¹⁸ of Σx² on the diagonal. The
    variance (Σx² − m·μ²)/(m − 1) amplifies a relative error of Σx² by
    (μ² + σ²)/σ² = 101 here, so σ would be off by about 2⁻¹⁸·101/2 ≈ 2e-4
    (1.6e-4 measured before the repair), twenty times the rtol 1e-5 the
    parity tests hold. The random part of the f32 sums falls as 1/√rows and
    stays below 1e-5 at 65,536 rows; the one-sided cut does not fall. The
    JAX package's "high" computes this Gram in f32 on the CPU backend, and
    the port's diagonal must agree: it comes from the kernel's Σ(hi + lo)².
    """
    rng = np.random.default_rng(3)
    x = rng.normal(size=(FAR_ROWS, FAR_N)).astype(np.float32)
    x[:, 1] = x[:, 1] * 0.5 + 5.0  # σ 0.5, mean 10σ
    old = jax_config().stream_fit_max_resident_bytes
    if path == "streamed":
        monkeypatch.setenv("TPU_ML_STREAM_FIT_MAX_RESIDENT_BYTES", "1")
        monkeypatch.setenv("TPU_ML_STREAM_CHUNK_ROWS", "16384")
        monkeypatch.setenv("TPU_ML_AUTOTUNE", "off")
        set_jax_config(stream_fit_max_resident_bytes=1)
    try:
        ref = JaxPCA(standardize=True).setInputCol("features").setK(FAR_K).setPrecision(
            "high"
        ).fit(x, num_partitions=2)
        port = PCA(device="cpu", standardize=True).setInputCol("features").setK(
            FAR_K
        ).setPrecision("high").fit(x, num_partitions=2)
    finally:
        set_jax_config(stream_fit_max_resident_bytes=old)
    assert (port.stream_report is not None) == (path == "streamed")
    np.testing.assert_allclose(port.mean, ref.mean, rtol=1e-5,
                               atol=2.0**-17 * np.abs(x).mean(axis=0).max())
    np.testing.assert_allclose(port.std, ref.std, rtol=1e-5)
    assert _min_abs_cosine(port.pc, ref.pc) >= COSINE_BAR
    np.testing.assert_allclose(port.explainedVariance, ref.explainedVariance, rtol=1e-4)


@pytest.mark.parametrize(
    "configure,match",
    [
        pytest.param(lambda p: p.setSolver("randomized"), "randomized", id="randomized"),
        pytest.param(lambda p: p.setSolver("svd"), "svd", id="svd"),
        pytest.param(lambda p: p.setSolver("auto"), "auto", id="auto"),
        pytest.param(lambda p: p.setPrecision("default"), "default", id="default_precision"),
    ],
)
def test_unported_options_raise(x, configure, match, monkeypatch):
    """The options of the earlier slices' ``NotImplementedError``, ported:
    each fit agrees with the JAX package's (the randomized sketch shared;
    "auto" at n = 96 is "full" in both; "default" at its explainedVariance
    tolerance) and transforms to x·pc."""
    _jax_sketch(monkeypatch, N)
    port = configure(PCA(device="cpu").setInputCol("features").setK(K)).fit(x, num_partitions=3)
    ref = configure(JaxPCA().setInputCol("features").setK(K)).fit(x, num_partitions=3)
    assert port.getOrDefault("solver") == ref.getOrDefault("solver")
    assert port.getOrDefault("precision") == ref.getOrDefault("precision")
    _assert_models_agree(port, ref, EV_RTOL[port.getOrDefault("precision")])
    _assert_transform_is_the_projection(port, x)


def test_save_load_raise(x, tmp_path):
    """Save and load, ported: a native round trip keeps the arrays, params
    and uid; the JAX package reads the same arrays from the save; and a
    JAX save of the same fit loads into the port equal to the JAX load."""
    model = PCA(device="cpu").setInputCol("features").setK(K).fit(x)
    model.save(str(tmp_path / "m"))
    loaded = PCAModel.load(str(tmp_path / "m"), device="cpu")
    assert isinstance(loaded, PCAModel) and loaded.uid == model.uid
    np.testing.assert_array_equal(loaded.pc, model.pc)
    np.testing.assert_array_equal(loaded.explainedVariance, model.explainedVariance)
    assert loaded.getK() == K and loaded.getInputCol() == "features"
    arrays = jax_persistence.load_arrays(str(tmp_path / "m"))
    np.testing.assert_array_equal(arrays["pc"], model.pc)
    ref = JaxPCA().setInputCol("features").setK(K).fit(x)
    ref.save(str(tmp_path / "j"))
    from_jax = PCAModel.load(str(tmp_path / "j"), device="cpu")
    jax_loaded = type(ref).load(str(tmp_path / "j"))
    np.testing.assert_array_equal(from_jax.pc, jax_loaded.pc)
    assert from_jax.uid == jax_loaded.uid and from_jax.getK() == K


SOLVER_N = 256  # "auto" picks "randomized" from n = 256 at k = 6 (16·4 ≤ 256)


@pytest.fixture(scope="module")
def x256():
    return _workload(n=SOLVER_N)


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("solver", ["full", "randomized", "auto"])
def test_covariance_solvers_at_every_precision_match_jax(x256, solver, precision, monkeypatch):
    _jax_sketch(monkeypatch, SOLVER_N)
    port, ref = _fit_both(x256, precision, solver=solver)
    assert port.stream_report is None
    _assert_models_agree(port, ref, EV_RTOL[precision], n=SOLVER_N)
    _assert_transform_is_the_projection(port, x256)
    if solver == "auto":  # the randomized route, bit-equal
        rand = PCA(device="cpu").setK(K).setPrecision(precision).setSolver("randomized").fit(
            x256, num_partitions=3)
        np.testing.assert_array_equal(port.pc, rand.pc)


@pytest.mark.parametrize("kind", ["ndarray", "arrow"])
@pytest.mark.parametrize("center", [False, True])
def test_svd_solver_matches_jax(x, kind, center):
    """The TSQR path: per-partition R on the device, a tree of stacked-pair
    QRs, SVD of R; with meanCentering the f64 host mean comes off first."""
    data = _container(x, kind)
    port, ref = _fit_both(data, "highest", solver="svd", meanCentering=center)
    _assert_models_agree(port, ref)
    full = PCA(device="cpu").setK(K).setMeanCentering(center).fit(x, num_partitions=3)
    _assert_models_agree(port, full)
    _assert_transform_is_the_projection(port, x)


def test_svd_never_streams_and_refuses_standardize(x, streamed):
    port, ref = _fit_both(x, "highest", solver="svd")
    assert port.stream_report is None
    _assert_models_agree(port, ref)
    for pca in (PCA(device="cpu", standardize=True), JaxPCA(standardize=True)):
        with pytest.raises(ValueError, match="standardize"):
            pca.setK(K).setSolver("svd").fit(x)


@pytest.mark.parametrize("solver", ["full", "randomized", "auto"])
@pytest.mark.parametrize("precision", ["high", "default"])
def test_streamed_solvers_match_jax(x256, streamed, solver, precision, monkeypatch):
    # the JAX package's streamed carry is f64 (its wire), and so its sketch
    _jax_sketch(monkeypatch, SOLVER_N, jnp.float64)
    port, ref = _fit_both(x256, precision, solver=solver)
    assert port.stream_report is not None
    _assert_models_agree(port, ref, EV_RTOL[precision], n=SOLVER_N)


@pytest.mark.parametrize("center", [False, True])
def test_streamed_fit_under_the_policy_matches_jax(x, streamed, monkeypatch, center):
    """TPU_ML_PRECISION_POLICY=bf16_f32acc: both packages' streamed folds
    take bf16 operands, the port's through the one-product kernel's plain
    version. Components agree to the usual bar; explainedVariance at
    rtol 2e-3, because the port's diagonal is the exact Σx² where JAX's is
    Σhi², up to 2⁻⁸ apart (5.6e-4 measured)."""
    monkeypatch.setenv("TPU_ML_PRECISION_POLICY", "bf16_f32acc")
    port, ref = _fit_both(x, "highest", meanCentering=center)
    assert port.stream_report is not None
    _assert_models_agree(port, ref, ev_rtol=2e-3)
    monkeypatch.delenv("TPU_ML_PRECISION_POLICY")
    default = PCA(device="cpu").setK(K).setMeanCentering(center).setPrecision("default").fit(
        x, num_partitions=3)
    np.testing.assert_array_equal(port.pc, default.pc)


@pytest.mark.parametrize("path", ["resident", "streamed"])
def test_default_standardize_matches_jax(x, request, path):
    """One bf16 pass with the kernels' exact Σx and Σx² on the diagonal: the
    scaler's mean and σ agree with the JAX package's f32 ones at rtol 1e-5
    (Σhi² would leave σ up to 2⁻⁸ off); the components as at "default"."""
    if path == "streamed":
        request.getfixturevalue("streamed")
    port, ref = _fit_both(x, "default", standardize=True)
    assert (port.stream_report is not None) == (path == "streamed")
    _assert_models_agree(port, ref, ev_rtol=2e-3)
    np.testing.assert_allclose(port.mean, ref.mean, rtol=1e-5,
                               atol=1e-6 * np.abs(x).mean(axis=0).max())
    np.testing.assert_allclose(port.std, ref.std, rtol=1e-5)


# -- Spark ML vector columns (VectorUDT) ------------------------------------------

_VECTOR_TYPE = pa.struct([
    ("type", pa.int8()), ("size", pa.int32()),
    ("indices", pa.list_(pa.int32())), ("values", pa.list_(pa.float64())),
])


def _vector_column(x, sparse_rows):
    """A VectorUDT struct column of ``x``'s rows: the rows in
    ``sparse_rows`` as sparse vectors (their nonzero entries), the others
    dense."""
    rows = []
    for i, row in enumerate(x.astype(np.float64)):
        if i in sparse_rows:
            nz = np.flatnonzero(row)
            rows.append({"type": 0, "size": len(row), "indices": nz.tolist(),
                         "values": row[nz].tolist()})
        else:
            rows.append({"type": 1, "size": None, "indices": None, "values": row.tolist()})
    return pa.array(rows, type=_VECTOR_TYPE)


@pytest.mark.parametrize("mixed", [False, True], ids=["dense", "dense_and_sparse"])
def test_vector_udt_column_fits_like_jax(mixed):
    """A 64 × 5 Spark ML vector column, dense rows only or mixed with sparse
    rows (some entries zeroed), fits in the port as in the JAX package:
    eigenvectors min |cos| ≥ 0.9999, explainedVariance rtol 1e-5."""
    rng = np.random.default_rng(21)
    x = rng.normal(size=(64, 5)).astype(np.float32) * np.float32([3, 2, 1.5, 1, 0.5])
    sparse_rows = set(range(0, 64, 3)) if mixed else set()
    for i in sparse_rows:
        x[i, rng.choice(5, size=2, replace=False)] = 0.0
    table = pa.table({"features": _vector_column(x, sparse_rows)})
    port = PCA(device="cpu").setInputCol("features").setK(3).fit(table)
    ref = JaxPCA().setInputCol("features").setK(3).fit(table)
    assert _min_abs_cosine(port.pc, ref.pc) >= COSINE_BAR
    np.testing.assert_allclose(port.explainedVariance, ref.explainedVariance, rtol=1e-5)
    # the densified rows are the rows
    from spark_rapids_ml_tpu_torch.utils import columnar

    np.testing.assert_array_equal(columnar._from_arrow_column(table.column("features")), x)


def _jax_one_pass(x, k):
    """The JAX package's one-pass tier as its bf16 product computes it
    (``policy_matmul`` under ``bf16_f32acc``: Σhi² on the diagonal; its CPU
    backend runs ``Precision.DEFAULT`` as f32): (σ, explainedVariance)."""
    from spark_rapids_ml_tpu.ops import linalg as JL

    xj = jnp.asarray(x)
    stats = JL.GramStats(JL.policy_matmul(xj.T, xj, policy="bf16_f32acc"), jnp.sum(xj, 0),
                         jnp.asarray(float(len(x)), jnp.float32))
    _, _, std = JL.standardized_cov_from_stats(stats)
    _, ev = JL.pca_fit_from_cov(JL.covariance_from_stats(stats, mean_centering=False), k)
    return np.asarray(std, np.float64), np.asarray(ev, np.float64)


def test_default_diagonal_rule_against_f64():
    """The "default" tier's diagonal (ROADMAP Queue C item 1), on rows whose
    mean is 100σ and on config-2-like rows near zero. σ (standardize) reads
    only the diagonal: the port's exact Σx² keeps it at 1.3e-3 of f64 where
    the JAX package's Σhi² is off by 0.60 (μ/σ = 100), and closer near zero
    too. explainedVariance (unstandardized) reads the whole matrix: Σhi²,
    which makes it the Gram of the bf16 rows, is nearer f64 on both inputs
    (5.4e-4 against 3.9e-3 with Σx² at μ/σ = 100; 2.3e-5 against 3.1e-5
    near zero, measured here), so the unstandardized fit keeps it and agrees
    with the JAX package's arithmetic (1e-5 of the largest ratio)."""
    rng = np.random.default_rng(5)
    k = 4
    inputs = {
        "mean_dominates": (100.0 + rng.normal(size=(4096, 32))).astype(np.float32),
        "near_zero": (rng.normal(size=(4096, 64)) @ rng.normal(size=(64, 32)) * 0.1
                      ).astype(np.float32),
    }
    for name, x in inputs.items():
        x64 = x.astype(np.float64)
        std64 = x64.std(axis=0, ddof=1)
        s64 = np.sqrt(np.clip(np.linalg.eigvalsh(x64.T @ x64)[::-1], 0.0, None))
        ev64 = (s64 / s64.sum())[:k]
        std_port = PCA(device="cpu", k=k, precision="default", standardize=True).fit(x).std
        ev_port = PCA(device="cpu", k=k, precision="default").fit(x).explainedVariance
        std_jax, ev_jax = _jax_one_pass(x, k)

        def dist(a, b):
            return float(np.abs(np.asarray(a, np.float64) - b).max() / np.abs(b).max())

        d = {"std_port": dist(std_port, std64), "std_jax": dist(std_jax, std64),
             "ev_port": dist(ev_port, ev64), "ev_jax": dist(ev_jax, ev64)}
        assert d["std_port"] < d["std_jax"], (name, d)
        if name == "mean_dominates":
            assert d["std_port"] < 0.01 < d["std_jax"], d
        np.testing.assert_allclose(ev_port, ev_jax, rtol=0, atol=1e-5 * ev_jax.max(),
                                   err_msg=name)
        assert d["ev_port"] <= 1.1 * d["ev_jax"], (name, d)
