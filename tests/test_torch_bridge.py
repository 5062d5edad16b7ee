"""The port's native row bridge (``spark_rapids_ml_tpu_torch/bridge``, built
from ``csrc/tpuml_bridge.cpp`` with g++ at first use) held against the JAX
package's (``spark_rapids_ml_tpu/bridge``), wrapper by wrapper, on the same
f64 inputs made by numpy from a seed.

The C++ source is the same and both libraries are built with the JAX
Makefile's flags on this machine's compiler, and every threaded kernel in
it sums in an order that does not depend on the thread count, so the
expected result is bit-equal: every comparison here is exact.
"""

import jax  # noqa: F401  (imported at the top of every port test file)
import numpy as np
import pytest

from spark_rapids_ml_tpu import bridge as jbridge
from spark_rapids_ml_tpu.models.pca import PCAModel as JaxPCAModel
from spark_rapids_ml_tpu_torch import bridge
from spark_rapids_ml_tpu_torch.models.pca import PCAModel
from spark_rapids_ml_tpu_torch.ops import _build

SHAPES = [(300, 6), (257, 32), (7, 19)]  # a tile's worth, two tiles and a ragged one


def _equal(a, b):
    """Exact equality of two results (arrays, floats, ints, or tuples of them)."""
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
        return
    a_arr, b_arr = np.asarray(a), np.asarray(b)
    assert a_arr.dtype == b_arr.dtype and a_arr.shape == b_arr.shape
    np.testing.assert_array_equal(a_arr, b_arr)


def test_builds_into_a_hash_named_library_and_reports_its_version():
    path = _build.library_path(bridge.SOURCE)
    assert bridge.available() and bridge.version() == jbridge.version() == 12
    assert path.exists() and path.parent == _build.BUILD_DIR
    assert path.name.startswith("tpuml_bridge-") and path.suffix == ".so"
    assert _build.source_path(bridge.SOURCE).suffix == ".cpp"


def test_build_flags_are_the_jax_makefiles():
    makefile = (jbridge._NATIVE_DIR / "Makefile").read_text()
    flags = next(line for line in makefile.splitlines() if line.startswith("CXXFLAGS"))
    assert flags.split("?=")[1].split() == [f for f in _build.HOST_CXX_FLAGS if f != "-shared"]
    assert "-shared" in _build.HOST_CXX_FLAGS


@pytest.mark.parametrize("rows,n", SHAPES)
def test_pack_rows_and_list(rows, n):
    rng = np.random.default_rng(rows)
    mat = rng.normal(size=(rows, n))
    _equal(bridge.pack_rows(list(mat)), jbridge.pack_rows(list(mat)))
    offsets = np.arange(0, (rows + 1) * n, n, dtype=np.int32)
    _equal(bridge.pack_list(mat.reshape(-1), offsets, n), jbridge.pack_list(mat.reshape(-1), offsets, n))
    _equal(bridge.pack_list(mat.reshape(-1), offsets, n), mat)


def test_pack_list_ragged_is_refused_by_both():
    values = np.random.default_rng(1).normal(size=20)
    offsets = np.array([0, 8, 13, 20], dtype=np.int32)
    with pytest.raises(bridge.NativeBridgeError, match="pack_list failed with code") as port:
        bridge.pack_list(values, offsets, 8)
    with pytest.raises(jbridge.NativeBridgeError) as ref:
        jbridge.pack_list(values, offsets, 8)
    assert str(port.value) == str(ref.value)
    with pytest.raises(ValueError, match="no rows"):
        bridge.pack_rows([])


@pytest.mark.parametrize("rows,n", SHAPES)
def test_gram_fresh_and_accumulated(rows, n):
    rng = np.random.default_rng(rows + 1)
    a, b = rng.normal(size=(rows, n)), rng.normal(size=(rows // 2 + 1, n))
    _equal(bridge.gram(a), jbridge.gram(a))
    _equal(bridge.gram(b, out=bridge.gram(a)), jbridge.gram(b, out=jbridge.gram(a)))


@pytest.mark.parametrize("rows,n", SHAPES)
def test_sign_flip_eigh_and_project(rows, n):
    rng = np.random.default_rng(rows + 2)
    x = rng.normal(size=(rows, n))
    u = rng.normal(size=(n, min(n, 5)))
    _equal(bridge.sign_flip(u), jbridge.sign_flip(u))
    cov = x.T @ x
    _equal(bridge.eigh_descending(cov), jbridge.eigh_descending(cov))
    _equal(bridge.project(x, u), jbridge.project(x, u))


@pytest.mark.parametrize("centering", [False, True])
@pytest.mark.parametrize("rows,n", SHAPES)
def test_pca_fit_host(rows, n, centering):
    x = np.random.default_rng(rows + 3).normal(size=(rows, n)) + 2.0
    k = min(n, 4)
    _equal(bridge.pca_fit_host(x, k, mean_centering=centering),
           jbridge.pca_fit_host(x, k, mean_centering=centering))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("rows,n", SHAPES)
def test_kmeans_assign_and_lloyd(rows, n, weighted):
    rng = np.random.default_rng(rows + 4)
    x = rng.normal(size=(rows, n))
    centers = x[: min(rows, 5)].copy()
    w = rng.uniform(0.5, 2.0, size=rows) if weighted else None
    _equal(bridge.kmeans_assign(x, centers, w), jbridge.kmeans_assign(x, centers, w))
    # accumulate a second batch into the first's sums and counts
    port = bridge.kmeans_assign(x, centers, w)
    ref = jbridge.kmeans_assign(x, centers, w)
    _equal(bridge.kmeans_assign(x, centers, w, sums=port[1], counts=port[2]),
           jbridge.kmeans_assign(x, centers, w, sums=ref[1], counts=ref[2]))
    _equal(bridge.kmeans_lloyd_host(x, centers, w, max_iter=10),
           jbridge.kmeans_lloyd_host(x, centers, w, max_iter=10))


def test_kmeans_assign_checks_shapes_like_jax():
    x = np.zeros((10, 4))
    for args, kwargs in (((x, np.zeros((3, 5))), {}), ((x, np.zeros((3, 4)), np.ones(9)), {}),
                         ((x, np.zeros((3, 4))), {"sums": np.zeros((3, 5))})):
        with pytest.raises(ValueError) as port:
            bridge.kmeans_assign(*args, **kwargs)
        with pytest.raises(ValueError) as ref:
            jbridge.kmeans_assign(*args, **kwargs)
        assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("rows,n", SHAPES[:2])
def test_linreg_accumulate_solve_and_fit(rows, n, weighted):
    rng = np.random.default_rng(rows + 5)
    x = rng.normal(size=(rows, n))
    y = x @ rng.normal(size=n) + 0.1 * rng.normal(size=rows)
    w = rng.uniform(0.5, 2.0, size=rows) if weighted else None
    _equal(bridge.linreg_accumulate(x, y, w), jbridge.linreg_accumulate(x, y, w))
    a = x.T @ x + np.eye(n)
    _equal(bridge.solve_spd(a, x.T @ y), jbridge.solve_spd(a, x.T @ y))
    for reg, intercept in ((0.0, True), (0.1, True), (0.1, False)):
        _equal(bridge.linreg_fit_host(x, y, w, reg_param=reg, fit_intercept=intercept),
               jbridge.linreg_fit_host(x, y, w, reg_param=reg, fit_intercept=intercept))


def test_solve_spd_refuses_a_matrix_that_is_not_positive_definite():
    a = np.array([[1.0, 2.0], [2.0, 1.0]])
    with pytest.raises(bridge.NativeBridgeError) as port:
        bridge.solve_spd(a, np.ones(2))
    with pytest.raises(jbridge.NativeBridgeError) as ref:
        jbridge.solve_spd(a, np.ones(2))
    assert str(port.value) == str(ref.value) == "native solve_spd failed with code 4"


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("reg,intercept", [(0.0, True), (0.05, True), (0.05, False)])
def test_logreg_fit_host(reg, intercept, weighted):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(300, 8))
    y = (x @ rng.normal(size=8) + 0.5 * rng.normal(size=300) > 0).astype(np.float64)
    w = rng.uniform(0.5, 2.0, size=300) if weighted else None
    _equal(bridge.logreg_fit_host(x, y, w, reg_param=reg, fit_intercept=intercept),
           jbridge.logreg_fit_host(x, y, w, reg_param=reg, fit_intercept=intercept))
    with pytest.raises(ValueError, match="0/1 labels"):
        bridge.logreg_fit_host(x, y + 1.0)


@pytest.mark.parametrize("standardized", [False, True])
@pytest.mark.parametrize("use_native", [False, True])
def test_transform_rows_matches_jax(use_native, standardized):
    """The model's row path in both packages over one model's arrays: the
    native rows through each bridge bit for bit, numpy's per-row products
    bit for bit, and the two paths within 1e-12 of each other."""
    rng = np.random.default_rng(7)
    n, k = 16, 4
    pc = np.linalg.qr(rng.normal(size=(n, n)))[0][:, :k]
    ev = np.sort(rng.uniform(size=k))[::-1] / 2
    mean, std = (rng.normal(size=n), rng.uniform(0.5, 2.0, size=n)) if standardized else (None, None)
    port = PCAModel(pc=pc, explainedVariance=ev, mean=mean, std=std, device="cpu")
    ref = JaxPCAModel(pc=pc, explainedVariance=ev, mean=mean, std=std)
    rows = list(rng.normal(size=(200, n)))
    got = np.stack(port.transform_rows(rows, use_native=use_native))
    _equal(got, np.stack(ref.transform_rows(rows, use_native=use_native)))
    other = np.stack(port.transform_rows(rows, use_native=not use_native))
    assert np.abs(got - other).max() <= 1e-12 * np.abs(other).max()
