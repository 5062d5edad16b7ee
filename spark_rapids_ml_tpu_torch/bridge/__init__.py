"""ctypes loader and NumPy-facing API of the native row bridge.

The JniRAPIDSML analog (JniRAPIDSML.java:26-78): a lazy singleton that
builds ``csrc/tpuml_bridge.cpp`` with the host compiler at first use, into a
library under ``build/`` named by the hash of its source and flags
(``ops/_build.py``), loads it once per process, checks its ``version()``
once, and wraps the C ABI with shape-checked NumPy signatures. A
hash-named build cannot be stale, so there is no rebuild-on-old-version
step.

Everything here runs on the host in f64, like the reference's CPU row
path: the module needs neither torch nor a device. The source is the JAX
package's ``bridge/native/tpuml_bridge.cpp`` unchanged and is built with
that package's Makefile flags, so each wrapper gives the JAX package's
bits on the same inputs.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from spark_rapids_ml_tpu_torch.ops import _build

SOURCE = "tpuml_bridge"
_MIN_VERSION = 12  # oldest library this module's wrappers can drive

_lib = None
_lock = threading.Lock()


class NativeBridgeError(RuntimeError):
    pass


def get_lib() -> ctypes.CDLL:
    """Load (building if needed) the bridge library, once per process, like
    the reference's eager singleton (JniRAPIDSML.java:27,60-62)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        try:
            lib = _build.load_library(SOURCE)
        except (RuntimeError, OSError) as e:
            raise NativeBridgeError(f"failed to build native bridge: {e}") from e
        i32, i64 = ctypes.c_int32, ctypes.c_int64
        dp = ctypes.POINTER(ctypes.c_double)
        ip = ctypes.POINTER(ctypes.c_int32)

        lib.tpuml_version.restype = i32
        if lib.tpuml_version() < _MIN_VERSION:
            raise NativeBridgeError(
                f"bridge reports version {lib.tpuml_version()} < required {_MIN_VERSION}"
            )
        lib.tpuml_pack_rows.argtypes = [ctypes.POINTER(dp), i64, i64, dp]
        lib.tpuml_pack_rows.restype = i32
        lib.tpuml_pack_list.argtypes = [dp, ip, i64, i64, dp]
        lib.tpuml_pack_list.restype = i32
        lib.tpuml_gram.argtypes = [dp, i64, i64, dp]
        lib.tpuml_gram.restype = i32
        lib.tpuml_sign_flip.argtypes = [dp, i64, i64]
        lib.tpuml_sign_flip.restype = i32
        lib.tpuml_eigh_descending.argtypes = [dp, i64, dp, dp]
        lib.tpuml_eigh_descending.restype = i32
        lib.tpuml_project.argtypes = [dp, dp, i64, i64, i64, dp]
        lib.tpuml_project.restype = i32
        lib.tpuml_kmeans_assign.argtypes = [dp, dp, dp, i64, i64, i64, ip, dp, dp, dp]
        lib.tpuml_kmeans_assign.restype = i32
        lib.tpuml_linreg_accumulate.argtypes = [dp, dp, dp, i64, i64, dp, dp, dp]
        lib.tpuml_linreg_accumulate.restype = i32
        lib.tpuml_solve_spd.argtypes = [dp, dp, i64, dp]
        lib.tpuml_solve_spd.restype = i32

        _lib = lib
        return lib


def available() -> bool:
    try:
        get_lib()
        return True
    except (NativeBridgeError, OSError):
        return False


def _as_c(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x, dtype=np.float64)


def _dptr(x: np.ndarray):
    return x.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _check(code: int, op: str) -> None:
    if code != 0:
        raise NativeBridgeError(f"native {op} failed with code {code}")


def version() -> int:
    return int(get_lib().tpuml_version())


def pack_rows(rows: list[np.ndarray]) -> np.ndarray:
    """Gather per-row arrays into a contiguous [rows, n] matrix natively."""
    if not rows:
        raise ValueError("no rows")
    rows = [_as_c(r) for r in rows]
    n = rows[0].shape[0]
    ptrs = (ctypes.POINTER(ctypes.c_double) * len(rows))(*[_dptr(r) for r in rows])
    out = np.empty((len(rows), n), dtype=np.float64)
    _check(get_lib().tpuml_pack_rows(ptrs, len(rows), n, _dptr(out)), "pack_rows")
    return out


def pack_list(values: np.ndarray, offsets: np.ndarray, n: int) -> np.ndarray:
    """Arrow list buffers (values + int32 offsets) → [rows, n], ragged-checked."""
    values = _as_c(values)
    offsets = np.ascontiguousarray(offsets, dtype=np.int32)
    rows = len(offsets) - 1
    out = np.empty((rows, n), dtype=np.float64)
    code = get_lib().tpuml_pack_list(
        _dptr(values), offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        rows, n, _dptr(out),
    )
    _check(code, "pack_list")
    return out


def gram(x: np.ndarray, out: np.ndarray | None = None) -> np.ndarray:
    """C += XᵀX. Pass ``out`` to accumulate across batches (the reference's
    per-partition covariance loop semantics)."""
    x = _as_c(x)
    rows, n = x.shape
    if out is None:
        out = np.zeros((n, n), dtype=np.float64)
    _check(get_lib().tpuml_gram(_dptr(x), rows, n, _dptr(out)), "gram")
    return out


def sign_flip(u: np.ndarray) -> np.ndarray:
    u = _as_c(u).copy()
    _check(get_lib().tpuml_sign_flip(_dptr(u), u.shape[0], u.shape[1]), "sign_flip")
    return u


def eigh_descending(cov: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """calSVD contract: (components [n, n], singular values [n])."""
    cov = _as_c(cov)
    n = cov.shape[0]
    comps = np.empty((n, n), dtype=np.float64)
    s = np.empty(n, dtype=np.float64)
    _check(
        get_lib().tpuml_eigh_descending(_dptr(cov), n, _dptr(comps), _dptr(s)),
        "eigh_descending",
    )
    return comps, s


def project(x: np.ndarray, pc: np.ndarray) -> np.ndarray:
    x, pc = _as_c(x), _as_c(pc)
    rows, n = x.shape
    k = pc.shape[1]
    out = np.empty((rows, k), dtype=np.float64)
    _check(get_lib().tpuml_project(_dptr(x), _dptr(pc), rows, n, k, _dptr(out)), "project")
    return out


def pca_fit_host(x: np.ndarray, k: int, *, mean_centering: bool = False):
    """Pure-native end-to-end PCA fit (no device): the full reference
    fit() semantics on the host backend. Returns (pc [n, k], ev [k])."""
    x = _as_c(x)
    g = gram(x)
    if mean_centering:
        s = x.sum(axis=0)
        g = g - np.outer(s, s) / max(len(x), 1)
    comps, sv = eigh_descending(g)
    total = sv.sum()
    ev = (sv / total if total > 0 else sv)[:k]
    return comps[:, :k], ev


def kmeans_assign(
    x: np.ndarray,
    centers: np.ndarray,
    w: np.ndarray | None = None,
    *,
    sums: np.ndarray | None = None,
    counts: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    """One weighted Lloyd accumulation pass on the native threaded kernel.

    The host-fallback analog of ``ops.kmeans.kmeans_stats`` (the reference
    delegates this roofline to RAFT's pairwise-distance kernels). Pass
    ``sums``/``counts`` to accumulate across batches like :func:`gram`.
    Returns (labels [rows] int32, sums [k, n], counts [k], cost).
    """
    x, centers = _as_c(x), _as_c(centers)
    rows, n = x.shape
    k = centers.shape[0]
    if centers.shape[1] != n:
        raise ValueError(
            f"centers have {centers.shape[1]} features, data has {n}"
        )
    labels = np.empty(rows, dtype=np.int32)
    if sums is None:
        sums = np.zeros((k, n), dtype=np.float64)
    elif (
        sums.shape != (k, n)
        or sums.dtype != np.float64
        or not sums.flags.c_contiguous
    ):
        raise ValueError(
            f"sums accumulator must be C-contiguous float64 [{k}, {n}]"
        )
    if counts is None:
        counts = np.zeros(k, dtype=np.float64)
    elif counts.shape != (k,) or counts.dtype != np.float64:
        raise ValueError(f"counts accumulator must be float64 [{k}]")
    cost = np.zeros(1, dtype=np.float64)
    wp = None if w is None else _as_c(np.asarray(w, dtype=np.float64))
    if wp is not None and wp.shape != (rows,):
        raise ValueError(
            f"weights have shape {wp.shape}, expected ({rows},)"
        )
    _check(
        get_lib().tpuml_kmeans_assign(
            _dptr(x), _dptr(centers),
            None if wp is None else _dptr(wp),
            rows, n, k,
            labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            _dptr(sums), _dptr(counts), _dptr(cost),
        ),
        "kmeans_assign",
    )
    return labels, sums, counts, float(cost[0])


def linreg_accumulate(
    x: np.ndarray,
    y: np.ndarray,
    w: np.ndarray | None = None,
    *,
    xtx: np.ndarray | None = None,
    xty: np.ndarray | None = None,
    moments: np.ndarray | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One fused weighted-moments pass on the native threaded kernel —
    the host-fallback analog of ``ops.linear.linear_stats``. Pass the
    accumulators to fold multiple batches (the per-partition loop
    semantics of :func:`gram`). Returns (xtx [n, n], xty [n],
    moments [n + 2] = [x_sum, y_sum, count])."""
    x = _as_c(x)
    rows, n = x.shape
    y = _as_c(np.asarray(y, dtype=np.float64).reshape(-1))
    if y.shape != (rows,):
        raise ValueError(f"y has shape {y.shape}, expected ({rows},)")
    wp = None if w is None else _as_c(np.asarray(w, dtype=np.float64))
    if wp is not None and wp.shape != (rows,):
        raise ValueError(f"weights have shape {wp.shape}, expected ({rows},)")
    if xtx is None:
        xtx = np.zeros((n, n), dtype=np.float64)
    if xty is None:
        xty = np.zeros(n, dtype=np.float64)
    if moments is None:
        moments = np.zeros(n + 2, dtype=np.float64)
    for name, acc, shape in (
        ("xtx", xtx, (n, n)),
        ("xty", xty, (n,)),
        ("moments", moments, (n + 2,)),
    ):
        if acc.shape != shape or acc.dtype != np.float64 or not acc.flags.c_contiguous:
            raise ValueError(
                f"{name} accumulator must be C-contiguous float64 {shape}"
            )
    _check(
        get_lib().tpuml_linreg_accumulate(
            _dptr(x), _dptr(y), None if wp is None else _dptr(wp),
            rows, n, _dptr(xtx), _dptr(xty), _dptr(moments),
        ),
        "linreg_accumulate",
    )
    return xtx, xty, moments


def solve_spd(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Native Cholesky solve for SPD systems. Raises NativeBridgeError
    (code 4) when ``a`` is not numerically positive definite."""
    a = _as_c(a)
    n = a.shape[0]
    if a.shape != (n, n):
        raise ValueError(f"a must be square, got {a.shape}")
    b = _as_c(np.asarray(b, dtype=np.float64).reshape(-1))
    if b.shape != (n,):
        raise ValueError(f"b has shape {b.shape}, expected ({n},)")
    out = np.empty(n, dtype=np.float64)
    _check(get_lib().tpuml_solve_spd(_dptr(a), _dptr(b), n, _dptr(out)), "solve_spd")
    return out


def linreg_fit_host(
    x: np.ndarray,
    y: np.ndarray,
    w: np.ndarray | None = None,
    *,
    reg_param: float = 0.0,
    fit_intercept: bool = True,
) -> tuple[np.ndarray, float]:
    """Pure-native ridge/OLS fit (no device): the GLM sibling of
    :func:`pca_fit_host` / :func:`kmeans_lloyd_host`, with EXACTLY
    ``ops.linear.solve_normal``'s semantics — centered moments (the
    intercept is never penalized), λ scaled by the row count (Spark ML's
    convention), and a least-squares fallback for rank-deficient designs.
    Returns (coefficients [n], intercept)."""
    xtx, xty, mom = linreg_accumulate(x, y, w)
    n = xtx.shape[0]
    m = max(float(mom[n + 1]), 1.0)
    lam = reg_param * m
    if fit_intercept:
        mu = mom[:n] / m
        ybar = float(mom[n]) / m
        a = xtx - m * np.outer(mu, mu)
        b = xty - m * mu * ybar
    else:
        a = xtx
        b = xty
    a = a + lam * np.eye(n)
    if not (np.isfinite(a).all() and np.isfinite(b).all()):
        # NaN/Inf moments: degrade to NaN coefficients like the device
        # path (solve_normal never raises on non-finite input; LAPACK's
        # lstsq would raise and spray DLASCL warnings)
        coef = np.full(n, np.nan)
    else:
        try:
            coef = solve_spd(a, b)
            if not np.all(np.isfinite(coef)):
                raise NativeBridgeError("non-finite solve")
        except NativeBridgeError:
            coef = np.linalg.lstsq(a, b, rcond=None)[0]
    intercept = (
        float(mom[n]) / m - float(np.dot(mom[:n] / m, coef))
        if fit_intercept
        else 0.0
    )
    return coef, intercept


def kmeans_lloyd_host(
    x: np.ndarray,
    centers0: np.ndarray,
    w: np.ndarray | None = None,
    *,
    max_iter: int = 20,
    tol: float = 1e-4,
) -> tuple[np.ndarray, float, int]:
    """Pure-native Lloyd loop (no device): the host-fallback sibling
    of :func:`pca_fit_host`. Empty clusters keep their previous center
    (the device kernel's convention). Returns (centers, cost, iterations)."""
    centers = _as_c(centers0).copy()
    it = 0
    tol_sq = tol * tol
    for it in range(1, max_iter + 1):
        _, sums, counts, _ = kmeans_assign(x, centers, w)
        new_centers = np.where(
            (counts > 0)[:, None], sums / np.maximum(counts, 1e-300)[:, None],
            centers,
        )
        shift = float(np.max(np.sum((new_centers - centers) ** 2, axis=1)))
        centers = new_centers
        if shift <= tol_sq:
            break
    # cost of the RETURNED centers (the in-loop cost describes the
    # pre-update centers; returning that pair would over-report inertia by
    # one Lloyd step and mis-rank restarts compared on cost)
    _, _, _, cost = kmeans_assign(x, centers, w)
    return centers, cost, it


def logreg_fit_host(
    x: np.ndarray,
    y: np.ndarray,
    w: np.ndarray | None = None,
    *,
    reg_param: float = 0.0,
    fit_intercept: bool = True,
    max_iter: int = 25,
    tol: float = 1e-6,
) -> tuple[np.ndarray, float]:
    """Pure-host binary logistic IRLS/Newton — the classifier completing
    the native GLM family (:func:`linreg_fit_host`'s sibling), with the
    device path's exact conventions (ops/linear.py ``newton_update``):
    λ·m L2 scaling, intercept unpenalized, √eps·trace/d jitter so
    separable data stays solvable. The O(rows·d²) Hessian runs on the
    native threaded kernel; margins on the native GEMM; the [d, d] solve
    on the native Cholesky. Returns (coefficients [n], intercept).
    """
    x = _as_c(x)
    y = np.asarray(y, dtype=np.float64).reshape(-1)
    if set(np.unique(y)) - {0.0, 1.0}:
        raise ValueError(
            f"binary logistic requires 0/1 labels, got {np.unique(y)[:8]}"
        )
    rows, n = x.shape
    xa = np.hstack([x, np.ones((rows, 1))]) if fit_intercept else x
    d = xa.shape[1]
    wv = (
        np.ones(rows)
        if w is None
        else _as_c(np.asarray(w, dtype=np.float64))
    )
    m = max(float(wv.sum()), 1.0)
    pen = np.ones(d)
    if fit_intercept:
        pen[-1] = 0.0
    lam2 = reg_param * m * pen
    beta = np.zeros(d)
    for _ in range(max_iter):
        z = project(xa, beta.reshape(-1, 1)).reshape(-1)  # native GEMM
        p = 1.0 / (1.0 + np.exp(-z))
        curv = p * (1.0 - p) * wv
        hess = np.zeros((d, d))
        linreg_accumulate(xa, y, curv, xtx=hess)  # native threaded X^T W X
        grad = xa.T @ ((y - p) * wv) - lam2 * beta
        hess[np.diag_indices(d)] += lam2
        eps = np.sqrt(np.finfo(np.float64).eps) * np.trace(hess) / d
        hess[np.diag_indices(d)] += eps
        if not (np.isfinite(hess).all() and np.isfinite(grad).all()):
            raise ValueError(
                "Newton statistics are non-finite — the features, labels, "
                "or weights contain NaN/Inf values; clean or impute first"
            )
        try:
            step = solve_spd(hess, grad)
        except NativeBridgeError:
            step = np.linalg.lstsq(hess, grad, rcond=None)[0]
        beta = beta + step
        if float(np.linalg.norm(step)) <= tol:
            break
    if fit_intercept:
        return beta[:-1], float(beta[-1])
    return beta, 0.0
