"""Model registry of the serving path: one CUDA graph per (model, bucket).

Port of ``spark_rapids_ml_tpu/serving/registry.py`` for the PCA, scaler,
linear, forest and ann families.

- **Pure kernel extraction.** A fitted ``PCAModel`` becomes a
  ``ServableEntry``: a pure ``kernel(params, x)`` over device tensors
  (``_pca_kernel``, the transform's ``ops.linalg.project``; or
  ``_pca_kernel_bf16``) and the host ``prepare`` hook the eager transform
  also runs (the standardization, applied before padding so pad rows stay
  zero). The serve path and ``PCAModel.transform`` run the same device
  computation. A fitted ``StandardScalerModel`` becomes ``_scaler_kernel``
  (``ops.scaler.standardize`` with the model's flags) over its f32
  ``mean``/``std``, with no host hook; its policy is always ``f32``. A
  fitted single-output GLM (``LinearRegressionModel``, a binary
  ``LogisticRegressionModel``, ``LinearSVCModel``) becomes ``_linear_kernel``
  (``ops.linear.predict_linear``: the margin x·coef + b, [rows]) over its f32
  coefficients and intercept, or ``_linear_kernel_bf16``; a multi-output
  (multinomial) model has no serve contract and is refused. A fitted
  random-forest or decision-tree classifier becomes ``_forest_kernel``
  (``ops.forest.forest_apply``, every tree's leaf class counts, [rows, T, C])
  with a host ``finalize`` that normalizes each tree's counts, averages them
  and takes the argmax (``models.forest.forest_votes``, the eager decision
  rule). A fitted IVF index becomes the ``"ann"`` family
  (``ann/serving.py``: ``ops.ivf.ivf_search`` behind a packed
  ``distances | ids`` finalize).
- **A CUDA graph per rung, captured at registration.** Where the JAX
  package compiles ``jax.jit(kernel)`` ahead of time for every rung of the
  bucket ladder, ``register()`` captures one ``torch.cuda.CUDAGraph`` per
  (entry, bucket): a static device input ``[bucket, n]``, the kernel, and
  its static output ``[bucket, k]``; each capture books
  ``serve.aot_compiles{model,bucket}`` (the JAX name) and
  ``compile.graph_captures{reason=register}``. A dispatch copies the padded
  block into a pinned staging buffer of the rung, copies it to the static
  input, replays the graph and copies the output back to a pinned buffer,
  all on the caller's current stream, under the rung's lock (the batcher's
  thread and direct ``predict`` callers share a rung). The copies stay
  outside the graph: a replay is then the one kernel the eager path runs,
  at the same shape. After registration no request size captures again; a
  bucket outside the warm set captures on demand and books
  ``serve.cold_compiles``. On a CUDA device a failed capture or replay
  raises; nothing falls back to eager dispatch. On the CPU no graph exists
  and the same kernel runs eagerly.
- **Paging.** ``serving/hbm.py`` pages cold models' parameters to pinned
  host memory; an entry drops its graphs before its parameters go and
  recaptures them when they come back (see that module).
- **Tuning-cache consult.** The registry asks the tuning cache
  (``autotune/cache.py``, keys ``serve.pca`` and ``serve.linear``) for a
  blessed precision policy; an explicit ``bf16_f32acc`` entry selects
  ``_pca_kernel_bf16`` or ``_linear_kernel_bf16``. The default is ``f32``,
  the eager-parity path.
- **Hot swap, rollback, the shadow gate.** ``swap`` captures the
  candidate's graph for every bucket of the live entry's warm set before
  the publish (so requests after a swap capture nothing), scores candidate
  and live on a shadow sample and refuses a divergent candidate
  (``SwapRefused``), then publishes it under the registry lock: the lock's
  hold is the blackout (``serve.swap_blackout_seconds``). The displaced
  version stays dispatchable and resident (booked as ``<name>@prior``)
  until ``prune_prior`` frees its graphs and parameters, each rung under
  its lock as paging does, or ``rollback`` republishes it with its graphs
  as they are. The fault site ``serve.swap`` fires before the publish,
  ``serve.dispatch`` at the top of ``dispatch_padded``.
- **Hedged dispatch.** A rung is not reentrant: it owns static buffers and
  a lock held for the whole replay, so a resend on the same rung would
  queue behind the stuck primary. ``warm_hedge`` therefore captures a rung
  set of the entry's own (``serve.aot_compiles{device="hedge"}``): on the
  second card when there is one, else on the same card on a stream of its
  own, with its own copy of the parameters and its own buffers.
  ``hedge_dispatch_padded`` replays it and never takes a primary rung's
  lock. On the CPU the hedge runs the kernel eagerly, as the primary does.

The JAX package's persistent XLA compile cache has no counterpart: a CUDA
graph cannot outlive its process.
"""

from __future__ import annotations

import functools
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.autotune import cache as tuning_cache
from spark_rapids_ml_tpu_torch.models.forest import RandomForestClassificationModel, forest_votes
from spark_rapids_ml_tpu_torch.models.linear import _GLMModel
from spark_rapids_ml_tpu_torch.models.pca import PCAModel
from spark_rapids_ml_tpu_torch.models.scaler import StandardScalerModel
from spark_rapids_ml_tpu_torch.ops import forest as FO
from spark_rapids_ml_tpu_torch.ops import linalg as L
from spark_rapids_ml_tpu_torch.ops import linear as LIN
from spark_rapids_ml_tpu_torch.ops import scaler as S
from spark_rapids_ml_tpu_torch.resilience import faults, sites
from spark_rapids_ml_tpu_torch.serving import buckets, hbm
from spark_rapids_ml_tpu_torch.telemetry import compilemon
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY
from spark_rapids_ml_tpu_torch.telemetry.timeline import TIMELINE
from spark_rapids_ml_tpu_torch.utils import columnar
from spark_rapids_ml_tpu_torch.utils.config import (
    DEFAULT_SWAP_SHADOW_TOLERANCE,
    SWAP_SHADOW_TOLERANCE_VAR,
    lenient_float,
)
from spark_rapids_ml_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("spark_rapids_ml_tpu_torch.serving")

FAMILIES = ("pca", "scaler", "linear", "forest", "ann")


class SwapRefused(RuntimeError):
    """A hot-swap candidate refused before the publish: shadow divergence
    past the tolerance, or a shape that differs from the live entry's. The
    old version keeps serving; nothing was torn."""


#: Input dtypes a serve request may carry. Integer and bool payloads (JSON
#: numbers decode to them) are widened to float64 first; anything else is
#: refused. Either float is cast once to float32, the device dtype, after
#: ``prepare`` and before the device.
ACCEPTED_DTYPES = ("float32", "float64")

#: The device dtype of every padded block.
X_DTYPE = np.dtype(np.float32)


def validate_request(x: Any, n_features: int, model: str) -> np.ndarray:
    """Dtype-preserving request validation: a ``[rows, n]`` float32 or
    float64 matrix, with no float64 copy forced. Raises ``ValueError`` (the
    transports' 400) for anything else, naming the accepted dtypes."""
    mat = np.asarray(x)
    if mat.dtype.kind in ("i", "u", "b"):
        # JSON integers and bools are exact in f64
        mat = mat.astype(np.float64)
    if mat.dtype.name not in ACCEPTED_DTYPES:
        raise ValueError(
            f"unsupported input dtype {mat.dtype.name!r} for {model!r} — "
            f"accepted dtypes: {', '.join(ACCEPTED_DTYPES)} (and integers, "
            "widened to float64)"
        )
    if mat.ndim == 1:
        mat = mat[None, :]
    if mat.ndim != 2 or mat.shape[1] != n_features:
        raise ValueError(
            f"expected [rows, {n_features}] input for {model!r}, "
            f"got shape {mat.shape}"
        )
    return mat


# -- pure serve kernels (params, x) -> out ----------------------------------


def _bf16_rounded(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


def _pca_kernel(params, x: torch.Tensor) -> torch.Tensor:
    """The eager transform's projection, ``ops.linalg.project`` (f32, TF32
    asserted off)."""
    (pc,) = params
    return L.project(x, pc)


def _pca_kernel_bf16(params, x: torch.Tensor) -> torch.Tensor:
    """bf16 operands, f32 result: x and pc rounded to bf16 and multiplied in
    f32 with TF32 off. A product of two bf16 values is exact in f32, so this
    is the function of the JAX package's bf16 ``jnp.matmul`` with
    ``preferred_element_type=f32`` (a bf16 × bf16 ``torch.matmul`` would
    round its result to bf16)."""
    (pc,) = params
    return L.project(_bf16_rounded(x), _bf16_rounded(pc))


def _linear_kernel(params, x: torch.Tensor) -> torch.Tensor:
    """The eager GLM margin, ``ops.linear.predict_linear``: x·coef + b."""
    coef, intercept = params
    return LIN.predict_linear(x, coef, intercept)


def _linear_kernel_bf16(params, x: torch.Tensor) -> torch.Tensor:
    """x and coef rounded to bf16, their product in f32 (exact products,
    TF32 off), plus the f32 intercept: the JAX package's bf16 ``jnp.matmul``
    with ``preferred_element_type=f32``."""
    coef, intercept = params
    return LIN.predict_linear(_bf16_rounded(x), _bf16_rounded(coef), intercept)


def _scaler_kernel(params, x: torch.Tensor, *, with_mean: bool, with_std: bool) -> torch.Tensor:
    """The eager ``StandardScalerModel`` transform's device computation."""
    mean, std = params
    return S.standardize(x, mean, std, with_mean=with_mean, with_std=with_std)


def _forest_kernel(params, x: torch.Tensor, *, max_depth: int) -> torch.Tensor:
    """The eager forest descent, ``ops.forest.forest_apply``, with the rows
    axis first ([rows, T, C]) so that a batch slices by rows."""
    trees, thresholds = FO.TreeArrays(*params[:5]), params[5]
    return FO.forest_apply(trees, x, thresholds, max_depth=max_depth).transpose(0, 1).contiguous()


def _forest_finalize(leaf: np.ndarray, true_rows: int) -> np.ndarray:
    """Host decision rule of the eager classifier: each tree's leaf counts
    normalized, averaged over trees, argmax (float64 class ids)."""
    return forest_votes(np.ascontiguousarray(leaf[:true_rows].transpose(1, 0, 2)))[1]


def _identity_prepare(mat: np.ndarray) -> np.ndarray:
    return mat


def _identity_finalize(out: np.ndarray, true_rows: int) -> np.ndarray:
    return out[:true_rows]


def _host_tensor(padded: np.ndarray) -> torch.Tensor:
    """A float32 CPU tensor over the padded block (copied when numpy's block
    is read-only, as a wire payload is)."""
    host = np.ascontiguousarray(padded, dtype=X_DTYPE)
    if not host.flags.writeable:
        host = host.copy()
    return torch.from_numpy(host)


# -- CUDA graph rungs --------------------------------------------------------

# Captures are serialized process-wide: a capture is cheap and rare, and one
# at a time keeps the capture stream's set-up simple to reason about. One
# capture stream per device serves every entry (each stream that runs a
# cuBLAS product keeps a workspace of its own for the life of the process),
# and one hedge stream per device replays every hedge rung.
_CAPTURE_LOCK = threading.Lock()
_CAPTURE_STREAMS: dict[torch.device, Any] = {}
_HEDGE_STREAMS: dict[torch.device, Any] = {}


def _stream_for(streams: dict, device: torch.device):
    with _CAPTURE_LOCK:
        stream = streams.get(device)
        if stream is None:
            stream = streams[device] = torch.cuda.Stream(device)
        return stream


class _Rung:
    """One captured (entry, bucket) graph: its static device input and
    output, the pinned host staging of both, the event that ends a
    dispatch, and the lock that serializes its users."""

    __slots__ = ("bucket", "lock", "graph", "x", "out", "host_x", "host_out", "done")

    def __init__(self, bucket: int, n: int, device: torch.device):
        self.bucket = bucket
        self.lock = threading.Lock()
        self.graph: torch.cuda.CUDAGraph | None = None
        self.x = torch.zeros((bucket, n), dtype=torch.float32, device=device)
        self.host_x = torch.zeros((bucket, n), dtype=torch.float32, pin_memory=True)
        self.out: torch.Tensor | None = None
        self.host_out: torch.Tensor | None = None
        self.done = torch.cuda.Event()

    def run(self, padded: np.ndarray) -> np.ndarray:
        """One dispatch of a padded [bucket, n] host block on the current
        stream; the caller holds ``lock``. Returns a host copy of the raw
        [bucket, k] output."""
        np.copyto(self.host_x.numpy(), padded, casting="same_kind")
        self.x.copy_(self.host_x, non_blocking=True)
        self.graph.replay()
        self.host_out.copy_(self.out, non_blocking=True)
        self.done.record()
        self.done.synchronize()
        return self.host_out.numpy().copy()

    def release(self) -> None:
        """Drop the graph and its buffers; the caller holds ``lock``."""
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.x = self.out = self.host_x = self.host_out = None


def _release_rungs(rungs: dict[int, _Rung]) -> None:
    """Release every rung under its own lock (an in-flight replay finishes
    before its graph goes) and forget them."""
    for rung in rungs.values():
        with rung.lock:
            rung.release()
    rungs.clear()


@dataclass(eq=False)
class ServableEntry:
    """One registered model: its pure kernel, its device parameters (None
    while paged out, ``host_params`` holding them), its host ``prepare``
    hook, its captured rungs and the buckets already warm, and its hedge
    rung set (``hedge_buckets`` the warm ones, ``hedge_rungs`` their graphs
    on a card)."""

    name: str
    family: str
    model_cls: str
    n_features: int
    kernel: Callable
    params: tuple | None            # device tensors the kernel takes
    prepare: Callable               # host pre-pad hook, np -> np
    device: torch.device
    policy: str = "f32"
    finalize: Callable = _identity_finalize  # host post hook, (np, true_rows) -> np
    version: int = 1                # bumped by each hot swap of the slot
    warm_buckets: set[int] = field(default_factory=set)
    model: Any = None
    host_params: tuple | None = None
    rungs: dict[int, _Rung] = field(default_factory=dict)
    lock: threading.RLock = field(default_factory=threading.RLock)
    # the CPU's per-bucket dispatch locks (a card's are its rungs' locks)
    cpu_locks: dict[int, threading.Lock] = field(default_factory=dict)
    hedge_params: tuple | None = None
    hedge_rungs: dict[int, _Rung] = field(default_factory=dict)
    hedge_buckets: set[int] = field(default_factory=set)
    # set by ``release``: a dispatch that still holds the entry re-resolves
    # its slot by name
    released: bool = False

    def describe(self) -> dict:
        return {
            "name": self.name,
            "family": self.family,
            "model_class": self.model_cls,
            "n_features": self.n_features,
            "policy": self.policy,
            "version": self.version,
            "buckets": sorted(self.warm_buckets),
        }

    @property
    def resident(self) -> bool:
        return self.params is not None

    @property
    def graphed(self) -> bool:
        """Whether dispatches replay CUDA graphs (a CUDA device)."""
        return self.device.type == "cuda"

    # -- graphs ---------------------------------------------------------------

    def _capture_rung(self, bucket: int, params: tuple, device: torch.device) -> _Rung:
        """Capture the kernel over ``params`` at ``bucket`` rows on
        ``device``'s capture stream: one eager warm-up launch (the stream's
        cuBLAS workspace), then the graph."""
        stream = _stream_for(_CAPTURE_STREAMS, device)
        with _CAPTURE_LOCK:
            rung = _Rung(bucket, self.n_features, device)
            current = torch.cuda.current_stream(device)
            stream.wait_stream(current)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(stream):
                self.kernel(params, rung.x)
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    out = self.kernel(params, rung.x)
                finally:
                    graph.capture_end()
            current.wait_stream(stream)
            rung.graph, rung.out = graph, out
            rung.host_out = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        return rung

    def warm(self, bucket: int, reason: str) -> None:
        """Make ``bucket`` warm: capture its graph on a CUDA device and book
        the capture (``serve.aot_compiles`` at registration, at a swap and
        for a cold bucket, ``serve.graph_recaptures`` after paging). The
        parameters are resident."""
        with self.lock:
            if self.graphed:
                t0 = time.perf_counter()
                self.rungs[bucket] = self._capture_rung(bucket, self.params, self.device)
                compilemon.record_graph_capture(time.perf_counter() - t0, reason)
                if reason == "page_in":
                    REGISTRY.counter_inc(
                        "serve.graph_recaptures", model=self.name, bucket=bucket, reason=reason
                    )
                else:
                    REGISTRY.counter_inc("serve.aot_compiles", model=self.name, bucket=bucket)
            self.warm_buckets.add(bucket)

    def rung(self, bucket: int) -> _Rung | None:
        """The graph rung of ``bucket``, captured now (and booked as
        ``serve.cold_compiles``) when the bucket is outside the warm set;
        None when the parameters were paged out meanwhile."""
        with self.lock:
            if self.params is None:
                return None
            rung = self.rungs.get(bucket)
            if rung is None:
                if bucket in self.warm_buckets:
                    # only a capture that raised midway leaves a warm bucket
                    # without its graph
                    raise RuntimeError(f"{self.name}: the graph of bucket {bucket} is missing")
                REGISTRY.counter_inc("serve.cold_compiles", model=self.name, bucket=bucket)
                self.warm(bucket, "cold")
                rung = self.rungs[bucket]
            return rung

    def dispatch_lock(self, bucket: int) -> threading.Lock:
        """The lock a primary dispatch of ``bucket`` holds for its whole run:
        the rung's on a card, a per-bucket lock on the CPU."""
        with self.lock:
            if self.graphed:
                return self.rungs[bucket].lock
            return self.cpu_locks.setdefault(bucket, threading.Lock())

    # -- the hedge rung set ---------------------------------------------------

    def warm_hedge_rung(self, bucket: int, device: torch.device) -> None:
        """Add ``bucket`` to the hedge set: on a card, capture a rung of its
        own on ``device`` over the hedge copy of the parameters (booked as
        ``serve.aot_compiles{device="hedge"}``); on the CPU, mark the bucket
        (the hedge runs the kernel eagerly). The parameters are resident."""
        with self.lock:
            if self.hedge_params is None:
                self.hedge_params = (
                    tuple(p.to(device, copy=True) for p in self.params)
                    if self.graphed else self.params
                )
            if self.graphed:
                t0 = time.perf_counter()
                self.hedge_rungs[bucket] = self._capture_rung(bucket, self.hedge_params, device)
                compilemon.record_graph_capture(time.perf_counter() - t0, "hedge")
                REGISTRY.counter_inc(
                    "serve.aot_compiles", model=self.name, bucket=bucket, device="hedge"
                )
            self.hedge_buckets.add(bucket)

    # -- paging (driven by serving/hbm.py) ------------------------------------

    def page_out(self) -> None:
        """Drop every graph (each under its rung's lock, so an in-flight
        replay finishes first), then move the parameters to host memory,
        pinned for a CUDA device, and free them on the device. The hedge
        set keeps its own copy and stays."""
        with self.lock:
            if self.params is None:
                return
            _release_rungs(self.rungs)
            if self.host_params is None:
                self.host_params = tuple(
                    torch.empty(p.shape, dtype=p.dtype, pin_memory=p.is_cuda)
                    for p in self.params
                )
            for host, p in zip(self.host_params, self.params):
                host.copy_(p)
            self.params = None

    def page_in(self) -> None:
        """Copy the parameters back to the device and recapture every warm
        rung (``reason=page_in``)."""
        with self.lock:
            if self.params is not None:
                return
            self.params = tuple(h.to(self.device, copy=True) for h in self.host_params)
            for bucket in sorted(self.warm_buckets):
                self.warm(bucket, "page_in")

    def release(self) -> None:
        """Free the version for good (a pruned prior, a demoted or refused
        candidate): every graph, the hedge set's included, each under its
        rung's lock as ``page_out`` does, then the parameters and their host
        copies. A dispatch that still holds the entry re-resolves its slot."""
        with self.lock:
            self.released = True
            _release_rungs(self.rungs)
            _release_rungs(self.hedge_rungs)
            self.hedge_buckets.clear()
            self.params = self.host_params = self.hedge_params = None


# -- kernel extraction -------------------------------------------------------


def _consult_policy(family: str, n_features: int, device: torch.device) -> str:
    """A blessed serve-kernel precision policy from the tuning cache; only an
    explicit ``bf16_f32acc`` entry deviates from f32. A cache that cannot be
    read (a malformed file, say) is logged and serves f32: a tuner problem
    must not block serving."""
    try:
        cfg = tuning_cache.lookup(
            tuning_cache.cache_key(
                f"serve.{family}", n=n_features, device=tuning_cache.device_kind(device)
            )
        )
    except Exception:  # noqa: BLE001 - any tuner fault falls back to f32
        logger.exception("tuning-cache consult failed for serve.%s", family)
        return "f32"
    if cfg is not None and cfg.policy == "bf16_f32acc":
        return cfg.policy
    return "f32"


def servable_from_model(name: str, model: Any, device: torch.device) -> ServableEntry:
    """The pure ``kernel(params, x)`` and host hooks of a fitted model, its
    parameters on ``device``. Raises ``TypeError`` for a model with no serve
    contract."""
    if isinstance(model, StandardScalerModel) and model.std is not None:
        return ServableEntry(
            name=name,
            family="scaler",
            model_cls=type(model).__name__,
            n_features=int(np.asarray(model.std).shape[0]),
            kernel=functools.partial(
                _scaler_kernel, with_mean=model.getWithMean(), with_std=model.getWithStd()
            ),
            params=tuple(
                torch.tensor(np.asarray(a, dtype=X_DTYPE), device=device)
                for a in (model.mean, model.std)
            ),
            prepare=_identity_prepare,
            device=device,
            policy="f32",
            model=model,
        )
    if isinstance(model, _GLMModel) and model.coefficients is not None:
        coef = np.asarray(model.coefficients)
        if coef.ndim != 1:
            raise TypeError(
                f"{type(model).__name__} is not single-output — the linear "
                "serve contract covers [n]-coefficient GLMs"
            )
        n = int(coef.shape[0])
        policy = _consult_policy("linear", n, device)
        return ServableEntry(
            name=name,
            family="linear",
            model_cls=type(model).__name__,
            n_features=n,
            kernel=_linear_kernel_bf16 if policy == "bf16_f32acc" else _linear_kernel,
            params=(
                torch.tensor(coef.astype(X_DTYPE), device=device),
                torch.tensor(model.intercept, dtype=torch.float32, device=device),
            ),
            prepare=_identity_prepare,
            device=device,
            policy=policy,
            model=model,
        )
    if isinstance(model, RandomForestClassificationModel) and model.trees is not None:
        return ServableEntry(
            name=name,
            family="forest",
            model_cls=type(model).__name__,
            n_features=int(model.numFeatures),
            kernel=functools.partial(_forest_kernel, max_depth=model.maxTreeDepth),
            params=model.device_params(device),
            prepare=_identity_prepare,
            device=device,
            policy="f32",
            finalize=_forest_finalize,
            model=model,
        )
    if getattr(model, "bucketItems", None) is not None and getattr(
        model, "centroids", None
    ) is not None:
        # a fitted IVF index (ApproximateNearestNeighborsModel or the
        # streamed IVFFlatIndexModel): the ann subsystem owns the contract
        from spark_rapids_ml_tpu_torch.ann import serving as ann_serving

        return ann_serving.servable_from_index(name, model, device)
    if not isinstance(model, PCAModel) or model.pc is None:
        raise TypeError(
            f"{type(model).__name__} has no serve contract — servable families: "
            f"{', '.join(FAMILIES)} (the port serves fitted PCA, StandardScaler, "
            "single-output GLM, random-forest classifier and IVF index models)"
        )
    n = int(model.pc.shape[0])
    pc = torch.tensor(np.asarray(model.pc, dtype=X_DTYPE), device=device)
    policy = _consult_policy("pca", n, device)
    return ServableEntry(
        name=name,
        family="pca",
        model_cls=type(model).__name__,
        n_features=n,
        kernel=_pca_kernel_bf16 if policy == "bf16_f32acc" else _pca_kernel,
        params=(pc,),
        # eager parity: the standardization is host work before padding
        prepare=functools.partial(columnar.standardize_host, mean=model.mean, std=model.std),
        device=device,
        policy=policy,
        model=model,
    )


# -- the registry ------------------------------------------------------------


class ModelRegistry:
    """Holds fitted models, captures their kernels across the bucket ladder
    and dispatches padded blocks to the captured graphs, on ``device`` (the
    card unless the caller names the CPU; raises without a card)."""

    def __init__(self, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self._entries: dict[str, ServableEntry] = {}
        # the prior version of a hot-swapped slot, kept dispatchable and
        # resident until probation prunes it or a rollback restores it
        self._prior: dict[str, ServableEntry] = {}
        self._lock = threading.RLock()

    def register(
        self, name: str, model: Any, *, bucket_list: tuple[int, ...] | None = None
    ) -> ServableEntry:
        """Extract the model's kernel and capture it for every bucket of
        ``bucket_list`` (default: the whole serve ladder). After this returns,
        requests up to the ladder cap never capture."""
        entry = servable_from_model(name, model, self.device)
        ladder = tuple(bucket_list) if bucket_list else buckets.bucket_ladder()
        for b in ladder:
            entry.warm(b, "register")
        with self._lock:
            self._entries[name] = entry
            REGISTRY.gauge_set("serve.models", len(self._entries))
        REGISTRY.gauge_set("serve.model_version", entry.version, model=name)
        # book the parameters against the fleet budget; registering past it
        # pages the least recently used models out
        hbm.get_fleet().account(entry)
        logger.info(
            "registered servable %s (%s, n=%d, policy=%s, %d buckets)",
            name, entry.family, entry.n_features, entry.policy, len(ladder),
        )
        return entry

    def get(self, name: str) -> ServableEntry:
        with self._lock:
            try:
                return self._entries[name]
            except KeyError:
                raise KeyError(
                    f"no servable model {name!r} (registered: "
                    f"{sorted(self._entries) or 'none'})"
                ) from None

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._entries)

    def describe(self) -> list[dict]:
        with self._lock:
            return [e.describe() for _, e in sorted(self._entries.items())]

    # -- versioned hot swap and rollback --------------------------------------

    @staticmethod
    def _prior_key(name: str) -> str:
        return f"{name}{hbm.PRIOR_SUFFIX}"

    def _run_entry(self, entry: ServableEntry, mat: np.ndarray) -> np.ndarray:
        """Score a validated host matrix through one given entry: the shadow
        gate's scorer and ``predict``'s body without the name lookup (so a
        gate never races the slot it gates)."""
        prepared = entry.prepare(mat)
        if prepared.dtype != X_DTYPE:
            prepared = prepared.astype(X_DTYPE)
        bucket = buckets.serve_bucket(prepared.shape[0])
        padded, true_rows = buckets.pad_to_bucket(prepared, bucket)
        return entry.finalize(self.dispatch_padded(entry, padded, bucket), true_rows)

    @staticmethod
    def _shadow_divergence(live_out: np.ndarray, cand_out: np.ndarray) -> float:
        """The candidate's divergence from the live model on the shadow
        sample: max absolute difference over the live output's max
        magnitude, in f64. A shape mismatch or a non-finite value is
        infinite divergence."""
        a = np.asarray(live_out, dtype=np.float64)
        b = np.asarray(cand_out, dtype=np.float64)
        if a.shape != b.shape or not (np.all(np.isfinite(a)) and np.all(np.isfinite(b))):
            return float("inf")
        scale = float(np.max(np.abs(a))) + 1e-12
        return float(np.max(np.abs(a - b))) / scale

    def shadow_tolerance(self) -> float:
        """``TPU_ML_SWAP_SHADOW_TOLERANCE`` (0.25 when unset or malformed)."""
        return lenient_float(SWAP_SHADOW_TOLERANCE_VAR, DEFAULT_SWAP_SHADOW_TOLERANCE)

    def swap(
        self,
        name: str,
        model: Any,
        *,
        shadow_sample: np.ndarray | None = None,
        tolerance: float | None = None,
        bucket_list: tuple[int, ...] | None = None,
    ) -> ServableEntry:
        """Hot-swap slot ``name`` to a freshly fitted ``model``, atomically.

        The costly work comes before the publish: the candidate's graph is
        captured for every bucket of the live entry's warm set (booked as
        ``serve.aot_compiles``), so no request after the swap captures, and
        the shadow gate scores candidate and live on ``shadow_sample`` and
        raises ``SwapRefused`` past ``tolerance`` (default
        ``TPU_ML_SWAP_SHADOW_TOLERANCE``). The publish is one dict store under
        the registry lock; its hold is the blackout
        (``serve.swap_blackout_seconds``). In-flight dispatches finish on the
        entry they hold. The displaced version stays resident, booked as
        ``<name>@prior``, until ``prune_prior`` or ``rollback``."""
        live = self.get(name)
        candidate = servable_from_model(name, model, self.device)
        if candidate.n_features != live.n_features:
            REGISTRY.counter_inc("serve.swap_refused", model=name, reason="shape")
            raise SwapRefused(
                f"swap of {name!r} refused: candidate n_features "
                f"{candidate.n_features} != live {live.n_features}"
            )
        try:
            ladder = (
                tuple(bucket_list) if bucket_list
                else tuple(sorted(live.warm_buckets)) or buckets.bucket_ladder()
            )
            for b in ladder:
                candidate.warm(b, "swap")
            if shadow_sample is not None and len(shadow_sample):
                sample = validate_request(shadow_sample, live.n_features, name)
                div = self._shadow_divergence(
                    self._run_entry(live, sample), self._run_entry(candidate, sample)
                )
                tol = self.shadow_tolerance() if tolerance is None else tolerance
                if div > tol:
                    REGISTRY.counter_inc("serve.swap_refused", model=name, reason="shadow")
                    raise SwapRefused(
                        f"swap of {name!r} refused by the shadow gate: relative "
                        f"divergence {div:.3g} > tolerance {tol:.3g} on "
                        f"{len(sample)} held-back rows"
                    )
            # the swap barrier: an injected hang or death lands before the
            # publish, so the old version keeps serving (never a torn slot)
            faults.inject(sites.SERVE_SWAP)
        except BaseException:
            candidate.release()
            raise
        t0 = time.perf_counter()
        with self._lock:
            prior = self._entries.get(name, live)
            candidate.version = prior.version + 1
            self._entries[name] = candidate
            stale = self._prior.get(name)
            self._prior[name] = prior
        blackout = time.perf_counter() - t0
        REGISTRY.histogram_record("serve.swap_blackout_seconds", blackout, model=name)
        REGISTRY.counter_inc("serve.swaps", model=name)
        REGISTRY.gauge_set("serve.model_version", candidate.version, model=name)
        TIMELINE.record_instant("serve.swap", model=name, version=candidate.version)
        # the prior's booking moves to the prior key, where it stays resident
        # (a rollback must not page) until probation clears; the candidate
        # books under the live key
        fleet = hbm.get_fleet()
        fleet.forget(name)
        fleet.account(prior, key=self._prior_key(name))
        fleet.account(candidate)
        if stale is not None and stale is not prior:
            stale.release()  # a prior still held from an earlier swap
        logger.info(
            "hot-swapped servable %s to version %d (blackout %.3f ms)",
            name, candidate.version, blackout * 1e3,
        )
        return candidate

    def rollback(self, name: str) -> ServableEntry:
        """Restore the retained prior version of ``name`` with its graphs as
        they are (no recapture): the probation escape hatch. Atomic like the
        swap; the demoted candidate is released after the publish (an
        in-flight replay on it finishes first)."""
        with self._lock:
            prior = self._prior.pop(name, None)
            if prior is None:
                raise KeyError(f"no prior version of {name!r} to roll back to")
            demoted = self._entries.get(name)
            self._entries[name] = prior
        REGISTRY.counter_inc("serve.rollback", model=name)
        REGISTRY.gauge_set("serve.model_version", prior.version, model=name)
        TIMELINE.record_instant("serve.rollback", model=name, version=prior.version)
        fleet = hbm.get_fleet()
        fleet.account(prior)  # rebooked under the live key, most recently used
        fleet.forget(self._prior_key(name))
        if demoted is not None and demoted is not prior:
            demoted.release()
        logger.warning("rolled back servable %s to version %d", name, prior.version)
        return prior

    def prune_prior(self, name: str) -> bool:
        """Probation cleared: free the retained prior version (its graphs,
        each under its rung's lock, and its parameters) and forget its
        booking. False when there is none."""
        with self._lock:
            prior = self._prior.pop(name, None)
        if prior is None:
            return False
        hbm.get_fleet().forget(self._prior_key(name))
        prior.release()
        logger.info(
            "pruned prior version %d of servable %s (probation cleared)", prior.version, name
        )
        return True

    def prior_entry(self, name: str) -> ServableEntry | None:
        with self._lock:
            return self._prior.get(name)

    def current_version(self, name: str) -> int:
        return self.get(name).version

    # -- dispatch -------------------------------------------------------------

    def dispatch_padded(
        self, entry: ServableEntry, padded: np.ndarray, bucket: int
    ) -> np.ndarray:
        """Run one padded [bucket, n] block through the entry's graph (its
        kernel, eagerly, on the CPU, under the bucket's lock); returns the
        raw, still padded output as a host array. Pages the parameters back
        in first when the fleet evicted them. An entry released meanwhile (a
        pruned prior, a demoted candidate) hands the block to its slot's
        current version."""
        # the fault gate, counted per process: before any state, so a retry
        # re-enters clean
        faults.inject(sites.SERVE_DISPATCH)
        if padded.shape != (bucket, entry.n_features):
            raise ValueError(
                f"padded block {padded.shape} is not [{bucket}, {entry.n_features}]"
            )
        fleet = hbm.get_fleet()
        while True:
            if entry.released:
                entry = self.get(entry.name)
                continue
            fleet.ensure_resident(entry)
            if not entry.graphed:
                with entry.lock:
                    if bucket not in entry.warm_buckets:
                        REGISTRY.counter_inc(
                            "serve.cold_compiles", model=entry.name, bucket=bucket
                        )
                        entry.warm_buckets.add(bucket)
                    params = entry.params
                if params is None:
                    continue
                with entry.dispatch_lock(bucket):
                    return entry.kernel(params, _host_tensor(padded)).numpy()
            rung = entry.rung(bucket)
            if rung is None:
                continue  # paged out or released between the two calls
            with rung.lock:
                if rung.graph is not None:
                    return rung.run(padded)

    # -- hedged dispatch ------------------------------------------------------

    def warm_hedge(
        self,
        name: str,
        *,
        bucket_list: tuple[int, ...] | None = None,
        device_index: int = 1,
    ) -> int:
        """Capture the model's hedge rung set, so that a hedged resend runs
        there instead of queueing behind the primary: on card
        ``device_index`` when the host has it, else on the entry's card on a
        hedge stream of its own. Returns the number of hedge rungs (on the
        CPU, of hedge buckets); buckets outside the warm set are skipped."""
        entry = self.get(name)
        ladder = tuple(bucket_list) if bucket_list else tuple(sorted(entry.warm_buckets))
        device = entry.device
        if entry.graphed and device_index < torch.cuda.device_count():
            device = torch.device("cuda", device_index)
        hbm.get_fleet().ensure_resident(entry)  # the hedge copies the parameters
        warmed = 0
        for b in ladder:
            if b in entry.warm_buckets:
                entry.warm_hedge_rung(b, device)
                warmed += 1
        return warmed

    def hedge_dispatch_padded(
        self, entry: ServableEntry, padded: np.ndarray, bucket: int
    ) -> np.ndarray:
        """The straggler resend: one dispatch through the entry's hedge
        rung set, the hedge rung's replay on the hedge device's hedge stream
        under the hedge rung's lock (on the CPU, the kernel, eagerly). It
        takes no primary rung's lock and no fault gate, and raises when
        ``bucket`` has no warm hedge rung."""
        if padded.shape != (bucket, entry.n_features):
            raise ValueError(
                f"padded block {padded.shape} is not [{bucket}, {entry.n_features}]"
            )
        if bucket not in entry.hedge_buckets:
            raise RuntimeError(f"{entry.name}: no warm hedge rung for bucket {bucket}")
        if not entry.graphed:
            return entry.kernel(entry.hedge_params, _host_tensor(padded)).numpy()
        rung = entry.hedge_rungs[bucket]
        with rung.lock:
            if rung.graph is None:
                raise RuntimeError(f"{entry.name}: the hedge rung of bucket {bucket} was released")
            with torch.cuda.stream(_stream_for(_HEDGE_STREAMS, rung.x.device)):
                return rung.run(padded)

    def predict(self, name: str, x: Any) -> np.ndarray:
        """The direct (unbatched) serve path: validate, prepare, pad,
        dispatch, slice. The micro-batcher uses the same pieces but
        coalesces several requests into one dispatch."""
        entry = self.get(name)
        mat = validate_request(x, entry.n_features, name)
        prepared = entry.prepare(mat)
        if prepared.dtype != X_DTYPE:
            # the one conversion to the device dtype
            prepared = prepared.astype(X_DTYPE)
        bucket = buckets.serve_bucket(prepared.shape[0])
        REGISTRY.counter_inc("serve.bucket_hits", model=name, bucket=bucket)
        padded, true_rows = buckets.pad_to_bucket(prepared, bucket)
        raw = self.dispatch_padded(entry, padded, bucket)
        REGISTRY.counter_inc("serve.rows", true_rows, model=name)
        return entry.finalize(raw, true_rows)


_REGISTRY_LOCK = threading.Lock()
_MODEL_REGISTRY: ModelRegistry | None = None


def get_registry(device: str | torch.device | None = None) -> ModelRegistry:
    """The process-wide registry the serve front end publishes, made on
    ``device`` (default the card) at the first call. Naming a device that
    differs from the existing registry's raises."""
    global _MODEL_REGISTRY
    with _REGISTRY_LOCK:
        if _MODEL_REGISTRY is None:
            _MODEL_REGISTRY = ModelRegistry("cuda" if device is None else device)
        elif device is not None and resolve_device(device) != _MODEL_REGISTRY.device:
            raise ValueError(
                f"the process's serve registry is on {_MODEL_REGISTRY.device}, "
                f"not {device}"
            )
        return _MODEL_REGISTRY


def reset_for_tests() -> None:
    """Drop the singleton registry and the fleet (tests)."""
    global _MODEL_REGISTRY
    with _REGISTRY_LOCK:
        _MODEL_REGISTRY = None
    hbm.reset_fleet()
