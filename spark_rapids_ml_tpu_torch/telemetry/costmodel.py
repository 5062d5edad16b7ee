"""Analytical kernel cost accounting: how fast a kernel *should* run.

Port of ``spark_rapids_ml_tpu/telemetry/costmodel.py``, with its API
(``capture``, ``kernel_costs``, ``reset``, ``window_summary``) and its
counters: every capture books ``costmodel.calls``, ``costmodel.flops`` and
``costmodel.bytes`` labelled ``kernel=<name>``, so a fit or transform window
(a registry snapshot delta) rolls up the analytical work it dispatched, also
when the kernels ran in local Spark worker processes: the counters ride the
worker's telemetry trailer.

Where the numbers come from differs. The JAX package reads XLA's
``cost_analysis()`` of the lowered program; torch has no counterpart, so
``capture(kernel, fn, *args, **kw)`` reads the analytical cost from the
callable: a ``cost(*args, **kw) -> (flops, bytes)`` attribute, which the
port's ``ops`` functions carry (``linalg.gram_stats``, ``gram_fold_step``'s
step, ``linalg.project``, ``linear.linear_fold_step``'s step). ``cost``
sees each tensor argument as a meta tensor of its shape and dtype (a tuple
argument, such as a fold's carry, as a tuple of them), so it never reads
data or waits for the card. It is computed once per shape and dtype
signature, as the JAX ``_sig`` memoizes, and each call books its own
signature's numbers; the JAX capture books the largest signature's for
every call of a kernel, which overcounts a ragged tail chunk or a smaller
partition. ``kernel_costs`` keeps the largest signature's entry per kernel,
as the JAX table does. A callable without a ``cost``, or
one whose ``cost`` raises, returns ``None`` and books nothing, as a
callable that does not lower does in the JAX package: capture never raises
into a fit.

The memory fields of a kernel's entry: ``argument_bytes`` is the bytes of
its tensor arguments and ``output_bytes`` what the cost's bytes count beyond
them (0 for a fold that updates its carry in place). XLA's ``temp_bytes``
has no counterpart and is left out.

``window_summary`` turns a delta into the ``cost_model`` dict of
``FitReport``/``TransformReport``: per-kernel calls and per-call cost,
window totals and a roofline utilization, analytical flops over
(wall seconds × peak). The peak is ``TPU_ML_PEAK_TFLOPS``, by default
``DEFAULT_PEAK_TFLOPS``: the NVIDIA H100 SXM5 80GB HBM3's dense bf16 tensor
peak at its 700 W limit (the data sheet's 989.4 TFLOP/s), not the JAX
module's TPU v5e figure.
"""

from __future__ import annotations

import logging
import os
import threading

import torch

from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY
from spark_rapids_ml_tpu_torch.utils.config import PEAK_TFLOPS_VAR

logger = logging.getLogger("spark_rapids_ml_tpu_torch")

# NVIDIA H100 SXM5 (80GB HBM3, 700 W) dense bf16 tensor-core peak, data sheet
DEFAULT_PEAK_TFLOPS = 989.4

_LOCK = threading.Lock()
_KERNELS: dict[str, dict] = {}  # kernel name -> its largest signature's entry
_ENTRIES: dict[tuple, dict] = {}  # (kernel, signature) -> its per-call entry
_FAILED: set = set()  # (kernel, signature) without a cost

_MEMORY_FIELDS = ("argument_bytes", "output_bytes")


def peak_flops() -> float:
    """The card's peak FLOP/s, the roofline's denominator."""
    try:
        return float(os.environ.get(PEAK_TFLOPS_VAR, DEFAULT_PEAK_TFLOPS)) * 1e12
    except (TypeError, ValueError):
        return DEFAULT_PEAK_TFLOPS * 1e12


def _sig(a) -> str:
    """Shape and dtype signature of one argument (never reads data)."""
    if isinstance(a, torch.Tensor):
        return f"{a.dtype}{tuple(a.shape)}"
    if isinstance(a, (tuple, list)):
        return "(" + ",".join(_sig(x) for x in a) + ")"
    return repr(a)[:48]


def _meta(a):
    """A tensor as a meta tensor of its shape and dtype; tuples item by item
    (a NamedTuple keeps its type); anything else as it is."""
    if isinstance(a, torch.Tensor):
        return torch.empty(a.shape, dtype=a.dtype, device="meta")
    if isinstance(a, tuple):
        items = [_meta(x) for x in a]
        return type(a)(*items) if hasattr(a, "_fields") else tuple(items)
    return a


def _tensor_bytes(a) -> int:
    if isinstance(a, torch.Tensor):
        return a.numel() * a.element_size()
    if isinstance(a, (tuple, list)):
        return sum(_tensor_bytes(x) for x in a)
    return 0


def _analyze(kernel: str, fn, args, kwargs) -> dict | None:
    cost = getattr(fn, "cost", None)
    if cost is None:
        return None
    try:
        flops, nbytes = cost(*(_meta(a) for a in args), **kwargs)
    except Exception:  # noqa: BLE001 - analysis must never break dispatch
        logger.debug("cost analysis failed for kernel %s", kernel, exc_info=True)
        return None
    argument_bytes = sum(_tensor_bytes(a) for a in args)
    return {
        "flops": float(flops),
        "bytes_accessed": float(nbytes),
        "argument_bytes": int(argument_bytes),
        "output_bytes": int(max(0.0, float(nbytes) - argument_bytes)),
    }


def capture(kernel: str, fn, *args, **kwargs) -> dict | None:
    """Book one dispatch of ``kernel`` against the analytical cost model.

    Call at the dispatch site with the callable and the arguments about to
    be passed. Returns this call's entry, or ``None`` when ``fn`` has no
    ``cost`` (then the window has no cost model for it)."""
    try:
        key = (kernel, tuple(_sig(a) for a in args),
               tuple((k, _sig(v)) for k, v in sorted(kwargs.items())))
    except Exception:  # noqa: BLE001
        return None
    with _LOCK:
        if key in _FAILED:
            return None
        entry = _ENTRIES.get(key)
    if entry is None:
        entry = _analyze(kernel, fn, args, kwargs)
        with _LOCK:
            if entry is None:
                _FAILED.add(key)
                return None
            _ENTRIES[key] = entry
            cur = _KERNELS.get(kernel)
            if cur is None or entry["flops"] >= cur["flops"]:
                _KERNELS[kernel] = dict(entry)
    REGISTRY.counter_inc("costmodel.calls", 1, kernel=kernel)
    if entry["flops"]:
        REGISTRY.counter_inc("costmodel.flops", entry["flops"], kernel=kernel)
    if entry["bytes_accessed"]:
        REGISTRY.counter_inc("costmodel.bytes", entry["bytes_accessed"], kernel=kernel)
    return entry


def kernel_costs() -> dict[str, dict]:
    """Copy of the in-process table (kernel -> its largest call's entry)."""
    with _LOCK:
        return {k: dict(v) for k, v in _KERNELS.items()}


def reset() -> None:
    """Drop every cached analysis (tests)."""
    with _LOCK:
        _KERNELS.clear()
        _ENTRIES.clear()
        _FAILED.clear()


def window_summary(delta, wall_seconds: float) -> dict:
    """Cost-model rollup of one capture window (a registry snapshot delta),
    from the ``costmodel.*`` counters, so worker-side captures count; the
    local table adds the memory fields where this process captured the
    kernel. ``{}`` when the window dispatched no captured kernel."""
    calls: dict[str, float] = {}
    flops: dict[str, float] = {}
    nbytes: dict[str, float] = {}
    by_name = {"costmodel.calls": calls, "costmodel.flops": flops, "costmodel.bytes": nbytes}
    for (name, labels), v in delta.counters.items():
        dest = by_name.get(name)
        if dest is None:
            continue
        kernel = dict(labels).get("kernel", "")
        if kernel:
            dest[kernel] = dest.get(kernel, 0.0) + v
    if not calls:
        return {}
    local = kernel_costs()
    kernels: dict[str, dict] = {}
    for kernel, n in sorted(calls.items()):
        n = max(n, 1.0)
        entry = {
            "calls": int(n),
            "flops": flops.get(kernel, 0.0) / n,
            "bytes_accessed": nbytes.get(kernel, 0.0) / n,
        }
        for field in _MEMORY_FIELDS:
            v = local.get(kernel, {}).get(field)
            if v is not None:
                entry[field] = v
        kernels[kernel] = entry
    total_flops = sum(flops.values())
    peak = peak_flops()
    out = {
        "kernels": kernels,
        "analytical_flops": total_flops,
        "analytical_bytes": sum(nbytes.values()),
        "peak_flops": peak,
    }
    if wall_seconds > 0 and total_flops > 0:
        achieved = total_flops / wall_seconds
        out["achieved_flop_s"] = achieved
        if peak > 0:
            out["roofline_utilization"] = achieved / peak
    return out
