"""Graph-capture and device-memory observability.

The torch counterpart of ``spark_rapids_ml_tpu/telemetry/compilemon.py``.
Where the JAX package listens to XLA's compile events, the port's serving
registry captures one CUDA graph per (model, bucket) rung, and each capture
is booked here by the code that makes it (``record_graph_capture``):

- ``compile.graph_captures{reason}``: one per captured graph, ``reason``
  being ``register`` (the ladder at registration), ``cold`` (a bucket
  outside the warm set, captured on demand), ``page_in`` (the ladder
  recaptured after HBM paging moved the model's parameters), ``swap`` (a
  hot-swap candidate's ladder, captured before the publish) or ``hedge``
  (the hedge rung set ``warm_hedge`` captures);
- ``compile.graph_capture_seconds``: host seconds of each capture, the warm-up
  launch included.

Device memory has no event stream: ``sample_device_memory`` polls
``torch.cuda.memory_stats()`` and ``torch.cuda.mem_get_info()`` into
per-device gauges under the JAX package's keys (``bytes_in_use``,
``peak_bytes_in_use``, ``bytes_limit``), which ``serving/hbm.py`` reads.
"""

from __future__ import annotations

import torch

from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY

CAPTURE_REASONS = ("register", "cold", "page_in", "swap", "hedge")


def record_graph_capture(seconds: float, reason: str) -> None:
    """Book one CUDA graph capture of ``seconds`` host time."""
    if reason not in CAPTURE_REASONS:
        raise ValueError(f"capture reason {reason!r} must be one of {CAPTURE_REASONS}")
    REGISTRY.counter_inc("compile.graph_captures", reason=reason)
    REGISTRY.histogram_record("compile.graph_capture_seconds", seconds, reason=reason)


def sample_device_memory() -> dict[str, dict[str, int]]:
    """Per-card memory into gauges; returns the sampled map
    ``{"cuda:i": {bytes_in_use, peak_bytes_in_use, bytes_limit}}``.

    ``bytes_in_use`` and ``peak_bytes_in_use`` are the caching allocator's
    allocated bytes (``allocated_bytes.all.current``/``.peak``);
    ``bytes_limit`` is the card's total memory from ``mem_get_info``. Empty
    without a card, and when CUDA is not initialized yet (sampling must
    never be what first creates a context)."""
    out: dict[str, dict[str, int]] = {}
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        _free, total = torch.cuda.mem_get_info(i)
        dev = f"cuda:{i}"
        out[dev] = {
            "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(total),
        }
        for k, v in out[dev].items():
            REGISTRY.gauge_set(f"device.{k}", v, device=dev)
    return out
