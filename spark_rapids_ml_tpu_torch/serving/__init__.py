"""Serving runtime of the port: bucket ladder, CUDA-graph registry,
micro-batcher, HBM paging and the HTTP/UDS/fast-lane front ends.

Port of ``spark_rapids_ml_tpu/serving/``:

- ``buckets``: power-of-two row buckets with zero padding; the enumerable
  ladder that makes "no capture after registration" a guarantee;
- ``registry``: servable extraction and one CUDA graph per (model, bucket),
  captured at ``register()``; dispatch replays it; the versioned hot swap
  (shadow gate, ``SwapRefused``), rollback and the hedge rung set;
- ``batcher``: concurrent requests for one (model, bucket) coalesce into
  one dispatch inside an adaptive window; a straggling dispatch is hedged;
- ``hbm``: parameter accounting against a budget and LRU paging to pinned
  host memory, the graphs dropped and recaptured around it;
- ``fastlane``: the JSON-free binary frame, pooled response buffers, the
  counted JSON codec;
- ``server``: ``/v1/models`` and ``/v1/models/<name>:predict`` over HTTP
  (JSON and binary) on the telemetry exporter, plus the UDS listener;
- ``client``: the in-process transport over the same batcher;
- ``fleet``: N replica server processes behind a consistent-hash router,
  with rolling restarts, fleet-wide swaps and a merged exporter.

Submodules load lazily; ``buckets`` and ``fastlane`` need no card.
"""

from __future__ import annotations

import importlib

_SUBMODULES = (
    "buckets", "registry", "batcher", "server", "client", "hbm", "fastlane", "fleet",
)

_LAZY_ATTRS = {
    "serve_bucket": "buckets",
    "bucket_ladder": "buckets",
    "pad_to_bucket": "buckets",
    "ModelRegistry": "registry",
    "ServableEntry": "registry",
    "servable_from_model": "registry",
    "get_registry": "registry",
    "reset_for_tests": "registry",
    "validate_request": "registry",
    "SwapRefused": "registry",
    "MicroBatcher": "batcher",
    "ServeFuture": "batcher",
    "ServingHTTPServer": "server",
    "ServeUDSListener": "server",
    "start_serving": "server",
    "stop_serving": "server",
    "get_serving_server": "server",
    "ServeClient": "client",
    "get_client": "client",
    "HbmFleetManager": "hbm",
    "ServeShed": "hbm",
    "get_fleet": "hbm",
    "FastlaneError": "fastlane",
    "ResponseBufferPool": "fastlane",
    "ServeFleet": "fleet",
    "HashRing": "fleet",
    "plan_placement": "fleet",
}

__all__ = list(_SUBMODULES) + sorted(_LAZY_ATTRS)


def __getattr__(name: str):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    target = _LAZY_ATTRS.get(name)
    if target is not None:
        return getattr(importlib.import_module(f"{__name__}.{target}"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
