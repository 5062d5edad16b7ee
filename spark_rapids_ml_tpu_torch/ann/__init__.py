"""ANN vector search of the port: the IVF-Flat index's build and serving.

Counterpart of ``spark_rapids_ml_tpu/ann/``:

- :mod:`.index`: ``IVFFlatIndex``, the out-of-core index build (a
  streamed k-means‖-initialized quantizer fit through
  ``spark.ingest.stream_fold``, then a streamed assignment and a host pack
  with the skew-aware cap and exact spill list of ``ops/ivf.py``), and
  ``IVFFlatIndexModel`` with its per-call ``nprobe``;
- :mod:`.serving`: indexes as the ``"ann"`` servable family of the serving
  runtime (a CUDA graph per ladder rung, the micro-batcher, HBM paging),
  answered at ``/v1/indexes/<name>:query`` over HTTP, UDS and the fast
  lane, and in process.

Everything is imported lazily.
"""

from __future__ import annotations

import importlib

_SUBMODULES = ("index", "serving")

_LAZY_ATTRS = {
    # index
    "IVFFlatIndex": "index",
    "IVFFlatIndexModel": "index",
    # serving
    "register_index": "serving",
    "servable_from_index": "serving",
    "query": "serving",
    "query_direct": "serving",
    "unpack_query_result": "serving",
}

__all__ = list(_SUBMODULES) + sorted(_LAZY_ATTRS)


def __getattr__(name: str):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    target = _LAZY_ATTRS.get(name)
    if target is not None:
        module = importlib.import_module(f"{__name__}.{target}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
