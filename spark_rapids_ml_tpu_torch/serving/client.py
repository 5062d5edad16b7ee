"""In-process serve transport: co-located callers skip framing entirely.

Port of ``spark_rapids_ml_tpu/serving/client.py`` (``ServeClient``,
``predict``). ``ServeClient.predict`` submits straight to the same
micro-batcher the HTTP and UDS front ends use, so in-process requests
coalesce into the same dispatches as network traffic and book the same
``serve.*`` series (``transport=inproc``).

With the process's front end running (``serving.server.start_serving``)
the client binds to its batcher; otherwise it starts a private batcher over
its registry (default: the process's registry, on the card; raises without
one). Errors are re-raised as they came, after booking the status code the
HTTP layer would give them.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from spark_rapids_ml_tpu_torch.serving import server as server_mod
from spark_rapids_ml_tpu_torch.serving.batcher import MicroBatcher
from spark_rapids_ml_tpu_torch.serving.registry import ModelRegistry, get_registry
from spark_rapids_ml_tpu_torch.telemetry import tracectx
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY
from spark_rapids_ml_tpu_torch.telemetry.timeline import TIMELINE


class ServeClient:
    """Zero-framing in-process predict path over the shared micro-batcher."""

    def __init__(
        self,
        batcher: MicroBatcher | None = None,
        *,
        registry: ModelRegistry | None = None,
    ):
        self._registry = registry
        self._explicit = batcher
        self._own: MicroBatcher | None = None
        self._lock = threading.Lock()

    def _batcher(self) -> MicroBatcher:
        if self._explicit is not None:
            return self._explicit
        srv = server_mod.get_serving_server()
        if srv is not None:
            return srv.batcher
        with self._lock:
            if self._own is None:
                self._own = MicroBatcher(
                    self._registry if self._registry is not None else get_registry()
                ).start()
            return self._own

    def predict(self, model: str, x, timeout: float = 30.0) -> np.ndarray:
        """Score one request through the shared batcher; blocks for the
        coalesced dispatch and returns the host array."""
        t0 = time.perf_counter()
        # adopt an ambient context (a traced caller) or mint a sampled one
        parent = tracectx.current_trace()
        ctx = parent.child() if parent is not None else tracectx.mint(origin="inproc")
        try:
            out = self._batcher().submit(model, x, trace=ctx).result(timeout)
        except Exception as e:
            code = server_mod.status_for_error(e)
            REGISTRY.counter_inc("serve.errors", model=model, code=code)
            REGISTRY.counter_inc("serve.requests", model=model, code=code)
            if ctx is not None:
                TIMELINE.record_span(
                    "serve.request", t0, time.perf_counter(),
                    model=model, transport="inproc", code=str(code),
                    **tracectx.span_labels(ctx, parent=parent),
                )
            raise
        latency = time.perf_counter() - t0
        REGISTRY.counter_inc("serve.requests", model=model, code=200)
        REGISTRY.counter_inc("serve.transport", transport="inproc", wire="array")
        REGISTRY.histogram_record(
            "serve.latency", latency,
            exemplar=ctx.trace_hex if ctx is not None else "",
            model=model, transport="inproc", wire="array",
        )
        if ctx is not None:
            TIMELINE.record_span(
                "serve.request", t0, time.perf_counter(),
                model=model, transport="inproc", wire="array",
                **tracectx.span_labels(ctx, parent=parent),
            )
        return out

    def close(self, timeout: float = 5.0) -> None:
        """Stop the private batcher, if one was started; the front end's
        batcher is never stopped from here."""
        with self._lock:
            own, self._own = self._own, None
        if own is not None:
            own.stop(timeout)


_CLIENT_LOCK = threading.Lock()
_CLIENT: ServeClient | None = None


def get_client() -> ServeClient:
    """The process-wide in-process client."""
    global _CLIENT
    with _CLIENT_LOCK:
        if _CLIENT is None:
            _CLIENT = ServeClient()
        return _CLIENT


def predict(model: str, x, timeout: float = 30.0) -> np.ndarray:
    """``get_client().predict(...)``."""
    return get_client().predict(model, x, timeout)


def reset_client() -> None:
    """Drop (and stop) the singleton client (tests)."""
    global _CLIENT
    with _CLIENT_LOCK:
        client, _CLIENT = _CLIENT, None
    if client is not None:
        client.close()
