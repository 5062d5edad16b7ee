"""Serve front ends: HTTP (JSON and binary), a UDS listener, the fast lane.

Port of ``spark_rapids_ml_tpu/serving/server.py``. The handler extends the
telemetry exporter's (``telemetry/httpd.py``), so one port serves both the
scrape surface (``/metrics``, ``/traces``) and the prediction API.

- ``GET  /v1/models``: registered servables (name, family, feature count,
  precision policy, warm buckets).
- ``POST /v1/models/<name>:predict``: a JSON body ``{"instances": [[...],
  ...]}``, or the binary wire: ``Content-Type: application/x-tpu-ml-f32``,
  an ``X-Shape: rows,features`` header and a row-major little-endian f32
  body, viewed in place (``np.frombuffer``) and kept f32 end to end. With
  ``Accept: application/x-tpu-ml-f32`` the answer comes back the same way,
  cast into a pooled buffer. Requests ride the micro-batcher.
- ``GET  /v1/indexes``: the registered ANN indexes (the ``"ann"`` family).
- ``POST /v1/indexes/<name>:query``: the same payloads, answered with
  ``{"index", "rows", "ids", "distances", "latency_ms"}`` in JSON, or the
  packed [rows, 2k] ``distances | ids`` block on the binary wire with an
  ``X-ANN-K`` header (ids exact up to 2^24 there, 2^53 in JSON). A name
  that is not an index answers 404. Each answered query books
  ``ann.queries``.

``TPU_ML_SERVE_UDS_PATH`` (or ``uds_path``) starts a Unix-socket listener
with the length-prefixed JSON-header protocol (``_uds_handle_one``) and,
on the same socket, the fast lane (``serving/fastlane.py``): a frame that
opens with ``FASTLANE_MAGIC`` goes from its fixed struct to the batcher
without a dict or a JSON codec pass. Both take ANN queries: a UDS header
with ``"kind": "query"``, a fast-lane frame with ``FLAG_QUERY``. A UDS
header with ``"kind": "stats"`` is the fleet's scrape frame: the answer is
the process's registry and flight-recorder tail (``since_seq``), in plain
JSON.

Every request books ``serve.requests`` and a ``serve.latency`` histogram
sample (labels model, transport, wire); failures book ``serve.errors``.
Status codes: 400 for a malformed body (naming the accepted dtypes), 404
for an unknown model or path, 413 for a request above the ladder cap, 503
for a shed request, 500 otherwise.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import socketserver
import threading
import time

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.ann.serving import unpack_query_result
from spark_rapids_ml_tpu_torch.serving import buckets, fastlane, hbm
from spark_rapids_ml_tpu_torch.serving.batcher import (
    MicroBatcher,
    adaptive_window_enabled,
    coalesce_window_s,
)
from spark_rapids_ml_tpu_torch.serving.registry import (
    ACCEPTED_DTYPES,
    ModelRegistry,
    get_registry,
)
from spark_rapids_ml_tpu_torch.telemetry import httpd, tracectx
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY
from spark_rapids_ml_tpu_torch.telemetry.timeline import TIMELINE
from spark_rapids_ml_tpu_torch.utils.config import SERVE_UDS_PATH_VAR

logger = logging.getLogger("spark_rapids_ml_tpu_torch.serving")

PREDICT_SUFFIX = ":predict"
QUERY_SUFFIX = ":query"
#: binary-wire header of an index query's answer: its k
ANN_K_HEADER = "X-ANN-K"

#: The binary wire: row-major little-endian float32.
BINARY_CONTENT_TYPE = "application/x-tpu-ml-f32"
SHAPE_HEADER = "X-Shape"


def require_index(registry: ModelRegistry, name: str) -> None:
    """Raise ``KeyError`` (404) unless ``name`` is a registered ANN index."""
    entry = registry.get(name)
    if entry.family != "ann":
        raise KeyError(f"{name!r} is a {entry.family} servable, not an ann index")


def status_for_error(err: BaseException) -> int:
    """The HTTP status an exception maps to, shared by every transport so
    the ``code`` labels stay comparable across HTTP, UDS and in-process."""
    if isinstance(err, KeyError):
        return 404
    if isinstance(err, hbm.ServeShed):
        return 503
    if isinstance(err, ValueError):
        return 413 if "ladder cap" in str(err) else 400
    return 500


def parse_binary_payload(body: bytes, shape_header: str) -> np.ndarray:
    """View a binary f32 request body as a ``[rows, features]`` matrix,
    without a copy."""
    dims = [d.strip() for d in (shape_header or "").split(",") if d.strip()]
    if len(dims) != 2 or not all(d.lstrip("-").isdigit() for d in dims):
        raise ValueError(
            f"binary payload needs {SHAPE_HEADER}: rows,features (got {shape_header!r})"
        )
    rows, cols = int(dims[0]), int(dims[1])
    if rows <= 0 or cols <= 0:
        raise ValueError(f"{SHAPE_HEADER} dims must be positive, got {rows},{cols}")
    expected = rows * cols * 4
    if len(body) != expected:
        raise ValueError(
            f"binary payload is {len(body)} byte(s), expected {expected} "
            f"for {rows}x{cols} float32"
        )
    return np.frombuffer(body, dtype="<f4").reshape(rows, cols)


def binary_response_bytes(out: np.ndarray) -> tuple[bytes, str]:
    """(body, shape header) of a prediction sent back as f32."""
    arr = np.ascontiguousarray(np.asarray(out), dtype="<f4")
    return arr.tobytes(), ",".join(str(d) for d in arr.shape)


@contextlib.contextmanager
def pooled_binary_response(pool: fastlane.ResponseBufferPool, model: str, out: np.ndarray):
    """Lease a response buffer and yield ``(view, shape_header)`` with the
    f32 wire form cast in place. The pool key buckets the row count, so a
    few recycled buffers cover every response size of a model."""
    mat = np.asarray(out)
    if mat.ndim != 2:
        mat = np.reshape(mat, (mat.shape[0], -1))
    nbytes = mat.shape[0] * mat.shape[1] * 4
    pool_bucket = buckets.serve_bucket(max(1, mat.shape[0]))
    with pool.lease(model, pool_bucket, nbytes) as view:
        rows, cols = fastlane.fill_f32(view, mat)
        yield view, f"{rows},{cols}"


def _book_request(model: str, t0: float, ctx, parent, *, transport: str, wire: str,
                  code: int = 200) -> float:
    """The request-level series of one answered request (errors also count
    ``serve.errors``) and its ``serve.request`` span; returns the latency."""
    latency = time.perf_counter() - t0
    REGISTRY.counter_inc("serve.requests", model=model, code=code)
    if code == 200:
        REGISTRY.counter_inc("serve.transport", transport=transport, wire=wire)
        REGISTRY.histogram_record(
            "serve.latency", latency,
            exemplar=ctx.trace_hex if ctx is not None else "",
            model=model, transport=transport, wire=wire,
        )
    else:
        REGISTRY.counter_inc("serve.errors", model=model, code=code)
    if ctx is not None:
        TIMELINE.record_span(
            "serve.request", t0, time.perf_counter(),
            model=model, transport=transport, wire=wire,
            code="" if code == 200 else str(code),
            **tracectx.span_labels(ctx, parent=parent),
        )
    return latency


class ServeHandler(httpd._Handler):
    """The exporter's handler plus the model-serving API; other GETs fall
    through to the exporter's routes."""

    server_version = "tpu-ml-serve/1.1"
    # persistent connections: a caller reuses one connection for many
    # requests instead of opening (and leaving in TIME_WAIT) one each
    protocol_version = "HTTP/1.1"

    def do_GET(self):  # noqa: N802 - http.server naming contract
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        if path == "/v1/models":
            REGISTRY.counter_inc("http.requests", path=path)
            self._json(200, {"models": self.server.model_registry.describe()})
            return
        if path == "/v1/indexes":
            REGISTRY.counter_inc("http.requests", path=path)
            self._json(200, {"indexes": [
                e for e in self.server.model_registry.describe() if e["family"] == "ann"
            ]})
            return
        super().do_GET()

    def do_POST(self):  # noqa: N802 - http.server naming contract
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        REGISTRY.counter_inc("http.requests", path=path)
        if path.startswith("/v1/models/") and path.endswith(PREDICT_SUFFIX):
            self._predict(path[len("/v1/models/"):-len(PREDICT_SUFFIX)])
            return
        if path.startswith("/v1/indexes/") and path.endswith(QUERY_SUFFIX):
            self._predict(path[len("/v1/indexes/"):-len(QUERY_SUFFIX)], query=True)
            return
        self.close_connection = True  # the body was not read
        self._json(404, {"error": f"no such endpoint: {path}"})

    def _predict(self, name: str, query: bool = False) -> None:
        """One predict, or with ``query`` one index query: the same payload
        decode and batcher ride; a query's answer unpacks into ids and
        distances."""
        t0 = time.perf_counter()
        # adopt a propagated X-TPU-ML-Trace context or mint a sampled one
        parent = tracectx.from_header(self.headers.get(tracectx.TRACE_HEADER, ""))
        ctx = parent.child() if parent is not None else tracectx.mint(origin="http")
        wire = "json"
        try:
            if query:
                require_index(self.server.model_registry, name)
            instances, wire = self._read_payload()
            out = self.server.batcher.submit(name, instances, trace=ctx).result(timeout=30.0)
        except Exception as e:  # noqa: BLE001 - predict must answer, not die
            code = status_for_error(e)
            if code == 500:
                logger.exception("predict failed for model %s", name)
            _book_request(name, t0, ctx, parent, transport="http", wire=wire, code=code)
            # the body may not have been read: the stream cannot be trusted
            self.close_connection = True
            self._serve_json(
                code, {"error": f"{type(e).__name__}: {e}" if code == 500 else str(e),
                       "model": name},
            )
            return
        latency = _book_request(name, t0, ctx, parent, transport="http", wire=wire)
        if query:
            REGISTRY.counter_inc("ann.queries", int(np.shape(out)[0]), index=name)
        if BINARY_CONTENT_TYPE in (self.headers.get("Accept") or ""):
            extra = {"X-Latency-Ms": f"{latency * 1e3:.3f}"}
            if query:
                extra[ANN_K_HEADER] = str(int(np.shape(out)[1]) // 2)
            # cast into a pooled buffer: no per-response allocation
            with pooled_binary_response(self.server.response_pool, name, out) as (view, shape):
                extra[SHAPE_HEADER] = shape
                self._respond(200, view, BINARY_CONTENT_TYPE, extra_headers=extra)
            return
        if query:
            dists, ids = unpack_query_result(out)
            self._serve_json(200, {
                "index": name,
                "rows": int(ids.shape[0]),
                "ids": ids.tolist(),
                "distances": dists.tolist(),
                "latency_ms": round(latency * 1e3, 3),
            })
            return
        self._serve_json(
            200,
            {
                "model": name,
                "rows": int(np.shape(out)[0]),
                "predictions": np.asarray(out).tolist(),
                "latency_ms": round(latency * 1e3, 3),
            },
        )

    def _serve_json(self, code: int, payload: dict) -> None:
        """A JSON answer through the counted codec (``serve.json_codec``)."""
        self._respond(code, fastlane.json_dumps(payload).encode() + b"\n", "application/json")

    def _respond(self, code, body, content_type, extra_headers=None):
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (extra_headers or {}).items():
            self.send_header(k, v)
        if self.close_connection:
            self.send_header("Connection", "close")
        self.end_headers()
        self.wfile.write(body)

    def _read_payload(self):
        """Decode one predict body: ``(instances, wire)``, instances being a
        JSON-decoded list or a zero-copy f32 matrix, wire ``"json"`` or
        ``"binary"``."""
        length = int(self.headers.get("Content-Length") or 0)
        if length <= 0:
            raise ValueError(
                "empty request body — expected JSON instances or a "
                f"{BINARY_CONTENT_TYPE} payload (accepted dtypes: "
                f"{', '.join(ACCEPTED_DTYPES)})"
            )
        body = self.rfile.read(length)
        ctype = (self.headers.get("Content-Type") or "").split(";", 1)[0]
        if ctype.strip().lower() == BINARY_CONTENT_TYPE:
            return parse_binary_payload(body, self.headers.get(SHAPE_HEADER)), "binary"
        try:
            payload = fastlane.json_loads(body)
        except json.JSONDecodeError as e:
            raise ValueError(f"request body is not valid JSON: {e}") from e
        instances = payload.get("instances") if isinstance(payload, dict) else payload
        if instances is None:
            raise ValueError('missing "instances" in request body')
        return instances, "json"


# -- UDS listener ------------------------------------------------------------
#
# Wire protocol (both directions): a 4-byte big-endian header length, a JSON
# header, then an optional raw payload the header describes. Request header:
# {"model", "wire": "json"|"binary", "accept": "json"|"binary", "trace",
# "instances": [...]} for the json wire, or {"shape": [rows, features],
# "payload_bytes": N} followed by N raw f32 bytes for the binary wire.
# Response header: {"ok", "code", "model", "rows", "latency_ms", "wire"} and
# either "predictions" inline (json) or {"shape", "payload_bytes"} followed
# by the raw f32 body. One connection carries any number of requests.


def _read_exact(rfile, n: int) -> bytes:
    chunks = []
    while n > 0:
        chunk = rfile.read(n)
        if not chunk:
            raise EOFError("peer closed mid-frame")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def _uds_send(wfile, header: dict, payload: bytes = b"") -> None:
    raw = fastlane.json_dumps(header).encode()
    wfile.write(len(raw).to_bytes(4, "big") + raw + payload)
    wfile.flush()


def _fastlane_handle(rfile, wfile, batcher: MicroBatcher, pool) -> bool:
    """One fast-lane frame: fixed struct → batcher → pooled buffer, with no
    dict built and no JSON codec run."""
    model, mat, is_query, parent = fastlane.read_request(lambda n: _read_exact(rfile, n))
    t0 = time.perf_counter()
    ctx = parent.child() if parent is not None else tracectx.mint(origin="fastlane")
    try:
        if is_query:
            require_index(batcher.registry, model)
        out = batcher.submit(model, mat, trace=ctx).result(timeout=30.0)
    except Exception as e:  # noqa: BLE001 - answer the frame, keep the connection
        code = status_for_error(e)
        if code == 500:
            logger.exception("fastlane predict failed for model %s", model)
        _book_request(model, t0, ctx, parent, transport="uds", wire="fast", code=code)
        wfile.write(fastlane.pack_error_response(code, str(e)))
        wfile.flush()
        return True
    _book_request(model, t0, ctx, parent, transport="uds", wire="fast")
    if is_query:
        REGISTRY.counter_inc("ann.queries", int(np.shape(out)[0]), index=model)
    with pooled_binary_response(pool, model, out) as (view, shape):
        rows, cols = (int(d) for d in shape.split(","))
        wfile.write(fastlane.pack_response_header(200, rows, cols, len(view)))
        wfile.write(view)
    wfile.flush()
    return True


def _uds_handle_one(rfile, wfile, batcher: MicroBatcher, pool) -> bool:
    """Serve one framed request; returns False on a clean end of stream."""
    try:
        head = rfile.read(4)
    except OSError:
        return False
    if not head:
        return False
    if len(head) < 4:
        raise EOFError("peer closed mid-frame")
    if fastlane.is_fastlane_head(head):
        return _fastlane_handle(rfile, wfile, batcher, pool)
    header = fastlane.json_loads(_read_exact(rfile, int.from_bytes(head, "big")))
    model = str(header.get("model", ""))
    wire = str(header.get("wire", "json"))
    accept = str(header.get("accept", wire))
    kind = str(header.get("kind", "predict"))
    if kind == "stats":
        # the scrape frame: the fleet router pulls this replica's registry
        # and flight-recorder tail over its serve socket, in plain stdlib
        # JSON (scrape traffic stays off the counted serve.json_codec)
        resp = {
            "ok": True,
            "kind": "stats",
            "registry": REGISTRY.snapshot().to_wire(),
            "events": TIMELINE.events(int(header.get("since_seq", 0) or 0)),
            "seq": TIMELINE.seq(),
            "mono_us": int(time.perf_counter() * 1e6),
            "pid": os.getpid(),
        }
        raw = json.dumps(resp).encode()
        wfile.write(len(raw).to_bytes(4, "big") + raw)
        wfile.flush()
        return True
    parent = tracectx.from_header(str(header.get("trace", "")))
    ctx = parent.child() if parent is not None else tracectx.mint(origin="uds")
    t0 = time.perf_counter()
    try:
        if kind == "query":
            require_index(batcher.registry, model)
        elif kind != "predict":
            raise ValueError(f'kind must be "predict" or "query", got {kind!r}')
        if wire == "binary":
            shape = header.get("shape") or []
            payload = _read_exact(rfile, int(header.get("payload_bytes", 0)))
            instances = parse_binary_payload(payload, ",".join(str(d) for d in shape))
        else:
            instances = header.get("instances")
            if instances is None:
                raise ValueError(
                    'missing "instances" in request header (accepted '
                    f"dtypes: {', '.join(ACCEPTED_DTYPES)})"
                )
        out = batcher.submit(model, instances, trace=ctx).result(timeout=30.0)
    except Exception as e:  # noqa: BLE001 - answer the frame, keep the connection
        code = status_for_error(e)
        if code == 500:
            logger.exception("uds predict failed for model %s", model)
        _book_request(model, t0, ctx, parent, transport="uds", wire=wire, code=code)
        _uds_send(wfile, {"ok": False, "code": code, "model": model, "error": str(e)})
        return True
    latency = _book_request(model, t0, ctx, parent, transport="uds", wire=wire)
    base = {
        "ok": True,
        "code": 200,
        "model": model,
        "rows": int(np.shape(out)[0]),
        "latency_ms": round(latency * 1e3, 3),
    }
    if kind == "query":
        REGISTRY.counter_inc("ann.queries", int(np.shape(out)[0]), index=model)
        base["k"] = int(np.shape(out)[1]) // 2
    if accept == "binary":
        body, shape = binary_response_bytes(out)
        base.update(wire="binary", shape=[int(d) for d in shape.split(",")],
                    payload_bytes=len(body))
        _uds_send(wfile, base, body)
    elif kind == "query":
        dists, ids = unpack_query_result(out)
        base.update(wire="json", ids=ids.tolist(), distances=dists.tolist())
        _uds_send(wfile, base)
    else:
        base.update(wire="json", predictions=np.asarray(out).tolist())
        _uds_send(wfile, base)
    return True


class _UDSHandler(socketserver.StreamRequestHandler):
    def handle(self):
        try:
            while _uds_handle_one(
                self.rfile, self.wfile, self.server.batcher, self.server.response_pool
            ):
                pass
        except (EOFError, BrokenPipeError, ConnectionResetError):
            pass
        except Exception:  # noqa: BLE001 - one bad connection must not end the listener
            logger.exception("uds connection failed")


class _UDSServer(socketserver.ThreadingUnixStreamServer):
    # a listen backlog for many callers connecting at once (the stdlib's
    # default of 5 refuses the sixth concurrent connect with EAGAIN)
    request_queue_size = 128


class ServeUDSListener:
    """Unix-domain-socket front end sharing the HTTP server's batcher."""

    def __init__(self, path: str, batcher: MicroBatcher,
                 pool: fastlane.ResponseBufferPool):
        self.path = path
        if os.path.exists(path):
            os.unlink(path)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._server = _UDSServer(path, _UDSHandler)
        self._server.daemon_threads = True
        self._server.batcher = batcher
        self._server.response_pool = pool
        self._thread: threading.Thread | None = None

    def start(self) -> "ServeUDSListener":
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._server.serve_forever,
                kwargs={"poll_interval": 0.05},
                name="tpu-ml-serve-uds",
                daemon=True,
            )
            self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass


class ServingHTTPServer(httpd.HealthHTTPServer):
    """The exporter with the serve handler, a model registry, a running
    micro-batcher, a response buffer pool (pinned on a CUDA registry) and,
    with a UDS path, a UDS listener."""

    def __init__(
        self,
        port: int = 0,
        *,
        registry: ModelRegistry | None = None,
        batcher: MicroBatcher | None = None,
        uds_path: str | None = None,
    ):
        super().__init__(port, handler=ServeHandler)
        self._httpd.model_registry = registry if registry is not None else get_registry()
        self._httpd.batcher = (
            batcher if batcher is not None else MicroBatcher(self._httpd.model_registry)
        )
        self._httpd.response_pool = fastlane.ResponseBufferPool(
            pinned=self._httpd.model_registry.device.type == "cuda"
        )
        self.uds_path = uds_path if uds_path is not None else os.environ.get(SERVE_UDS_PATH_VAR, "")
        self._uds: ServeUDSListener | None = None

    @property
    def registry(self) -> ModelRegistry:
        return self._httpd.model_registry

    @property
    def batcher(self) -> MicroBatcher:
        return self._httpd.batcher

    @property
    def response_pool(self) -> fastlane.ResponseBufferPool:
        return self._httpd.response_pool

    def start(self) -> "ServingHTTPServer":
        self.batcher.start()
        super().start()
        if self.uds_path and self._uds is None:
            self._uds = ServeUDSListener(self.uds_path, self.batcher, self.response_pool).start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        if self._uds is not None:
            self._uds.stop(timeout)
            self._uds = None
        super().stop(timeout)
        self.batcher.stop(timeout)


def serve_summary(snap) -> dict:
    """JSON-safe summary of the serving activity in one snapshot window
    (``REGISTRY.snapshot().delta(before)``): request, batch and capture
    counters, bucket hits, the transport mix, paging, the JSON codec count,
    the latency, queue-delay and window histograms, the hedges and their
    winners, and the fleet's routing, drains, restarts, swaps, refusals,
    rollbacks and swap blackouts."""
    bucket_hits: dict[str, float] = {}
    transport_mix: dict[str, float] = {}
    lanes = set()
    for (n, lbl), v in snap.counters.items():
        d = dict(lbl)
        if n == "serve.bucket_hits":
            b = str(d.get("bucket", "?"))
            bucket_hits[b] = bucket_hits.get(b, 0) + v
        elif n == "serve.transport":
            k = f"{d.get('transport', '?')}/{d.get('wire', '?')}"
            transport_mix[k] = transport_mix.get(k, 0) + v
    for (n, lbl), _h in snap.hists.items():
        d = dict(lbl)
        if n == "serve.latency" and "transport" in d and "wire" in d:
            lanes.add((d["transport"], d["wire"]))
    hedge_wins: dict[str, float] = {}
    for (n, lbl), v in snap.counters.items():
        if n == "serve.hedge_wins":
            w = str(dict(lbl).get("winner", "?"))
            hedge_wins[w] = hedge_wins.get(w, 0) + v
    replica_gauges = [v for (n, _), v in snap.gauges.items() if n == "serve.fleet_replicas"]
    return {
        "type": "serve_summary",
        "coalesce_window_s": coalesce_window_s(),
        "adaptive_window": adaptive_window_enabled(),
        "requests": snap.counter("serve.requests"),
        "errors": snap.counter("serve.errors"),
        "rows": snap.counter("serve.rows"),
        "batches": snap.counter("serve.batches"),
        "aot_compiles": snap.counter("serve.aot_compiles"),
        "cold_compiles": snap.counter("serve.cold_compiles"),
        "graph_recaptures": snap.counter("serve.graph_recaptures"),
        "graph_captures": snap.counter("compile.graph_captures"),
        "joined_in_flight": snap.counter("serve.joined_in_flight"),
        "page_in": snap.counter("serve.page_in"),
        "page_out": snap.counter("serve.page_out"),
        "transport_mix": transport_mix,
        "bucket_hits": bucket_hits,
        "latency": snap.hist("serve.latency").to_dict(),
        "latency_by_transport": {
            f"{t}/{w}": snap.hist("serve.latency", transport=t, wire=w).to_dict()
            for t, w in sorted(lanes)
        },
        "queue_delay_us": snap.hist("serve.queue_delay_us").to_dict(),
        "window_effective": snap.hist("serve.window_effective_seconds").to_dict(),
        "batch_rows": snap.hist("serve.batch_rows").to_dict(),
        "json_codec": {
            "encode": snap.counter("serve.json_codec", op="encode"),
            "decode": snap.counter("serve.json_codec", op="decode"),
        },
        "traces_minted": snap.counter("serve.traces"),
        "hedges": snap.counter("serve.hedges"),
        "hedge_wins": hedge_wins,
        "fleet": {
            "replicas": int(max(replica_gauges)) if replica_gauges else 0,
            "route_hits": snap.counter("serve.route_hits"),
            "route_misses": snap.counter("serve.route_misses"),
            "drain_events": snap.counter("serve.drain_events"),
            "replica_restarts": snap.counter("serve.replica_restarts"),
            "swaps": snap.counter("serve.swaps"),
            "swap_refused": snap.counter("serve.swap_refused"),
            "rollbacks": snap.counter("serve.rollback"),
            "swap_blackout": snap.hist("serve.swap_blackout_seconds").to_dict(),
        },
    }


_LOCK = threading.Lock()
_SERVER: ServingHTTPServer | None = None


def start_serving(
    port: int = 0,
    *,
    registry: ModelRegistry | None = None,
    uds_path: str | None = None,
    device: str | torch.device | None = None,
) -> ServingHTTPServer:
    """Start (or return) the process-wide serve front end on 127.0.0.1:
    ``port`` (0: an ephemeral port), over ``registry`` (default: the
    process's registry on ``device``, the card unless the CPU is named;
    raises without a card), with a UDS listener when ``uds_path`` (or
    ``TPU_ML_SERVE_UDS_PATH``) names a socket."""
    global _SERVER
    with _LOCK:
        if _SERVER is None:
            if registry is None:
                registry = get_registry(device)
            _SERVER = ServingHTTPServer(port, registry=registry, uds_path=uds_path).start()
        return _SERVER


def get_serving_server() -> ServingHTTPServer | None:
    with _LOCK:
        return _SERVER


def stop_serving(timeout: float = 5.0) -> None:
    """Stop and forget the serve front end; a no-op when none runs."""
    global _SERVER
    with _LOCK:
        server, _SERVER = _SERVER, None
    if server is not None:
        server.stop(timeout)
