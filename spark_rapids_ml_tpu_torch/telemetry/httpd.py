"""HTTP exporter: ``/metrics`` and ``/traces`` on a local port.

Port of ``spark_rapids_ml_tpu/telemetry/httpd.py``'s handler and server,
the base that ``serving/server.py`` extends, so one port serves both the
scrape surface and the prediction API. A stdlib ``ThreadingHTTPServer`` on
127.0.0.1.

- ``/metrics``: the whole registry in the Prometheus text exposition format
  (``RegistrySnapshot.to_prometheus``).
- ``/traces``: stitching coverage over this process's flight recorder;
  ``/traces/<id>`` returns one stitched span tree
  (``telemetry.tracectx.stitch``).

``/healthz``, ``/slo`` and ``/report`` need the health monitor, the SLO
engine and the fit report, which come with the fit-telemetry slice; until
then they answer 404 like any unknown path.
"""

from __future__ import annotations

import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from spark_rapids_ml_tpu_torch.telemetry import tracectx
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY
from spark_rapids_ml_tpu_torch.telemetry.timeline import TIMELINE

logger = logging.getLogger("spark_rapids_ml_tpu_torch.httpd")

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


class _Handler(BaseHTTPRequestHandler):
    server_version = "tpu-ml-exporter/1.0"

    # access logs go to the package logger, not stderr
    def log_message(self, fmt, *args):  # noqa: D102 - BaseHTTPRequestHandler
        logger.debug("http %s", fmt % args)

    def do_GET(self):  # noqa: N802 - http.server naming contract
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        REGISTRY.counter_inc("http.requests", path=path)
        try:
            if path == "/metrics":
                self._respond(
                    200, REGISTRY.snapshot().to_prometheus().encode(), PROM_CONTENT_TYPE
                )
            elif path == "/traces":
                self._json(200, tracectx.coverage(TIMELINE.events()))
            elif path.startswith("/traces/"):
                tid = path[len("/traces/"):]
                tree = tracectx.stitch(TIMELINE.events(), tid)
                if tree is None:
                    self._json(404, {"error": f"unknown trace {tid!r}"})
                else:
                    self._json(200, tree)
            else:
                self._json(404, {"error": f"no such endpoint: {path}"})
        except Exception as e:  # noqa: BLE001 - the handler must answer
            logger.exception("http handler failed for %s", path)
            try:
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
            except OSError:  # the client is already gone
                pass

    def _json(self, code: int, payload: dict) -> None:
        self._respond(
            code, json.dumps(payload, indent=2).encode() + b"\n", "application/json"
        )

    def _respond(self, code: int, body: bytes, content_type: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    # a listen backlog for many callers connecting at once (the stdlib's
    # default is 5)
    request_queue_size = 128


class HealthHTTPServer:
    """A started/stoppable exporter bound to 127.0.0.1:``port`` (0 binds
    an ephemeral port; read it back from ``port``)."""

    def __init__(self, port: int = 0, handler: type = _Handler):
        self._httpd = _HTTPServer(("127.0.0.1", port), handler)
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "HealthHTTPServer":
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                kwargs={"poll_interval": 0.1},
                name="tpu-ml-httpd",
                daemon=True,
            )
            self._thread.start()
        return self

    def stop(self, timeout: float = 5.0) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None
