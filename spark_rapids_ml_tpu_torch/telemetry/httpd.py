"""HTTP exporter: ``/metrics``, ``/healthz``, ``/slo``, ``/report`` and
``/traces`` on a local port.

Port of ``spark_rapids_ml_tpu/telemetry/httpd.py``: the handler and server
that ``serving/server.py`` extends, so one port serves both the scrape
surface and the prediction API. A stdlib ``ThreadingHTTPServer`` on
127.0.0.1.

- ``/metrics``: the whole registry in the Prometheus text exposition format
  (``RegistrySnapshot.to_prometheus``).
- ``/healthz``: the health monitor's rollup (``telemetry/health.py``); 200
  while the worst component is OK or DEGRADED, 503 once one is FAILING;
  200 with state UNKNOWN when no monitor runs.
- ``/slo``: the last SLO evaluation (``telemetry/slo.py``).
- ``/report``: the most recent fit and transform reports
  (``telemetry/report.py``).
- ``/traces``: stitching coverage over this process's flight recorder;
  ``/traces/<id>`` returns one stitched span tree
  (``telemetry.tracectx.stitch``).

``ensure_started`` is the fit path's hook (``report.begin_fit``): with
``TPU_ML_HTTP_PORT`` set, the first fit of the process brings up the
exporter and the health monitor; without it, nothing. It never raises.
"""

from __future__ import annotations

import json
import logging
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from spark_rapids_ml_tpu_torch.telemetry import health as health_mod
from spark_rapids_ml_tpu_torch.telemetry import report as report_mod
from spark_rapids_ml_tpu_torch.telemetry import tracectx
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY
from spark_rapids_ml_tpu_torch.telemetry.timeline import TIMELINE
from spark_rapids_ml_tpu_torch.utils.config import HTTP_PORT_VAR

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
            elif path == "/healthz":
                self._healthz()
            elif path == "/slo":
                self._json(200, self._rollup().get("slo", {}))
            elif path == "/report":
                self._json(200, {"reports": report_mod.recent_reports()})
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

    @staticmethod
    def _rollup() -> dict:
        mon = health_mod.get_monitor()
        if mon is None:
            return {}
        if mon.polls == 0:
            # a scrape before the first tick polls inline, so /healthz never
            # serves a vacuous all-OK
            return mon.poll_once()
        return mon.rollup()

    def _healthz(self) -> None:
        rollup = self._rollup()
        if not rollup:
            self._json(200, {"state": "UNKNOWN", "detail": "no health monitor"})
            return
        self._json(503 if rollup["state"] == "FAILING" else 200, rollup)

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


# -- the process-wide exporter ------------------------------------------------

_LOCK = threading.Lock()
_SERVER: HealthHTTPServer | None = None


def start_http_server(port: int | None = None, *, with_monitor: bool = True) -> HealthHTTPServer:
    """Start (or return) the process-wide exporter on ``port``
    (``TPU_ML_HTTP_PORT`` when None, which must then be set; 0 binds an
    ephemeral port), and by default the health monitor beside it."""
    global _SERVER
    if port is None:
        raw = os.environ.get(HTTP_PORT_VAR, "")
        if raw == "":
            raise ValueError(f"start_http_server(port=None) requires {HTTP_PORT_VAR}")
        port = int(raw)
    with _LOCK:
        if _SERVER is None:
            _SERVER = HealthHTTPServer(port).start()
        server = _SERVER
    if with_monitor:
        health_mod.start_monitor()
    return server


def get_http_server() -> HealthHTTPServer | None:
    with _LOCK:
        return _SERVER


def stop_http_server(timeout: float = 5.0, *, stop_monitor: bool = True) -> None:
    """Stop and forget the exporter and, by default, the monitor; a no-op
    when nothing runs."""
    global _SERVER
    with _LOCK:
        server, _SERVER = _SERVER, None
    if server is not None:
        server.stop(timeout)
    if stop_monitor:
        health_mod.stop_monitor(timeout)


def ensure_started() -> HealthHTTPServer | None:
    """The fit path's hook: the exporter and the monitor iff
    ``TPU_ML_HTTP_PORT`` is set. Idempotent; never raises."""
    raw = os.environ.get(HTTP_PORT_VAR, "")
    if raw == "":
        return None
    try:
        return start_http_server(int(raw))
    except Exception:  # noqa: BLE001 - an exporter must not break a fit
        logger.exception("could not start the telemetry HTTP exporter")
        return None
