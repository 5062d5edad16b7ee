"""Multi-process serve fleet: N replica servers behind one router.

Port of ``spark_rapids_ml_tpu/serving/fleet.py``. One serve process tops out
on the host, not the card: the GIL serializes framing, and one batcher
thread owns every dispatch. ``ServeFleet`` spawns N **replica** processes,
each a whole serve runtime (registry with its CUDA graphs, micro-batcher,
UDS listener), and fronts them with an in-process **router** that speaks the
single server's UDS wires (JSON, binary and the fast lane), so a client
needs no knowledge of the fleet.

- **Replica supervision.** Replicas are spawned through
  ``resilience.supervisor.WorkerSupervisor`` (lease, breaker, backoff);
  ``TPU_ML_WORKER_SLOT`` stamps each replica's slot. A replica is a fresh
  interpreter started with ``subprocess`` (``python -m
  spark_rapids_ml_tpu_torch.serving.fleet --replica``), never a fork: a
  process that has initialised CUDA cannot fork a child that uses it. The
  spawn puts the parent's package root first on ``PYTHONPATH``, so a
  replica imports the port from the parent's tree whether or not the
  package is installed. A replica imports neither pyarrow nor cloudpickle.
- **Device affinity.** The replica's command names its device
  (``--device``, default ``cuda``); a CUDA replica pins
  ``cuda:{slot % device_count}``, so on one card every replica shares it,
  each in a CUDA context of its own. A replica that cannot reach the card
  exits non-zero before READY, and ``ServeFleet.start`` raises.
- **Respawns recapture.** The JAX package's replicas share a persistent XLA
  cache, so a respawn compiles nothing. A CUDA graph cannot outlive its
  process: a respawned replica captures every (model, bucket) rung again at
  registration. Its shutdown report (``COMPILES <graph captures> <warm
  rungs> <cold compiles after READY>``, from ``compile.graph_captures`` and
  ``serve.cold_compiles``) shows it captured models × ladder rungs and
  nothing on the request path.
- **Models travel as a spec.** An ``.npz`` of parameter arrays plus a JSON
  manifest (``write_spec``/``load_spec``), the JAX package's format byte
  for byte, for the families ``pca`` and ``linear``; anything else
  (forests, GBT, MLP, FM, UMAP, ...) is refused by ``_model_arrays``.
- **Consistent-hash routing.** ``HashRing`` maps ``(model, bucket)`` to a
  preference order over replicas (md5, 32 virtual nodes a slot: the JAX
  ring's order for every key), so a request shape lands on the replica
  whose graphs are warm. A request served by its home replica books
  ``serve.route_hits``, one routed around a draining, dead or saturated
  replica ``serve.route_misses``.
- **Rolling drain and restart.** ``restart_replica`` marks the slot
  draining (the ring walks past it), waits for its in-flight count to reach
  zero (``TPU_ML_SERVE_DRAIN_TIMEOUT_S``), respawns it through the
  supervisor and readmits it at READY (``serve.drain_events``,
  ``serve.replica_restarts``). ``swap_models`` walks every slot that way
  with a new spec.
- **Placement.** ``plan_placement`` sets the fleet's per-replica parameter
  bytes beside the HBM budget before the spawn.
- **Observability.** The router adopts or mints a trace context, injects it
  into the forwarded frame (byte surgery at a fixed offset on the fast
  lane) and records a ``serve.relay`` span per request. Replicas answer the
  ``stats`` frame on their serve socket and write a telemetry trailer next
  to it at READY and at teardown. ``FleetExporter`` serves the merged view:
  ``/metrics`` (replica-labeled; its sums equal the per-replica
  registries), ``/healthz`` (worst-of rollup) and ``/traces/<id>``.

The router is host work only: bytes in, bytes out. Every device launch
happens inside a replica.
"""

from __future__ import annotations

import argparse
import bisect
import hashlib
import http.server
import json
import logging
import os
import socket
import socketserver
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.resilience.supervisor import WorkerSupervisor
from spark_rapids_ml_tpu_torch.serving import buckets, fastlane, hbm
from spark_rapids_ml_tpu_torch.telemetry import tracectx
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY, MetricsRegistry
from spark_rapids_ml_tpu_torch.telemetry.timeline import TIMELINE
from spark_rapids_ml_tpu_torch.utils.config import (
    DEFAULT_SERVE_DRAIN_TIMEOUT_S,
    DEFAULT_SERVE_FLEET_REPLICAS,
    SERVE_DRAIN_TIMEOUT_S_VAR,
    SERVE_FLEET_REPLICAS_VAR,
    SERVE_FLEET_SOCKET_DIR_VAR,
    WORKER_SLOT_VAR,
    lenient_float,
    lenient_int,
)
from spark_rapids_ml_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("spark_rapids_ml_tpu_torch.serving")

_READY_SENTINEL = "READY"
_COMPILES_SENTINEL = "COMPILES"
_SPAWN_TIMEOUT_S = 120.0
# spill threshold: how far past the least-loaded replica the home replica's
# in-flight count may run before affinity yields to throughput
_SPILL_IN_FLIGHT = 8
# the directory that holds the port's package: a replica imports from it
_PACKAGE_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def drain_timeout_s() -> float:
    return max(0.0, lenient_float(SERVE_DRAIN_TIMEOUT_S_VAR, DEFAULT_SERVE_DRAIN_TIMEOUT_S))


# -- replica telemetry trailer -----------------------------------------------
#
# Each replica writes its registry and flight-recorder tail next to its
# socket: right after READY (so a replica that dies before its first request
# still leaves its fragment) and again at teardown. The router harvests the
# file once per replica incarnation, so the fleet's /metrics sums and the
# stitched traces survive restarts.


def trailer_path(socket_path: str) -> str:
    return socket_path + ".trailer"


def write_trailer(socket_path: str) -> None:
    """Write this process's telemetry next to its socket, atomically."""
    trailer = {
        "pid": os.getpid(),
        "seq": TIMELINE.seq(),
        "mono_us": int(time.perf_counter() * 1e6),
        "registry": REGISTRY.snapshot().to_wire(),
        "events": TIMELINE.events(),
    }
    tmp = trailer_path(socket_path) + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(trailer, f)
    os.replace(tmp, trailer_path(socket_path))


def read_trailer(socket_path: str) -> dict | None:
    try:
        with open(trailer_path(socket_path), encoding="utf-8") as f:
            trailer = json.load(f)
    except (OSError, ValueError):
        return None
    return trailer if isinstance(trailer, dict) else None


# -- model spec: how fitted models travel to replica processes ----------------


def _model_arrays(model) -> tuple[str, dict[str, np.ndarray]]:
    """(family, arrays) a replica needs to rebuild ``model``."""
    from spark_rapids_ml_tpu_torch.models.linear import _GLMModel
    from spark_rapids_ml_tpu_torch.models.pca import PCAModel

    if isinstance(model, PCAModel):
        arrays = {"pc": model.pc, "explainedVariance": model.explainedVariance}
        if model.mean is not None:
            arrays["mean"] = model.mean
            arrays["std"] = model.std
        return "pca", arrays
    if isinstance(model, _GLMModel) and model.coefficients is not None:
        return "linear", {
            "coefficients": model.coefficients,
            "intercept": np.asarray([model.intercept]),
        }
    raise TypeError(
        f"{type(model).__name__} has no fleet spec — the fleet ships pca "
        "and linear-family servables (extend _model_arrays for new "
        "families)"
    )


def _model_from_arrays(name: str, family: str, arrays: dict, device):
    if family == "pca":
        from spark_rapids_ml_tpu_torch.models.pca import PCAModel

        return PCAModel(
            f"fleet-{name}",
            arrays["pc"],
            arrays["explainedVariance"],
            arrays.get("mean"),
            arrays.get("std"),
            device=device,
        )
    if family == "linear":
        from spark_rapids_ml_tpu_torch.models.linear import LinearRegressionModel

        return LinearRegressionModel(
            uid=f"fleet-{name}",
            coefficients=arrays["coefficients"],
            intercept=float(arrays["intercept"][0]),
            device=device,
        )
    raise TypeError(f"unknown fleet spec family {family!r}")


def write_spec(path: str, models: dict[str, object]) -> dict[str, int]:
    """Write the fleet's model spec (one ``.npz`` and its manifest); returns
    each model's parameter bytes, which ``plan_placement`` reads."""
    blobs: dict[str, np.ndarray] = {}
    manifest: dict[str, dict] = {}
    param_bytes: dict[str, int] = {}
    for name, model in sorted(models.items()):
        family, arrays = _model_arrays(model)
        manifest[name] = {"family": family, "arrays": sorted(arrays)}
        param_bytes[name] = int(sum(np.asarray(a).nbytes for a in arrays.values()))
        for fld, arr in arrays.items():
            blobs[f"{name}::{fld}"] = np.asarray(arr)
    np.savez(path, **blobs)
    with open(path + ".json", "w", encoding="utf-8") as f:
        json.dump(manifest, f)
    return param_bytes


def load_spec(path: str, *, device: str | torch.device = "cuda") -> dict[str, object]:
    """The models of a spec, rebuilt with their transforms on ``device``."""
    with open(path + ".json", encoding="utf-8") as f:
        manifest = json.load(f)
    out: dict[str, object] = {}
    with np.load(path) as blobs:
        for name, meta in manifest.items():
            arrays = {fld: blobs[f"{name}::{fld}"] for fld in meta["arrays"]}
            out[name] = _model_from_arrays(name, meta["family"], arrays, device)
    return out


def plan_placement(
    param_bytes: dict[str, int],
    replicas: int,
    *,
    budget_bytes: int | None = None,
    device: torch.device | None = None,
) -> dict:
    """Full-replication placement against the HBM budget.

    Routing places traffic, not weights: every replica registers every
    model (so any replica can take a re-route), and each replica's HBM
    manager pages cold weights within its budget. The plan shows the
    resident pressure up front: per-replica parameter bytes against the
    budget (default: ``serving.hbm.budget_bytes`` of ``device``)."""
    if budget_bytes is None:
        budget_bytes = hbm.budget_bytes(device)
    total = int(sum(param_bytes.values()))
    fits = budget_bytes is None or total <= budget_bytes
    return {
        "replicas": replicas,
        "models": sorted(param_bytes),
        "param_bytes_per_replica": total,
        "budget_bytes": budget_bytes,
        "fits": fits,
    }


# -- consistent-hash ring -----------------------------------------------------


class HashRing:
    """Consistent hash over replica slots, keyed by (model, bucket).

    Virtual nodes even out the split; md5 keeps placement stable across
    processes and runs (``hash()`` is salted per process). The preference
    order lets the router walk past drained or dead replicas
    deterministically."""

    def __init__(self, slots: list[int], vnodes: int = 32):
        points: list[tuple[int, int]] = []
        for slot in slots:
            for v in range(vnodes):
                digest = hashlib.md5(f"replica-{slot}:vnode-{v}".encode()).digest()
                points.append((int.from_bytes(digest[:8], "big"), slot))
        points.sort()
        self._points = points
        self._hashes = [p[0] for p in points]
        self.slots = sorted(set(slots))

    @staticmethod
    def key(model: str, bucket: int) -> str:
        return f"{model}/{bucket}"

    def preference(self, key: str) -> list[int]:
        """Replica slots in routing-preference order for ``key``: the first
        is the home replica, the later ones take re-routes."""
        if not self._points:
            return []
        h = int.from_bytes(hashlib.md5(key.encode()).digest()[:8], "big")
        start = bisect.bisect_right(self._hashes, h) % len(self._points)
        seen: list[int] = []
        for i in range(len(self._points)):
            slot = self._points[(start + i) % len(self._points)][1]
            if slot not in seen:
                seen.append(slot)
                if len(seen) == len(self.slots):
                    break
        return seen


# -- replica process ----------------------------------------------------------


class ReplicaProcess:
    """One spawned replica server (the supervisor's worker contract:
    ``dead``/``proc``/``close()``)."""

    def __init__(
        self,
        slot: int,
        spec_path: str,
        socket_path: str,
        bucket_list: tuple[int, ...],
        extra_env: dict | None = None,
        device: str = "cuda",
    ):
        self.slot = slot
        self.socket_path = socket_path
        self.spawned_at = time.perf_counter()
        cmd = [
            sys.executable, "-m", "spark_rapids_ml_tpu_torch.serving.fleet",
            "--replica", "--spec", spec_path, "--socket", socket_path,
            "--buckets", ",".join(str(b) for b in bucket_list),
            "--device", device,
        ]
        env = dict(os.environ)
        env.update(extra_env or {})
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_PACKAGE_ROOT, env.get("PYTHONPATH", "")) if p
        )
        # stderr goes to a file beside the socket: a pipe nobody reads would
        # fill and stall a chatty replica
        self.stderr_path = socket_path + ".stderr"
        self._stderr = open(self.stderr_path, "w", encoding="utf-8")
        self.proc = subprocess.Popen(
            cmd,
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=self._stderr,
            env=env,
            text=True,
        )
        self._ready = False
        # the replica's shutdown report, read by close() (None: no report)
        self.graph_captures: int | None = None
        self.warm_rungs: int | None = None
        self.cold_compiles: int | None = None
        # seconds from the spawn to READY
        self.ready_s: float | None = None
        # the monotonic-clock handshake: the replica stamps its
        # perf_counter on the READY line; with the router's reading at
        # receipt it gives the clock offset the fleet's trace merge uses
        self.ready_mono_us: int | None = None
        self.ready_local_us: int | None = None

    @property
    def clock_offset_us(self) -> int:
        """Router clock minus replica clock at the READY handshake."""
        if self.ready_mono_us is None or self.ready_local_us is None:
            return 0
        return self.ready_local_us - self.ready_mono_us

    @property
    def dead(self) -> bool:
        return self.proc.poll() is not None

    def wait_ready(self, timeout: float = _SPAWN_TIMEOUT_S) -> bool:
        """Block until the replica prints READY (models registered, every
        rung warm, the socket listening) or dies."""
        if self._ready:
            return True
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            line = self.proc.stdout.readline()
            if not line:
                return False  # died before READY
            if line.strip().startswith(_READY_SENTINEL):
                self.ready_local_us = int(time.perf_counter() * 1e6)
                self.ready_s = time.perf_counter() - self.spawned_at
                parts = line.split()
                if len(parts) >= 3 and parts[2].isdigit():
                    self.ready_mono_us = int(parts[2])
                self._ready = True
                return True
        return False

    def close(self) -> None:
        """EOF on stdin is the shutdown sentinel; escalate if ignored."""
        try:
            if self.proc.stdin is not None:
                self.proc.stdin.close()
        except OSError:
            pass
        try:
            self.proc.wait(timeout=10.0)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=5.0)
        try:
            # the shutdown report trails READY on the same pipe
            tail = self.proc.stdout.read() if self.proc.stdout else ""
            for line in (tail or "").splitlines():
                if line.startswith(_COMPILES_SENTINEL):
                    parts = line.split()
                    self.graph_captures = int(parts[1])
                    self.warm_rungs = int(parts[2])
                    self.cold_compiles = int(parts[3])
        except (OSError, ValueError, IndexError):
            pass
        for stream in (self.proc.stdout, self._stderr):
            try:
                stream.close()
            except OSError:
                pass
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass


def _replica_main(argv: list[str]) -> int:
    """Entry point of one replica process: load the spec, register every
    model (a graph per rung on a card), serve UDS until stdin closes."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--spec", required=True)
    ap.add_argument("--socket", required=True)
    ap.add_argument("--buckets", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)  # raises without a card
    if device.type == "cuda":
        # device affinity: replica i owns card i (mod the card count)
        slot = lenient_int(WORKER_SLOT_VAR, 0)
        device = torch.device("cuda", slot % torch.cuda.device_count())
        torch.cuda.set_device(device)

    from spark_rapids_ml_tpu_torch.serving.batcher import MicroBatcher
    from spark_rapids_ml_tpu_torch.serving.registry import get_registry
    from spark_rapids_ml_tpu_torch.serving.server import ServeUDSListener

    bucket_list = tuple(int(b) for b in args.buckets.split(",") if b.strip()) or None
    registry = get_registry(device)
    for name, model in load_spec(args.spec, device=device).items():
        registry.register(name, model, bucket_list=bucket_list)
    warm_rungs = sum(len(registry.get(n).warm_buckets) for n in registry.names())
    cold_at_ready = REGISTRY.snapshot().counter("serve.cold_compiles")
    batcher = MicroBatcher(registry).start()
    pool = fastlane.ResponseBufferPool(pinned=device.type == "cuda")
    listener = ServeUDSListener(args.socket, batcher, pool).start()
    print(f"{_READY_SENTINEL} {args.socket} {int(time.perf_counter() * 1e6)}", flush=True)
    # the first trailer right after READY: a replica killed before its first
    # request still leaves its telemetry for the router
    write_trailer(args.socket)
    try:
        sys.stdin.read()  # blocks until the parent closes our stdin
    except KeyboardInterrupt:
        pass
    finally:
        listener.stop()
        batcher.stop()
        try:
            write_trailer(args.socket)
        except OSError:
            pass
        # the shutdown report: graph captures (every one at registration on
        # a card, none on the CPU), the warm rungs, and the request path's
        # cold captures after READY
        snap = REGISTRY.snapshot()
        print(
            f"{_COMPILES_SENTINEL} "
            f"{int(snap.counter('compile.graph_captures'))} {warm_rungs} "
            f"{int(snap.counter('serve.cold_compiles') - cold_at_ready)}",
            flush=True,
        )
    return 0


# -- router -------------------------------------------------------------------


class _RouterHandler(socketserver.StreamRequestHandler):
    """One client connection: read a frame, pick a replica by consistent
    hash, forward the raw bytes, relay the raw answer. The per-replica
    upstream connections live as long as the client's."""

    def setup(self):
        super().setup()
        self._upstream: dict[int, socket.socket] = {}

    def finish(self):
        for s in self._upstream.values():
            try:
                s.close()
            except OSError:
                pass
        super().finish()

    def _read_exact(self, rfile, n: int) -> bytes:
        chunks = []
        while n > 0:
            chunk = rfile.read(n)
            if not chunk:
                raise EOFError("peer closed mid-frame")
            chunks.append(chunk)
            n -= len(chunk)
        return b"".join(chunks)

    def _read_request(self):
        """Read one client frame; returns ``(model, rows, raw_frame, ctx,
        parent)``, or None at a clean end of stream. The frame is parsed
        only as far as routing needs, and the trace context goes through: a
        propagated one is adopted (the relay span re-parents it), an absent
        one is minted here. On the fast lane the injection is byte surgery
        at a fixed offset (no JSON); on the JSON wire the header, decoded
        for routing already, is encoded again through the counted codec."""
        head = self.rfile.read(4)
        if not head:
            return None
        if len(head) < 4:
            raise EOFError("peer closed mid-frame")
        if fastlane.is_fastlane_head(head):
            struct_raw = self._read_exact(self.rfile, fastlane.request_struct_size())
            name_len, rows, cols = fastlane.peek_request(struct_raw)
            name = self._read_exact(self.rfile, name_len)
            payload = self._read_exact(self.rfile, rows * cols * 4)
            parent = fastlane.peek_trace(struct_raw)
            ctx = parent.child() if parent is not None else tracectx.mint(origin="router")
            if ctx is not None:
                struct_raw = fastlane.rewrite_trace(struct_raw, ctx)
            return (
                name.decode("utf-8"), rows,
                b"".join((head, struct_raw, name, payload)),
                ctx, parent,
            )
        header_raw = self._read_exact(self.rfile, int.from_bytes(head, "big"))
        header = fastlane.json_loads(header_raw)
        model = str(header.get("model", ""))
        if header.get("wire") == "binary":
            payload = self._read_exact(self.rfile, int(header.get("payload_bytes", 0)))
            rows = int((header.get("shape") or [1])[0])
        else:
            payload = b""
            rows = len(header.get("instances") or [None])
        parent = tracectx.from_header(str(header.get("trace", "")))
        ctx = parent.child() if parent is not None else tracectx.mint(origin="router")
        if ctx is not None:
            header["trace"] = ctx.to_header()
            header_raw = fastlane.json_dumps(header).encode()
            head = len(header_raw).to_bytes(4, "big")
        return model, rows, head + header_raw + payload, ctx, parent

    def _relay_response(self, rfile) -> bytes:
        """Read one whole replica answer, verbatim."""
        head = self._read_exact(rfile, 4)
        if fastlane.is_fastlane_head(head):
            struct_raw = self._read_exact(rfile, fastlane.response_struct_size())
            payload_len = fastlane.peek_response_payload_len(struct_raw)
            return head + struct_raw + self._read_exact(rfile, payload_len)
        header_raw = self._read_exact(rfile, int.from_bytes(head, "big"))
        header = fastlane.json_loads(header_raw)
        payload = self._read_exact(rfile, int(header.get("payload_bytes", 0)))
        return head + header_raw + payload

    def _upstream_for(self, slot: int) -> socket.socket:
        s = self._upstream.get(slot)
        if s is None:
            s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            s.connect(self.server.fleet.replica_socket(slot))
            self._upstream[slot] = s
        return s

    def _drop_upstream(self, slot: int, s: socket.socket) -> None:
        self._upstream.pop(slot, None)
        try:
            s.close()
        except OSError:
            pass

    def _forward(self, slot: int, frame: bytes) -> bytes:
        cached = slot in self._upstream
        s = self._upstream_for(slot)
        try:
            s.sendall(frame)
            return self._relay_response(s.makefile("rb"))
        except (OSError, EOFError):
            self._drop_upstream(slot, s)
            if not cached:
                raise
        # the cached upstream went stale between requests (the replica was
        # restarted and its listener made anew); the frame is buffered whole
        # and nothing was relayed yet, so one retry on a fresh connection is
        # safe
        s = self._upstream_for(slot)
        try:
            s.sendall(frame)
            return self._relay_response(s.makefile("rb"))
        except (OSError, EOFError):
            self._drop_upstream(slot, s)
            raise

    def handle(self):
        fleet: ServeFleet = self.server.fleet
        try:
            while True:
                req = self._read_request()
                if req is None:
                    return
                model, rows, frame, ctx, parent = req
                try:
                    bucket = buckets.serve_bucket(max(1, rows))
                except ValueError:
                    bucket = buckets.max_batch_rows()
                t0 = time.perf_counter()
                response = fleet.route(model, bucket, frame, self._forward, trace=ctx)
                if ctx is not None:
                    # the relay span: the fleet's admission (a root when
                    # minted here) over route, forward and relay
                    TIMELINE.record_span(
                        "serve.relay", t0, time.perf_counter(), model=model,
                        **tracectx.span_labels(ctx, parent=parent),
                    )
                self.wfile.write(response)
                self.wfile.flush()
        except (EOFError, BrokenPipeError, ConnectionResetError):
            pass
        except Exception:  # noqa: BLE001 - one bad connection must not end the router
            logger.exception("fleet router connection failed")


class _RouterServer(socketserver.ThreadingUnixStreamServer):
    # a listen backlog for many clients connecting at once
    request_queue_size = 128


class ServeFleet:
    """N supervised replica processes behind one consistent-hash router, on
    ``device`` (each replica's; ``"cuda"`` unless the caller names the CPU)."""

    def __init__(
        self,
        models: dict[str, object],
        *,
        replicas: int | None = None,
        socket_dir: str | None = None,
        bucket_list: tuple[int, ...] = (),
        extra_env: dict | None = None,
        device: str | torch.device = "cuda",
    ):
        if replicas is None:
            replicas = lenient_int(SERVE_FLEET_REPLICAS_VAR, DEFAULT_SERVE_FLEET_REPLICAS)
        if replicas < 1:
            raise ValueError("a serve fleet needs at least 1 replica")
        self.device = resolve_device(device)
        self.replicas = replicas
        self.bucket_list = tuple(bucket_list)
        self._extra_env = dict(extra_env or {})
        socket_dir = socket_dir or os.environ.get(SERVE_FLEET_SOCKET_DIR_VAR, "")
        if not socket_dir:
            socket_dir = tempfile.mkdtemp(prefix="tpu-ml-fleet-")
        self.socket_dir = socket_dir
        os.makedirs(socket_dir, exist_ok=True)
        self.spec_path = os.path.join(socket_dir, "fleet-spec.npz")
        self.param_bytes = write_spec(self.spec_path, models)
        self.placement = plan_placement(self.param_bytes, replicas, device=self.device)
        if not self.placement["fits"]:
            logger.warning(
                "fleet placement exceeds the HBM budget (%d bytes a replica against %s): "
                "replicas will page weights under pressure",
                self.placement["param_bytes_per_replica"], self.placement["budget_bytes"],
            )
        self.router_path = os.path.join(socket_dir, "router.sock")
        self.ring = HashRing(list(range(replicas)))
        self._supervisor = WorkerSupervisor(self._spawn, replicas)
        self._state_lock = threading.Lock()
        self._state_cond = threading.Condition(self._state_lock)
        self._draining: set[int] = set()
        self._in_flight: dict[int, int] = {i: 0 for i in range(replicas)}
        self._served: dict[int, int] = {i: 0 for i in range(replicas)}
        self._router: _RouterServer | None = None
        self._router_thread: threading.Thread | None = None
        # dead incarnations' final registries and flight-recorder fragments
        # (harvested from trailers once per (slot, pid)), so the merged
        # /metrics sums and stitched traces stay whole across restarts
        self._agg_lock = threading.Lock()
        self._final_registry = MetricsRegistry()
        self._final_events: list[dict] = []
        self._harvested: set[tuple[int, int]] = set()
        self._clock_offsets: dict[int, int] = {}
        self._exporter: FleetExporter | None = None

    # -- lifecycle ------------------------------------------------------------

    def _spawn(self, extra_env: dict) -> ReplicaProcess:
        slot = int(extra_env.get(WORKER_SLOT_VAR, "0") or 0)
        env = dict(self._extra_env)
        env.update(extra_env)
        return ReplicaProcess(
            slot, self.spec_path, self.replica_socket(slot), self.bucket_list,
            extra_env=env, device=self.device.type,
        )

    def replica_socket(self, slot: int) -> str:
        return os.path.join(self.socket_dir, f"replica-{slot}.sock")

    def replica(self, slot: int) -> ReplicaProcess | None:
        """The live replica of ``slot`` (None while it has none)."""
        return self._supervisor._slots[slot].worker

    def start(self, timeout: float = _SPAWN_TIMEOUT_S) -> "ServeFleet":
        """Spawn every replica, wait until all report READY, then open the
        router socket. Raises when a replica dies or times out before READY
        (a CUDA replica that cannot reach the card exits non-zero)."""
        self._supervisor.begin_stage()
        workers = [self._supervisor.checkout(slot) for slot in range(self.replicas)]
        for slot, worker in enumerate(workers):
            if worker is None or not worker.wait_ready(timeout):
                err = self._replica_stderr(worker)
                self._supervisor.close()
                raise RuntimeError(f"fleet replica {slot} failed to become ready" + err)
            self._supervisor.report_success(slot)
            with self._agg_lock:
                self._clock_offsets[slot] = worker.clock_offset_us
        if os.path.exists(self.router_path):
            os.unlink(self.router_path)
        self._router = _RouterServer(self.router_path, _RouterHandler)
        self._router.daemon_threads = True
        self._router.fleet = self
        self._router_thread = threading.Thread(
            target=self._router.serve_forever,
            kwargs={"poll_interval": 0.05},
            name="tpu-ml-fleet-router",
            daemon=True,
        )
        self._router_thread.start()
        REGISTRY.gauge_set("serve.fleet_replicas", self.live_replicas())
        return self

    @staticmethod
    def _replica_stderr(worker) -> str:
        if worker is None:
            return ""
        try:
            if worker.proc.poll() is None:
                worker.proc.kill()
                worker.proc.wait(timeout=5.0)
            with open(worker.stderr_path, encoding="utf-8", errors="replace") as f:
                tail = f.read()
        except (OSError, subprocess.TimeoutExpired):
            return ""
        return ("\n--- replica stderr ---\n" + tail[-2000:]) if tail else ""

    def stop(self, timeout: float = 10.0) -> None:
        if self._exporter is not None:
            self._exporter.stop(timeout)
            self._exporter = None
        if self._router is not None:
            self._router.shutdown()
            self._router.server_close()
            self._router = None
        if self._router_thread is not None:
            self._router_thread.join(timeout)
            self._router_thread = None
        try:
            os.unlink(self.router_path)
        except OSError:
            pass
        self._supervisor.close()
        # every replica just wrote its teardown trailer; fold them in so
        # reads after the stop see the fleet's whole telemetry
        for slot in range(self.replicas):
            self._harvest_trailer(slot)
        REGISTRY.gauge_set("serve.fleet_replicas", 0)

    # -- routing --------------------------------------------------------------

    def live_replicas(self) -> int:
        return sum(
            1 for slot in range(self.replicas)
            if (w := self.replica(slot)) is not None and not w.dead
        )

    def _available(self, slot: int) -> bool:
        with self._state_lock:
            if slot in self._draining:
                return False
        return self._live(slot)

    def _live(self, slot: int) -> bool:
        w = self.replica(slot)
        return w is not None and not w.dead

    def route(self, model: str, bucket: int, frame: bytes, forward, trace=None) -> bytes:
        """Pick a replica for (model, bucket) and forward the frame.

        The home replica (first in the ring's order) gets the request unless
        it is draining, dead or saturated: every replica warms every model,
        so when the home replica's in-flight count runs ``_SPILL_IN_FLIGHT``
        past the least loaded one's, the request spills there. Whatever
        lands off home books ``serve.route_misses``. A transport failure
        reports a dead replica to the supervisor and retries the buffered
        frame on the next preference: a replica's death mid-request is a
        retry, not a failed request. When every live replica is draining at
        the moment of choice (one restart of a walk ending as the next
        begins, or a one-replica fleet restarting), the request waits for
        the ring to change, up to ``TPU_ML_SERVE_DRAIN_TIMEOUT_S``; the JAX
        package's router fails it instead."""
        last_err: Exception | None = None
        prefs = self.ring.preference(HashRing.key(model, bucket))
        deadline = time.monotonic() + drain_timeout_s()
        while True:
            with self._state_lock:
                draining = set(self._draining)
                in_flight = dict(self._in_flight)
            order = [s for s in prefs if s not in draining and self._live(s)]
            if len(order) > 1:
                least = min(order, key=in_flight.get)
                if in_flight[order[0]] - in_flight[least] >= _SPILL_IN_FLIGHT:
                    order.remove(least)
                    order.insert(0, least)
            for slot in order:
                with self._state_lock:
                    # the draining re-check and the in-flight increment are
                    # one step against drain(): once admitted here, the count
                    # holds the drain open until the finally below
                    if slot in self._draining:
                        continue
                    self._in_flight[slot] += 1
                try:
                    response = forward(slot, frame)
                except (OSError, EOFError) as e:
                    last_err = e
                    worker = self.replica(slot)
                    if worker is not None and worker.dead:
                        self._supervisor.report_crash(slot, e)
                        # its READY trailer is all that is left of its telemetry
                        self._harvest_trailer(slot)
                    if trace is not None:
                        # the silent retry leaves a mark on the trace
                        TIMELINE.record_instant(
                            "retry", slot=str(slot), model=model, **tracectx.span_labels(trace),
                        )
                    continue
                finally:
                    with self._state_cond:
                        self._in_flight[slot] -= 1
                        self._state_cond.notify_all()
                with self._state_lock:
                    self._served[slot] += 1
                if prefs and slot == prefs[0]:
                    REGISTRY.counter_inc("serve.route_hits", model=model)
                else:
                    REGISTRY.counter_inc("serve.route_misses", model=model)
                return response
            if last_err is not None or not draining or time.monotonic() >= deadline:
                raise last_err or RuntimeError(
                    f"no live replica for {model!r} (all draining or dead)"
                )
            with self._state_cond:
                self._state_cond.wait(0.05)

    # -- rolling drain and restart --------------------------------------------

    def drain(self, slot: int, timeout: float | None = None) -> bool:
        """Stop routing to ``slot`` and wait for its in-flight requests;
        True when it drained fully within the bound."""
        timeout = drain_timeout_s() if timeout is None else timeout
        with self._state_cond:
            self._draining.add(slot)
            REGISTRY.counter_inc("serve.drain_events", slot=str(slot))
            deadline = time.monotonic() + timeout
            while self._in_flight[slot] > 0:
                left = deadline - time.monotonic()
                if left <= 0:
                    return False
                self._state_cond.wait(left)
        return True

    def undrain(self, slot: int) -> None:
        with self._state_cond:
            self._draining.discard(slot)
            self._state_cond.notify_all()

    def restart_replica(self, slot: int, timeout: float = _SPAWN_TIMEOUT_S) -> bool:
        """Rolling restart of one replica under live load: drain, respawn
        through the supervisor, readmit at READY. The respawn captures every
        rung again (a graph cannot outlive its process)."""
        if not self.drain(slot):
            logger.warning(
                "replica %d drain timed out with requests in flight; restarting anyway", slot
            )
        worker = self.replica(slot)
        if worker is not None:
            worker.close()
            # the outgoing incarnation's teardown trailer is final now
            self._harvest_trailer(slot)
        replacement = self._supervisor.checkout(slot)
        ok = replacement is not None and replacement.wait_ready(timeout)
        if ok:
            self._supervisor.report_success(slot)
            with self._agg_lock:
                self._clock_offsets[slot] = replacement.clock_offset_us
            REGISTRY.counter_inc("serve.replica_restarts", slot=str(slot))
        else:
            self._supervisor.report_crash(slot, RuntimeError("replica respawn did not become ready"))
        self.undrain(slot)
        REGISTRY.gauge_set("serve.fleet_replicas", self.live_replicas())
        return ok

    # -- fleet-wide hot swap ----------------------------------------------------

    def swap_models(self, models: dict[str, object], timeout: float = _SPAWN_TIMEOUT_S) -> bool:
        """Carry a hot swap to every replica: merge ``models`` into the
        spec, then restart each slot through the drain discipline (a
        draining slot finishes its in-flight requests on the old spec while
        the ring routes around it), so the fleet converges replica by
        replica with no failed request. True when every replica came back
        READY on the new spec."""
        current = load_spec(self.spec_path, device="cpu")
        current.update(models)
        self.param_bytes = write_spec(self.spec_path, current)
        self.placement = plan_placement(self.param_bytes, self.replicas, device=self.device)
        ok = True
        for slot in range(self.replicas):
            ok = self.restart_replica(slot, timeout) and ok
        return ok

    # -- introspection --------------------------------------------------------

    def stats(self) -> dict:
        with self._state_lock:
            served = dict(self._served)
            in_flight = dict(self._in_flight)
            draining = sorted(self._draining)
        with self._agg_lock:
            offsets = dict(self._clock_offsets)
        return {
            "replicas": self.replicas,
            "live_replicas": self.live_replicas(),
            "router_socket": self.router_path,
            "served_per_replica": {str(k): v for k, v in served.items()},
            "in_flight": {str(k): v for k, v in in_flight.items()},
            "draining": draining,
            "clock_offsets_us": {str(k): v for k, v in offsets.items()},
            "placement": self.placement,
            "supervisor": self._supervisor.summary(),
        }

    # -- the fleet's observability plane ----------------------------------------

    def _harvest_trailer(self, slot: int) -> None:
        """Fold a dead or stopped incarnation's trailer into the fleet's
        aggregate, once per (slot, pid): a crashed incarnation's READY
        trailer and a graceful one's teardown trailer never count twice."""
        trailer = read_trailer(self.replica_socket(slot))
        if not trailer:
            return
        pid = int(trailer.get("pid") or 0)
        with self._agg_lock:
            if (slot, pid) in self._harvested:
                return
            self._harvested.add((slot, pid))
            self._final_registry.merge_wire(trailer.get("registry") or {}, replica=str(slot))
            for e in trailer.get("events") or []:
                if isinstance(e, dict):
                    self._final_events.append(
                        dict(e, args=dict(e.get("args") or {}, replica=str(slot)))
                    )

    def scrape_stats(self, slot: int, since_seq: int = 0, timeout: float = 5.0) -> dict | None:
        """One live replica's registry and flight-recorder tail over the
        ``stats`` frame; None when it cannot be scraped. Plain stdlib JSON
        on both sides (off the counted ``serve.json_codec``)."""
        if not self._available(slot):
            return None
        s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            s.settimeout(timeout)
            s.connect(self.replica_socket(slot))
            raw = json.dumps({"kind": "stats", "since_seq": since_seq}).encode()
            s.sendall(len(raw).to_bytes(4, "big") + raw)
            rfile = s.makefile("rb")
            head = rfile.read(4)
            if len(head) < 4:
                return None
            n = int.from_bytes(head, "big")
            body = b""
            while len(body) < n:
                chunk = rfile.read(n - len(body))
                if not chunk:
                    return None
                body += chunk
            stats = json.loads(body)
            return stats if isinstance(stats, dict) else None
        except (OSError, ValueError):
            return None
        finally:
            try:
                s.close()
            except OSError:
                pass

    def fleet_events(self) -> list[dict]:
        """The fleet's merged flight-recorder stream: the router's own
        events, every live replica's scraped tail and the harvested
        fragments of dead incarnations, deduplicated by (pid, seq); replica
        events carry ``replica=<slot>`` in their args."""
        seen: set[tuple] = set()
        out: list[dict] = []

        def add(events: list, replica: str = "") -> None:
            for e in events:
                if not isinstance(e, dict):
                    continue
                k = (e.get("pid"), e.get("seq"))
                if k in seen:
                    continue
                seen.add(k)
                if replica:
                    e = dict(e, args=dict(e.get("args") or {}, replica=replica))
                out.append(e)

        add(TIMELINE.events())
        for slot in range(self.replicas):
            stats = self.scrape_stats(slot)
            if stats:
                add(stats.get("events") or [], replica=str(slot))
        with self._agg_lock:
            final = list(self._final_events)
        add(final)
        return out

    def fleet_registry(self, include_router: bool = True) -> MetricsRegistry:
        """One merged registry of the fleet: live replicas scraped over the
        ``stats`` frame (``replica=<slot>``), dead incarnations' final
        trailers and, by default, the router's own (``replica=router``).
        Summing a family over the replica label gives back the per-replica
        registries."""
        merged = MetricsRegistry()
        for slot in range(self.replicas):
            stats = self.scrape_stats(slot)
            if stats:
                merged.merge_wire(stats.get("registry") or {}, replica=str(slot))
        with self._agg_lock:
            merged.merge_wire(self._final_registry.snapshot().to_wire())
        if include_router:
            merged.merge_wire(REGISTRY.snapshot().to_wire(), replica="router")
        return merged

    def healthz(self) -> dict:
        """Worst-of rollup: a dead replica (or a closed router) makes the
        fleet ``down``, a draining one ``degraded``, else ``ok``."""
        components: dict[str, str] = {}
        with self._state_lock:
            draining = set(self._draining)
        for slot in range(self.replicas):
            w = self.replica(slot)
            if w is None or w.dead:
                components[f"replica-{slot}"] = "down"
            elif slot in draining:
                components[f"replica-{slot}"] = "draining"
            else:
                components[f"replica-{slot}"] = "ok"
        components["router"] = "ok" if self._router is not None else "down"
        if any(s == "down" for s in components.values()):
            status = "down"
        elif any(s == "draining" for s in components.values()):
            status = "degraded"
        else:
            status = "ok"
        return {
            "status": status,
            "components": components,
            "live_replicas": self.live_replicas(),
            "replicas": self.replicas,
        }

    def trace_coverage(self) -> dict:
        """Stitching coverage over the merged fleet event stream."""
        return tracectx.coverage(self.fleet_events())

    def start_exporter(self, port: int = 0) -> "FleetExporter":
        """Start (or return) the fleet-wide scrape surface."""
        if self._exporter is None:
            self._exporter = FleetExporter(self, port).start()
        return self._exporter


# -- fleet exporter -----------------------------------------------------------


class _FleetExporterHandler(http.server.BaseHTTPRequestHandler):
    """The merged observability plane over one port: fleet-wide Prometheus
    metrics, a worst-of health rollup and stitched cross-process traces."""

    server_version = "tpu-ml-fleet-exporter/1.0"

    def log_message(self, format, *args):  # noqa: A002 - http.server naming
        logger.debug("fleet exporter: " + format, *args)

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, code: int, payload: dict) -> None:
        self._send(code, json.dumps(payload).encode() + b"\n", "application/json")

    def do_GET(self):  # noqa: N802 - http.server naming contract
        fleet: ServeFleet = self.server.fleet
        path = self.path.split("?", 1)[0].rstrip("/") or "/"
        if path == "/metrics":
            self._send(
                200,
                fleet.fleet_registry().snapshot().to_prometheus().encode(),
                "text/plain; version=0.0.4; charset=utf-8",
            )
            return
        if path == "/healthz":
            health = fleet.healthz()
            self._json(503 if health["status"] == "down" else 200, health)
            return
        if path == "/traces":
            self._json(200, fleet.trace_coverage())
            return
        if path.startswith("/traces/"):
            tid = path[len("/traces/"):]
            tree = tracectx.stitch(fleet.fleet_events(), tid)
            if tree is None:
                self._json(404, {"error": f"unknown trace {tid!r}"})
            else:
                self._json(200, tree)
            return
        self._json(404, {"error": f"no such endpoint: {path}"})


class FleetExporter:
    """HTTP scrape surface of a running fleet: ``/metrics`` (merged,
    replica-labeled), ``/healthz`` (worst-of rollup), ``/traces`` (stitching
    coverage) and ``/traces/<id>`` (one stitched tree)."""

    def __init__(self, fleet: ServeFleet, port: int = 0):
        self._httpd = http.server.ThreadingHTTPServer(("127.0.0.1", port), _FleetExporterHandler)
        self._httpd.daemon_threads = True
        self._httpd.fleet = fleet
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def url(self, path: str = "/") -> str:
        return f"http://127.0.0.1:{self.port}{path}"

    def start(self) -> "FleetExporter":
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                kwargs={"poll_interval": 0.05},
                name="tpu-ml-fleet-exporter",
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


if __name__ == "__main__":
    if "--replica" in sys.argv:
        raise SystemExit(_replica_main([a for a in sys.argv[1:] if a != "--replica"]))
    raise SystemExit(
        "serving.fleet is a library (use ServeFleet); only --replica runs standalone"
    )
