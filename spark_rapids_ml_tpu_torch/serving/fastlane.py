"""JSON-free serve dispatch lane: magic-framed binary wire, pooled response
buffers and the counted JSON codec.

Port of ``spark_rapids_ml_tpu/serving/fastlane.py``; the bytes on the wire
are the JAX package's, so a frame packed by either package is answered by
the other's server.

- **Magic-framed fast lane.** The UDS listener reads a 4-byte big-endian
  JSON-header length first; a fast-lane frame opens with
  ``FASTLANE_MAGIC`` in its place, a value (~4.1 GB) no JSON header length
  reaches, so one read tells the lanes apart. The request is a fixed
  32-byte struct (version, flags, name length, rows, cols, then the trace
  tail: trace_id u64, span_id u32, origin_us u64, all zero on an untraced
  request), the model name and raw little-endian f32 rows; the response a
  16-byte struct (version, flags, HTTP-equivalent status, rows, cols,
  payload length) and raw f32 (or a UTF-8 error message under the error
  flag). No dict is built on either side.
- **Pooled response buffers.** ``ResponseBufferPool`` keeps pre-sized
  buffers per (model, bucket) and leases them per response; the output is
  cast into the leased buffer (``fill_f32``) instead of a fresh
  ``tobytes()``. A pool made for a CUDA registry takes its buffers from
  pinned host memory.
- **Relay helpers.** ``request_struct_size``/``peek_request`` and
  ``response_struct_size``/``peek_response_payload_len`` read a frame's
  fixed struct, so the fleet router (``serving/fleet.py``) routes and
  relays fast-lane frames without parsing their payloads.
- **Counted JSON codec.** ``json_loads``/``json_dumps`` wrap the stdlib
  codec and book ``serve.json_codec{op=decode|encode}``; every serve-path
  JSON touch goes through them, so the fast lane's count is checkably 0.
"""

from __future__ import annotations

import contextlib
import json
import struct
import threading

import numpy as np
import torch

from spark_rapids_ml_tpu_torch.telemetry import tracectx
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY

# Rides in place of the 4-byte JSON-header length that opens every UDS
# frame. JSON headers are tens to thousands of bytes; this reads as
# ~4.1 GB, unreachable by construction (header dicts carry no payload).
FASTLANE_MAGIC = 0xF5A57A4E
_MAGIC_BYTES = struct.pack(">I", FASTLANE_MAGIC)

FASTLANE_VERSION = 2

# request: version u8, flags u8, name_len u16, rows u32, cols u32,
# trace_id u64, span_id u32, origin_us u64 (trace fields all-zero on an
# untraced request; the trace tail mirrors telemetry.tracectx.TRACE_STRUCT)
_REQ_STRUCT = struct.Struct(">BBHIIQIQ")
# fixed byte offset of the trace tail inside the packed request struct: a
# relay rewrites these 20 bytes in place (rewrite_trace) to inject or
# re-parent a frame's context without decoding it
_TRACE_OFFSET = _REQ_STRUCT.size - tracectx.TRACE_STRUCT.size
# response: version u8, flags u8, status u16, rows u32, cols u32,
# payload_len u32 (== rows*cols*4 on success, error-message bytes on error)
_RESP_STRUCT = struct.Struct(">BBHIII")

FLAG_QUERY = 0x01   # request: ANN query instead of predict
FLAG_ERROR = 0x01   # response: payload is a UTF-8 error message

_DTYPE = np.dtype("<f4")


class FastlaneError(RuntimeError):
    """A fast-lane response carried the error flag."""

    def __init__(self, status: int, message: str):
        super().__init__(f"fastlane status {status}: {message}")
        self.status = status
        self.message = message


def json_loads(data):
    """stdlib ``json.loads`` counted as a serve hot-path decode."""
    REGISTRY.counter_inc("serve.json_codec", op="decode")
    return json.loads(data)


def json_dumps(obj, **kwargs) -> str:
    """stdlib ``json.dumps`` counted as a serve hot-path encode."""
    REGISTRY.counter_inc("serve.json_codec", op="encode")
    return json.dumps(obj, **kwargs)


def is_fastlane_head(head: bytes) -> bool:
    """True when the 4 bytes that open a UDS frame are the fast-lane
    magic rather than a JSON-header length."""
    return head == _MAGIC_BYTES


def pack_request(
    model: str, x: np.ndarray, *, query: bool = False, trace=None
) -> bytes:
    """One contiguous fast-lane request frame (magic included).

    ``trace`` is an optional :class:`telemetry.tracectx.TraceContext`;
    ``None`` packs the all-zero (untraced) trace tail.
    """
    mat = np.ascontiguousarray(x, dtype=_DTYPE)
    if mat.ndim != 2:
        raise ValueError("fastlane payload must be 2-D (rows, features)")
    name = model.encode("utf-8")
    if len(name) > 0xFFFF:
        raise ValueError("model name too long for fastlane frame")
    flags = FLAG_QUERY if query else 0
    header = _REQ_STRUCT.pack(
        FASTLANE_VERSION, flags, len(name), mat.shape[0], mat.shape[1],
        trace.trace_id if trace is not None else 0,
        trace.span_id if trace is not None else 0,
        trace.origin_us if trace is not None else 0,
    )
    return b"".join((_MAGIC_BYTES, header, name, mat.tobytes()))


def read_request(read_exact):
    """Parse one request after the magic has been consumed.

    ``read_exact(n)`` must return exactly ``n`` bytes (the server's
    ``_read_exact`` over the socket rfile). Returns
    ``(model, matrix, is_query, trace)``; the matrix is a zero-copy
    ``frombuffer`` view over the received payload and ``trace`` is a
    ``TraceContext`` (``None`` when the frame's trace tail is zero).
    """
    version, flags, name_len, rows, cols, trace_id, span_id, origin_us = (
        _REQ_STRUCT.unpack(read_exact(_REQ_STRUCT.size))
    )
    if version != FASTLANE_VERSION:
        raise ValueError(f"unsupported fastlane version {version}")
    model = bytes(read_exact(name_len)).decode("utf-8")
    payload = read_exact(rows * cols * _DTYPE.itemsize)
    mat = np.frombuffer(payload, dtype=_DTYPE).reshape(rows, cols)
    trace = tracectx.from_wire(trace_id, span_id, origin_us)
    return model, mat, bool(flags & FLAG_QUERY), trace


def request_struct_size() -> int:
    """Size of the fixed request struct that follows the magic."""
    return _REQ_STRUCT.size


def peek_request(raw: bytes) -> tuple[int, int, int]:
    """(name_len, rows, cols) of a packed request struct: what a router
    needs to route the frame without touching its payload."""
    version, _flags, name_len, rows, cols = _REQ_STRUCT.unpack(raw)[:5]
    if version != FASTLANE_VERSION:
        raise ValueError(f"unsupported fastlane version {version}")
    return name_len, rows, cols


def response_struct_size() -> int:
    """Size of the fixed response struct that follows the magic."""
    return _RESP_STRUCT.size


def peek_response_payload_len(raw: bytes) -> int:
    """The payload length of a packed response struct (a relay's sizing)."""
    return _RESP_STRUCT.unpack(raw)[5]


def peek_trace(raw: bytes):
    """The trace tail of a packed request struct as a ``TraceContext``
    (``None`` when untraced) — a relay's zero-decode context read."""
    trace_id, span_id, origin_us = tracectx.TRACE_STRUCT.unpack_from(
        raw, _TRACE_OFFSET
    )
    return tracectx.from_wire(trace_id, span_id, origin_us)


def rewrite_trace(raw: bytes, trace) -> bytes:
    """A copy of a packed request struct with its trace tail replaced —
    how a relay injects a freshly minted context (or re-parents
    a propagated one to its relay span) into the bytes it already
    buffered. Pure byte surgery at a fixed offset: no JSON, no decode of
    the surrounding frame."""
    return raw[:_TRACE_OFFSET] + tracectx.TRACE_STRUCT.pack(
        trace.trace_id if trace is not None else 0,
        trace.span_id if trace is not None else 0,
        trace.origin_us if trace is not None else 0,
    )


def pack_response_header(status: int, rows: int, cols: int,
                         payload_len: int, *, error: bool = False) -> bytes:
    return b"".join((
        _MAGIC_BYTES,
        _RESP_STRUCT.pack(
            FASTLANE_VERSION, FLAG_ERROR if error else 0,
            status, rows, cols, payload_len,
        ),
    ))


def pack_error_response(status: int, message: str) -> bytes:
    body = message.encode("utf-8")[:4096]
    return pack_response_header(
        status, 0, 0, len(body), error=True
    ) + body


def read_response(read_exact) -> np.ndarray:
    """Parse one response (magic included); raises ``FastlaneError`` on
    an error frame. The returned matrix is ``<f4`` with shape
    ``(rows, cols)``."""
    head = read_exact(4)
    if head != _MAGIC_BYTES:
        raise ValueError("fastlane response missing magic")
    version, flags, status, rows, cols, payload_len = _RESP_STRUCT.unpack(
        read_exact(_RESP_STRUCT.size)
    )
    if version != FASTLANE_VERSION:
        raise ValueError(f"unsupported fastlane version {version}")
    payload = read_exact(payload_len)
    if flags & FLAG_ERROR:
        raise FastlaneError(status, payload.decode("utf-8", "replace"))
    return np.frombuffer(payload, dtype=_DTYPE).reshape(rows, cols)


class ResponseBufferPool:
    """Pre-sized response buffers recycled per (model, bucket).

    ``lease`` hands out a ``memoryview`` sized to the response; in steady
    state the same few buffers cycle between the socket writer and the
    pool. A key's buffer grows to the largest response seen for it, and at
    most ``max_per_key`` are kept. With ``pinned`` the buffers are pinned
    host memory (a CUDA registry's pool).
    """

    def __init__(self, max_per_key: int = 8, *, pinned: bool = False):
        self._free: dict[tuple[str, int], list] = {}
        self._lock = threading.Lock()
        self._max_per_key = max_per_key
        self.pinned = pinned
        self.leases = 0
        self.allocations = 0

    def _allocate(self, nbytes: int):
        self.allocations += 1
        if self.pinned:
            return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True).numpy()  # tpulint: disable=TPL002 -- a view of pinned host memory, no device
        return bytearray(nbytes)

    @contextlib.contextmanager
    def lease(self, model: str, bucket: int, nbytes: int):
        key = (model, bucket)
        with self._lock:
            self.leases += 1
            stack = self._free.get(key)
            buf = stack.pop() if stack else None
            if buf is None or len(buf) < nbytes:
                buf = self._allocate(nbytes)
        try:
            yield memoryview(buf)[:nbytes]
        finally:
            with self._lock:
                stack = self._free.setdefault(key, [])
                if len(stack) < self._max_per_key:
                    stack.append(buf)

    def stats(self) -> dict:
        with self._lock:
            return {
                "leases": self.leases,
                "allocations": self.allocations,
                "keys": len(self._free),
                "pinned": self.pinned,
            }


def fill_f32(view: memoryview, out: np.ndarray) -> tuple[int, int]:
    """Cast an output into a leased buffer; returns (rows, cols). The one
    copy a response pays, with no ``tobytes()`` beside it."""
    mat = out if out.ndim == 2 else np.reshape(out, (out.shape[0], -1))
    dst = np.frombuffer(view, dtype=_DTYPE).reshape(mat.shape)
    np.copyto(dst, mat, casting="unsafe")
    return mat.shape[0], mat.shape[1]
