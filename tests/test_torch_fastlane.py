"""The port's fast lane against the JAX package's, byte for byte.

Request frames (with and without a trace tail), response headers and error
frames packed by either package are the same bytes, and each package reads
what the other packed. The response buffer pool and the counted JSON codec
are checked on the port alone.
"""

from __future__ import annotations

import io

import jax  # noqa: F401  (imported at the top of every port test file)
import numpy as np
import pytest

from spark_rapids_ml_tpu.serving import fastlane as jfl
from spark_rapids_ml_tpu.telemetry import tracectx as jtracectx
from spark_rapids_ml_tpu_torch.serving import fastlane as fl
from spark_rapids_ml_tpu_torch.telemetry import tracectx
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY

TRACE = (0x0123456789ABCDEF, 0xDEADBEEF, 1_234_567_890_123)


def _rows(rows: int = 3, cols: int = 16, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(rows, cols)).astype(np.float32)


def _reader(data: bytes):
    buf = io.BytesIO(data)
    return lambda n: buf.read(n)


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("query", [False, True])
@pytest.mark.parametrize("shape", [(1, 16), (3, 16), (64, 512)])
def test_request_frames_are_byte_equal(traced, query, shape):
    x = _rows(*shape)
    port_trace = tracectx.TraceContext(*TRACE) if traced else None
    jax_trace = jtracectx.TraceContext(*TRACE) if traced else None
    a = fl.pack_request("pca512", x, query=query, trace=port_trace)
    b = jfl.pack_request("pca512", x, query=query, trace=jax_trace)
    assert a == b
    # magic, the 32-byte struct, the name, the rows
    assert len(a) == 4 + 32 + len("pca512") + x.nbytes


@pytest.mark.parametrize("traced", [False, True])
def test_each_package_reads_the_others_request(traced):
    x = _rows(5)
    jax_frame = jfl.pack_request(
        "m", x, trace=jtracectx.TraceContext(*TRACE) if traced else None
    )
    assert fl.is_fastlane_head(jax_frame[:4])
    model, mat, is_query, trace = fl.read_request(_reader(jax_frame[4:]))
    assert model == "m" and not is_query and np.array_equal(mat, x)
    assert (trace is not None) == traced
    if traced:
        assert (trace.trace_id, trace.span_id, trace.origin_us) == TRACE
    port_frame = fl.pack_request("m", x, trace=tracectx.TraceContext(*TRACE) if traced else None)
    model, mat, _, jtrace = jfl.read_request(_reader(port_frame[4:]))
    assert model == "m" and np.array_equal(mat, x) and (jtrace is not None) == traced


def test_peek_and_rewrite_trace_match():
    x = _rows(2)
    frame = fl.pack_request("m", x)
    head = frame[4:4 + 32]
    assert jfl.peek_request(head) == (1, 2, 16)
    assert fl.peek_trace(head) is None and jfl.peek_trace(head) is None
    rewritten = fl.rewrite_trace(head, tracectx.TraceContext(*TRACE))
    assert rewritten == jfl.rewrite_trace(head, jtracectx.TraceContext(*TRACE))
    peeked = fl.peek_trace(rewritten)
    assert (peeked.trace_id, peeked.span_id, peeked.origin_us) == TRACE
    assert fl.rewrite_trace(rewritten, None) == head


@pytest.mark.parametrize("status,rows,cols,payload,error", [
    (200, 3, 50, 600, False), (200, 4096, 50, 819_200, False), (404, 0, 0, 17, True),
])
def test_response_headers_are_byte_equal(status, rows, cols, payload, error):
    a = fl.pack_response_header(status, rows, cols, payload, error=error)
    assert a == jfl.pack_response_header(status, rows, cols, payload, error=error)
    assert jfl.peek_response_payload_len(a[4:]) == payload
    assert len(a) == 4 + 16  # magic and the 16-byte struct


def test_error_frames_are_byte_equal_and_raise_in_both_readers():
    a = fl.pack_error_response(413, "over the ladder cap")
    assert a == jfl.pack_error_response(413, "over the ladder cap")
    with pytest.raises(fl.FastlaneError) as err:
        fl.read_response(_reader(a))
    assert err.value.status == 413 and "ladder cap" in err.value.message
    with pytest.raises(jfl.FastlaneError):
        jfl.read_response(_reader(a))


def test_each_package_reads_the_others_response():
    out = _rows(7, 50)
    pool = fl.ResponseBufferPool()
    with pool.lease("m", 8, out.nbytes) as view:
        rows, cols = fl.fill_f32(view, out)
        frame = fl.pack_response_header(200, rows, cols, len(view)) + bytes(view)
    assert np.array_equal(jfl.read_response(_reader(frame)), out)
    jax_frame = jfl.pack_response_header(200, 7, 50, out.nbytes) + out.tobytes()
    assert jax_frame == frame
    assert np.array_equal(fl.read_response(_reader(jax_frame)), out)


def test_unknown_version_is_refused():
    frame = bytearray(fl.pack_request("m", _rows(1)))
    frame[4] = 9
    with pytest.raises(ValueError, match="unsupported fastlane version"):
        fl.read_request(_reader(bytes(frame[4:])))
    with pytest.raises(ValueError, match="missing magic"):
        fl.read_response(_reader(b"\x00" * 20))
    with pytest.raises(ValueError, match="2-D"):
        fl.pack_request("m", np.ones(3, np.float32))


def test_response_pool_reuses_buffers():
    pool = fl.ResponseBufferPool(max_per_key=2)
    for _ in range(5):
        with pool.lease("m", 8, 600) as view:
            assert len(view) == 600
    stats = pool.stats()
    assert stats == {"leases": 5, "allocations": 1, "keys": 1, "pinned": False}
    with pool.lease("m", 8, 4000) as view:  # larger than the pooled buffer
        assert len(view) == 4000
    assert pool.stats()["allocations"] == 2
    with pool.lease("m", 8, 3000):
        pass
    assert pool.stats()["allocations"] == 2  # the grown buffer came back


def test_fill_f32_casts_into_the_buffer():
    pool = fl.ResponseBufferPool()
    out = np.arange(12, dtype=np.float64).reshape(3, 4)
    with pool.lease("m", 8, 48) as view:
        assert fl.fill_f32(view, out) == (3, 4)
        assert np.array_equal(np.frombuffer(view, "<f4").reshape(3, 4), out)
    with pool.lease("m", 8, 12) as view:
        assert fl.fill_f32(view, np.arange(3, dtype=np.float32)) == (3, 1)


def test_json_codec_is_counted():
    snap = REGISTRY.snapshot()
    raw = fl.json_dumps({"a": [1, 2]})
    assert fl.json_loads(raw) == {"a": [1, 2]}
    delta = REGISTRY.snapshot().delta(snap)
    assert delta.counter("serve.json_codec", op="encode") == 1
    assert delta.counter("serve.json_codec", op="decode") == 1
    assert fl.FASTLANE_MAGIC == jfl.FASTLANE_MAGIC and fl.FASTLANE_VERSION == jfl.FASTLANE_VERSION
