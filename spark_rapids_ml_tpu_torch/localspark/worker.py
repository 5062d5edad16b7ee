"""The local Spark engine's Python worker: a separate OS process that runs
``mapInArrow`` plan functions, as Spark's executor-side Python worker does.

Port of ``spark_rapids_ml_tpu/localspark/worker.py``, run as ``python -m
spark_rapids_ml_tpu_torch.localspark.worker``. It keeps the JAX engine's
boundaries:

- the plan function arrives **cloudpickle-serialized**, so closures that do
  not pickle fail here as they would on a cluster;
- partition data crosses as an **Arrow IPC stream**;
- the worker is a **fresh interpreter**: torch and any card it uses start
  cold, as on an executor;
- output batches are **cast to the declared schema**; a mismatch raises
  here, naming the column;
- workers are **reused** across jobs of a session.

Framing protocol, little-endian u64 lengths, one task per request::

    driver -> worker:  b"LSPK" | fn | input-arrow-stream | target-schema
    driver -> worker:  b"LSPB" | fn | input-arrow-stream | target-schema
                       | json task-context               (barrier task)
    worker -> driver:  b"O" | output-arrow-stream
                       | json telemetry-trailer          (success)
                       b"E" | pickled traceback string   (failure)

A barrier frame installs a ``BarrierTaskContext`` before the plan function
runs. The telemetry trailer is the task's registry delta (``to_wire``) and
its timeline events, which the driver merges labelled by partition; a
trailer that does not serialize is sent empty, never failing the task.

stdout is re-pointed at stderr after start-up, so a plan function's
``print`` cannot corrupt the protocol stream.

Before its first task a worker whose environment arms the probe
(``TPU_ML_WORKER_PROBE``, ``utils/devicepolicy.py``) probes its platform
under a bound and exits with ``PROBE_EXIT_CODE`` when that fails.
"""

from __future__ import annotations

import io
import os
import struct
import sys
import time
import traceback

import pyarrow as pa

MAGIC = b"LSPK"
MAGIC_BARRIER = b"LSPB"


def write_block(stream, payload: bytes) -> None:
    stream.write(struct.pack("<Q", len(payload)))
    stream.write(payload)


def read_block(stream) -> bytes:
    header = stream.read(8)
    if len(header) != 8:
        raise EOFError("worker protocol stream truncated")
    (length,) = struct.unpack("<Q", header)
    payload = stream.read(length)
    if len(payload) != length:
        raise EOFError("worker protocol stream truncated")
    return payload


def batches_to_ipc(batches: list[pa.RecordBatch], schema: pa.Schema) -> bytes:
    sink = io.BytesIO()
    with pa.ipc.new_stream(sink, schema) as writer:
        for b in batches:
            writer.write_batch(b)
    return sink.getvalue()


def batches_from_ipc(payload: bytes) -> tuple[list[pa.RecordBatch], pa.Schema]:
    with pa.ipc.open_stream(pa.BufferReader(payload)) as reader:
        schema = reader.schema
        return list(reader), schema


def cast_to_declared(batch: pa.RecordBatch, target: pa.Schema) -> pa.RecordBatch:
    """Match one output batch to the declared schema, as Spark does: columns
    by name, value-compatible types cast, anything else an error naming the
    column."""
    if batch.schema.equals(target):
        return batch
    cols = []
    for field in target:
        idx = batch.schema.get_field_index(field.name)
        if idx < 0:
            raise ValueError(
                f"mapInArrow output is missing declared column {field.name!r}; "
                f"got columns {batch.schema.names}"
            )
        col = batch.column(idx)
        if col.type != field.type:
            try:
                col = col.cast(field.type)
            except pa.ArrowInvalid as e:
                raise ValueError(
                    f"mapInArrow output column {field.name!r} has type "
                    f"{col.type}, cannot cast to declared {field.type}: {e}"
                ) from e
        cols.append(col)
    return pa.RecordBatch.from_arrays(cols, schema=target)


def run_task(fn_bytes: bytes, data: bytes, schema_bytes: bytes,
             context: dict | None = None) -> bytes:
    """Run one mapInArrow task; returns the output IPC stream's bytes."""
    import cloudpickle

    from spark_rapids_ml_tpu_torch.localspark.taskcontext import BarrierTaskContext

    fn = cloudpickle.loads(fn_bytes)
    batches, _ = batches_from_ipc(data)
    target = pa.ipc.read_schema(pa.BufferReader(schema_bytes))
    if context is not None:
        BarrierTaskContext._install(
            BarrierTaskContext(
                partition_id=context["partition_id"],
                num_tasks=context["num_tasks"],
                barrier_dir=context["barrier_dir"],
                timeout=context.get("timeout", 120.0),
            )
        )
    try:
        out = [cast_to_declared(b, target) for b in fn(iter(batches))]
    finally:
        if context is not None:
            BarrierTaskContext._install(None)
    return batches_to_ipc(out, target)


def main() -> None:
    import json

    import cloudpickle

    # keep the protocol descriptors private; user prints go to stderr
    proto_in = os.fdopen(os.dup(0), "rb")
    proto_out = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)
    sys.stdout = sys.stderr

    from spark_rapids_ml_tpu_torch.utils import devicepolicy

    if os.environ.get(devicepolicy.PROBE_VAR):
        try:
            devicepolicy.probe_platform()
        except devicepolicy.DevicePolicyError as e:
            print(f"[tpu-ml worker] device policy violation: {e}", file=sys.stderr)
            sys.stderr.flush()
            os._exit(devicepolicy.PROBE_EXIT_CODE)

    from spark_rapids_ml_tpu_torch.resilience import faults, sites
    from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY
    from spark_rapids_ml_tpu_torch.telemetry.timeline import TIMELINE

    while True:
        magic = proto_in.read(4)
        if not magic:
            return  # the driver closed the pipe: clean shutdown
        if magic not in (MAGIC, MAGIC_BARRIER):
            raise RuntimeError(f"bad task frame magic: {magic!r}")
        fn_bytes = read_block(proto_in)
        data = read_block(proto_in)
        schema_bytes = read_block(proto_in)
        context = json.loads(read_block(proto_in)) if magic == MAGIC_BARRIER else None
        # bracket the task so the trailer carries exactly what it recorded
        reg0 = REGISTRY.snapshot()
        tl_seq0 = TIMELINE.seq()
        t0 = time.perf_counter()
        try:
            # a worker-scoped TPU_ML_FAULT_PLAN (worker.task:kill:1) crashes
            # this process mid-job, which the session must survive
            faults.inject(sites.WORKER_TASK)
            payload, status = run_task(fn_bytes, data, schema_bytes, context), b"O"
        except BaseException:
            payload, status = cloudpickle.dumps(traceback.format_exc()), b"E"
        proto_out.write(status)
        write_block(proto_out, payload)
        if status == b"O":
            t1 = time.perf_counter()
            REGISTRY.histogram_record("span.seconds", t1 - t0, phase="worker.task")
            TIMELINE.record_span("worker.task", t0, t1)
            try:
                trailer = json.dumps({
                    "registry": REGISTRY.snapshot().delta(reg0).to_wire(),
                    "events": TIMELINE.events(since_seq=tl_seq0),
                }).encode()
            except Exception:  # noqa: BLE001 - telemetry must never fail a task
                trailer = b"{}"
            write_block(proto_out, trailer)
        proto_out.flush()


if __name__ == "__main__":
    main()
