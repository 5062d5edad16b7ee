"""LocalSparkSession: createDataFrame + the worker-process pool behind
``mapInArrow`` (see ``worker.py`` for the boundary-fidelity contract).

Port of ``spark_rapids_ml_tpu/localspark/session.py``, around the port's
``resilience`` (``WorkerSupervisor``, the ``scheduler.task`` and
``scheduler.rank`` fault sites) and ``utils/devicepolicy.py``
(``worker_env``, ``apply_overrides``, the startup probe). The scheduler,
its retries and hedges, the barrier stages and the telemetry merge are the
JAX engine's. What differs is the worker platform's default, ``"cuda"``
(see ``LocalSparkSession``).
"""

from __future__ import annotations

import atexit
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from collections import deque
from typing import Any, Iterator

import numpy as np
import pyarrow as pa

from spark_rapids_ml_tpu_torch.localspark import types as T
from spark_rapids_ml_tpu_torch.localspark import worker as W
from spark_rapids_ml_tpu_torch.resilience import faults, sites
from spark_rapids_ml_tpu_torch.resilience.supervisor import (
    WorkerSupervisor,
    hedge_config,
)
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY
from spark_rapids_ml_tpu_torch.telemetry.timeline import TIMELINE
from spark_rapids_ml_tpu_torch.utils import devicepolicy
from spark_rapids_ml_tpu_torch.utils.config import (
    BARRIER_RETRIES_VAR,
    BARRIER_TIMEOUT_S_VAR,
    DEFAULT_BARRIER_RETRIES,
    DEFAULT_BARRIER_TIMEOUT_S,
    get_config,
    lenient_int,
)
from spark_rapids_ml_tpu_torch.localspark.dataframe import (
    DataFrame,
    Row,
    _infer_type,
    dataframe_from_partitions,
)

logger = logging.getLogger("spark_rapids_ml_tpu_torch")


class WorkerException(RuntimeError):
    """A mapInArrow plan function raised inside a worker process; carries the
    worker-side traceback (the analog of pyspark's PythonException)."""


class _BarrierInfraFailure(Exception):
    """Internal: a barrier epoch failed on *infrastructure* (worker death,
    injected preemption, rank-join deadline) — retryable with fresh workers,
    unlike a plan error, which would only run the same bug twice."""

    def __init__(self, cause: BaseException):
        super().__init__(str(cause))
        self.cause = cause


def _require_results(
    results: list, stage: str
) -> list:
    """Every partition must have produced a result; a silent ``None`` used
    to be yielded as an empty batch list — data loss dressed up as an empty
    partition. Name the holes and refuse instead."""
    missing = [i for i, r in enumerate(results) if r is None]
    if missing:
        raise WorkerException(
            f"{stage} stage finished without a result for partition(s) "
            f"{missing}: no worker returned a payload for them and no "
            "failure was recorded — refusing to yield partial output"
        )
    return results


class _Worker:
    """One reusable worker subprocess + its half of the framing protocol."""

    dead = False

    def __init__(self, extra_env: dict[str, str | None] | None = None):
        env = devicepolicy.apply_overrides(os.environ, extra_env or {})
        self._probe_armed = bool(env.get(devicepolicy.PROBE_VAR))
        self._tasks_done = 0
        self._stderr = tempfile.NamedTemporaryFile(
            mode="w+b", prefix="torch-localspark-worker-", suffix=".log", delete=False
        )
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "spark_rapids_ml_tpu_torch.localspark.worker"],
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=self._stderr,
            env=env,
        )
        self._lock = threading.Lock()

    def run_task(
        self,
        fn_bytes: bytes,
        data: bytes,
        schema_bytes: bytes,
        context: dict | None = None,
        partition: int | None = None,
        defer_trailer: bool = False,
    ) -> bytes | tuple[bytes, bytes]:
        trailer = b""
        with self._lock:
            try:
                out = self.proc.stdin
                if context is None:
                    out.write(W.MAGIC)
                else:
                    out.write(W.MAGIC_BARRIER)
                W.write_block(out, fn_bytes)
                W.write_block(out, data)
                W.write_block(out, schema_bytes)
                if context is not None:
                    W.write_block(out, json.dumps(context).encode())
                out.flush()
                status = self.proc.stdout.read(1)
                if len(status) != 1:
                    raise EOFError
                payload = W.read_block(self.proc.stdout)
                if status == b"O":
                    # telemetry trailer: the worker's registry delta +
                    # timeline events for THIS task (worker.py framing doc)
                    trailer = W.read_block(self.proc.stdout)
            except (EOFError, BrokenPipeError, OSError) as e:
                self.dead = True  # session must not reuse this process
                try:  # EOF can precede process teardown: wait briefly for rc
                    rc = self.proc.wait(timeout=5)
                except subprocess.TimeoutExpired:
                    rc = None
                # the probe can only fail before the first task of an armed
                # worker — a later rc collision is an unrelated crash
                if (
                    rc == devicepolicy.PROBE_EXIT_CODE
                    and self._probe_armed
                    and self._tasks_done == 0
                ):
                    raise WorkerException(
                        "localspark worker failed its device-policy probe "
                        "(see utils/devicepolicy.py); stderr tail:\n"
                        + self._stderr_tail()
                    ) from e
                raise WorkerException(
                    f"localspark worker died mid-task (exit code {rc}); "
                    "stderr tail:\n" + self._stderr_tail()
                ) from e
        self._tasks_done += 1
        if status == b"E":
            import cloudpickle

            raise WorkerException(
                "mapInArrow plan function failed in the worker process:\n"
                + cloudpickle.loads(payload)
            )
        if defer_trailer:
            # the caller decides whether this attempt's telemetry counts —
            # a hedge loser's trailer must be dropped, not merged twice
            return payload, trailer
        self._merge_telemetry(trailer, partition)
        return payload

    @staticmethod
    def _merge_telemetry(trailer: bytes, partition: int | None) -> None:
        """Fold a worker's telemetry trailer into the driver's registry and
        flight-recorder timeline, labeling every series/event with the
        partition it came from. Best-effort by design: a malformed trailer
        is logged and dropped, never failing the task that produced it."""
        if not trailer:
            return
        try:
            t = json.loads(trailer)
            label = "" if partition is None else str(partition)
            if t.get("registry"):
                REGISTRY.merge_wire(t["registry"], partition=label)
            if t.get("events"):
                TIMELINE.merge(t["events"], partition=label)
            # worker liveness: the monotonic stamp of the last merged
            # trailer, the series the health monitor's ``workers``
            # component reads (telemetry/health.py)
            REGISTRY.gauge_set("worker.last_trailer", time.monotonic())
        except Exception:
            logger.warning(
                "dropping unmergeable worker telemetry trailer (partition=%s)",
                partition,
                exc_info=True,
            )

    def _stderr_tail(self, limit: int = 4000) -> str:
        try:
            with open(self._stderr.name, "rb") as f:
                data = f.read()
            return data[-limit:].decode(errors="replace")
        except OSError:
            return "<stderr unavailable>"

    def close(self) -> None:
        try:
            if self.proc.stdin:
                self.proc.stdin.close()
            self.proc.wait(timeout=10)
        except Exception:
            self.proc.kill()
        finally:
            try:
                self._stderr.close()
                os.unlink(self._stderr.name)
            except OSError:
                pass


class LocalSparkSession:
    """A no-JVM session with the ``SparkSession`` surface the estimators use.

    Parameters mirror the Spark knobs they stand in for:

    - ``parallelism``: default partition count of ``createDataFrame``
      (``spark.default.parallelism``)
    - ``num_workers``: worker processes executing mapInArrow tasks; they are
      reused across jobs (``spark.python.worker.reuse``)
    - ``max_records_per_batch``: input chunking so plan functions see
      multiple batches per partition
      (``spark.sql.execution.arrow.maxRecordsPerBatch``)
    - ``worker_platform``: the device policy for worker processes (see
      ``utils.devicepolicy``). Default ``"cuda"``: workers see the cards,
      and a partition function on ``device="cuda"`` computes there. The JAX
      engine's default is ``"cpu"``, because one process owns libtpu on a
      host; several processes may share one CUDA card, so the driver and
      its workers can all use it. ``"cpu"`` hides the cards from the
      workers (``CUDA_VISIBLE_DEVICES=""``), and then a partition function
      on ``"cuda"`` raises in the worker, naming both settings; ``None``
      hands the workers the parent's environment untouched.
    - ``worker_env``: extra env overrides for workers, applied on top of
      the device policy (a value of ``None`` removes the variable)
    """

    def __init__(
        self,
        parallelism: int = 2,
        num_workers: int = 1,
        max_records_per_batch: int = 10_000,
        worker_env: dict[str, str | None] | None = None,
        worker_platform: str | None = "cuda",
    ):
        if parallelism < 1 or num_workers < 1 or max_records_per_batch < 1:
            raise ValueError("parallelism/num_workers/max_records_per_batch >= 1")
        self.parallelism = parallelism
        self.num_workers = num_workers
        self.max_records_per_batch = max_records_per_batch
        self._worker_env = devicepolicy.worker_env(worker_platform)
        self._worker_env.update(worker_env or {})
        # rendezvous bound for barrier stages (spark.barrier.sync.timeout),
        # raised on a loaded host rather than letting load turn into
        # spurious WorkerExceptions
        raw_bt = os.environ.get(BARRIER_TIMEOUT_S_VAR, DEFAULT_BARRIER_TIMEOUT_S)
        try:
            self.barrier_timeout = float(raw_bt)
        except ValueError:
            raise ValueError(
                f"{BARRIER_TIMEOUT_S_VAR} must be a number of seconds, got {raw_bt!r}"
            ) from None
        if self.barrier_timeout <= 0:
            raise ValueError(f"{BARRIER_TIMEOUT_S_VAR} must be > 0, got {raw_bt!r}")
        # worker lifecycle is owned by the supervisor: leases, bounded
        # respawn with backoff, per-slot circuit breaker (see
        # resilience/supervisor.py) — replacing the old unbounded
        # remove-dead-and-respawn loop
        self._supervisor = WorkerSupervisor(
            lambda extra: _Worker({**self._worker_env, **extra}),
            num_workers,
        )
        self._closed = False
        atexit.register(self.stop)

    @property
    def _workers(self) -> list[_Worker]:
        """Live supervised workers in slot order — kept as a property for
        the tests and diagnostics that peeked at the old worker list."""
        return self._supervisor.live_workers()

    # -- DataFrame construction --------------------------------------------

    def createDataFrame(
        self,
        data: Any,
        schema: T.StructType | list[str] | None = None,
        numPartitions: int | None = None,
    ) -> DataFrame:
        if self._closed:
            raise RuntimeError("session is stopped")
        # pa.Table first: it also implements the dataframe-interchange
        # protocol, so the pandas duck-check below would claim it
        if isinstance(data, pa.Table):
            struct = T.from_arrow_schema(data.schema)
            parts = self._split_batches(data, numPartitions or self.parallelism)
            return dataframe_from_partitions(self, struct, parts)
        if hasattr(data, "itertuples"):  # pandas (or API-compatible) frame
            rows = [tuple(r) for r in data.itertuples(index=False)]
            names = [str(c) for c in data.columns]
            struct = self._infer_schema(rows, names) if schema is None else schema
        else:
            rows = [tuple(r) for r in data]
            if schema is None:
                raise ValueError(
                    "createDataFrame from rows needs a schema (StructType or "
                    "column names)"
                )
            struct = schema
            names = None
        if isinstance(struct, list):
            struct = self._infer_schema(rows, struct)
        if not isinstance(struct, T.StructType):
            raise TypeError(f"unsupported schema: {struct!r}")

        arrow_schema = struct.to_arrow()
        columns = []
        for i, field in enumerate(arrow_schema):
            vals = [_coerce_cell(r[i]) for r in rows]
            columns.append(pa.array(vals, type=field.type))
        table = pa.Table.from_arrays(columns, schema=arrow_schema)
        parts = self._split_batches(table, numPartitions or self.parallelism)
        return dataframe_from_partitions(self, struct, parts)

    def _infer_schema(self, rows, names) -> T.StructType:
        if not rows:
            raise ValueError("cannot infer schema from an empty dataset")
        first = rows[0]
        if len(first) != len(names):
            raise ValueError(
                f"row arity {len(first)} != number of column names {len(names)}"
            )
        return T.StructType(
            [T.StructField(n, _infer_type(v)) for n, v in zip(names, first)]
        )

    def _split_batches(
        self, table: pa.Table, num_partitions: int
    ) -> list[list[pa.RecordBatch]]:
        cuts = np.linspace(0, table.num_rows, num_partitions + 1).astype(int)
        return [
            table.slice(lo, hi - lo).to_batches() if hi > lo else []
            for lo, hi in zip(cuts[:-1], cuts[1:])
        ]

    # -- execution ----------------------------------------------------------

    def _chunk_batches(
        self, part: list[pa.RecordBatch], schema: pa.Schema
    ) -> bytes:
        """One partition -> IPC stream, re-chunked to max_records_per_batch."""
        out = []
        for b in part:
            for at in range(0, b.num_rows, self.max_records_per_batch):
                out.append(b.slice(at, self.max_records_per_batch))
        return W.batches_to_ipc(out, schema)

    def _run_map_in_arrow(
        self, func, task_parts: list[bytes], target: pa.Schema
    ) -> Iterator[list[pa.RecordBatch]]:
        """Elastic stage scheduler.

        Partitions flow through a work queue instead of the old static
        round-robin split, which made every worker death fatal to the whole
        stage. Three behaviors fall out:

        - a worker death fails only the *attempt* — the partition is
          re-queued and migrates to a surviving slot
          (``scheduler.reassign``) while the supervisor respawns, backs
          off, or quarantines the crashed slot;
        - an idle slot *hedges* a straggler: once a running partition's age
          exceeds ``max(TPU_ML_HEDGE_FLOOR_S, TPU_ML_HEDGE_FACTOR × p50)``
          of completed-partition runtimes, a duplicate attempt launches and
          the first result wins (``scheduler.hedge``); the loser's payload
          AND telemetry trailer are discarded, so nothing double-counts;
        - each slot is seeded its first partition deterministically (the
          worker-reuse and both-workers-used placement contracts), only the
          remainder is contended.

        Plan errors — the worker survived, the user's function raised —
        stay immediately fatal: re-running a deterministic bug is not
        resilience, it is the same traceback twice.
        """
        import cloudpickle

        fn_bytes = cloudpickle.dumps(func)  # fails here exactly like Spark would
        schema_bytes = target.serialize().to_pybytes()
        if self._closed:
            raise RuntimeError("session is stopped")
        n = len(task_parts)
        if n == 0:
            return
        sup = self._supervisor
        sup.begin_stage()
        slots = sup.available_slots()
        hedge_factor, hedge_floor = hedge_config()
        max_attempts = 1 + max(0, get_config().task_retries)

        cv = threading.Condition()
        results: list[list[pa.RecordBatch] | None] = [None] * n
        seeds: dict[int, deque] = {s: deque() for s in slots}
        queue: deque = deque()
        for i in range(n):
            if i < len(slots):
                seeds[slots[i]].append(i)
            else:
                queue.append(i)
        attempts_left = [max_attempts] * n
        done = [False] * n
        hedged = [False] * n
        inflight: dict[int, dict] = {}  # idx -> {"t0": start, "count": live}
        durations: list[float] = []
        fatal: list[BaseException] = []
        state = {"done": 0, "last_error": None}

        def _pick(slot):
            # under cv: the next (partition, is_hedge) for this slot, or None
            if seeds[slot]:
                return seeds[slot].popleft(), False
            if queue:
                return queue.popleft(), False
            if hedge_factor > 0 and durations:
                med = sorted(durations)[len(durations) // 2]
                limit = max(hedge_floor, hedge_factor * med)
                now = time.monotonic()
                for idx, info in inflight.items():
                    if (
                        not done[idx]
                        and not hedged[idx]
                        and now - info["t0"] > limit
                    ):
                        hedged[idx] = True
                        return idx, True
            return None

        def _depart(idx):
            # under cv: one attempt of idx left flight
            info = inflight.get(idx)
            if info is not None:
                info["count"] -= 1
                if info["count"] <= 0:
                    del inflight[idx]

        def _attempt_failed(idx, exc):
            # under cv: consume an attempt — requeue, defer to a live hedge
            # twin, or fail the stage once every recourse is spent
            state["last_error"] = exc
            if done[idx]:
                return
            attempts_left[idx] -= 1
            if inflight.get(idx, {"count": 0})["count"] > 0:
                return  # a hedge twin is still running; let it decide
            if attempts_left[idx] > 0:
                queue.append(idx)
                REGISTRY.counter_inc("scheduler.reassign", partition=str(idx))
                TIMELINE.record_instant("scheduler.reassign", partition=str(idx))
            else:
                fatal.append(exc)

        def _runner(slot):
            worker = None
            try:
                while True:
                    with cv:
                        unit = None
                        while unit is None:
                            if fatal or state["done"] >= n:
                                return
                            unit = _pick(slot)
                            if unit is None:
                                cv.wait(0.05)
                        idx, is_hedge = unit
                        info = inflight.setdefault(
                            idx, {"t0": time.monotonic(), "count": 0}
                        )
                        info["count"] += 1
                        if is_hedge:
                            REGISTRY.counter_inc(
                                "scheduler.hedge", partition=str(idx)
                            )
                            TIMELINE.record_instant(
                                "scheduler.hedge",
                                partition=str(idx),
                                slot=str(slot),
                            )
                            logger.info(
                                "hedging straggler partition %d on slot %d",
                                idx, slot,
                            )
                        else:
                            REGISTRY.counter_inc("scheduler.tasks")
                    if worker is None or worker.dead:
                        worker = sup.checkout(slot)
                        if worker is None:  # quarantined/stopped under us
                            with cv:
                                _depart(idx)
                                _attempt_failed(
                                    idx,
                                    WorkerException(
                                        f"worker slot {slot} is unavailable"
                                    ),
                                )
                                cv.notify_all()
                            return
                    t0 = time.monotonic()
                    try:
                        faults.inject(sites.SCHEDULER_TASK)
                        payload, trailer = worker.run_task(
                            fn_bytes,
                            task_parts[idx],
                            schema_bytes,
                            partition=idx,
                            defer_trailer=True,
                        )
                        batches, _ = W.batches_from_ipc(payload)
                    except faults.FaultInjected as e:
                        # injected dispatch failure: the worker is fine,
                        # the attempt is spent
                        with cv:
                            _depart(idx)
                            _attempt_failed(idx, e)
                            cv.notify_all()
                        continue
                    except WorkerException as e:
                        if worker.dead:
                            quarantined = sup.report_crash(slot, e)
                            worker = None
                            with cv:
                                _depart(idx)
                                _attempt_failed(idx, e)
                                cv.notify_all()
                            if quarantined:
                                return
                            continue
                        with cv:  # plan error: fatal, never retried
                            _depart(idx)
                            fatal.append(e)
                            cv.notify_all()
                        return
                    sup.report_success(slot)
                    accept = False
                    with cv:
                        _depart(idx)
                        if not done[idx]:
                            done[idx] = True
                            state["done"] += 1
                            results[idx] = batches
                            durations.append(time.monotonic() - t0)
                            accept = True
                        cv.notify_all()
                    if accept:
                        _Worker._merge_telemetry(trailer, idx)
            except BaseException as e:  # noqa: BLE001 - surfaced to the stage
                with cv:
                    fatal.append(e)
                    cv.notify_all()

        threads = [
            threading.Thread(target=_runner, args=(s,), daemon=True)
            for s in slots
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if fatal:
            raise fatal[0]
        if state["done"] < n and state["last_error"] is not None:
            raise state["last_error"]
        yield from _require_results(results, "mapInArrow")

    def _run_map_in_arrow_barrier(
        self, func, task_parts: list[bytes], target: pa.Schema
    ) -> Iterator[list[pa.RecordBatch]]:
        """Barrier-mode stage: every partition's task launches SIMULTANEOUSLY
        in its own FRESH worker process, with a shared BarrierTaskContext for
        rendezvous/allGather — Spark's ``RDD.barrier()`` semantics, which an
        SPMD mesh program needs from the scheduler.

        Fresh (non-reused) workers are deliberate: a barrier task typically
        bootstraps the stage's process group (``torch.distributed``), which
        belongs to that stage alone — a reused worker (or one that ran the
        device-policy probe) may already hold a process group or a device
        context. The workers are torn down when the stage ends, like
        Spark executors finishing a barrier stage. The startup probe is
        disarmed for the same reason; the bootstrap-trigger scrub (the part
        that prevents the accelerator hang) still applies.

        A barrier stage is all-or-nothing — its membership is fixed at
        launch, so a single lost rank dooms the epoch. Instead of turning
        one preemption into a failed fit, the whole round is retried with
        fresh workers up to ``TPU_ML_BARRIER_RETRIES`` times
        (``scheduler.barrier_retry``). Only *infrastructure* failures
        (worker death, injected preemption, rank-join deadline) retry; a
        plan error raises immediately, every time.
        """
        import cloudpickle

        if self._closed:
            raise RuntimeError("session is stopped")
        fn_bytes = cloudpickle.dumps(func)
        schema_bytes = target.serialize().to_pybytes()
        retries = max(0, lenient_int(BARRIER_RETRIES_VAR, DEFAULT_BARRIER_RETRIES))
        results = None
        for epoch in range(retries + 1):
            try:
                results = self._run_barrier_epoch(
                    fn_bytes, task_parts, schema_bytes
                )
                break
            except _BarrierInfraFailure as e:
                if epoch >= retries:
                    raise e.cause
                REGISTRY.counter_inc("scheduler.barrier_retry")
                TIMELINE.record_instant(
                    "scheduler.barrier_retry", epoch=str(epoch)
                )
                logger.warning(
                    "barrier epoch %d lost a rank to infrastructure (%s); "
                    "retrying the whole round with fresh workers (%d "
                    "retry(ies) left)",
                    epoch, e, retries - epoch,
                )
        yield from _require_results(results, "mapInArrow(barrier)")

    def _run_barrier_epoch(
        self, fn_bytes: bytes, task_parts: list[bytes], schema_bytes: bytes
    ) -> list:
        """One all-or-nothing barrier round: fresh workers, deadline-bounded
        rank joins, teardown + scratch-dir cleanup guaranteed by finally.

        Raises :class:`_BarrierInfraFailure` when the round died to
        infrastructure (retryable), or the plan error itself when user code
        raised with its worker still alive (never retried).
        """
        n = len(task_parts)
        barrier_dir = tempfile.mkdtemp(prefix="torch-localspark-barrier-")
        env = dict(self._worker_env)
        env.pop(devicepolicy.PROBE_VAR, None)
        workers: list[_Worker] = []
        results: list[list[pa.RecordBatch] | None] = [None] * n
        errors: list[tuple[int, BaseException]] = []
        torn_down = False

        def close_all() -> None:
            for w in workers:
                w.close()

        try:
            workers.extend(_Worker(env) for _ in range(n))

            def run_one(rank: int) -> None:
                context = {
                    "partition_id": rank,
                    "num_tasks": n,
                    "barrier_dir": barrier_dir,
                    "timeout": self.barrier_timeout,
                }
                try:
                    REGISTRY.counter_inc("scheduler.tasks")
                    faults.inject(sites.SCHEDULER_RANK)
                    payload = workers[rank].run_task(
                        fn_bytes, task_parts[rank], schema_bytes, context,
                        partition=rank,
                    )
                    results[rank], _ = W.batches_from_ipc(payload)
                except BaseException as e:  # noqa: BLE001 - re-raised below
                    errors.append((rank, e))

            threads = [
                threading.Thread(target=run_one, args=(r,), daemon=True)
                for r in range(n)
            ]
            for t in threads:
                t.start()
            # bounded joins: the in-worker rendezvous is already capped at
            # barrier_timeout, so 2x + grace only catches a wedged compute
            deadline = time.monotonic() + 2.0 * self.barrier_timeout + 30.0
            pending = list(threads)
            while pending:
                for t in list(pending):
                    t.join(timeout=0.1)
                    if not t.is_alive():
                        pending.remove(t)
                if not pending:
                    break
                if errors and not torn_down:
                    # membership is fixed: one failed rank dooms the epoch.
                    # Kill the survivors now rather than letting them wait
                    # out the rendezvous timeout on a rank that never comes.
                    torn_down = True
                    close_all()
                elif time.monotonic() > deadline:
                    errors.append((-1, WorkerException(
                        f"barrier rank(s) failed to join within "
                        f"{2.0 * self.barrier_timeout + 30.0:.0f}s "
                        f"(2x {BARRIER_TIMEOUT_S_VAR} + grace); "
                        "tearing the epoch down"
                    )))
                    torn_down = True
                    close_all()
                    for t in pending:
                        t.join(timeout=15)
                    break
        finally:
            close_all()
            shutil.rmtree(barrier_dir, ignore_errors=True)
        if errors:
            def _infra(rank: int, exc: BaseException) -> bool:
                return (
                    isinstance(exc, faults.FaultInjected)
                    or rank < 0
                    or (rank < len(workers) and workers[rank].dead)
                )

            plan_errors = [e for r, e in errors if not _infra(r, e)]
            if plan_errors:
                raise plan_errors[0]
            # prefer an injected fault as the representative cause: the
            # early teardown above kills the surviving ranks, so their
            # died-mid-task errors are downstream noise of the first fault
            cause = next(
                (e for _, e in errors if isinstance(e, faults.FaultInjected)),
                errors[0][1],
            )
            raise _BarrierInfraFailure(cause)
        return results

    # -- lifecycle -----------------------------------------------------------

    def stop(self) -> None:
        self._closed = True
        self._supervisor.close()

    def __enter__(self) -> "LocalSparkSession":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # pyspark-compat sugar so ``LocalSparkSession.builder...getOrCreate()``
    # shaped code works in examples
    class _Builder:
        def master(self, _):
            return self

        def appName(self, _):
            return self

        def config(self, *_, **__):
            return self

        def getOrCreate(self) -> "LocalSparkSession":
            return LocalSparkSession()

    class _BuilderDescriptor:
        def __get__(self, obj, objtype=None) -> "LocalSparkSession._Builder":
            return LocalSparkSession._Builder()

    builder = _BuilderDescriptor()


def _coerce_cell(v):
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, Row):
        return tuple(v)
    return v
