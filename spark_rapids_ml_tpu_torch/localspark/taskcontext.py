"""Barrier task context — localspark's analog of pyspark.BarrierTaskContext.

Spark's barrier execution mode (``mapInArrow(..., barrier=True)``) launches
ALL partition tasks of a stage simultaneously and gives each a
``BarrierTaskContext`` with a global rendezvous: ``barrier()`` blocks until
every task arrives, ``allGather(msg)`` additionally exchanges one string per
task. That primitive is exactly what an SPMD mesh program needs from the
scheduler: a simultaneous launch plus one bootstrap round to agree on the
process group's address (``torch.distributed``'s here; SURVEY.md §7 hard
part 2 — Spark tasks vs SPMD mesh). Copy of
``spark_rapids_ml_tpu/localspark/taskcontext.py``; its consumer, the
mesh-barrier fit, waits for ROADMAP Queue A item 6.

localspark's implementation rendezvouses through the filesystem: the driver
assigns every concurrently-running task a shared private directory, and each
``allGather`` round writes one ``round-R/rank.msg`` file per task then polls
for all of them. No sockets, no extra protocol — and the failure mode of a
lost peer is a bounded timeout with a diagnosis, not a hang (the same
fail-fast stance as utils/devicepolicy.py).
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class BarrierTimeout(RuntimeError):
    """A barrier round did not complete — a peer task died or stalled."""


class BarrierTaskContext:
    """Per-task context installed by the worker for barrier-mode tasks.

    Surface mirrors the pyspark class the estimators' plan functions use:
    ``get()``, ``partitionId()``, ``getTaskInfos()`` (length == number of
    tasks), ``barrier()``, ``allGather(message)``.
    """

    _current: Optional["BarrierTaskContext"] = None

    def __init__(self, partition_id: int, num_tasks: int, barrier_dir: str,
                 timeout: float = 120.0):
        self._partition_id = partition_id
        self._num_tasks = num_tasks
        self._barrier_dir = barrier_dir
        self._timeout = timeout
        self._round = 0

    # -- pyspark surface -----------------------------------------------------

    @classmethod
    def get(cls) -> "BarrierTaskContext":
        if cls._current is None:
            raise RuntimeError(
                "not inside a barrier task (mapInArrow(..., barrier=True))"
            )
        return cls._current

    def partitionId(self) -> int:
        return self._partition_id

    def getTaskInfos(self) -> list:
        # pyspark returns one BarrierTaskInfo (with .address) per task; the
        # estimators only use len() and indexing existence
        class _Info:
            address = "127.0.0.1"

        return [_Info() for _ in range(self._num_tasks)]

    def barrier(self) -> None:
        self.allGather("")

    def allGather(self, message: str = "") -> list[str]:
        """Exchange one string per task; returns messages ordered by rank."""
        round_dir = os.path.join(self._barrier_dir, f"round-{self._round}")
        self._round += 1
        os.makedirs(round_dir, exist_ok=True)
        mine = os.path.join(round_dir, f"{self._partition_id}.msg")
        tmp = mine + ".tmp"
        with open(tmp, "w") as f:
            json.dump(message, f)
        os.replace(tmp, mine)  # atomic publish
        deadline = time.monotonic() + self._timeout
        paths = [
            os.path.join(round_dir, f"{r}.msg") for r in range(self._num_tasks)
        ]
        while True:
            missing = [p for p in paths if not os.path.exists(p)]
            if not missing:
                break
            if time.monotonic() > deadline:
                raise BarrierTimeout(
                    f"barrier round {self._round - 1}: "
                    f"{len(missing)}/{self._num_tasks} tasks never arrived "
                    f"within {self._timeout}s (missing ranks "
                    f"{[os.path.basename(p) for p in missing[:8]]}); a peer "
                    "task likely failed — check the driver for its error"
                )
            time.sleep(0.005)
        out = []
        for p in paths:
            # publish is atomic (os.replace), so a visible file is complete
            with open(p) as f:
                out.append(json.load(f))
        return out

    # -- worker-side install -------------------------------------------------

    @classmethod
    def _install(cls, ctx: Optional["BarrierTaskContext"]) -> None:
        cls._current = ctx


class TaskContext:
    """Minimal non-barrier task context (pyspark.TaskContext analog)."""

    _partition_id: int = 0

    @classmethod
    def get(cls) -> "TaskContext":
        return cls()

    def partitionId(self) -> int:
        return self._partition_id
