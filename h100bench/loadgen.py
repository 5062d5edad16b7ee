"""The one traffic generator. A mix file (``traffic/<name>.json``) gives its
parameters; this module knows no mix by name.

- ``op``: the operation of the configuration that each request calls;
- ``loop``: ``"closed"``, one caller: each operation starts when the last
  returns, until ``seconds`` have passed since the first started. Or
  ``"open"``: requests arrive at ``rate_per_s`` a second through the
  window, ``arrival`` ``"poisson"`` (exponential gaps drawn from the run's
  seed) or ``"uniform"`` (even gaps), and one server takes them in order
  of arrival, waiting while none is due;
- ``trace_skip_ops``, ``trace_ops``: with a tracer, the operations from
  index ``trace_skip_ops`` on, ``trace_ops`` of them, run under the
  profiler, each whole. A closed loop goes on until they have run even
  where the window closes first.

The operation that is running when the window closes runs to its end and
counts; so does every request that arrived in the window. A closed loop has
one caller: the cells run one process on one card, and a second caller
thread would share that card with the first.
"""

from __future__ import annotations

import time
import traceback
from dataclasses import dataclass
from typing import Callable

import numpy as np


@dataclass
class OpRecord:
    index: int
    arrival: float
    start: float
    end: float
    output: dict | None = None
    error: str | None = None
    traced: bool = False

    @property
    def ok(self) -> bool:
        return self.error is None


def arrivals(mix: dict, seconds: float, seed: int) -> np.ndarray:
    """Arrival times of an open loop's requests, seconds from the window's
    start, all under ``seconds``."""
    rate = float(mix["rate_per_s"])
    count = int(np.ceil(seconds * rate)) + 1
    if mix.get("arrival", "poisson") == "uniform":
        times = np.arange(count) / rate
    else:
        gaps = np.random.default_rng(int(seed)).exponential(1.0 / rate, 4 * count + 16)
        times = np.concatenate([[0.0], np.cumsum(gaps)])
    return times[times < seconds]


def drive(op: Callable[[int], dict], seconds: float, mix: dict, seed: int = 0,
          tracer=None, clock=time.perf_counter, sleep=time.sleep) -> list[OpRecord]:
    """The requests of ``mix`` over a window of ``seconds``, each a call of
    ``op(index)``; one record each, in order."""
    loop = mix.get("loop")
    if loop == "closed":
        if int(mix.get("clients", 1)) != 1:
            raise ValueError(f"a closed loop has one caller, not {mix['clients']}")
        due = None
    elif loop == "open":
        due = arrivals(mix, seconds, seed)
    else:
        raise ValueError(f"unknown loop {loop!r} in mix {mix}")
    skip = int(mix.get("trace_skip_ops", 0))
    count = int(mix.get("trace_ops", 0)) if tracer is not None else 0
    records: list[OpRecord] = []
    first = clock()
    while True:
        i = len(records)
        if due is None:
            if records and clock() - first >= seconds and i >= skip + count:
                break
            arrival = clock()
        else:
            if i >= len(due):
                break
            arrival = first + float(due[i])
            if clock() < arrival:
                sleep(arrival - clock())
        traced = skip <= i < skip + count
        if traced and i == skip:
            tracer.start()
        start = clock()
        try:
            if traced:
                with tracer.op_range():
                    output = op(i)
            else:
                output = op(i)
            rec = OpRecord(i, arrival, start, clock(), output=output)
        except Exception:  # a failed operation is counted, and the loop goes on
            rec = OpRecord(i, arrival, start, clock(), error=traceback.format_exc(limit=20))
        rec.traced = traced
        records.append(rec)
        if traced and (i == skip + count - 1 or (due is not None and i == len(due) - 1)):
            tracer.stop()
    return records


def seconds_per_op(records: list[OpRecord]) -> float | None:
    """From the first operation's start to the last completed one's end,
    over the operations completed."""
    done = [r for r in records if r.ok]
    if not done:
        return None
    return (done[-1].end - records[0].start) / len(done)
