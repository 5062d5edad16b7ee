"""Mid-training checkpoint/resume for iterative estimators (the KMeans
Lloyd loop).

Copy of ``spark_rapids_ml_tpu/utils/checkpoint.py`` (numpy and json only),
so a checkpoint directory written by either package resumes in the other.
A checkpoint is a step-numbered directory holding one ``.npz`` of named
arrays and a ``state.json`` of scalars. Writes are atomic (write to
``<dir>/.tmp-<step>``, fsync, ``os.replace``), so a preemption mid-write
never corrupts the newest durable state: readers only see fully renamed
step directories. Retention keeps the newest ``keep`` steps.
"""

from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

import numpy as np

_STEP_PREFIX = "step-"


class TrainingCheckpointer:
    """Atomic step-numbered checkpoints of training state in one directory.

    >>> ckpt = TrainingCheckpointer(dir)
    >>> ckpt.save(3, {"centers": c}, {"cost": 1.5})
    >>> step, arrays, state = ckpt.latest()
    """

    def __init__(self, directory: str | Path, *, keep: int = 2):
        if keep < 1:
            raise ValueError("keep must be >= 1")
        self.dir = Path(directory)
        self.keep = keep
        self.dir.mkdir(parents=True, exist_ok=True)

    def _step_dir(self, step: int) -> Path:
        return self.dir / f"{_STEP_PREFIX}{step:09d}"

    def steps(self) -> list[int]:
        out = []
        for p in self.dir.iterdir():
            if p.is_dir() and p.name.startswith(_STEP_PREFIX):
                try:
                    out.append(int(p.name[len(_STEP_PREFIX):]))
                except ValueError:
                    continue
        return sorted(out)

    def save(self, step: int, arrays: dict[str, np.ndarray], state: dict | None = None) -> None:
        # sweep ALL stale staging dirs, not just this step's: a writer killed
        # mid-save (preemption, fault injection) leaves a .tmp-<other-step>
        # orphan that would otherwise accumulate forever
        if self.dir.is_dir():
            for stale in self.dir.iterdir():
                if stale.name.startswith(".tmp-"):
                    shutil.rmtree(stale, ignore_errors=True)
        tmp = self.dir / f".tmp-{step}"
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz", **{k: np.asarray(v) for k, v in arrays.items()})
        (tmp / "state.json").write_text(json.dumps({"step": step, **(state or {})}))
        # fsync the files then atomically publish the directory
        for f in tmp.iterdir():
            fd = os.open(f, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)
        final = self._step_dir(step)
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        # fsync the parent directory so the rename itself is durable across
        # power loss, not just the file contents
        dfd = os.open(self.dir, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
        self._retain()

    def _retain(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def load(self, step: int) -> tuple[dict[str, np.ndarray], dict]:
        d = self._step_dir(step)
        with np.load(d / "arrays.npz") as z:
            arrays = {k: z[k] for k in z.files}
        state = json.loads((d / "state.json").read_text())
        return arrays, state

    def latest(self) -> tuple[int, dict[str, np.ndarray], dict] | None:
        """Newest durable checkpoint, or None. Skips any step whose payload
        is unreadable (e.g. a stale dir from a different schema)."""
        for step in reversed(self.steps()):
            try:
                arrays, state = self.load(step)
            except Exception:
                continue
            return step, arrays, state
        return None
