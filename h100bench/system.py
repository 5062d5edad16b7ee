"""The system under test, as a configuration names it: an estimator class of
the port by its dotted path, its params, and its ``operations``, each a
method call that a traffic mix names by its key. Nothing here knows a
configuration or an operation by name.

An operation's entry:

- ``call``: the method's name;
- ``on``: ``"estimator"`` (default), a fresh estimator for every call; or
  the key of another operation, whose result, made once at the first call
  (in set-up), the method is called on (a fitted model);
- ``input``: ``"rows"`` (default), every row; or ``"batch"``, the mix's
  ``batch_rows`` rows, operation i taking the i-th whole batch, cycled;
- ``args``: keyword arguments of the call;
- ``outputs``: attributes of the result that are the answer; without it,
  the result itself, as ``value``;
- ``check``: for a checked call, the arguments it adds and the one that
  takes a fresh directory for the state it writes (``state_dir_arg``).
  Every directory the call publishes there (by ``os.replace``, as a
  checkpoint's step is published) is copied as it appears, so the steps
  the program later prunes stay for the reference.
"""

from __future__ import annotations

import importlib
import os
import shutil
import sys
import tempfile
from typing import Callable

import numpy as np
import torch


#: a checked call's state directory -> where what it publishes is copied
_KEEP: dict[str, str] = {}
_HOOKED = False


def _keep_published(event: str, args: tuple) -> None:
    """Audit hook: copy a directory renamed into a watched state directory."""
    if event != "os.rename" or not _KEEP:
        return
    src, dst = os.fspath(args[0]), os.fspath(args[1])
    if isinstance(dst, str) and isinstance(src, str):
        kept = _KEEP.get(os.path.dirname(os.path.abspath(dst)))
        if kept is not None and os.path.isdir(src):
            shutil.copytree(src, os.path.join(kept, os.path.basename(dst)))


def _watch(state_dir: str, kept: str) -> None:
    global _HOOKED
    if not _HOOKED:
        sys.addaudithook(_keep_published)
        _HOOKED = True
    os.makedirs(kept)
    _KEEP[os.path.abspath(state_dir)] = kept


def estimator_class(dotted: str):
    module, _, name = dotted.rpartition(".")
    return getattr(importlib.import_module(module), name)


class System:
    """The operations of ``config`` on the host rows ``x``; every call ends
    with its answer on the host."""

    def __init__(self, config: dict, seed: int, device: torch.device, x: np.ndarray,
                 scratch: str):
        self.cls = estimator_class(config["estimator"])
        self.params = dict(config["params"])
        if "seed_param" in config:
            self.params[config["seed_param"]] = int(seed)
        self.ops = config["operations"]
        self.device = device
        self.x = x
        self.scratch = scratch
        self.made: dict = {}

    def _target(self, on: str):
        if on == "estimator":
            return self.cls(device=self.device, **self.params)
        if on not in self.made:
            self.made[on] = self._call(on, 0, {}, check=False)[0]
        return self.made[on]

    def _input(self, spec: dict, index: int, mix: dict) -> np.ndarray:
        if spec.get("input", "rows") == "rows":
            return self.x
        size = int(mix["batch_rows"])
        lo = (index % max(1, self.x.shape[0] // size)) * size
        return self.x[lo:lo + size]

    def _call(self, name: str, index: int, mix: dict, check: bool):
        spec = self.ops[name]
        args = dict(spec.get("args", {}))
        kept = None
        if check and "check" in spec:
            state_dir = tempfile.mkdtemp(prefix=f"{name}-", dir=self.scratch)
            kept = state_dir + ".kept"
            _watch(state_dir, kept)
            args.update(spec["check"]["args"], **{spec["check"]["state_dir_arg"]: state_dir})
        target = self._target(spec.get("on", "estimator"))
        try:
            result = getattr(target, spec["call"])(self._input(spec, index, mix), **args)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        finally:
            if kept is not None:
                del _KEEP[os.path.abspath(state_dir)]
        return result, kept

    def operation(self, name: str, mix: dict) -> Callable[..., dict]:
        """``op(index, check=False)``: one call of operation ``name`` under
        ``mix``; returns {output name: host value}, and for a checked call
        ``state_dir``, where every state it published was copied."""
        outputs = self.ops[name].get("outputs")

        def op(index: int, check: bool = False) -> dict:
            result, state_dir = self._call(name, index, mix, check)
            if outputs is None:
                out = {"value": np.asarray(result)}
            else:
                out = {key: getattr(result, key) for key in outputs}
                out = {k: np.array(v) if isinstance(v, np.ndarray) else v for k, v in out.items()}
            if state_dir is not None:
                out["state_dir"] = state_dir
            return out

        return op
