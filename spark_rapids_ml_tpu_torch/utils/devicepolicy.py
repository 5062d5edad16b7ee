"""Who owns the card on a host: worker environments and bounded device
probes.

Port of ``spark_rapids_ml_tpu/utils/devicepolicy.py``, function by
function, for CUDA:

- ``worker_env("cpu")`` is what a worker subprocess gets under the default
  policy of one device owner per host (the main process owns the card, workers
  compute on the CPU): ``CUDA_VISIBLE_DEVICES=""``, so the child's torch
  sees no card, the counterpart of the JAX package's scrub of the PJRT
  bootstrap variables, and the scrub of ``TPU_ML_WORKER_SCRUB_VARS``;
  ``worker_env(None)`` hands the child everything, the card included;
- ``probe_platform`` runs a first touch of the device on a daemon thread
  under a timeout (``torch.cuda.init``, one tiny kernel and a synchronize
  for CUDA) and raises ``DevicePolicyError`` if it does not end in time,
  fails, or finds another platform than the expected one;
- ``use_platform`` chooses a ``torch.device`` and probes it;
- ``probe_transport_subprocess`` runs that probe in a throwaway child
  interpreter (``python -c``): a wedged first touch costs the child, not
  this process, so it can be repeated; ``wait_for_transport`` repeats it
  under the shared retry policy's backoff until it passes or a window
  ends.

The health monitor's ``subprocess`` probe mode is
``probe_transport_subprocess``. A platform is ``"cuda"`` or ``"cpu"``.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
from typing import Callable, Mapping

import torch

from spark_rapids_ml_tpu_torch.utils.config import (
    DEFAULT_WORKER_PROBE_TIMEOUT,
    WORKER_PLATFORM_VAR,
    WORKER_PROBE_TIMEOUT_VAR,
    WORKER_PROBE_VAR,
    WORKER_SCRUB_VARS_VAR,
)

# What keeps a child off the card: no variable registers a CUDA plugin at
# interpreter start (as a PJRT bootstrap does), so the policy hides the
# card, and scrubs only what TPU_ML_WORKER_SCRUB_VARS names.
CUDA_VISIBLE_DEVICES_VAR = "CUDA_VISIBLE_DEVICES"

PLATFORM_VAR = WORKER_PLATFORM_VAR
PROBE_VAR = WORKER_PROBE_VAR
PROBE_TIMEOUT_VAR = WORKER_PROBE_TIMEOUT_VAR
DEFAULT_PROBE_TIMEOUT = DEFAULT_WORKER_PROBE_TIMEOUT

# the exit code of a failed probe, told apart from a task's crash
PROBE_EXIT_CODE = 17

PLATFORMS = ("cuda", "cpu")


def scrub_vars() -> tuple[str, ...]:
    """The variables removed from a worker's environment under a policy:
    those ``TPU_ML_WORKER_SCRUB_VARS`` names (comma-separated)."""
    return tuple(
        v.strip() for v in os.environ.get(WORKER_SCRUB_VARS_VAR, "").split(",") if v.strip()
    )


def worker_env(platform: str | None = "cpu") -> dict[str, str | None]:
    """Environment overrides of a worker subprocess under ``platform``: a
    value of None removes the variable (``apply_overrides``);
    ``platform=None`` overrides nothing. Under ``"cpu"`` the child sees no
    card. The startup probe is armed only where the parent's environment
    holds a variable the policy scrubs, the risk it guards against."""
    if platform is None:
        return {}
    env: dict[str, str | None] = {v: None for v in scrub_vars()}
    if platform == "cpu":
        env[CUDA_VISIBLE_DEVICES_VAR] = ""
    env[PLATFORM_VAR] = platform
    if any(v in os.environ for v in scrub_vars()):
        env[PROBE_VAR] = "1"
    return env


def apply_overrides(
    base: Mapping[str, str], overrides: Mapping[str, str | None]
) -> dict[str, str]:
    """A copy of ``base`` with ``overrides`` merged in; None deletes."""
    env = dict(base)
    for key, value in overrides.items():
        if value is None:
            env.pop(key, None)
        else:
            env[key] = value
    return env


class DevicePolicyError(RuntimeError):
    """The process could not honour its assigned device platform."""


def _first_touch() -> str:
    """The platform this process computes on, touched once: on CUDA the
    context is made, one kernel runs and the card is synchronized."""
    if not torch.cuda.is_available():
        return "cpu"
    torch.cuda.init()
    probe = torch.ones(1, device="cuda")
    probe.add_(1)
    torch.cuda.synchronize()
    return "cuda"


def use_platform(platform: str, *, probe_timeout: float | None = None) -> torch.device:
    """The ``torch.device`` of ``platform`` (``"cuda"`` is card 0), after a
    bounded first touch that finds that platform: a card that is absent or
    does not answer raises ``DevicePolicyError`` within ``probe_timeout``
    seconds instead of hanging."""
    if platform not in PLATFORMS:
        raise ValueError(f"platform must be one of {PLATFORMS}, got {platform!r}")
    if platform == "cpu":
        return torch.device("cpu")
    probe_platform(expected=platform, timeout=probe_timeout)
    return torch.device("cuda", 0)


# probe_platform's default ``expected``: read TPU_ML_WORKER_PLATFORM. An
# explicit None accepts any platform, which no variable can undo.
FROM_ENV = object()


def probe_platform(expected: object = FROM_ENV, timeout: float | None = None) -> str:
    """The platform of this process after a first touch on a daemon thread,
    waited for at most ``timeout`` seconds (default
    ``TPU_ML_WORKER_PROBE_TIMEOUT``, 60). Raises ``DevicePolicyError`` when
    the touch does not end in time, raises, or finds another platform than
    ``expected`` (default ``TPU_ML_WORKER_PLATFORM``; None accepts any)."""
    if expected is FROM_ENV:
        expected = os.environ.get(PLATFORM_VAR) or None
    if timeout is None:
        raw = os.environ.get(PROBE_TIMEOUT_VAR, str(DEFAULT_PROBE_TIMEOUT))
        try:
            timeout = float(raw)
        except ValueError as e:
            raise DevicePolicyError(f"{PROBE_TIMEOUT_VAR}={raw!r} is not a number of seconds") from e
    result: dict[str, str] = {}

    def _probe() -> None:
        try:
            result["platform"] = _first_touch()
        except BaseException as e:  # noqa: BLE001 - reported to the caller
            result["error"] = f"{type(e).__name__}: {e}"

    t = threading.Thread(target=_probe, name="tpu-ml-device-probe", daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        raise DevicePolicyError(
            f"device probe did not complete within {timeout}s: the card's first "
            "touch (context, one kernel, a synchronize) is blocked, most likely a "
            "wedged card or another process holding it. Check the card's "
            "health (nvidia-smi), or probe in a child with "
            "devicepolicy.probe_transport_subprocess(). To wait longer, pass a "
            f"larger timeout (workers: the {PROBE_TIMEOUT_VAR} env var)."
        )
    if "error" in result:
        raise DevicePolicyError(f"the device failed to initialize in this process: {result['error']}")
    platform = result.get("platform", "<unknown>")
    if expected is not None and platform != expected:
        raise DevicePolicyError(
            f"this process was assigned platform {expected!r} but found {platform!r}: "
            f"{CUDA_VISIBLE_DEVICES_VAR} hides the card, or no card is present. Under "
            "the one-device-owner-per-host policy a worker runs on the CPU "
            "(worker_env('cpu')); hand a worker the card with worker_env(None)."
        )
    return platform


# The child of a subprocess probe ends itself (os._exit, so no stuck thread
# keeps it alive): the parent never has to kill a child mid-way through its
# first touch of the card.
_SUBPROBE_PROGRAM = """\
import os, sys
from spark_rapids_ml_tpu_torch.utils import devicepolicy as _dp
try:
    p = _dp.probe_platform(expected=None, timeout=float(sys.argv[1]))
    sys.stdout.write(p)
    sys.stdout.flush()
    os._exit(0)
except BaseException as e:
    sys.stderr.write(f"{type(e).__name__}: {e}")
    sys.stderr.flush()
    os._exit(_dp.PROBE_EXIT_CODE)
"""


def probe_transport_subprocess(
    timeout: float = 120.0,
    env_overrides: Mapping[str, str | None] | None = None,
) -> tuple[bool, str]:
    """``probe_platform`` in a throwaway child interpreter: ``(ok, detail)``,
    ``detail`` the platform on success or the child's diagnosis. Never
    raises for a failed probe. ``env_overrides`` shape the child's
    environment (``apply_overrides``); by default it sees what this process
    sees, the card included."""
    env = apply_overrides(os.environ, env_overrides or {})
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
    try:
        proc = subprocess.run(
            [sys.executable, "-c", _SUBPROBE_PROGRAM, str(timeout)],
            env=env,
            capture_output=True,
            text=True,
            # the child ends itself at ``timeout``; this outer bound (import
            # and join slack) fires only if its main thread is stuck
            timeout=timeout + 60.0,
        )
    except subprocess.TimeoutExpired:
        return False, (
            f"probe child did not exit within {timeout + 60.0}s (its own bound is "
            f"{timeout}s): child main thread stuck"
        )
    if proc.returncode == 0 and proc.stdout:
        return True, proc.stdout.strip()
    return False, (proc.stderr or f"probe child exited rc={proc.returncode}").strip()


def wait_for_transport(
    *,
    window: float = 3600.0,
    attempt_timeout: float = 120.0,
    backoff_start: float = 30.0,
    backoff_max: float = 300.0,
    log: Callable[[str], None] | None = None,
    probe: Callable[..., tuple[bool, str]] | None = None,
) -> str:
    """``probe_transport_subprocess`` repeated with exponential backoff
    (the shared ``RetryPolicy``, no jitter) until it passes or ``window``
    seconds end: the platform, or ``DevicePolicyError`` with every
    attempt's line. Each pause counts ``retry.attempts{site=transport}``."""
    from spark_rapids_ml_tpu_torch.resilience.retry import RetryPolicy
    from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY

    emit = log or (lambda m: print(m, file=sys.stderr, flush=True))
    do_probe = probe or probe_transport_subprocess
    policy = RetryPolicy(
        max_attempts=1 << 30,  # bounded by the window, not a count
        backoff_s=backoff_start,
        multiplier=2.0,
        max_backoff_s=backoff_max,
        jitter=0.0,
        deadline_s=window,
    )
    deadline = time.monotonic() + window
    attempts: list[str] = []
    attempt = 0
    while True:
        attempt += 1
        start = time.monotonic()
        ok, detail = do_probe(timeout=attempt_timeout)
        took = time.monotonic() - start
        if ok:
            emit(f"[transport] attempt {attempt} ok in {took:.1f}s: platform={detail}")
            return detail
        attempts.append(f"attempt {attempt} ({took:.1f}s): {detail.splitlines()[0][:160]}")
        backoff = policy.sleep_s(attempt)
        remaining = deadline - time.monotonic()
        if remaining <= backoff:
            raise DevicePolicyError(
                f"device transport did not become healthy within {window:.0f}s "
                f"({attempt} attempts):\n  " + "\n  ".join(attempts)
            )
        emit(
            f"[transport] attempt {attempt} failed ({took:.1f}s); retrying in "
            f"{backoff:.0f}s ({remaining:.0f}s left in window): "
            f"{detail.splitlines()[0][:160]}"
        )
        REGISTRY.counter_inc("retry.attempts", site="transport")
        time.sleep(backoff)  # tpulint: disable=TPL004 -- the windowed transport wait, RetryPolicy delays counted as retry.attempts
