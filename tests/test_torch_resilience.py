"""The port's resilience layer and device policy against the JAX package's.

Both packages read one ``TPU_ML_FAULT_PLAN``; each counts its own site
occurrences and books its own registry, so every comparison resets both and
reads each registry's delta. What is compared, and how:

- fault plans, the injected faults and their classes: equal;
- ``classify``: the same class for every error both packages know; the
  port's own rows (torch's OOM, the sticky CUDA errors) against the table
  the port's docstring states;
- ``RetryPolicy`` and ``call_with_retry``: the same sleeps, attempts and
  ``retry.attempts`` counts;
- ``WorkerSupervisor``: the same calls on both, the same answers and lease
  summaries (times left out);
- the executor: the same results, ``fault.injected``, ``retry.attempts``
  and ``scheduler.hedge`` counts under the same plan;
- the device policy: the same overrides, probe errors and transport-wait
  log, and the port's CUDA-side choices (``CUDA_VISIBLE_DEVICES``) as
  stated; the health monitor's ``subprocess`` probe and ``device.init``
  site.
"""

import threading
import time
import types

import jax  # noqa: F401  (the JAX package's modules below import it)
import numpy as np
import pytest
import torch

from spark_rapids_ml_tpu.parallel import executor as JE
from spark_rapids_ml_tpu.resilience import faults as JF
from spark_rapids_ml_tpu.resilience import retry as JR
from spark_rapids_ml_tpu.resilience import supervisor as JS
from spark_rapids_ml_tpu.telemetry import health as jhealth
from spark_rapids_ml_tpu.telemetry.registry import REGISTRY as JREG
from spark_rapids_ml_tpu.utils import devicepolicy as JD
from spark_rapids_ml_tpu_torch.parallel import executor as PE
from spark_rapids_ml_tpu_torch.resilience import faults as PF
from spark_rapids_ml_tpu_torch.resilience import retry as PR
from spark_rapids_ml_tpu_torch.resilience import sites as PS
from spark_rapids_ml_tpu_torch.resilience import supervisor as PSUP
from spark_rapids_ml_tpu_torch.telemetry import health
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY as PREG
from spark_rapids_ml_tpu_torch.utils import devicepolicy as PD

pytestmark = pytest.mark.chaos


@pytest.fixture(autouse=True)
def clean_faults(monkeypatch):
    monkeypatch.delenv("TPU_ML_FAULT_PLAN", raising=False)
    JF.reset_faults()
    PF.reset_faults()
    yield
    JF.reset_faults()
    PF.reset_faults()


def _deltas():
    """() -> (port delta, JAX delta) of the two registries since now."""
    p0, j0 = PREG.snapshot(), JREG.snapshot()
    return lambda: (PREG.snapshot().delta(p0), JREG.snapshot().delta(j0))


# -- sites and plans ----------------------------------------------------------


def test_sites_kinds_and_exceptions_match_jax():
    from spark_rapids_ml_tpu.resilience import sites as JSITES

    assert PS.FAULT_SITES == JSITES.FAULT_SITES
    assert PF.KINDS == JF.KINDS and PF.KILL_EXIT_CODE == JF.KILL_EXIT_CODE
    for name in ("InjectedResourceExhausted", "InjectedTransientIOError", "InjectedPreemption"):
        assert getattr(PF, name).error_class == getattr(JF, name).error_class
    assert issubclass(PF.InjectedTransientIOError, OSError)


@pytest.mark.parametrize("raw", [
    "fold.dispatch:oom:3, ingest.chunk:io:1,fold.wait:hang:2:0.5", "", " , ",
])
def test_plans_parse_alike(raw):
    assert [tuple(vars(s).values()) for s in PF.parse_plan(raw)] == [
        tuple(vars(s).values()) for s in JF.parse_plan(raw)]


@pytest.mark.parametrize("raw", ["fold.dispatch:oom", "a:frobnicate:1", "a:io:x", "a:io:0"])
def test_malformed_plans_are_refused_alike(raw):
    with pytest.raises(ValueError) as pe:
        PF.parse_plan(raw)
    with pytest.raises(ValueError) as je:
        JF.parse_plan(raw)
    assert str(pe.value) == str(je.value)


@pytest.mark.parametrize("kind,exc", [
    ("oom", "InjectedResourceExhausted"), ("io", "InjectedTransientIOError"),
    ("preempt", "InjectedPreemption"),
])
def test_the_nth_occurrence_fires_once_in_both(monkeypatch, kind, exc):
    monkeypatch.setenv("TPU_ML_FAULT_PLAN", f"s:{kind}:2")
    delta = _deltas()
    for mod in (PF, JF):
        mod.inject("s")
        with pytest.raises(getattr(mod, exc)) as e:
            mod.inject("s")
        mod.inject("s")
        assert PR.classify(e.value).name == JR.classify(e.value).name
    p, j = delta()
    assert p.counter("fault.injected", site="s", kind=kind) == 1
    assert j.counter("fault.injected", site="s", kind=kind) == 1


def test_nonfinite_corrupts_a_copy_and_hang_sleeps(monkeypatch):
    monkeypatch.setenv("TPU_ML_FAULT_PLAN", "s:nonfinite:1,h:hang:1:0.05")
    x = np.ones((4, 3))
    out_p, out_j = PF.inject("s", x), JF.inject("s", x)
    np.testing.assert_array_equal(out_p, out_j)
    assert np.isnan(out_p[0, 0]) and np.isfinite(x).all()
    t0 = time.monotonic()
    PF.inject("h")
    assert time.monotonic() - t0 >= 0.05
    assert PF.inject("none", x) is x


# -- classify and the retry loop ----------------------------------------------


@pytest.mark.parametrize("exc", [
    OSError("disk"), ConnectionResetError("peer"), TimeoutError("t"), EOFError(),
    MemoryError(), ValueError("shape"), RuntimeError("anything"),
    PF.InjectedPreemption("p"), PR.FoldHangTimeout("hung"),
])
def test_classify_matches_jax_on_shared_errors(exc):
    expected = JR.classify(JR.FoldHangTimeout("hung") if isinstance(exc, PR.FoldHangTimeout)
                           else exc)
    assert PR.classify(exc).name == expected.name


@pytest.mark.parametrize("exc,want", [
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB"),
     "RESOURCE_EXHAUSTED"),
    (RuntimeError("CUDA error: CUBLAS_STATUS_ALLOC_FAILED when calling cublasCreate"),
     "RESOURCE_EXHAUSTED"),
    (RuntimeError("CUDA out of memory. Tried to allocate 20.00 MiB"), "RESOURCE_EXHAUSTED"),
    (RuntimeError("CUDA error: an illegal memory access was encountered"), "POISONED"),
    (RuntimeError("CUDA error: unspecified launch failure"), "POISONED"),
    (RuntimeError("CUDA error: uncorrectable ECC error encountered"), "POISONED"),
    (RuntimeError("CUDA error: device-side assert triggered"), "POISONED"),
    (RuntimeError("CUDA error: invalid argument"), "FATAL"),
])
def test_classify_reads_torchs_errors(exc, want):
    assert PR.classify(exc).name == want


def test_a_real_torch_oom_is_resource_exhausted():
    oom = getattr(torch, "OutOfMemoryError", torch.cuda.OutOfMemoryError)
    assert oom is torch.cuda.OutOfMemoryError
    assert PR.classify(oom("CUDA out of memory")) is PR.ErrorClass.RESOURCE_EXHAUSTED


def test_backoff_schedule_matches_jax():
    for kw in ({}, {"jitter": 0.0}, {"seed": 7, "max_backoff_s": 0.3}):
        p, j = PR.RetryPolicy(**kw), JR.RetryPolicy(**kw)
        assert [p.sleep_s(k) for k in range(1, 9)] == [j.sleep_s(k) for k in range(1, 9)]


def test_from_config_reads_the_knobs(monkeypatch):
    monkeypatch.setenv("TPU_ML_RETRY_MAX_ATTEMPTS", "7")
    monkeypatch.setenv("TPU_ML_RETRY_DEADLINE_S", "0")
    pol = PR.RetryPolicy.from_config()
    assert pol.max_attempts == 7 and pol.deadline_s is None


@pytest.mark.parametrize("failures,cls,retry_on", [
    (2, OSError, "default"), (5, OSError, "default"), (1, ValueError, "default"),
    (2, ValueError, "any"),
])
def test_call_with_retry_matches_jax(failures, cls, retry_on):
    outcomes = []
    delta = _deltas()
    for mod in (PR, JR):
        calls, sleeps = {"n": 0}, []

        def fn():
            calls["n"] += 1
            if calls["n"] <= failures:
                raise cls("boom")
            return "ok"

        on = mod.RETRY_ANY if retry_on == "any" else mod.RETRYABLE_DEFAULT
        try:
            out = mod.call_with_retry(fn, site="t", retry_on=on, sleep=sleeps.append,
                                      policy=mod.RetryPolicy(max_attempts=4, jitter=0.0),
                                      on_failure=lambda *a: None)
        except cls:
            out = "raised"
        outcomes.append((out, calls["n"], sleeps))
    assert outcomes[0] == outcomes[1]
    p, j = delta()
    assert p.counter("retry.attempts", site="t") == j.counter("retry.attempts", site="t")


# -- the worker supervisor ----------------------------------------------------


class _Worker:
    def __init__(self):
        self.dead = False
        self.closed = False
        self.proc = types.SimpleNamespace(poll=lambda: None)

    def close(self):
        self.closed = True


def _lease_view(summary: dict) -> dict:
    drop = {"age_s", "last_trailer_age_s"}
    return {
        **{k: v for k, v in summary.items() if k != "leases"},
        "leases": {s: {k: v for k, v in lease.items() if k not in drop}
                   for s, lease in summary["leases"].items()},
    }


def test_supervisor_matches_jax_call_by_call():
    sups = [mod.WorkerSupervisor(lambda env: _Worker(), 3, breaker_threshold=2, backoff_s=0.0)
            for mod in (PSUP, JS)]
    try:
        script = [
            ("checkout", 0), ("checkout", 1), ("checkout", 2), ("report_success", 0),
            ("report_crash", 1), ("checkout", 1), ("report_crash", 1),  # quarantined
            ("checkout", 1), ("report_crash", 0), ("report_crash", 0),
            ("report_crash", 2), ("report_crash", 2),  # every slot quarantined
            ("begin_stage",), ("checkout", 0), ("report_success", 0), ("checkout", 1),
        ]
        for step in script:
            answers = []
            for sup in sups:
                out = getattr(sup, step[0])(*step[1:])
                answers.append(None if out is None else
                               type(out).__name__ if isinstance(out, _Worker) else out)
            assert answers[0] == answers[1], step
            assert _lease_view(sups[0].summary()) == _lease_view(sups[1].summary()), step
            assert sups[0].available_slots() == sups[1].available_slots()
            assert sups[0].quarantined_slots() == sups[1].quarantined_slots()
        assert _lease_view(PSUP.active_summary()) == _lease_view(sups[0].summary())
        # the rollup carries the live supervisors as ``scheduler``
        rollup = health.HealthMonitor(probe_mode="off", interval_s=60.0).rollup()
        assert _lease_view(rollup["scheduler"]) == _lease_view(sups[0].summary())
    finally:
        for sup in sups:
            sup.close()
    assert PSUP.active_summary() == {}
    assert "scheduler" not in health.HealthMonitor(probe_mode="off").rollup()


def test_hedge_config_matches_jax(monkeypatch):
    for factor, floor in (("", ""), ("2.5", "0.1"), ("0", "3"), ("x", "-1")):
        monkeypatch.setenv("TPU_ML_HEDGE_FACTOR", factor)
        monkeypatch.setenv("TPU_ML_HEDGE_FLOOR_S", floor)
        assert PSUP.hedge_config() == JS.hedge_config()
        for obs in (0.0, 0.01, 2.0):
            assert PSUP.hedge_threshold_s(obs) == JS.hedge_threshold_s(obs)


# -- the executor -------------------------------------------------------------


@pytest.mark.parametrize("plan,workers", [
    ("worker.task:io:2", 1), ("worker.task:io:3", 4), ("worker.task:oom:1,worker.task:io:5", 3),
])
def test_executor_retries_match_jax(monkeypatch, plan, workers):
    monkeypatch.setenv("TPU_ML_FAULT_PLAN", plan)
    monkeypatch.setenv("TPU_ML_HEDGE_FACTOR", "0")
    ran = {"port": [], "jax": []}
    delta = _deltas()
    outs = []
    for name, mod in (("port", PE), ("jax", JE)):
        def fn(v, name=name):
            ran[name].append(v)
            return v * v

        outs.append(mod.run_partition_tasks(fn, list(range(6)), max_workers=workers,
                                            retry_backoff_s=0.0))
    assert outs[0] == outs[1] == [v * v for v in range(6)]
    # the fault fires before the body: every body runs exactly once
    assert sorted(ran["port"]) == sorted(ran["jax"]) == list(range(6))
    p, j = delta()
    for name in ("fault.injected", "retry.attempts", "scheduler.hedge"):
        assert p.counter(name) == j.counter(name), name
    assert p.counter("retry.attempts", site="worker.task") == len(plan.split(","))


def test_executor_exhaustion_raises_task_failed_in_both(monkeypatch):
    for mod in (PE, JE):
        def fn(v):
            raise ValueError("always")

        with pytest.raises(mod.TaskFailedError, match="after 3 attempts"):
            mod.run_partition_tasks(fn, [1, 2], max_retries=2, retry_backoff_s=0.0,
                                    max_workers=1)


def test_straggler_is_hedged_once_in_both(monkeypatch):
    monkeypatch.setenv("TPU_ML_FAULT_PLAN", "worker.task:hang:3:0.6")
    monkeypatch.setenv("TPU_ML_HEDGE_FACTOR", "2.0")
    monkeypatch.setenv("TPU_ML_HEDGE_FLOOR_S", "0.05")
    delta = _deltas()
    runs = {"port": 0, "jax": 0}
    lock = threading.Lock()
    for name, mod in (("port", PE), ("jax", JE)):
        def fn(v, name=name):
            with lock:
                runs[name] += 1
            return v + 1

        out = mod.run_partition_tasks(fn, list(range(4)), max_workers=2, max_retries=0)
        assert out == [1, 2, 3, 4]
    p, j = delta()
    assert p.counter("scheduler.hedge") == j.counter("scheduler.hedge") == 1
    # both attempts of the hedged task ran their body: one launch each
    assert runs["port"] == runs["jax"] == 5


# -- the device policy --------------------------------------------------------


def test_worker_env_and_overrides(monkeypatch):
    monkeypatch.delenv("TPU_ML_WORKER_SCRUB_VARS", raising=False)
    assert PD.worker_env(None) == JD.worker_env(None) == {}
    assert PD.worker_env("cpu") == {"CUDA_VISIBLE_DEVICES": "", "TPU_ML_WORKER_PLATFORM": "cpu"}
    assert PD.worker_env("cuda") == {"TPU_ML_WORKER_PLATFORM": "cuda"}
    # the extra scrub list and the probe flag follow the JAX contract
    monkeypatch.setenv("TPU_ML_WORKER_SCRUB_VARS", "MY_BOOT, OTHER")
    monkeypatch.setenv("MY_BOOT", "1")
    p, j = PD.worker_env("cpu"), JD.worker_env("cpu")
    for key in ("MY_BOOT", "OTHER", PD.PLATFORM_VAR, PD.PROBE_VAR):
        assert p[key] == j[key], key
    base = {"A": "1", "B": "2"}
    over = {"A": None, "C": "3"}
    assert PD.apply_overrides(base, over) == JD.apply_overrides(base, over) == {"B": "2", "C": "3"}
    assert (PD.PROBE_EXIT_CODE, PD.DEFAULT_PROBE_TIMEOUT) == (
        JD.PROBE_EXIT_CODE, JD.DEFAULT_PROBE_TIMEOUT)


def test_probe_platform_finds_this_hosts_platform_and_refuses_another(monkeypatch):
    expected = "cuda" if torch.cuda.is_available() else "cpu"
    assert PD.probe_platform(expected=None, timeout=60.0) == expected
    monkeypatch.setenv("TPU_ML_WORKER_PLATFORM", expected)
    assert PD.probe_platform(timeout=60.0) == expected
    other = "cpu" if expected == "cuda" else "cuda"
    with pytest.raises(PD.DevicePolicyError, match=f"assigned platform '{other}'"):
        PD.probe_platform(expected=other, timeout=60.0)
    with pytest.raises(JD.DevicePolicyError, match="assigned platform 'tpu'"):
        JD.probe_platform(expected="tpu", timeout=60.0)
    assert PD.use_platform("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="platform must be one of"):
        PD.use_platform("tpu")


def test_probe_platform_timeout_and_failure_raise_alike(monkeypatch):
    monkeypatch.setattr(PD, "_first_touch", lambda: time.sleep(1.0))
    with pytest.raises(PD.DevicePolicyError, match="did not complete within 0.05s"):
        PD.probe_platform(expected=None, timeout=0.05)

    def broken():
        raise RuntimeError("CUDA initialization failed: no kernel image")

    monkeypatch.setattr(PD, "_first_touch", broken)
    with pytest.raises(PD.DevicePolicyError, match="failed to initialize.*no kernel image"):
        PD.probe_platform(expected=None, timeout=5.0)
    monkeypatch.setenv("TPU_ML_WORKER_PROBE_TIMEOUT", "soon")
    for mod in (PD, JD):
        with pytest.raises(mod.DevicePolicyError, match="is not a number of seconds"):
            mod.probe_platform(expected=None)


def test_wait_for_transport_matches_jax(monkeypatch):
    outcomes = []
    delta = _deltas()
    for mod in (PD, JD):
        monkeypatch.setattr(mod.time, "sleep", lambda s: None)
        answers = iter([(False, "wedged\nmore"), (False, "still"), (True, "cpu")])
        lines: list[str] = []
        got = mod.wait_for_transport(window=1e6, backoff_start=1.0, log=lines.append,
                                     probe=lambda timeout: next(answers))
        outcomes.append((got, [ln.split(" in ")[0].split(" (")[0] for ln in lines]))
        with pytest.raises(mod.DevicePolicyError, match="did not become healthy"):
            mod.wait_for_transport(window=0.5, backoff_start=1.0, log=lines.append,
                                   probe=lambda timeout: (False, "down"))
    assert outcomes[0] == outcomes[1]
    p, j = delta()
    assert p.counter("retry.attempts", site="transport") == j.counter(
        "retry.attempts", site="transport") == 2


def test_subprocess_probe_and_the_monitors_subprocess_mode():
    ok, detail = PD.probe_transport_subprocess(timeout=120.0, env_overrides=PD.worker_env("cpu"))
    assert (ok, detail) == (True, "cpu")
    mon = health.HealthMonitor(probe_mode="subprocess", probe_timeout_s=120.0, interval_s=60.0,
                               slo_engine=health.slo_mod.SloEngine(()))
    mon.poll_once()
    assert mon.rollup()["components"]["transport"]["state"] == "OK"


def test_device_init_site_fails_the_inline_probe_in_both(monkeypatch):
    monkeypatch.setenv("TPU_ML_FAULT_PLAN", "device.init:io:1")
    delta = _deltas()
    details = []
    for mod in (health, jhealth):
        mon = mod.HealthMonitor(probe_mode="inline", failing_after=3, interval_s=60.0,
                                slo_engine=mod.slo_mod.SloEngine(()))
        mon.poll_once()
        comp = mon.rollup()["components"]
        assert comp["transport"]["state"] == "DEGRADED"
        assert comp["resilience"]["state"] == "DEGRADED"
        details.append(comp["transport"]["detail"].split(": ", 1)[1])
        mon.poll_once()  # the second occurrence passes the site
        assert mon.rollup()["components"]["transport"]["state"] == "OK"
    assert details[0] == details[1] and "InjectedTransientIOError" in details[0]
    p, j = delta()
    assert p.counter("fault.injected", site="device.init", kind="io") == j.counter(
        "fault.injected", site="device.init", kind="io") == 1


def test_resilience_component_reads_a_retry_storm_like_jax():
    for mod, reg in ((health, PREG), (jhealth, JREG)):
        mon = mod.HealthMonitor(probe_mode="off", retry_storm=3, interval_s=60.0,
                                slo_engine=mod.slo_mod.SloEngine(()))
        mon.poll_once()
        reg.counter_inc("retry.attempts", 3, site="storm")
        mon.poll_once()
        r = mon.rollup()["components"]["resilience"]
        assert r["state"] == "DEGRADED" and "retry storm: 3 attempts" in r["detail"]
        mon.poll_once()
        assert mon.rollup()["components"]["resilience"]["state"] == "OK"
