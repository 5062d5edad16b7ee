"""Runtime knobs the port reads, under the names and defaults of the
inventory (``utils/knobs.py``).

Each knob both packages read keeps the JAX package's name and default, so
one environment configures both (``TPU_ML_PEAK_TFLOPS`` keeps its name, but
its default is the card's peak). ``get_config()`` reads the environment on
every call. The serving, telemetry, health, fleet, refresh and ANN modules
read their knobs at each use through ``lenient_int``/``lenient_float``,
which take an unset, empty or malformed value as the default, as the JAX
package's serving modules do.

``TPU_ML_MESH_LOCAL_WIRE_DTYPE`` only sizes the streamed-fit cutover, as the
JAX package's wire would be sized: the port stages and computes in f32
whatever it says (``wire_dtype``). ``TPU_ML_PRECISION_POLICY`` is the fold's
default precision policy (``autotune/policy.py``, which the fold step
resolves itself).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from spark_rapids_ml_tpu_torch.utils import knobs as K

# Every name and default below is the inventory's (utils/knobs.py); a
# module reads a knob through one of these, never a literal or a knobs
# handle of its own. This module imports no other module of the port at its
# top, so that any module can import it.
MIN_BUCKET_VAR = K.MIN_BUCKET.name
MAX_WORKERS_VAR = K.MAX_WORKERS.name
DEFAULT_PRECISION_VAR = K.DEFAULT_PRECISION.name
STREAM_CUTOVER_VAR = K.STREAM_FIT_MAX_RESIDENT_BYTES.name
WIRE_DTYPE_VAR = K.MESH_LOCAL_WIRE_DTYPE.name
STREAM_CHUNK_VAR = K.STREAM_CHUNK_ROWS.name
NONFINITE_POLICY_VAR = K.NONFINITE_POLICY.name
PRECISION_POLICY_VAR = K.PRECISION_POLICY.name
MESH_LOCAL_ARROW_MAX_BYTES_VAR, DEFAULT_MESH_LOCAL_ARROW_MAX_BYTES = (
    K.MESH_LOCAL_ARROW_MAX_BYTES.name, K.MESH_LOCAL_ARROW_MAX_BYTES.value
)
MESH_LOCAL_MAX_BYTES_VAR = K.MESH_LOCAL_MAX_BYTES.name  # empty: no cap

# serving
SERVE_MIN_BUCKET_VAR, DEFAULT_SERVE_MIN_BUCKET = K.SERVE_MIN_BUCKET.name, K.SERVE_MIN_BUCKET.value
SERVE_MAX_BATCH_ROWS_VAR, DEFAULT_SERVE_MAX_BATCH_ROWS = (
    K.SERVE_MAX_BATCH_ROWS.name, K.SERVE_MAX_BATCH_ROWS.value
)
SERVE_MAX_DELAY_US_VAR, DEFAULT_SERVE_MAX_DELAY_US = (
    K.SERVE_MAX_DELAY_US.name, K.SERVE_MAX_DELAY_US.value
)
SERVE_ADAPTIVE_WINDOW_VAR, DEFAULT_SERVE_ADAPTIVE_WINDOW = (
    K.SERVE_ADAPTIVE_WINDOW.name, K.SERVE_ADAPTIVE_WINDOW.value
)
SERVE_UDS_PATH_VAR = K.SERVE_UDS_PATH.name  # empty: no UDS listener
SERVE_HBM_BUDGET_BYTES_VAR = K.SERVE_HBM_BUDGET_BYTES.name  # empty: from the card
TRACE_SAMPLE_VAR, DEFAULT_TRACE_SAMPLE = K.TRACE_SAMPLE.name, K.TRACE_SAMPLE.value
TRACE_EXEMPLARS_VAR, DEFAULT_TRACE_EXEMPLARS = K.TRACE_EXEMPLARS.name, K.TRACE_EXEMPLARS.value
TIMELINE_EVENTS_VAR, DEFAULT_TIMELINE_EVENTS = K.TIMELINE_EVENTS.name, K.TIMELINE_EVENTS.value
TUNING_CACHE_PATH_VAR = K.TUNING_CACHE_PATH.name  # empty: in-process only
# the serve fleet, hot swap and the refresh daemon
SERVE_HEDGE_FLOOR_US_VAR, DEFAULT_SERVE_HEDGE_FLOOR_US = (
    K.SERVE_HEDGE_FLOOR_US.name, K.SERVE_HEDGE_FLOOR_US.value
)
SERVE_FLEET_REPLICAS_VAR, DEFAULT_SERVE_FLEET_REPLICAS = (
    K.SERVE_FLEET_REPLICAS.name, K.SERVE_FLEET_REPLICAS.value
)
SERVE_FLEET_SOCKET_DIR_VAR = K.SERVE_FLEET_SOCKET_DIR.name  # empty: a fresh temporary dir
SERVE_DRAIN_TIMEOUT_S_VAR, DEFAULT_SERVE_DRAIN_TIMEOUT_S = (
    K.SERVE_DRAIN_TIMEOUT_S.name, K.SERVE_DRAIN_TIMEOUT_S.value
)
REFRESH_INTERVAL_S_VAR, DEFAULT_REFRESH_INTERVAL_S = (
    K.REFRESH_INTERVAL_S.name, K.REFRESH_INTERVAL_S.value
)
REFRESH_MIN_ROWS_VAR, DEFAULT_REFRESH_MIN_ROWS = K.REFRESH_MIN_ROWS.name, K.REFRESH_MIN_ROWS.value
REFRESH_CHECKPOINT_DIR_VAR = K.REFRESH_CHECKPOINT_DIR.name  # empty: memory only
SWAP_SHADOW_ROWS_VAR, DEFAULT_SWAP_SHADOW_ROWS = K.SWAP_SHADOW_ROWS.name, K.SWAP_SHADOW_ROWS.value
SWAP_SHADOW_TOLERANCE_VAR, DEFAULT_SWAP_SHADOW_TOLERANCE = (
    K.SWAP_SHADOW_TOLERANCE.name, K.SWAP_SHADOW_TOLERANCE.value
)
SWAP_PROBATION_S_VAR, DEFAULT_SWAP_PROBATION_S = K.SWAP_PROBATION_S.name, K.SWAP_PROBATION_S.value
# telemetry, SLOs, health and admission
TELEMETRY_PATH_VAR = K.TELEMETRY_PATH.name  # empty: no report sink
TIMELINE_PATH_VAR = K.TIMELINE_PATH.name  # empty: no timeline sink
HTTP_PORT_VAR = K.HTTP_PORT.name  # empty: fits start no exporter
SLO_VAR = K.SLO.name  # empty: no objectives
SLO_WINDOW_S_VAR, DEFAULT_SLO_WINDOW_S = K.SLO_WINDOW_S.name, K.SLO_WINDOW_S.value
SLO_BURN_VAR, DEFAULT_SLO_BURN = K.SLO_BURN.name, K.SLO_BURN.value
HEALTH_INTERVAL_S_VAR, DEFAULT_HEALTH_INTERVAL_S = (
    K.HEALTH_INTERVAL_S.name, K.HEALTH_INTERVAL_S.value
)
HEALTH_PROBE_VAR, DEFAULT_HEALTH_PROBE = K.HEALTH_PROBE.name, K.HEALTH_PROBE.value
HEALTH_PROBE_TIMEOUT_S_VAR, DEFAULT_HEALTH_PROBE_TIMEOUT_S = (
    K.HEALTH_PROBE_TIMEOUT_S.name, K.HEALTH_PROBE_TIMEOUT_S.value
)
HEALTH_HBM_WATERMARK_VAR, DEFAULT_HBM_WATERMARK = (
    K.HEALTH_HBM_WATERMARK.name, K.HEALTH_HBM_WATERMARK.value
)
HEALTH_STALE_S_VAR, DEFAULT_HEALTH_STALE_S = K.HEALTH_STALE_S.name, K.HEALTH_STALE_S.value
HEALTH_FAILING_AFTER_VAR, DEFAULT_HEALTH_FAILING_AFTER = (
    K.HEALTH_FAILING_AFTER.name, K.HEALTH_FAILING_AFTER.value
)
ADMISSION_POLICY_VAR, DEFAULT_ADMISSION_POLICY = (
    K.ADMISSION_POLICY.name, K.ADMISSION_POLICY.value
)
# approximate nearest neighbours
ANN_CAP_PERCENTILE_VAR, DEFAULT_ANN_CAP_PERCENTILE = (
    K.ANN_CAP_PERCENTILE.name, K.ANN_CAP_PERCENTILE.value
)
ANN_SAMPLE_ROWS_VAR, DEFAULT_ANN_SAMPLE_ROWS = K.ANN_SAMPLE_ROWS.name, K.ANN_SAMPLE_ROWS.value

# resilience
TASK_RETRIES_VAR = K.TASK_RETRIES.name
RETRY_MAX_ATTEMPTS_VAR = K.RETRY_MAX_ATTEMPTS.name
RETRY_DEADLINE_S_VAR = K.RETRY_DEADLINE_S.name
STREAM_CHECKPOINT_EVERY_VAR = K.STREAM_CHECKPOINT_EVERY_CHUNKS.name
FOLD_WAIT_TIMEOUT_S_VAR = K.FOLD_WAIT_TIMEOUT_S.name
STREAM_CHUNK_FLOOR_VAR, DEFAULT_STREAM_CHUNK_FLOOR = (
    K.STREAM_CHUNK_FLOOR.name, K.STREAM_CHUNK_FLOOR.value
)
PROGRESS_VAR = K.PROGRESS.name  # seconds between stderr heartbeats; empty: off
FAULT_PLAN_VAR = K.FAULT_PLAN.name  # empty: no faults
HEDGE_FACTOR_VAR, DEFAULT_HEDGE_FACTOR = K.HEDGE_FACTOR.name, K.HEDGE_FACTOR.value
HEDGE_FLOOR_S_VAR, DEFAULT_HEDGE_FLOOR_S = K.HEDGE_FLOOR_S.name, K.HEDGE_FLOOR_S.value
WORKER_BREAKER_THRESHOLD_VAR, DEFAULT_WORKER_BREAKER_THRESHOLD = (
    K.WORKER_BREAKER_THRESHOLD.name, K.WORKER_BREAKER_THRESHOLD.value
)
WORKER_RESPAWN_BACKOFF_S_VAR, DEFAULT_WORKER_RESPAWN_BACKOFF_S = (
    K.WORKER_RESPAWN_BACKOFF_S.name, K.WORKER_RESPAWN_BACKOFF_S.value
)
WORKER_SLOT_VAR = K.WORKER_SLOT.name  # stamped by the supervisor
WORKER_PLATFORM_VAR = K.WORKER_PLATFORM.name
WORKER_PROBE_VAR = K.WORKER_PROBE.name
WORKER_PROBE_TIMEOUT_VAR, DEFAULT_WORKER_PROBE_TIMEOUT = (
    K.WORKER_PROBE_TIMEOUT.name, K.WORKER_PROBE_TIMEOUT.value
)
WORKER_SCRUB_VARS_VAR = K.WORKER_SCRUB_VARS.name
HEALTH_RETRY_STORM_VAR, DEFAULT_HEALTH_RETRY_STORM = (
    K.HEALTH_RETRY_STORM.name, K.HEALTH_RETRY_STORM.value
)

# the cost model, the tuner and the local Spark engine
AUTOTUNE_VAR, DEFAULT_AUTOTUNE = K.AUTOTUNE.name, K.AUTOTUNE.value
AUTOTUNE_TRIALS_VAR, DEFAULT_AUTOTUNE_TRIALS = K.AUTOTUNE_TRIALS.name, K.AUTOTUNE_TRIALS.value
PEAK_TFLOPS_VAR, DEFAULT_PEAK_TFLOPS = K.PEAK_TFLOPS.name, K.PEAK_TFLOPS.value
BARRIER_TIMEOUT_S_VAR, DEFAULT_BARRIER_TIMEOUT_S = (
    K.BARRIER_TIMEOUT_S.name, K.BARRIER_TIMEOUT_S.default
)
BARRIER_RETRIES_VAR, DEFAULT_BARRIER_RETRIES = K.BARRIER_RETRIES.name, K.BARRIER_RETRIES.value

DEFAULT_STREAM_CHUNK = K.STREAM_CHUNK_ROWS.value
VALID_NONFINITE_POLICIES = ("raise", "skip", "allow")


def _int_env(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        raise ValueError(f"{name}={os.environ[name]!r} is not an integer") from None


def lenient_int(name: str, default: int) -> int:
    """``int`` of the variable, or ``default`` when it is unset, empty or
    malformed."""
    raw = os.environ.get(name, "").strip()
    try:
        return int(raw) if raw else default
    except ValueError:
        return default


def lenient_float(name: str, default: float) -> float:
    """``float`` of the variable, or ``default`` when it is unset, empty or
    malformed."""
    raw = os.environ.get(name, "").strip()
    try:
        return float(raw) if raw else default
    except ValueError:
        return default


def _precision_env() -> str:
    from spark_rapids_ml_tpu_torch.ops.linalg import PRECISIONS

    v = os.environ.get(DEFAULT_PRECISION_VAR, K.DEFAULT_PRECISION.default)
    if v not in PRECISIONS:
        raise ValueError(
            f"{DEFAULT_PRECISION_VAR}={v!r} must be one of {PRECISIONS}"
        )
    return v


def _nonfinite_env() -> str:
    v = os.environ.get(NONFINITE_POLICY_VAR, K.NONFINITE_POLICY.default)
    if v not in VALID_NONFINITE_POLICIES:
        raise ValueError(
            f"{NONFINITE_POLICY_VAR}={v!r} must be one of {VALID_NONFINITE_POLICIES}"
        )
    return v


def _policy_env() -> str:
    from spark_rapids_ml_tpu_torch.autotune.policy import resolve_policy

    return resolve_policy(None)


@dataclass(frozen=True)
class RuntimeConfig:
    min_bucket: int = field(default_factory=lambda: _int_env(MIN_BUCKET_VAR, K.MIN_BUCKET.value))
    max_workers: int = field(default_factory=lambda: _int_env(MAX_WORKERS_VAR, K.MAX_WORKERS.value))
    default_precision: str = field(default_factory=_precision_env)
    stream_fit_max_resident_bytes: int = field(
        default_factory=lambda: _int_env(STREAM_CUTOVER_VAR, K.STREAM_FIT_MAX_RESIDENT_BYTES.value)
    )
    stream_chunk_rows: int = field(
        default_factory=lambda: _int_env(STREAM_CHUNK_VAR, DEFAULT_STREAM_CHUNK)
    )
    nonfinite_policy: str = field(default_factory=_nonfinite_env)
    task_retries: int = field(
        default_factory=lambda: _int_env(TASK_RETRIES_VAR, K.TASK_RETRIES.value)
    )
    retry_max_attempts: int = field(
        default_factory=lambda: _int_env(RETRY_MAX_ATTEMPTS_VAR, K.RETRY_MAX_ATTEMPTS.value)
    )
    retry_deadline_s: int = field(
        default_factory=lambda: _int_env(RETRY_DEADLINE_S_VAR, K.RETRY_DEADLINE_S.value)
    )
    stream_checkpoint_every_chunks: int = field(
        default_factory=lambda: _int_env(
            STREAM_CHECKPOINT_EVERY_VAR, K.STREAM_CHECKPOINT_EVERY_CHUNKS.value
        )
    )
    fold_wait_timeout_s: int = field(
        default_factory=lambda: _int_env(FOLD_WAIT_TIMEOUT_S_VAR, K.FOLD_WAIT_TIMEOUT_S.value)
    )
    precision_policy: str = field(default_factory=_policy_env)


def get_config() -> RuntimeConfig:
    return RuntimeConfig()


def wire_dtype() -> np.dtype:
    """Wire dtype that sizes the resident-fit cutover; the port itself stages
    in f32 whatever it says."""
    name = os.environ.get(WIRE_DTYPE_VAR, K.MESH_LOCAL_WIRE_DTYPE.default)
    if name not in ("float32", "float64"):
        raise ValueError(f"{WIRE_DTYPE_VAR}={name!r}: expected float32 or float64")
    return np.dtype(name)
