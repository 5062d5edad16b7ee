"""Runtime knobs the port's PCA paths read.

A copy of the knobs of ``spark_rapids_ml_tpu/utils/config.py`` and
``spark_rapids_ml_tpu/spark/ingest.py`` that these paths need, under the same
environment variable names and defaults, so one environment configures both
packages. ``get_config()`` reads the environment on every call.

The serving runtime's knobs (``TPU_ML_SERVE_*``, ``TPU_ML_TRACE_*``,
``TPU_ML_TIMELINE_EVENTS``, ``TPU_ML_TUNING_CACHE_PATH``), the fleet's,
hot swap's and the refresh daemon's (``TPU_ML_SERVE_FLEET_*``,
``TPU_ML_SERVE_DRAIN_TIMEOUT_S``, ``TPU_ML_SERVE_HEDGE_FLOOR_US``,
``TPU_ML_SWAP_*``, ``TPU_ML_REFRESH_*``) and the telemetry
and health knobs (``TPU_ML_TELEMETRY_PATH``, ``TPU_ML_TIMELINE_PATH``,
``TPU_ML_HTTP_PORT``, ``TPU_ML_SLO*``, ``TPU_ML_HEALTH_*``,
``TPU_ML_ADMISSION_POLICY``) and the ANN knobs (``TPU_ML_ANN_CAP_PERCENTILE``,
``TPU_ML_ANN_SAMPLE_ROWS``) are copies of
``spark_rapids_ml_tpu/utils/knobs.py``'s, names and defaults alike. Their
modules read them at each use through ``lenient_int``/``lenient_float``,
which take an unset, empty or malformed value as the default, as the JAX
package's serving modules do.

The resilience knobs (``TPU_ML_TASK_RETRIES``, ``TPU_ML_RETRY_*``,
``TPU_ML_STREAM_CHECKPOINT_EVERY_CHUNKS``, ``TPU_ML_FOLD_WAIT_TIMEOUT_S``,
``TPU_ML_STREAM_CHUNK_FLOOR``, ``TPU_ML_PROGRESS``, ``TPU_ML_FAULT_PLAN``,
``TPU_ML_HEDGE_*``, ``TPU_ML_WORKER_*``, ``TPU_ML_HEALTH_RETRY_STORM``)
are copies of the JAX package's too, names and defaults alike. So are the
tuner's (``TPU_ML_AUTOTUNE``, ``TPU_ML_AUTOTUNE_TRIALS``) and the local
Spark engine's (``TPU_ML_BARRIER_TIMEOUT_S``, ``TPU_ML_BARRIER_RETRIES``);
``TPU_ML_PEAK_TFLOPS`` keeps its name, but its default is the card's peak.

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

from spark_rapids_ml_tpu_torch.autotune.policy import resolve_policy
from spark_rapids_ml_tpu_torch.ops.linalg import PRECISIONS

MIN_BUCKET_VAR = "TPU_ML_MIN_BUCKET"
MAX_WORKERS_VAR = "TPU_ML_MAX_WORKERS"
DEFAULT_PRECISION_VAR = "TPU_ML_DEFAULT_PRECISION"
STREAM_CUTOVER_VAR = "TPU_ML_STREAM_FIT_MAX_RESIDENT_BYTES"
WIRE_DTYPE_VAR = "TPU_ML_MESH_LOCAL_WIRE_DTYPE"
STREAM_CHUNK_VAR = "TPU_ML_STREAM_CHUNK_ROWS"
NONFINITE_POLICY_VAR = "TPU_ML_NONFINITE_POLICY"

# serving (spark_rapids_ml_tpu/utils/knobs.py:186-242), with their defaults
SERVE_MIN_BUCKET_VAR, DEFAULT_SERVE_MIN_BUCKET = "TPU_ML_SERVE_MIN_BUCKET", 8
SERVE_MAX_BATCH_ROWS_VAR, DEFAULT_SERVE_MAX_BATCH_ROWS = "TPU_ML_SERVE_MAX_BATCH_ROWS", 4096
SERVE_MAX_DELAY_US_VAR, DEFAULT_SERVE_MAX_DELAY_US = "TPU_ML_SERVE_MAX_DELAY_US", 2000.0
SERVE_ADAPTIVE_WINDOW_VAR, DEFAULT_SERVE_ADAPTIVE_WINDOW = "TPU_ML_SERVE_ADAPTIVE_WINDOW", "1"
SERVE_UDS_PATH_VAR = "TPU_ML_SERVE_UDS_PATH"  # empty: no UDS listener
SERVE_HBM_BUDGET_BYTES_VAR = "TPU_ML_SERVE_HBM_BUDGET_BYTES"  # empty: from the card
TRACE_SAMPLE_VAR, DEFAULT_TRACE_SAMPLE = "TPU_ML_TRACE_SAMPLE", 1.0
TRACE_EXEMPLARS_VAR, DEFAULT_TRACE_EXEMPLARS = "TPU_ML_TRACE_EXEMPLARS", 4
TIMELINE_EVENTS_VAR, DEFAULT_TIMELINE_EVENTS = "TPU_ML_TIMELINE_EVENTS", 4096
TUNING_CACHE_PATH_VAR = "TPU_ML_TUNING_CACHE_PATH"  # empty: in-process only
# the serve fleet, hot swap and the refresh daemon
# (spark_rapids_ml_tpu/utils/knobs.py:219-266), with their defaults
SERVE_HEDGE_FLOOR_US_VAR, DEFAULT_SERVE_HEDGE_FLOOR_US = "TPU_ML_SERVE_HEDGE_FLOOR_US", 2000.0
SERVE_FLEET_REPLICAS_VAR, DEFAULT_SERVE_FLEET_REPLICAS = "TPU_ML_SERVE_FLEET_REPLICAS", 0
SERVE_FLEET_SOCKET_DIR_VAR = "TPU_ML_SERVE_FLEET_SOCKET_DIR"  # empty: a fresh temporary dir
SERVE_DRAIN_TIMEOUT_S_VAR, DEFAULT_SERVE_DRAIN_TIMEOUT_S = "TPU_ML_SERVE_DRAIN_TIMEOUT_S", 30.0
REFRESH_INTERVAL_S_VAR, DEFAULT_REFRESH_INTERVAL_S = "TPU_ML_REFRESH_INTERVAL_S", 30.0
REFRESH_MIN_ROWS_VAR, DEFAULT_REFRESH_MIN_ROWS = "TPU_ML_REFRESH_MIN_ROWS", 1
REFRESH_CHECKPOINT_DIR_VAR = "TPU_ML_REFRESH_CHECKPOINT_DIR"  # empty: memory only
SWAP_SHADOW_ROWS_VAR, DEFAULT_SWAP_SHADOW_ROWS = "TPU_ML_SWAP_SHADOW_ROWS", 256
SWAP_SHADOW_TOLERANCE_VAR, DEFAULT_SWAP_SHADOW_TOLERANCE = "TPU_ML_SWAP_SHADOW_TOLERANCE", 0.25
SWAP_PROBATION_S_VAR, DEFAULT_SWAP_PROBATION_S = "TPU_ML_SWAP_PROBATION_S", 60.0
# telemetry, SLOs, health and admission (spark_rapids_ml_tpu/utils/knobs.py
# :339-340, :356, :405-415), with their defaults
TELEMETRY_PATH_VAR = "TPU_ML_TELEMETRY_PATH"  # empty: no report sink
TIMELINE_PATH_VAR = "TPU_ML_TIMELINE_PATH"  # empty: no timeline sink
HTTP_PORT_VAR = "TPU_ML_HTTP_PORT"  # empty: fits start no exporter
SLO_VAR = "TPU_ML_SLO"  # empty: no objectives
SLO_WINDOW_S_VAR, DEFAULT_SLO_WINDOW_S = "TPU_ML_SLO_WINDOW_S", 300.0
SLO_BURN_VAR, DEFAULT_SLO_BURN = "TPU_ML_SLO_BURN", 2
HEALTH_INTERVAL_S_VAR, DEFAULT_HEALTH_INTERVAL_S = "TPU_ML_HEALTH_INTERVAL_S", 5.0
HEALTH_PROBE_VAR, DEFAULT_HEALTH_PROBE = "TPU_ML_HEALTH_PROBE", "inline"
HEALTH_PROBE_TIMEOUT_S_VAR, DEFAULT_HEALTH_PROBE_TIMEOUT_S = (
    "TPU_ML_HEALTH_PROBE_TIMEOUT_S", 20.0
)
HEALTH_HBM_WATERMARK_VAR, DEFAULT_HBM_WATERMARK = "TPU_ML_HEALTH_HBM_WATERMARK", 0.92
HEALTH_STALE_S_VAR, DEFAULT_HEALTH_STALE_S = "TPU_ML_HEALTH_STALE_S", 60.0
HEALTH_FAILING_AFTER_VAR, DEFAULT_HEALTH_FAILING_AFTER = "TPU_ML_HEALTH_FAILING_AFTER", 3
ADMISSION_POLICY_VAR, DEFAULT_ADMISSION_POLICY = "TPU_ML_ADMISSION_POLICY", "refuse"
# approximate nearest neighbours (spark_rapids_ml_tpu/utils/knobs.py:177-184),
# with their defaults
ANN_CAP_PERCENTILE_VAR, DEFAULT_ANN_CAP_PERCENTILE = "TPU_ML_ANN_CAP_PERCENTILE", 99.0
ANN_SAMPLE_ROWS_VAR, DEFAULT_ANN_SAMPLE_ROWS = "TPU_ML_ANN_SAMPLE_ROWS", 32768

# resilience (spark_rapids_ml_tpu/utils/knobs.py:40, :66, :73-109, :130-146,
# :306), with their defaults
TASK_RETRIES_VAR = "TPU_ML_TASK_RETRIES"
RETRY_MAX_ATTEMPTS_VAR = "TPU_ML_RETRY_MAX_ATTEMPTS"
RETRY_DEADLINE_S_VAR = "TPU_ML_RETRY_DEADLINE_S"
STREAM_CHECKPOINT_EVERY_VAR = "TPU_ML_STREAM_CHECKPOINT_EVERY_CHUNKS"
FOLD_WAIT_TIMEOUT_S_VAR = "TPU_ML_FOLD_WAIT_TIMEOUT_S"
STREAM_CHUNK_FLOOR_VAR, DEFAULT_STREAM_CHUNK_FLOOR = "TPU_ML_STREAM_CHUNK_FLOOR", 8
PROGRESS_VAR = "TPU_ML_PROGRESS"  # seconds between stderr heartbeats; empty: off
FAULT_PLAN_VAR = "TPU_ML_FAULT_PLAN"  # empty: no faults
HEDGE_FACTOR_VAR, DEFAULT_HEDGE_FACTOR = "TPU_ML_HEDGE_FACTOR", 4.0
HEDGE_FLOOR_S_VAR, DEFAULT_HEDGE_FLOOR_S = "TPU_ML_HEDGE_FLOOR_S", 1.0
WORKER_BREAKER_THRESHOLD_VAR, DEFAULT_WORKER_BREAKER_THRESHOLD = (
    "TPU_ML_WORKER_BREAKER_THRESHOLD", 3
)
WORKER_RESPAWN_BACKOFF_S_VAR, DEFAULT_WORKER_RESPAWN_BACKOFF_S = (
    "TPU_ML_WORKER_RESPAWN_BACKOFF_S", 0.05
)
WORKER_SLOT_VAR = "TPU_ML_WORKER_SLOT"  # stamped by the supervisor
WORKER_PLATFORM_VAR = "TPU_ML_WORKER_PLATFORM"
WORKER_PROBE_VAR = "TPU_ML_WORKER_PROBE"
WORKER_PROBE_TIMEOUT_VAR = "TPU_ML_WORKER_PROBE_TIMEOUT"
WORKER_SCRUB_VARS_VAR = "TPU_ML_WORKER_SCRUB_VARS"
HEALTH_RETRY_STORM_VAR, DEFAULT_HEALTH_RETRY_STORM = "TPU_ML_HEALTH_RETRY_STORM", 8

# the cost model, the tuner and the local Spark engine
# (spark_rapids_ml_tpu/utils/knobs.py:69, :99, :133, :163-169), with their
# defaults, but for the peak: the port's is the card's (telemetry/costmodel.py)
AUTOTUNE_VAR, DEFAULT_AUTOTUNE = "TPU_ML_AUTOTUNE", "cache"
AUTOTUNE_TRIALS_VAR, DEFAULT_AUTOTUNE_TRIALS = "TPU_ML_AUTOTUNE_TRIALS", 9
PEAK_TFLOPS_VAR = "TPU_ML_PEAK_TFLOPS"
BARRIER_TIMEOUT_S_VAR, DEFAULT_BARRIER_TIMEOUT_S = "TPU_ML_BARRIER_TIMEOUT_S", "120"
BARRIER_RETRIES_VAR, DEFAULT_BARRIER_RETRIES = "TPU_ML_BARRIER_RETRIES", 1

DEFAULT_STREAM_CHUNK = 65_536
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
    v = os.environ.get(DEFAULT_PRECISION_VAR, "highest")
    if v not in PRECISIONS:
        raise ValueError(
            f"{DEFAULT_PRECISION_VAR}={v!r} must be one of {PRECISIONS}"
        )
    return v


def _nonfinite_env() -> str:
    v = os.environ.get(NONFINITE_POLICY_VAR, "raise")
    if v not in VALID_NONFINITE_POLICIES:
        raise ValueError(
            f"{NONFINITE_POLICY_VAR}={v!r} must be one of {VALID_NONFINITE_POLICIES}"
        )
    return v


@dataclass(frozen=True)
class RuntimeConfig:
    min_bucket: int = field(default_factory=lambda: _int_env(MIN_BUCKET_VAR, 128))
    max_workers: int = field(default_factory=lambda: _int_env(MAX_WORKERS_VAR, 4))
    default_precision: str = field(default_factory=_precision_env)
    stream_fit_max_resident_bytes: int = field(
        default_factory=lambda: _int_env(STREAM_CUTOVER_VAR, 1 << 31)
    )
    stream_chunk_rows: int = field(
        default_factory=lambda: _int_env(STREAM_CHUNK_VAR, DEFAULT_STREAM_CHUNK)
    )
    nonfinite_policy: str = field(default_factory=_nonfinite_env)
    task_retries: int = field(default_factory=lambda: _int_env(TASK_RETRIES_VAR, 3))
    retry_max_attempts: int = field(default_factory=lambda: _int_env(RETRY_MAX_ATTEMPTS_VAR, 4))
    retry_deadline_s: int = field(default_factory=lambda: _int_env(RETRY_DEADLINE_S_VAR, 300))
    stream_checkpoint_every_chunks: int = field(
        default_factory=lambda: _int_env(STREAM_CHECKPOINT_EVERY_VAR, 64)
    )
    fold_wait_timeout_s: int = field(
        default_factory=lambda: _int_env(FOLD_WAIT_TIMEOUT_S_VAR, 600)
    )
    precision_policy: str = field(default_factory=lambda: resolve_policy(None))


def get_config() -> RuntimeConfig:
    return RuntimeConfig()


def wire_dtype() -> np.dtype:
    """Wire dtype that sizes the resident-fit cutover; the port itself stages
    in f32 whatever it says."""
    name = os.environ.get(WIRE_DTYPE_VAR, "float64")
    if name not in ("float32", "float64"):
        raise ValueError(f"{WIRE_DTYPE_VAR}={name!r}: expected float32 or float64")
    return np.dtype(name)
