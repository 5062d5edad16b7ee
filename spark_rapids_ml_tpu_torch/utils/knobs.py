"""The port's inventory of ``TPU_ML_*`` environment knobs.

Every environment variable the port (the package and ``chip_smoke.py``)
reads is declared here once: name, type, default, one-line doc, and the
module that consumes it, in the form of the JAX package's
``utils/knobs.py``. A knob both packages read keeps that package's name,
type and default, so one environment configures both; the one deliberate
difference is listed in ``DEFAULTS_DIFFER`` with its reason, and every knob
the JAX package declares that the port does not read is listed in
``NOT_READ`` with its reason.

Consumers take the variable's name and default from here
(``utils/config.py`` re-exports them as ``*_VAR`` and ``DEFAULT_*``); the
port's lint rule TPL006 (``analysis/rules.py``) rejects any ``TPU_ML_*``
literal outside this module, and ``python -m
spark_rapids_ml_tpu_torch.analysis --list-knobs`` renders the inventory
(the README's port knob table is generated from it and ``--check-readme``
holds the two together).

Import-pure on purpose: no torch, no package siblings.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Knob:
    """One declared environment knob."""

    name: str          # the TPU_ML_* environment variable
    type: str          # "int" | "float" | "str" | "path" | "flag" | "enum"
    default: str       # rendered default ("" = unset/disabled)
    doc: str           # one-line meaning, README-table ready
    module: str        # the consuming module of the port

    @property
    def value(self) -> int | float | str | None:
        """The default as its type: an ``int`` or ``float`` for those types
        (None when unset), the string otherwise."""
        if self.type in ("int", "float"):
            if not self.default:
                return None
            return int(self.default) if self.type == "int" else float(self.default)
        return self.default


_DECLARATIONS = (
    # -- core runtime (utils.config.RuntimeConfig) ------------------------------
    Knob("TPU_ML_MIN_BUCKET", "int", "128",
         "row-bucket floor for padding partitions (bounds distinct shapes)",
         "utils.config"),
    Knob("TPU_ML_MAX_WORKERS", "int", "4",
         "partition executor thread pool size", "utils.config"),
    Knob("TPU_ML_TASK_RETRIES", "int", "3",
         "per-task retry budget (the `spark.task.maxFailures` analog)",
         "utils.config"),
    Knob("TPU_ML_DEFAULT_PRECISION", "enum", "highest",
         "`highest`/`high`/`default` matmul precision for Gram/projection "
         "kernels (`high` and `default` run the hand-written Gram kernels)",
         "utils.config"),
    Knob("TPU_ML_STREAM_FIT_MAX_RESIDENT_BYTES", "int", str(1 << 31),
         "device-footprint cutover above which fits stream chunk-wise "
         "instead of materializing", "utils.config"),
    # -- telemetry --------------------------------------------------------------
    Knob("TPU_ML_TELEMETRY_PATH", "path", "",
         "JSONL sink for per-fit/transform telemetry reports (empty "
         "disables)", "telemetry.export"),
    Knob("TPU_ML_TIMELINE_PATH", "path", "",
         "JSONL sink for flight-recorder timelines (empty disables)",
         "telemetry.export"),
    Knob("TPU_ML_TIMELINE_EVENTS", "int", "4096",
         "flight-recorder ring-buffer capacity (0 disables)",
         "telemetry.timeline"),
    Knob("TPU_ML_PROGRESS", "float", "",
         "emit a live streamed-fit heartbeat to stderr every N seconds "
         "(unset = off)", "spark.ingest"),
    Knob("TPU_ML_PEAK_TFLOPS", "float", "989.4",
         "device peak for the cost model's roofline denominator (default "
         "= the H100 SXM5's dense bf16 tensor peak at 700 W)",
         "telemetry.costmodel"),
    # -- resilience -------------------------------------------------------------
    Knob("TPU_ML_RETRY_MAX_ATTEMPTS", "int", "4",
         "shared retry-policy attempt budget per call site", "utils.config"),
    Knob("TPU_ML_RETRY_DEADLINE_S", "int", "300",
         "wall-clock ceiling across one call's retries (0 = unbounded)",
         "utils.config"),
    Knob("TPU_ML_STREAM_CHECKPOINT_EVERY_CHUNKS", "int", "64",
         "checkpoint the streamed-fit carry every K full chunks (with a "
         "checkpoint_dir)", "utils.config"),
    Knob("TPU_ML_FOLD_WAIT_TIMEOUT_S", "int", "600",
         "bound on the streamed fit's terminal device wait (0 = unbounded)",
         "spark.ingest"),
    Knob("TPU_ML_NONFINITE_POLICY", "enum", "raise",
         "`raise`/`skip`/`allow` for non-finite input rows in streamed "
         "fits", "utils.config"),
    Knob("TPU_ML_FAULT_PLAN", "str", "",
         "`site:kind:nth[:arg]` comma list of deterministic synthetic "
         "faults (chaos tests only — never production)",
         "resilience.faults"),
    # -- elastic stage scheduler (resilience.supervisor + localspark) -----------
    Knob("TPU_ML_HEDGE_FACTOR", "float", "4.0",
         "speculatively re-dispatch a partition once its runtime exceeds "
         "this multiple of the completed-partition p50 (0 disables "
         "hedging, serve hedging too)", "resilience.supervisor"),
    Knob("TPU_ML_HEDGE_FLOOR_S", "float", "1.0",
         "minimum straggler runtime before a hedge may fire (keeps tiny "
         "tasks from hedging on scheduler noise)", "resilience.supervisor"),
    Knob("TPU_ML_BARRIER_RETRIES", "int", "1",
         "barrier-stage epoch retries after an infrastructure rank failure "
         "(fresh workers per epoch; plan errors never retry)",
         "localspark.session"),
    Knob("TPU_ML_WORKER_BREAKER_THRESHOLD", "int", "3",
         "consecutive crashes after which a worker slot's circuit breaker "
         "opens and the slot is quarantined", "resilience.supervisor"),
    Knob("TPU_ML_WORKER_RESPAWN_BACKOFF_S", "float", "0.05",
         "base of the exponential backoff between respawns of a crashed "
         "worker slot", "resilience.supervisor"),
    Knob("TPU_ML_WORKER_SLOT", "int", "",
         "slot index the supervisor stamps into each worker's environment "
         "(diagnostics and slot-targeted chaos plans; never set manually)",
         "resilience.supervisor"),
    Knob("TPU_ML_ADMISSION_POLICY", "enum", "refuse",
         "`off`/`refuse`/`degrade`: what a fit does while the live health "
         "monitor reports FAILING — admit anyway, raise AdmissionRefused, "
         "or run on the CPU", "telemetry.health"),
    # -- ingestion / streaming (spark.ingest) -----------------------------------
    Knob("TPU_ML_MESH_LOCAL_WIRE_DTYPE", "enum", "float64",
         "wire dtype that sizes the resident-fit cutover (the port stages "
         "and computes in f32 whatever it says)", "utils.config"),
    Knob("TPU_ML_MESH_LOCAL_MAX_BYTES", "int", "",
         "hard cap on resident ingestion bytes on the device (unset = "
         "uncapped)", "spark.ingest"),
    Knob("TPU_ML_MESH_LOCAL_ARROW_MAX_BYTES", "int", str(1 << 30),
         "Arrow-batch staging cutover for resident ingestion",
         "spark.ingest"),
    Knob("TPU_ML_STREAM_CHUNK_ROWS", "int", "65536",
         "streamed-fit chunk size in rows", "spark.ingest"),
    Knob("TPU_ML_STREAM_CHUNK_FLOOR", "int", "8",
         "smallest chunk the OOM bisection may produce", "spark.ingest"),
    # -- worker device policy (localspark session <-> worker contract) ----------
    Knob("TPU_ML_BARRIER_TIMEOUT_S", "float", "120",
         "barrier-stage rendezvous timeout", "localspark.session"),
    Knob("TPU_ML_WORKER_PLATFORM", "str", "",
         "torch platform (`cuda`/`cpu`) a worker must find (env contract "
         "with the session)", "utils.devicepolicy"),
    Knob("TPU_ML_WORKER_PROBE", "flag", "",
         "`1`: workers run a bounded-time device probe at startup",
         "utils.devicepolicy"),
    Knob("TPU_ML_WORKER_PROBE_TIMEOUT", "float", "60.0",
         "seconds the device probe may take before failing (workers and "
         "`jvm_bridge`)", "utils.devicepolicy"),
    Knob("TPU_ML_WORKER_SCRUB_VARS", "str", "",
         "extra comma-separated env vars scrubbed from cpu-policy worker "
         "environments", "utils.devicepolicy"),
    # -- autotune (autotune/) ---------------------------------------------------
    Knob("TPU_ML_AUTOTUNE", "enum", "cache",
         "`off`/`cache`/`search` tuner mode: ignore the tuning cache, "
         "consult it read-only, or search unseen shape buckets on first "
         "fit", "autotune.search"),
    Knob("TPU_ML_AUTOTUNE_TRIALS", "int", "9",
         "total timing-trial budget of one successive-halving search",
         "autotune.search"),
    Knob("TPU_ML_TUNING_CACHE_PATH", "path", "",
         "persistent JSON tuning cache of blessed search winners (empty = "
         "in-process only)", "autotune.cache"),
    Knob("TPU_ML_PRECISION_POLICY", "enum", "f32",
         "`f32`/`bf16_f32acc`/`int8_dist` mixed-precision kernel policy "
         "default (accumulators stay f32)", "autotune.policy"),
    # -- ANN vector search (ann/ + ops.ivf) -------------------------------------
    Knob("TPU_ML_ANN_CAP_PERCENTILE", "float", "99.0",
         "IVF bucket-cap percentile over cluster sizes; members beyond the "
         "cap land on the exact spill list (100 = pad every bucket to the "
         "largest cluster)", "ops.ivf"),
    Knob("TPU_ML_ANN_SAMPLE_ROWS", "int", "32768",
         "row budget of the sampled kmeans|| coarse-quantizer training set "
         "for streamed IVF index builds (0 = train on the full stream)",
         "ann.index"),
    # -- warm-path serving runtime (serving/) -----------------------------------
    Knob("TPU_ML_SERVE_MIN_BUCKET", "int", "8",
         "serve-path row-bucket floor (smaller than the fit-path "
         "TPU_ML_MIN_BUCKET so single-row scoring pads less)",
         "serving.buckets"),
    Knob("TPU_ML_SERVE_MAX_BATCH_ROWS", "int", "4096",
         "largest serve row bucket; caps one micro-batched dispatch and "
         "bounds the ladder of captured CUDA graphs", "serving.buckets"),
    Knob("TPU_ML_SERVE_MAX_DELAY_US", "float", "2000",
         "micro-batcher coalescing window CEILING: a queued request waits "
         "at most this long for same-(model,bucket) company before dispatch "
         "(the adaptive window shrinks below it under load)",
         "serving.batcher"),
    Knob("TPU_ML_SERVE_ADAPTIVE_WINDOW", "flag", "1",
         "`1`: the coalescing window tracks the observed device dispatch "
         "time; `0`: fixed TPU_ML_SERVE_MAX_DELAY_US window",
         "serving.batcher"),
    Knob("TPU_ML_SERVE_UDS_PATH", "path", "",
         "Unix-domain-socket path for the framing-free serve listener "
         "(empty = UDS transport off)", "serving.server"),
    Knob("TPU_ML_SERVE_HBM_BUDGET_BYTES", "int", "",
         "byte budget of resident model parameters on the card (unset = "
         "the card's memory x TPU_ML_HEALTH_HBM_WATERMARK; cold models "
         "page to host beyond it)", "serving.hbm"),
    Knob("TPU_ML_SERVE_HEDGE_FLOOR_US", "float", "2000",
         "serve-scale floor (microseconds) of the hedged-dispatch "
         "threshold: a micro-batch is re-issued when the primary dispatch "
         "exceeds max(this, TPU_ML_HEDGE_FACTOR x device-time EWMA)",
         "serving.batcher"),
    Knob("TPU_ML_SERVE_FLEET_REPLICAS", "int", "0",
         "replica count of the multi-process serve fleet (0 = fleet off; "
         "each replica is a UDS server process capturing its own graphs)",
         "serving.fleet"),
    Knob("TPU_ML_SERVE_FLEET_SOCKET_DIR", "path", "",
         "directory for fleet replica + router UDS sockets (empty = a "
         "fresh tempdir per fleet; must be short enough for AF_UNIX's "
         "~100-byte path limit)", "serving.fleet"),
    Knob("TPU_ML_SERVE_DRAIN_TIMEOUT_S", "float", "30",
         "rolling drain bound: max seconds the fleet router waits for a "
         "draining replica's in-flight requests to reach zero before the "
         "replica is restarted anyway", "serving.fleet"),
    # -- distributed tracing (telemetry.tracectx) -------------------------------
    Knob("TPU_ML_TRACE_SAMPLE", "float", "1.0",
         "fraction of admitted serve requests that mint a trace context "
         "(0 disables request tracing)", "telemetry.tracectx"),
    Knob("TPU_ML_TRACE_EXEMPLARS", "int", "4",
         "slowest-request exemplars (value + trace_id) retained per "
         "latency-histogram series (0 disables exemplar capture)",
         "telemetry.registry"),
    # -- closed-loop model refresh (refresh/) -----------------------------------
    Knob("TPU_ML_REFRESH_INTERVAL_S", "float", "30",
         "seconds between refresh-daemon cycles (fold pending deltas, "
         "checkpoint, attempt a hot-swap)", "refresh.daemon"),
    Knob("TPU_ML_REFRESH_MIN_ROWS", "int", "1",
         "delta rows that must fold before the daemon finalizes a "
         "candidate and attempts a swap", "refresh.daemon"),
    Knob("TPU_ML_REFRESH_CHECKPOINT_DIR", "path", "",
         "directory for the refresh daemon's durable carry checkpoints "
         "(atomic npz; empty = memory-only, no restart survival)",
         "refresh.daemon"),
    Knob("TPU_ML_SWAP_SHADOW_ROWS", "int", "256",
         "held-back sample rows the shadow-scoring gate scores a swap "
         "candidate against the live model on (0 disables the gate)",
         "refresh.daemon"),
    Knob("TPU_ML_SWAP_SHADOW_TOLERANCE", "float", "0.25",
         "max relative divergence between candidate and live outputs on "
         "the shadow sample before the swap is refused", "serving.registry"),
    Knob("TPU_ML_SWAP_PROBATION_S", "float", "60",
         "post-swap probation window: an SLO burn inside it rolls back to "
         "the prior version (which stays resident until probation clears)",
         "refresh.daemon"),
    # -- live health monitor (telemetry.health) ---------------------------------
    Knob("TPU_ML_HEALTH_INTERVAL_S", "float", "5.0",
         "seconds between HealthMonitor poll cycles", "telemetry.health"),
    Knob("TPU_ML_HEALTH_PROBE", "enum", "inline",
         "`off`/`inline`/`subprocess` device liveness probe mode of the "
         "health monitor", "telemetry.health"),
    Knob("TPU_ML_HEALTH_PROBE_TIMEOUT_S", "float", "20.0",
         "deadline of one health-monitor liveness probe", "telemetry.health"),
    Knob("TPU_ML_HEALTH_HBM_WATERMARK", "float", "0.92",
         "allocated/total card-memory fraction above which the device "
         "component degrades", "telemetry.health"),
    Knob("TPU_ML_HEALTH_STALE_S", "float", "60.0",
         "stream-heartbeat / worker-trailer staleness threshold",
         "telemetry.health"),
    Knob("TPU_ML_HEALTH_FAILING_AFTER", "int", "3",
         "consecutive degraded polls before a component turns FAILING",
         "telemetry.health"),
    Knob("TPU_ML_HEALTH_RETRY_STORM", "int", "8",
         "retry.attempts delta per poll window that flags a retry storm",
         "telemetry.health"),
    # -- sliding-window SLOs (telemetry.slo) ------------------------------------
    Knob("TPU_ML_SLO", "str", "",
         "comma list of `series:pNN:ceiling_s` latency objectives and "
         "`counter:min_rate:floor_per_s` throughput floors (empty = rolling "
         "percentiles only)", "telemetry.slo"),
    Knob("TPU_ML_SLO_WINDOW_S", "float", "300",
         "sliding evaluation window of the SLO engine", "telemetry.slo"),
    Knob("TPU_ML_SLO_BURN", "int", "2",
         "consecutive breached evaluations before slo.breach fires (burn "
         "rate)", "telemetry.slo"),
    # -- HTTP exporter (telemetry.httpd) ----------------------------------------
    Knob("TPU_ML_HTTP_PORT", "int", "",
         "serve /metrics,/healthz,/slo,/report on this port (0 = ephemeral; "
         "unset = exporter off)", "telemetry.httpd"),
)

KNOBS: dict[str, Knob] = {k.name: k for k in _DECLARATIONS}

if len(KNOBS) != len(_DECLARATIONS):  # pragma: no cover - declaration bug
    raise RuntimeError("duplicate TPU_ML_* knob declaration")

# Knobs both packages read whose port default differs on purpose.
DEFAULTS_DIFFER: dict[str, str] = {
    "TPU_ML_PEAK_TFLOPS": "the roofline's denominator is the card's peak, "
    "not a TPU v5e's (telemetry/costmodel.py)",
}

# Knobs the JAX package declares that the port does not read, and why.
NOT_READ: dict[str, str] = {
    "TPU_ML_COMPILE_CACHE": "the persistent XLA compilation cache: the port "
    "compiles no XLA programs, and its CUDA kernels build once per source "
    "into a hash-named library under build/ (ops/_build.py)",
    "TPU_ML_SERVE_COMPILE_CACHE_DIR": "AOT-compiled serve executables on "
    "disk: the port's serve path captures CUDA graphs at register(), and a "
    "CUDA graph cannot outlive its process",
    "TPU_ML_LOG_LEVEL": "the JAX package sets its logger level at import; "
    "the port leaves logging to the application",
    "TPU_ML_PERF_LEDGER_PATH": "read by the JAX package's bench.py; the port "
    "has no benchmark yet",
    "TPU_ML_PERF_SENTINEL": "read by the JAX package's bench.py; the port has "
    "no benchmark yet",
    "TPU_ML_BENCH_PROBE_WINDOW_S": "read by the JAX package's bench.py; the "
    "port has no benchmark yet",
    "TPU_ML_BENCH_PROBE_TIMEOUT": "read by the JAX package's bench.py; the "
    "port has no benchmark yet",
    "TPU_ML_OPPORTUNISTIC_MAX_AGE_S": "read by the JAX package's bench.py; the "
    "port has no benchmark yet",
    "TPU_ML_SERVE_P99_GATE_MS": "a gate bench.py stamps on the JAX package's "
    "ledger entry; the port has no benchmark yet",
    "TPU_ML_MONITOR_BENCH_OUT": "tools/healthd.py, the TPU transport monitor; "
    "the port's device liveness is the health monitor's probe "
    "(TPU_ML_HEALTH_PROBE)",
    "TPU_ML_MONITOR_DRIFT_OUT": "tools/healthd.py, the TPU transport monitor",
    "TPU_ML_MONITOR_INTERVAL_S": "tools/healthd.py, the TPU transport monitor",
    "TPU_ML_MONITOR_PROBE_TIMEOUT_S": "tools/healthd.py, the TPU transport "
    "monitor",
    "TPU_ML_MONITOR_WINDOW_S": "tools/healthd.py, the TPU transport monitor",
    "TPU_ML_MONITOR_BENCH_RUNS": "tools/healthd.py, the TPU transport monitor",
    "TPU_ML_MONITOR_BENCH_TIMEOUT_S": "tools/healthd.py, the TPU transport "
    "monitor",
}

# Named handles: consumers take the name (``.name``) and default
# (``.default``/``.value``) from these, never from a fresh literal.
MIN_BUCKET = KNOBS["TPU_ML_MIN_BUCKET"]
MAX_WORKERS = KNOBS["TPU_ML_MAX_WORKERS"]
TASK_RETRIES = KNOBS["TPU_ML_TASK_RETRIES"]
DEFAULT_PRECISION = KNOBS["TPU_ML_DEFAULT_PRECISION"]
STREAM_FIT_MAX_RESIDENT_BYTES = KNOBS["TPU_ML_STREAM_FIT_MAX_RESIDENT_BYTES"]
TELEMETRY_PATH = KNOBS["TPU_ML_TELEMETRY_PATH"]
TIMELINE_PATH = KNOBS["TPU_ML_TIMELINE_PATH"]
TIMELINE_EVENTS = KNOBS["TPU_ML_TIMELINE_EVENTS"]
PROGRESS = KNOBS["TPU_ML_PROGRESS"]
PEAK_TFLOPS = KNOBS["TPU_ML_PEAK_TFLOPS"]
RETRY_MAX_ATTEMPTS = KNOBS["TPU_ML_RETRY_MAX_ATTEMPTS"]
RETRY_DEADLINE_S = KNOBS["TPU_ML_RETRY_DEADLINE_S"]
STREAM_CHECKPOINT_EVERY_CHUNKS = KNOBS["TPU_ML_STREAM_CHECKPOINT_EVERY_CHUNKS"]
FOLD_WAIT_TIMEOUT_S = KNOBS["TPU_ML_FOLD_WAIT_TIMEOUT_S"]
NONFINITE_POLICY = KNOBS["TPU_ML_NONFINITE_POLICY"]
FAULT_PLAN = KNOBS["TPU_ML_FAULT_PLAN"]
HEDGE_FACTOR = KNOBS["TPU_ML_HEDGE_FACTOR"]
HEDGE_FLOOR_S = KNOBS["TPU_ML_HEDGE_FLOOR_S"]
BARRIER_RETRIES = KNOBS["TPU_ML_BARRIER_RETRIES"]
WORKER_BREAKER_THRESHOLD = KNOBS["TPU_ML_WORKER_BREAKER_THRESHOLD"]
WORKER_RESPAWN_BACKOFF_S = KNOBS["TPU_ML_WORKER_RESPAWN_BACKOFF_S"]
WORKER_SLOT = KNOBS["TPU_ML_WORKER_SLOT"]
ADMISSION_POLICY = KNOBS["TPU_ML_ADMISSION_POLICY"]
MESH_LOCAL_WIRE_DTYPE = KNOBS["TPU_ML_MESH_LOCAL_WIRE_DTYPE"]
MESH_LOCAL_MAX_BYTES = KNOBS["TPU_ML_MESH_LOCAL_MAX_BYTES"]
MESH_LOCAL_ARROW_MAX_BYTES = KNOBS["TPU_ML_MESH_LOCAL_ARROW_MAX_BYTES"]
STREAM_CHUNK_ROWS = KNOBS["TPU_ML_STREAM_CHUNK_ROWS"]
STREAM_CHUNK_FLOOR = KNOBS["TPU_ML_STREAM_CHUNK_FLOOR"]
BARRIER_TIMEOUT_S = KNOBS["TPU_ML_BARRIER_TIMEOUT_S"]
WORKER_PLATFORM = KNOBS["TPU_ML_WORKER_PLATFORM"]
WORKER_PROBE = KNOBS["TPU_ML_WORKER_PROBE"]
WORKER_PROBE_TIMEOUT = KNOBS["TPU_ML_WORKER_PROBE_TIMEOUT"]
WORKER_SCRUB_VARS = KNOBS["TPU_ML_WORKER_SCRUB_VARS"]
AUTOTUNE = KNOBS["TPU_ML_AUTOTUNE"]
AUTOTUNE_TRIALS = KNOBS["TPU_ML_AUTOTUNE_TRIALS"]
TUNING_CACHE_PATH = KNOBS["TPU_ML_TUNING_CACHE_PATH"]
PRECISION_POLICY = KNOBS["TPU_ML_PRECISION_POLICY"]
ANN_CAP_PERCENTILE = KNOBS["TPU_ML_ANN_CAP_PERCENTILE"]
ANN_SAMPLE_ROWS = KNOBS["TPU_ML_ANN_SAMPLE_ROWS"]
SERVE_MIN_BUCKET = KNOBS["TPU_ML_SERVE_MIN_BUCKET"]
SERVE_MAX_BATCH_ROWS = KNOBS["TPU_ML_SERVE_MAX_BATCH_ROWS"]
SERVE_MAX_DELAY_US = KNOBS["TPU_ML_SERVE_MAX_DELAY_US"]
SERVE_ADAPTIVE_WINDOW = KNOBS["TPU_ML_SERVE_ADAPTIVE_WINDOW"]
SERVE_UDS_PATH = KNOBS["TPU_ML_SERVE_UDS_PATH"]
SERVE_HBM_BUDGET_BYTES = KNOBS["TPU_ML_SERVE_HBM_BUDGET_BYTES"]
SERVE_HEDGE_FLOOR_US = KNOBS["TPU_ML_SERVE_HEDGE_FLOOR_US"]
SERVE_FLEET_REPLICAS = KNOBS["TPU_ML_SERVE_FLEET_REPLICAS"]
SERVE_FLEET_SOCKET_DIR = KNOBS["TPU_ML_SERVE_FLEET_SOCKET_DIR"]
SERVE_DRAIN_TIMEOUT_S = KNOBS["TPU_ML_SERVE_DRAIN_TIMEOUT_S"]
TRACE_SAMPLE = KNOBS["TPU_ML_TRACE_SAMPLE"]
TRACE_EXEMPLARS = KNOBS["TPU_ML_TRACE_EXEMPLARS"]
REFRESH_INTERVAL_S = KNOBS["TPU_ML_REFRESH_INTERVAL_S"]
REFRESH_MIN_ROWS = KNOBS["TPU_ML_REFRESH_MIN_ROWS"]
REFRESH_CHECKPOINT_DIR = KNOBS["TPU_ML_REFRESH_CHECKPOINT_DIR"]
SWAP_SHADOW_ROWS = KNOBS["TPU_ML_SWAP_SHADOW_ROWS"]
SWAP_SHADOW_TOLERANCE = KNOBS["TPU_ML_SWAP_SHADOW_TOLERANCE"]
SWAP_PROBATION_S = KNOBS["TPU_ML_SWAP_PROBATION_S"]
HEALTH_INTERVAL_S = KNOBS["TPU_ML_HEALTH_INTERVAL_S"]
HEALTH_PROBE = KNOBS["TPU_ML_HEALTH_PROBE"]
HEALTH_PROBE_TIMEOUT_S = KNOBS["TPU_ML_HEALTH_PROBE_TIMEOUT_S"]
HEALTH_HBM_WATERMARK = KNOBS["TPU_ML_HEALTH_HBM_WATERMARK"]
HEALTH_STALE_S = KNOBS["TPU_ML_HEALTH_STALE_S"]
HEALTH_FAILING_AFTER = KNOBS["TPU_ML_HEALTH_FAILING_AFTER"]
HEALTH_RETRY_STORM = KNOBS["TPU_ML_HEALTH_RETRY_STORM"]
SLO = KNOBS["TPU_ML_SLO"]
SLO_WINDOW_S = KNOBS["TPU_ML_SLO_WINDOW_S"]
SLO_BURN = KNOBS["TPU_ML_SLO_BURN"]
HTTP_PORT = KNOBS["TPU_ML_HTTP_PORT"]


def markdown_table() -> str:
    """The README's port knob table, generated (``python -m
    spark_rapids_ml_tpu_torch.analysis --list-knobs --markdown``; the
    ``--check-readme`` drift gate compares it with the README)."""
    lines = [
        "| knob | type | default | meaning | read by |",
        "|------|------|---------|---------|---------|",
    ]
    for k in _DECLARATIONS:
        default = f"`{k.default}`" if k.default else "unset"
        lines.append(
            f"| `{k.name}` | {k.type} | {default} | {k.doc} | `{k.module}` |"
        )
    return "\n".join(lines)
