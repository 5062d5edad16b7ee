"""The port's registry of telemetry names: metrics, span phases, instants.

A typo'd name at a call site does not crash: it silently mints a fresh
metric family that no dashboard, FitReport consumer or health check ever
reads. This module is the single declaration point the port's linter
(``analysis/rules.py`` rule TPL005) cross-checks every string literal
passed to ``counter_inc``/``gauge_set``/``histogram_record``,
``trace_range``, ``record_span``/``record_instant`` and
``resilience.faults.inject`` against: adding a new series means adding it
here first.

It has the form of the JAX package's ``telemetry/names.py`` and holds every
name the port books. The names both packages book are the same; the
port's own are the CUDA-graph captures (``compile.graph_captures``,
``compile.graph_capture_seconds``, ``serve.graph_recaptures``, in place of
the XLA compile monitor's ``compile.*`` events) and the split spans of its
IVF build (``ann sample``/``init``/``lloyd``/``assign``, ``ivf assign``/
``pack``). The JAX package's report re-aggregation names (``fits``,
``transforms``, ``fit.wall_seconds``, ...) belong to its
``tools/metrics_dump.py``, which the port has no copy of.

Import-pure: no torch, no package siblings.
"""

from __future__ import annotations

# -- metric families (telemetry.registry counter/gauge/histogram names) ----

METRICS: frozenset[str] = frozenset({
    # ingestion / data movement
    "ingest.rows",
    "ingest.bytes",
    "ingest.chunk_rows",
    "h2d.bytes",
    "columnar.rows",
    "columnar.bytes",
    # collectives / distributed aggregation
    "collective.bytes",
    "collective.count",
    "collective.tree_combines",
    "collective.dispatch",
    "drivermerge.passes",
    "drivermerge.bytes",
    # streamed-fit lifecycle
    "stream.checkpoints",
    "stream.resumes",
    "stream.overlap_fraction",
    "chunk.bisections",
    "rows.nonfinite_skipped",
    # spans
    "span.seconds",
    # CUDA-graph captures (telemetry.compilemon, serving.registry)
    "compile.graph_captures",
    "compile.graph_capture_seconds",
    "serve.graph_recaptures",
    # resilience
    "retry.attempts",
    "fault.injected",
    "degraded.cpu_fallback",
    # elastic stage scheduler (resilience.supervisor + localspark.session)
    "scheduler.tasks",
    "scheduler.hedge",
    "scheduler.reassign",
    "scheduler.barrier_retry",
    "scheduler.admission",
    "worker.respawn",
    "worker.quarantine",
    "worker.slots",
    "worker.quarantined",
    # live health monitor (telemetry.health)
    "health.state",
    "health.transitions",
    "health.probe_seconds",
    "stream.last_beat",
    "stream.active",
    "worker.last_trailer",
    # sliding-window SLO engine (telemetry.slo)
    "slo.breach",
    "slo.value",
    "slo.target",
    "slo.rolling",
    # HTTP exporter (telemetry.httpd)
    "http.requests",
    # warm-path serving runtime (spark_rapids_ml_tpu.serving)
    "serve.requests",
    "serve.rows",
    "serve.errors",
    "serve.latency",
    "serve.queue_delay_seconds",
    "serve.batches",
    "serve.batch_rows",
    "serve.bucket_hits",
    "serve.models",
    "serve.aot_compiles",
    "serve.cold_compiles",
    # serving fast path (transports, continuous batching, HBM fleet)
    "serve.transport",
    "serve.joined_in_flight",
    "serve.window_effective_seconds",
    "serve.page_in",
    "serve.page_out",
    "serve.hbm_bytes",
    "serve.shed",
    # serve tail hunt: µs queue-delay series, JSON-free lane, hedged
    # dispatch, multi-process fleet (serving.fastlane / serving.fleet)
    "serve.queue_delay_us",
    "serve.json_codec",
    "serve.hedges",
    "serve.hedge_wins",
    "serve.fleet_replicas",
    "serve.route_hits",
    "serve.route_misses",
    "serve.drain_events",
    "serve.replica_restarts",
    # distributed tracing (telemetry.tracectx): traces minted at admission
    "serve.traces",
    # closed-loop model refresh / atomic hot-swap (refresh + serving.registry)
    "serve.swaps",
    "serve.swap_refused",
    "serve.rollback",
    "serve.swap_blackout_seconds",
    "serve.model_version",
    "refresh.folds",
    "refresh.rows",
    "refresh.checkpoints",
    "refresh.resumes",
    "refresh.finalizes",
    "refresh.lag_seconds",
    # ANN vector search subsystem (spark_rapids_ml_tpu.ann)
    "ann.queries",
    "ann.build_rows",
    "ann.spill_fraction",
    "ann.cells_reseeded",
    # serve path
    "transform.rows",
    "transform.bytes",
    "transform.batches",
    "transform.partition_seconds",
    # autotune (tuning-cache consults and searches)
    "autotune.cache_hits",
    "autotune.cache_misses",
    "autotune.search_runs",
    "autotune.trials",
    "autotune.trial_failures",
    # cost model
    "costmodel.calls",
    "costmodel.flops",
    "costmodel.bytes",
})

# Metric families minted with a dynamic suffix (one registered prefix per
# family; the dynamic tail is data, not a name).
METRIC_PREFIXES: tuple[str, ...] = (
    "device.",  # telemetry.compilemon device memory gauges: device.<stat>
)

# -- metric family kinds ----------------------------------------------------
# Families not listed below are counters. The Prometheus export
# (telemetry/registry.py) renders each family by the kind it was booked
# with; a test holds every histogram and gauge booked in the port to its
# declaration here.

HISTOGRAMS: frozenset[str] = frozenset({
    "span.seconds",
    "compile.graph_capture_seconds",
    "health.probe_seconds",
    "ingest.chunk_rows",
    "stream.overlap_fraction",
    "transform.partition_seconds",
    "serve.latency",
    "serve.queue_delay_seconds",
    "serve.queue_delay_us",
    "serve.window_effective_seconds",
    "serve.batch_rows",
    "serve.swap_blackout_seconds",
})

GAUGES: frozenset[str] = frozenset({
    "ann.spill_fraction",  # undeclared in the JAX package, which books it as a gauge too
    "stream.active",
    "stream.last_beat",
    "worker.last_trailer",
    "health.state",
    "slo.value",
    "slo.target",
    "slo.rolling",
    "worker.slots",
    "worker.quarantined",
    "serve.models",
    "serve.model_version",
    "serve.hbm_bytes",
    "serve.fleet_replicas",
    "refresh.lag_seconds",
})

# -- span phases (trace_range names -> span.seconds{phase=...}) ------------

SPAN_PHASES: frozenset[str] = frozenset({
    # distributed request tracing (telemetry.tracectx + serving plane)
    "serve.request",
    "serve.queue",
    "serve.dispatch",
    "serve.relay",
    "refresh.fold",
    "refresh.swap",
    "refresh.probation",
    # streamed-fit / dispatch machinery
    "fold.dispatch",
    "fold.wait",
    "ingest.chunk",
    "autotune.search",
    "autotune.trial",
    "transform.plan",
    "transform.dispatch",
    # cross-process timeline span events
    "worker.task",
    "transform.partition",
    # linalg / decomposition
    "compute cov",
    "eigh",
    "svd from r",
    "svd mesh fit",
    "tsvd decompose",
    "tsvd reduce",
    "tsvd transform",
    "tsvd mesh fit",
    "pca transform",
    # scalers / preprocessing
    "scaler moments",
    "scaler range stats",
    "scaler transform",
    "robust scaler histogram",
    "robust transform",
    "maxabs transform",
    "minmax transform",
    "normalize",
    "binarize",
    "bucketize",
    "quantile bucketize",
    "quantile discretizer histogram",
    "quantile sketch histogram",
    "impute",
    "imputer fit",
    "polynomial expansion",
    "elementwise product",
    "vector slicer",
    "dct",
    "variance selector fit",
    "variance selector transform",
    "label scan",
    # linear family
    "linreg solve",
    "linreg stats",
    "logreg newton",
    "logreg transform",
    "logreg mesh fit",
    "logreg mesh-local fit",
    "logreg mesh-local chunked fit",
    "softmax newton",
    "softmax mesh fit",
    "svc mesh-local fit",
    "svc transform",
    "isotonic pav",
    # clustering
    "kmeans init",
    "kmeans lloyd",
    "kmeans transform",
    "kmeans mesh fit",
    "kmeans mesh init",
    "kmeans mesh-local fit",
    "kmeans mesh-local chunked fit",
    "dbscan cluster",
    "dbscan spark cluster",
    # trees / ensembles / misc models
    "forest build",
    "gbt boost",
    "fm train",
    "mlp train",
    "naive bayes stats",
    "naive bayes stats (mesh)",
    "naive bayes variance pass",
    "one-vs-rest fit",
    "one-vs-rest transform",
    # neighbors / umap
    "knn kneighbors",
    "ivf build",
    "ivf assign",
    "ivf pack",
    "ivf kneighbors",
    "ann sample",
    "ann init",
    "ann lloyd",
    "ann assign",
    "ann build",
    "ann pack",
    "ann query",
    "umap init",
    "umap knn graph",
    "umap fuzzy graph",
    "umap layout",
    "umap transform",
})

# -- timeline instant events (flight-recorder record_instant names) --------

INSTANTS: frozenset[str] = frozenset({
    "stream.chunk",
    "stream.checkpoint",
    "stream.resume",
    "chunk.bisection",
    "collective.dispatch",
    "retry",
    "fault.injected",
    "autotune.decision",
    "health.transition",
    "slo.breach",
    "scheduler.hedge",
    "scheduler.reassign",
    "scheduler.barrier_retry",
    "scheduler.admission",
    "worker.quarantine",
    "serve.swap",
    "serve.rollback",
})
