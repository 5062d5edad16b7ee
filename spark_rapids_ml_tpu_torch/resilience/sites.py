"""The fault-injection sites, by name.

Copy of ``spark_rapids_ml_tpu/resilience/sites.py``: ``faults.inject(site)``
gates are addressed by name from ``TPU_ML_FAULT_PLAN`` plans, so the two
packages share every name and one plan drives both. A site named in a plan
that no call site passes never fires.
"""

from __future__ import annotations

WORKER_TASK = "worker.task"       # executor task entry
COLLECTIVE = "collective"         # cross-device collective dispatch
DEVICE_INIT = "device.init"       # device initialization (the health probe)
FOLD_DISPATCH = "fold.dispatch"   # streamed-fit chunk dispatch
FOLD_WAIT = "fold.wait"           # streamed-fit terminal device wait
INGEST_CHUNK = "ingest.chunk"     # streamed-fit chunk staging
AUTOTUNE_TRIAL = "autotune.trial"  # one timing trial of an autotune search
# the scheduler's gates count in the scheduling process, so a plan can fail
# exactly one dispatch or one rank of one epoch
SCHEDULER_TASK = "scheduler.task"
SCHEDULER_RANK = "scheduler.rank"
# the serving and refresh planes: serve.swap fires before the registry
# publishes, so an injected death leaves the old version serving
SERVE_DISPATCH = "serve.dispatch"
SERVE_SWAP = "serve.swap"
REFRESH_FOLD = "refresh.fold"
REFRESH_CHECKPOINT = "refresh.checkpoint"

FAULT_SITES: frozenset[str] = frozenset({
    WORKER_TASK,
    COLLECTIVE,
    DEVICE_INIT,
    FOLD_DISPATCH,
    FOLD_WAIT,
    INGEST_CHUNK,
    AUTOTUNE_TRIAL,
    SCHEDULER_TASK,
    SCHEDULER_RANK,
    SERVE_DISPATCH,
    SERVE_SWAP,
    REFRESH_FOLD,
    REFRESH_CHECKPOINT,
})
