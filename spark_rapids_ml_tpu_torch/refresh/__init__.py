"""Closed-loop model refresh: fold deltas off the hot path, swap under guard.

Port of ``spark_rapids_ml_tpu/refresh/``. ``RefreshDaemon`` owns one
registry slot's lifecycle:

    deltas → partial_fit (off the hot path) → durable checkpoint →
    finalize a candidate → shadow gate → atomic swap → probation →
    promoted | rolled back

The carry checkpoints ride ``utils.checkpoint.TrainingCheckpointer``'s
atomic writes, the swap is the registry's versioned publish (in-flight
dispatches finish on the old graphs), probation is a fresh sliding-window
SLO engine, and a fault plan can fail every stage (``refresh.fold``,
``refresh.checkpoint``, ``serve.swap``, ``serve.dispatch``): every failure
ends on exactly one consistent serving version.
"""

from spark_rapids_ml_tpu_torch.refresh.daemon import RefreshDaemon

__all__ = ["RefreshDaemon"]
