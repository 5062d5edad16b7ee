"""Fault injection and recovery of the port.

Port of ``spark_rapids_ml_tpu/resilience``:

- ``sites``: the fault sites' names, shared with the JAX package;
- ``faults``: the ``TPU_ML_FAULT_PLAN`` plan (``site:kind:nth[:arg]``) and
  the ``inject`` gate each site calls;
- ``retry``: the error classifier over torch's errors and the one backoff
  loop, ``call_with_retry``;
- ``supervisor``: worker-slot leases, bounded respawn and a per-slot circuit
  breaker (its consumer, the local Spark session, is not ported yet).

The recoveries live where they protect: ``spark/ingest.py::stream_fold``
retries transient faults, bisects a chunk on a device OOM, checkpoints and
resumes, and bounds its terminal wait; ``parallel/executor.py`` retries
tasks and hedges stragglers.
"""

from spark_rapids_ml_tpu_torch.resilience.faults import (  # noqa: F401
    FAULT_PLAN_VAR,
    FaultInjected,
    FaultSpec,
    InjectedPreemption,
    InjectedResourceExhausted,
    InjectedTransientIOError,
    inject,
    parse_plan,
    reset_faults,
)
from spark_rapids_ml_tpu_torch.resilience.retry import (  # noqa: F401
    ErrorClass,
    FoldHangTimeout,
    RetryPolicy,
    call_with_retry,
    classify,
)
from spark_rapids_ml_tpu_torch.resilience.supervisor import (  # noqa: F401
    SlotLease,
    WorkerSupervisor,
    active_summary,
    hedge_config,
)
