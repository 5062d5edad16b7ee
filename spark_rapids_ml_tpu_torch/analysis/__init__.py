"""The port's own static analysis: its invariants, checked on the source.

The JAX package's ``analysis`` package, for the PyTorch code: the engine
(:mod:`.engine`: per-rule IDs, ``# tpulint: disable=RULE <reason>``
suppressions, the JAX package's baseline format, JSON and human forms of
a finding) and the rules
(:mod:`.rules`): no host syncs in the device compute layer and on the warm
serve path, one retry policy, registered telemetry names and fault sites,
a central knob inventory, locked telemetry globals, no silently swallowed
broad exceptions.

Run it as ``python -m spark_rapids_ml_tpu_torch.analysis`` (``--strict``
exits nonzero on any finding); its default paths are the port's package
and ``chip_smoke.py``.
"""

from spark_rapids_ml_tpu_torch.analysis.engine import (  # noqa: F401
    Baseline,
    Finding,
    LintedModule,
    Rule,
    lint_paths,
    lint_source,
)
from spark_rapids_ml_tpu_torch.analysis.rules import ALL_RULES, NO_COUNTERPART  # noqa: F401
