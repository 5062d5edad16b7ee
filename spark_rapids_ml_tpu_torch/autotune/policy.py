"""Precision policies: how a fold's matmuls treat operand and accumulator
dtypes.

Copy of ``PrecisionPolicy``, ``POLICIES``, ``FOLD_POLICIES``,
``validate_policy``, ``resolve_policy`` and ``TuningConfig`` from
``spark_rapids_ml_tpu/autotune/policy.py``, under the same environment
variable (``TPU_ML_PRECISION_POLICY``, default ``f32``). The tuner
(``autotune/search.py``) searches chunk geometry, never the policy; blessed
winners are read through ``autotune/cache.py`` (the serving registry's
``bf16_f32acc`` variant is selected that way).

The invariant every policy keeps: accumulators stay f32. ``bf16_f32acc``
rounds only the matmul operands to bf16 and accumulates their exact
products in f32 (``ops.linalg.policy_matmul``; the streamed fold's unit-weight
Gram runs the one-product kernel instances of ``ops.gram_moments``).
"""

from __future__ import annotations

import enum
import os
from dataclasses import dataclass

PRECISION_POLICY_VAR = "TPU_ML_PRECISION_POLICY"


class PrecisionPolicy(str, enum.Enum):
    """Named mixed-precision kernel policies.

    - ``F32``: full-precision operands (the ``precision`` tier still
      applies); the default everywhere.
    - ``BF16_F32ACC``: matmul operands rounded to bf16, their products
      accumulated in f32, the result f32.
    - ``INT8_DIST``: int8 quantization of the distance cross term of k-means
      and k-NN scoring only (``ops.linalg.int8_quantized_matmul``), never
      of a Gram.
    """

    F32 = "f32"
    BF16_F32ACC = "bf16_f32acc"
    INT8_DIST = "int8_dist"


POLICIES: tuple[str, ...] = tuple(p.value for p in PrecisionPolicy)

#: Policies meaningful for accumulation kernels (Gram and moment folds);
#: ``int8_dist`` applies only to distance scoring and is rejected there.
FOLD_POLICIES: tuple[str, ...] = (
    PrecisionPolicy.F32.value,
    PrecisionPolicy.BF16_F32ACC.value,
)


def validate_policy(policy: str, *, allowed: tuple[str, ...] = POLICIES) -> str:
    """Canonicalize ``policy`` (str or ``PrecisionPolicy``) or raise."""
    value = policy.value if isinstance(policy, PrecisionPolicy) else policy
    if value not in allowed:
        raise ValueError(f"precision policy {value!r} must be one of {allowed}")
    return value


def resolve_policy(policy: str | None, *, allowed: tuple[str, ...] = POLICIES) -> str:
    """An explicit policy, or for ``None`` the process default from
    ``TPU_ML_PRECISION_POLICY`` (default ``f32``), read at each call so that
    a fold step built after a change of the environment follows it."""
    if policy is None:
        policy = os.environ.get(PRECISION_POLICY_VAR, PrecisionPolicy.F32.value)
    return validate_policy(policy, allowed=allowed)


#: Memory layouts a tuned fold may pin (the JAX package's search space).
LAYOUTS: tuple[str, ...] = ("row", "col")


@dataclass(frozen=True)
class TuningConfig:
    """One point in the tuner's search space for one kernel signature, as
    the tuning cache stores it. ``chunk_rows=None`` keeps the static knob;
    ``donate_carry`` is recorded for the JAX package's ledger and means
    nothing to the port."""

    chunk_rows: int | None = None
    layout: str = "row"
    policy: str = PrecisionPolicy.F32.value
    donate_carry: bool = True

    def __post_init__(self) -> None:
        if self.layout not in LAYOUTS:
            raise ValueError(f"layout {self.layout!r} must be one of {LAYOUTS}")
        validate_policy(self.policy)
        if self.chunk_rows is not None and self.chunk_rows < 1:
            raise ValueError(f"chunk_rows must be >= 1, got {self.chunk_rows}")

    def to_dict(self) -> dict:
        return {
            "chunk_rows": self.chunk_rows,
            "layout": self.layout,
            "policy": self.policy,
            "donate_carry": self.donate_carry,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "TuningConfig":
        return cls(
            chunk_rows=d.get("chunk_rows"),
            layout=d.get("layout", "row"),
            policy=d.get("policy", PrecisionPolicy.F32.value),
            donate_carry=bool(d.get("donate_carry", True)),
        )
