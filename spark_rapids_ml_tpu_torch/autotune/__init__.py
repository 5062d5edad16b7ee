"""Measured tuning of the streamed fit's hot path, as in the JAX package
(``spark_rapids_ml_tpu/autotune/__init__.py``).

- ``policy``: the precision policies and ``TuningConfig``;
- ``cache``: blessed winners per (kernel, shape bucket, dtype, device kind)
  in a JSON file, and the per-fit decision journal;
- ``search``: bounded successive halving over candidates, and ``resolve``,
  the hot paths' one entry point (``TPU_ML_AUTOTUNE``: ``off``, ``cache``
  by default, or ``search``).

The names below are the JAX package's exports. They load on first use:
``utils/config.py`` imports ``policy`` while ``search`` imports
``utils/config.py``, so the package imports none of its modules eagerly.
"""

from __future__ import annotations

import importlib

_EXPORTS = {
    "cache_key": "cache",
    "decision_seq": "cache",
    "decisions_since": "cache",
    "reset": "cache",
    "shape_bucket": "cache",
    "FOLD_POLICIES": "policy",
    "LAYOUTS": "policy",
    "POLICIES": "policy",
    "PrecisionPolicy": "policy",
    "TuningConfig": "policy",
    "resolve_policy": "policy",
    "validate_policy": "policy",
    "MODES": "search",
    "candidate_grid": "search",
    "mode": "search",
    "resolve": "search",
    "stream_fold_measure": "search",
    "successive_halving": "search",
    "trial_budget": "search",
}

__all__ = ["cache", "policy", "search", *_EXPORTS]


def __getattr__(name: str):
    if name in ("cache", "policy", "search"):
        return importlib.import_module(f"{__name__}.{name}")
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
