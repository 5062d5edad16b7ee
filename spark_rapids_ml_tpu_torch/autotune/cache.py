"""The persistent tuning cache of blessed search winners.

Port of ``spark_rapids_ml_tpu/autotune/cache.py`` (``cache_key``,
``lookup``, ``store`` and the JSON file under ``TPU_ML_TUNING_CACHE_PATH``).
Winners are remembered per (kernel signature, shape bucket, dtype, device
kind) in two tiers:

- **in-process**: a lock-guarded dict; every stored winner lands there;
- **persistent JSON** at ``TPU_ML_TUNING_CACHE_PATH`` (empty: in-process
  only), loaded lazily at the first lookup after the path changes and
  rewritten by ``store``. The file's schema and keys are the JAX package's,
  so one blessed file serves both packages on the same device kind.

The device kind is ``"gpu/" + torch.cuda.get_device_name()`` on a card and
``"cpu/cpu"`` on the CPU (spaces as ``_``), the strings the JAX package
builds from its own backend. The serving registry reads the entry keyed
``serve.pca`` to pick its ``bf16_f32acc`` variant, the only way the JAX
package selects it too. Every lookup books ``autotune.cache_hits`` or
``autotune.cache_misses``.

Every resolution of the tuner (``autotune/search.py::resolve``: a hit, a
searched winner, or the static knobs) goes into a bounded decision journal
(``record_decision``) with an ``autotune.decision`` timeline instant;
``telemetry/report.py`` takes ``decision_seq()`` when a fit begins and
drains ``decisions_since`` into ``FitReport.tuning`` when it ends, so the
report shows which configuration the fit ran with.
"""

from __future__ import annotations

import json
import logging
import os
import threading

import torch

from spark_rapids_ml_tpu_torch.autotune.policy import TuningConfig
from spark_rapids_ml_tpu_torch.telemetry.registry import REGISTRY
from spark_rapids_ml_tpu_torch.telemetry.timeline import TIMELINE
from spark_rapids_ml_tpu_torch.utils.config import TUNING_CACHE_PATH_VAR

logger = logging.getLogger("spark_rapids_ml_tpu_torch")

CACHE_SCHEMA = 1

_LOCK = threading.Lock()
_CACHE: dict[str, dict] = {}  # key -> {"config": {...}, ...provenance}
_LOADED_PATH: str | None = None  # which file the persistent tier came from
# the decision journal's bound; the counters keep the totals
MAX_JOURNAL_EVENTS = 256
_JOURNAL: list[tuple[int, dict]] = []  # (seq, decision)
_SEQ = 0


def cache_path() -> str:
    """The persistent cache's location ('' = in-process only)."""
    return os.environ.get(TUNING_CACHE_PATH_VAR, "")


def shape_bucket(n: int, rows: int | None) -> str:
    """Exact width × power-of-two row bucket."""
    if rows is None or rows <= 0:
        return f"n{int(n)}/rowsANY"
    bucket = 1
    while bucket < rows:
        bucket <<= 1
    return f"n{int(n)}/rows{bucket}"


def device_kind(device: str | torch.device | None = None) -> str:
    """Device identity of a cache key: ``gpu/<card name>`` for a CUDA device
    (the card when ``device`` is None and one is present), else ``cpu/cpu``."""
    dev = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available() else torch.device("cpu")
    )
    if dev.type == "cuda":
        return f"gpu/{torch.cuda.get_device_name(dev)}".replace(" ", "_")
    return "cpu/cpu"


def cache_key(kernel: str, *, n: int, rows: int | None = None,
              dtype=None, device: str | None = None) -> str:
    """The full key: kernel signature, shape bucket, dtype, device kind."""
    dt = str(dtype) if dtype is not None else "any"
    dev = device if device is not None else device_kind()
    return f"{kernel}|{shape_bucket(n, rows)}|{dt}|{dev}"


def _ensure_loaded() -> None:
    """Merge the persistent tier under ``_LOCK`` (held by the caller) when
    the path changed. In-process entries win over the file's."""
    global _LOADED_PATH
    path = cache_path()
    if path == _LOADED_PATH:
        return
    _LOADED_PATH = path
    if not path or not os.path.exists(path):
        return
    try:
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        entries = doc.get("entries", {}) if isinstance(doc, dict) else {}
        for key, entry in entries.items():
            if key not in _CACHE and isinstance(entry, dict):
                _CACHE[key] = dict(entry)
    except (OSError, ValueError):
        logger.warning("unreadable tuning cache at %s; ignoring it", path, exc_info=True)


def lookup(key: str) -> TuningConfig | None:
    """Consult the cache; books the hit/miss counters."""
    with _LOCK:
        _ensure_loaded()
        entry = _CACHE.get(key)
    if entry is None:
        REGISTRY.counter_inc("autotune.cache_misses")
        return None
    REGISTRY.counter_inc("autotune.cache_hits")
    try:
        return TuningConfig.from_dict(entry.get("config", {}))
    except (TypeError, ValueError):
        logger.warning("malformed tuning-cache entry for %s; ignoring it", key)
        return None


def store(key: str, config: TuningConfig, *, measured_s: float | None = None,
          trials: int | None = None, persist: bool = True) -> None:
    """Remember a winner; rewrites the persistent file when a path is set."""
    entry: dict = {"config": config.to_dict()}
    if measured_s is not None:
        entry["measured_s"] = float(measured_s)
    if trials is not None:
        entry["trials"] = int(trials)
    with _LOCK:
        _ensure_loaded()
        _CACHE[key] = entry
        snapshot = {k: dict(v) for k, v in _CACHE.items()}
    if persist and cache_path():
        write_cache(cache_path(), snapshot)


def entries() -> dict[str, dict]:
    """Copy of the merged cache."""
    with _LOCK:
        _ensure_loaded()
        return {k: dict(v) for k, v in _CACHE.items()}


def write_cache(path: str, cache_entries: dict[str, dict]) -> None:
    """Write the persistent tier (atomic replace, sorted keys)."""
    doc = {
        "type": "tuning_cache",
        "schema": CACHE_SCHEMA,
        "entries": {k: cache_entries[k] for k in sorted(cache_entries)},
    }
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def reset() -> None:
    """Forget the in-process tier, the journal and the file-load state."""
    global _LOADED_PATH, _SEQ
    with _LOCK:
        _CACHE.clear()
        _JOURNAL.clear()
        _LOADED_PATH = None
        _SEQ = 0


def record_decision(*, kernel: str, key: str, source: str,
                    config: TuningConfig | None) -> dict:
    """Journal one resolution: ``source`` is ``cache`` (a hit), ``search``
    (a fresh winner) or ``default`` (a miss: the static knobs)."""
    global _SEQ
    decision = {
        "kernel": kernel,
        "key": key,
        "source": source,
        "cache_hit": source == "cache",
        "config": config.to_dict() if config is not None else None,
    }
    with _LOCK:
        _SEQ += 1
        _JOURNAL.append((_SEQ, decision))
        del _JOURNAL[:-MAX_JOURNAL_EVENTS]
    TIMELINE.record_instant("autotune.decision", kernel=kernel, source=source)
    return decision


def decision_seq() -> int:
    """The journal's watermark (``begin_fit`` takes it)."""
    with _LOCK:
        return _SEQ


def decisions_since(seq: int) -> list[dict]:
    """The decisions journaled after ``seq`` (``end_fit`` drains them)."""
    with _LOCK:
        return [dict(d) for s, d in _JOURNAL if s > seq]
