"""What a run sets up before it imports torch or the program, and what it
checks before it prints: the environment a configuration pins, the build
and kernel caches at fixed paths inside the checkout, the process's age,
and the modules that must not be loaded.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

#: top-level modules no run may load: JAX and the JAX package the port
#: was written from (compared whole: the port's own name begins with it)
FORBIDDEN = ("jax", "jaxlib", "flax", "spark_rapids_ml_tpu")
KNOB_PREFIX = "TPU_ML_"


def forbidden_modules(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (default:
    ``sys.modules``)."""
    names = {name.partition(".")[0] for name in (sys.modules if modules is None else modules)}
    return sorted(names.intersection(FORBIDDEN))


def cache_dirs(checkout: Path) -> dict[str, str]:
    """Fixed cache directories inside the checkout (git ignores ``build/``,
    where the port also builds its kernels: ``build/torch_kernels``)."""
    base = Path(checkout) / "build" / "h100bench"
    return {
        "TRITON_CACHE_DIR": str(base / "triton"),
        "TORCH_EXTENSIONS_DIR": str(base / "torch_extensions"),
        "CUDA_CACHE_PATH": str(base / "cuda"),
    }


def prepare_environment(config: dict, checkout: Path) -> None:
    """Drop every ``TPU_ML_*`` knob the caller's environment carries (the
    telemetry sinks, exporters, fault plans, tuner caches among them), set
    the ones the configuration pins, and point the caches into the
    checkout."""
    for name in [n for n in os.environ if n.startswith(KNOB_PREFIX)]:
        del os.environ[name]
    os.environ.update({k: str(v) for k, v in config.get("env", {}).items()})
    os.environ.update(cache_dirs(checkout))


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``; 0 elsewhere)."""
    try:
        start_ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
    except (OSError, ValueError, IndexError):
        return 0.0
    return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


def process_start(clock=time.perf_counter) -> float:
    """This process's start on ``clock``'s scale."""
    return clock() - process_age_s()
