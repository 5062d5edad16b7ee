"""The port imports nothing of JAX and nothing of the JAX package.

A fresh interpreter blocks ``jax``, ``jaxlib`` and ``spark_rapids_ml_tpu``
(exactly, or as a dotted prefix, so ``spark_rapids_ml_tpu_torch`` stays
importable) with a ``sys.meta_path`` finder, then imports every module of
the port and ``chip_smoke``. A scan of the port's source text backs it up for
imports that only run inside functions.
"""

import pathlib
import re
import subprocess
import sys

import jax  # noqa: F401  (imported at the top of every port test file)
import torch  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT = REPO / "spark_rapids_ml_tpu_torch"

BLOCKER = r'''
import importlib, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "spark_rapids_ml_tpu")

class Blocker:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError(f"blocked import of {name}")
        return None

for name in list(sys.modules):
    if any(name == b or name.startswith(b + ".") for b in BLOCKED):
        del sys.modules[name]
sys.meta_path.insert(0, Blocker())

import spark_rapids_ml_tpu_torch as port
names = [port.__name__] + [
    m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")
]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = [m for m in sys.modules if any(m == b or m.startswith(b + ".") for b in BLOCKED)]
assert not leaked, leaked
print("imported", len(names), "modules")
'''


def _port_modules():
    return sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in PORT.rglob("*.py")
    )


def test_port_imports_with_jax_blocked():
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKER],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    # every module file, __init__ files counted as their package
    assert f"imported {len(_port_modules())} modules" in proc.stdout


IMPORT_RE = re.compile(
    r"^\s*(?:import|from)\s+(jax|jaxlib|spark_rapids_ml_tpu)(?:\.|\s|$)", re.MULTILINE
)


def test_port_source_has_no_blocked_imports():
    files = [*PORT.rglob("*.py"), REPO / "chip_smoke.py"]
    offenders = {
        str(f.relative_to(REPO)): IMPORT_RE.findall(f.read_text()) for f in files
    }
    assert {k: v for k, v in offenders.items() if v} == {}


def test_blocked_import_pattern():
    assert IMPORT_RE.search("import jax.numpy as jnp")
    assert IMPORT_RE.search("    from spark_rapids_ml_tpu.ops import linalg")
    assert IMPORT_RE.search("import spark_rapids_ml_tpu\n")
    assert not IMPORT_RE.search("from spark_rapids_ml_tpu_torch.ops import linalg")
    assert not IMPORT_RE.search("import jaxtyping")


def test_serving_and_telemetry_modules_are_covered():
    """The serving runtime and the telemetry core are among the modules the
    blocked-import run imports."""
    modules = set(_port_modules())
    for name in ("buckets", "registry", "batcher", "hbm", "fastlane", "server", "client",
                 "__init__"):
        assert f"spark_rapids_ml_tpu_torch.serving.{name}" in modules
    for name in ("__init__", "registry", "timeline", "tracectx", "compilemon", "httpd"):
        assert f"spark_rapids_ml_tpu_torch.telemetry.{name}" in modules
    assert "spark_rapids_ml_tpu_torch.autotune.cache" in modules


def test_fit_telemetry_and_scaler_modules_are_covered():
    """The fit-telemetry and health modules and BASELINE config 4's are
    among the modules the blocked-import run imports."""
    modules = set(_port_modules())
    for name in ("spans", "report", "export", "slo", "health"):
        assert f"spark_rapids_ml_tpu_torch.telemetry.{name}" in modules
    for name in ("scaler", "pipeline", "discretizer", "selector"):
        assert f"spark_rapids_ml_tpu_torch.models.{name}" in modules
