"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles, at its first use in a process, into
``build/torch_kernels/<name>-<hash>.so`` under the checkout, where ``<hash>``
covers the source and the flags: a changed source builds anew, an unchanged
one loads the library already there. The library is written under a
temporary name and renamed, so a process never loads a half-written file.
The sources export plain C functions (no PyTorch headers), which keeps a
build to seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_libraries: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME "
        f"({cuda_home}); the CUDA kernels cannot be built"
    )


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by its source and flags."""
    source = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: list[str]) -> dict[str, str]:
    """Compile every named source that has no library yet, all at once (one
    ``nvcc`` each), and return each one's compiler log: ``-Xptxas -v``'s
    registers, shared memory and spills per kernel. Raises with nvcc's
    stderr if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        running[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
            ),
            tmp,
            out,
        )
    failures = []
    for name, (proc, tmp, out) in running.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu:\n{stderr}{stdout}")
            continue
        out.with_suffix(".log").write_text(stdout + stderr)
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return {name: build_log(name) for name in names}


def build_log(name: str) -> str:
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if need be."""
    with _lock:
        lib = _libraries.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libraries[name] = lib
        return lib
