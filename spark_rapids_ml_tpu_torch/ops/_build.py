"""Build the package's native sources and load them with ctypes.

Two routes, chosen by the source's suffix: ``csrc/<name>.cu`` (the CUDA
kernels) compiles with ``nvcc`` for ``sm_90a``, ``csrc/<name>.cpp`` (host
C++, the native row bridge) with the host compiler (``$CXX``, else ``g++``).
Each compiles, at its first use in a process, into
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
# the host route's flags: those of the JAX package's bridge Makefile
HOST_CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-pthread", "-shared")

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


def _cxx() -> str:
    compiler = os.environ.get("CXX", "g++")
    found = shutil.which(compiler)
    if found:
        return found
    raise RuntimeError(f"host compiler {compiler!r} not found on PATH; the native bridge cannot be built")


def source_path(name: str) -> Path:
    """``csrc/<name>.cu`` or ``csrc/<name>.cpp``, whichever exists."""
    for suffix in (".cu", ".cpp"):
        path = CSRC_DIR / f"{name}{suffix}"
        if path.is_file():
            return path
    raise FileNotFoundError(f"no csrc/{name}.cu or csrc/{name}.cpp under {CSRC_DIR}")


def _flags(source: Path) -> tuple[str, ...]:
    return NVCC_FLAGS if source.suffix == ".cu" else HOST_CXX_FLAGS


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.{cu,cpp}`` builds to, keyed by its source and flags."""
    source = source_path(name)
    digest = hashlib.sha256(source.read_bytes() + " ".join(_flags(source)).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: list[str]) -> dict[str, str]:
    """Compile every named source that has no library yet, all at once (one
    compiler process each), and return each one's compiler log: for a
    ``.cu``, ``-Xptxas -v``'s registers, shared memory and spills per
    kernel. Raises with the compiler's stderr if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        source = source_path(name)
        compiler = _nvcc() if source.suffix == ".cu" else _cxx()
        cmd = [compiler, *_flags(source), "-o", str(tmp), str(source)]
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
            failures.append(f"{proc.args[0]} failed for {source_path(name).name}:\n{stderr}{stdout}")
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
    """The loaded library of ``csrc/<name>.{cu,cpp}``, built first if need be."""
    with _lock:
        lib = _libraries.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _libraries[name] = lib
        return lib
