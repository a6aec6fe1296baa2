"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` into a shared library
with a plain C interface, loaded with :mod:`ctypes`. Nothing is built
when a module is imported: :func:`library` builds a source at its first
use, and :func:`build_all` builds every source at once, one ``nvcc``
process each, all started together. Libraries go to ``_kernels_build/``
inside the package (listed in ``.gitignore``), named by a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, so a changed
source or header is rebuilt.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["NVCC_FLAGS", "build_all", "library", "sources"]

_PACKAGE = Path(__file__).resolve().parents[1]
_SRC_DIR = _PACKAGE / "csrc"
_BUILD_DIR = _PACKAGE / "_kernels_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LOADED: dict[str, ctypes.CDLL] = {}
# ptxas resource lines (registers, stack frame, spills) of each build.
BUILD_LOG: dict[str, str] = {}


def sources() -> dict[str, Path]:
    """Kernel name -> source path, for every ``csrc/*.cu``."""
    return {p.stem: p for p in sorted(_SRC_DIR.glob("*.cu"))}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found: the CUDA toolkit is needed to build the kernels"
    )


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(_SRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return _BUILD_DIR / f"lib{src.stem}_{digest}.so"


def _start(src: Path) -> tuple[subprocess.Popen, Path, Path] | None:
    out = _target(src)
    if out.exists():
        return None
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
    )
    return proc, tmp, out


def _finish(name: str, job: tuple[subprocess.Popen, Path, Path]) -> None:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    BUILD_LOG[name] = "\n".join(
        line.strip() for line in log.splitlines() if "ptxas" in line or "stack frame" in line
    )
    os.replace(tmp, out)


def build_all() -> dict[str, Path]:
    """Compile every kernel source that has no current library, all in
    parallel; return name -> library path."""
    with _LOCK:
        srcs = sources()
        jobs = {name: _start(src) for name, src in srcs.items()}
        for name, job in jobs.items():
            if job is not None:
                _finish(name, job)
        return {name: _target(src) for name, src in srcs.items()}


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is not None:
            return lib
        src = sources().get(name)
        if src is None:
            raise FileNotFoundError(f"no kernel source csrc/{name}.cu")
        job = _start(src)
        if job is not None:
            _finish(name, job)
        lib = ctypes.CDLL(str(_target(src)))
        _LOADED[name] = lib
        return lib
