"""Native (C++) host-side data-loading loops with ctypes bindings
(``kikuchipy_tpu/native``).

``loader.cpp`` is the port's own copy of the JAX package's source. It is
compiled with the system ``g++`` at first use into ``_kernels_build/``
inside the package (listed in ``.gitignore``), named by a hash of the
source and the flags, as :mod:`kikuchipy_tpu_torch.ops._build` names the
CUDA libraries. Every entry point has a NumPy fallback, so the package
works without a compiler; :data:`BUILD_LOG` keeps the compiler's output of
a failed build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = [
    "available",
    "u8_to_f32",
    "preprocess_u8",
    "reorder_patterns",
]

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "loader.cpp"
_BUILD_DIR = _HERE.parent / "_kernels_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib = None
_tried = False
# The compiler's output (or the error) of a build that failed; "" otherwise.
BUILD_LOG = ""


def library_path() -> Path:
    """Where the library of the current source and flags is built."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return _BUILD_DIR / f"libloader_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> bool:
    """Build the library into ``out``; False (the reason in ``BUILD_LOG``)
    where the build directory cannot be made or written, or g++ fails."""
    global BUILD_LOG
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        out.parent.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run(
            ["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp)], capture_output=True, text=True, timeout=120
        )
        if proc.returncode != 0:
            BUILD_LOG = proc.stdout + proc.stderr
            tmp.unlink(missing_ok=True)
            return False
        os.replace(tmp, out)
    except (OSError, subprocess.TimeoutExpired) as err:
        BUILD_LOG = f"the library was not built: {err}"
        return False
    return True


def _get_lib():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        lib.kp_u8_to_f32.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
        lib.kp_preprocess_u8.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
            ctypes.c_float, ctypes.c_float,
        ]
        lib.kp_reorder_patterns.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64,
        ]
        for fn in (lib.kp_u8_to_f32, lib.kp_preprocess_u8, lib.kp_reorder_patterns):
            fn.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native library is built and loadable."""
    return _get_lib() is not None


def u8_to_f32(src: np.ndarray) -> np.ndarray:
    """Bulk uint8 -> float32 conversion (threaded native, NumPy
    fallback)."""
    src = np.ascontiguousarray(src, dtype=np.uint8)
    lib = _get_lib()
    if lib is None:
        return src.astype(np.float32)
    out = np.empty(src.shape, dtype=np.float32)
    lib.kp_u8_to_f32(src.ctypes.data, out.ctypes.data, ctypes.c_int64(src.size))
    return out


def preprocess_u8(
    patterns: np.ndarray,
    static_bg: np.ndarray,
    operation: str = "subtract",
    out_range: tuple[float, float] = (-1.0, 1.0),
) -> np.ndarray:
    """uint8 -> float32 static-background removal + per-pattern rescale
    on the host (threaded native; NumPy fallback). Mirrors
    ``ops.pattern.remove_static_background`` for staging streamed
    chunks before device upload."""
    patterns = np.ascontiguousarray(patterns, dtype=np.uint8)
    lead = patterns.shape[:-2]
    sy, sx = patterns.shape[-2:]
    n = int(np.prod(lead)) if lead else 1
    bg = np.ascontiguousarray(static_bg, dtype=np.float32).reshape(-1)
    if bg.size != sy * sx:
        raise ValueError(f"static background size {bg.size} != pattern size {sy * sx}")
    op = {"subtract": 0, "divide": 1}[operation]
    lib = _get_lib()
    if lib is None:
        p = patterns.reshape(n, -1).astype(np.float32)
        p = p - bg if op == 0 else p / bg
        mn = p.min(axis=1, keepdims=True)
        mx = p.max(axis=1, keepdims=True)
        out = (p - mn) / (mx - mn) * (out_range[1] - out_range[0]) + out_range[0]
        return out.reshape(patterns.shape).astype(np.float32)
    out = np.empty(patterns.shape, dtype=np.float32)
    lib.kp_preprocess_u8(
        patterns.ctypes.data,
        bg.ctypes.data,
        out.ctypes.data,
        ctypes.c_int64(n),
        ctypes.c_int64(sy * sx),
        ctypes.c_int(op),
        ctypes.c_float(out_range[0]),
        ctypes.c_float(out_range[1]),
    )
    return out


def reorder_patterns(src: np.ndarray, order: np.ndarray) -> np.ndarray:
    """Gather-reorder patterns (first axis) by ``order`` (threaded
    native memcpy; NumPy fallback). Used for Oxford .ebsp files whose
    patterns are stored out of map order."""
    src = np.ascontiguousarray(src)
    order = np.ascontiguousarray(order, dtype=np.int64)
    if order.size and (order.min() < 0 or order.max() >= src.shape[0]):
        raise IndexError(f"order holds indices outside [0, {src.shape[0]})")
    lib = _get_lib()
    if lib is None:
        return src[order]
    out = np.empty((order.size,) + src.shape[1:], dtype=src.dtype)
    bytes_per = int(np.prod(src.shape[1:])) * src.dtype.itemsize
    lib.kp_reorder_patterns(
        src.ctypes.data,
        order.ctypes.data,
        out.ctypes.data,
        ctypes.c_int64(order.size),
        ctypes.c_int64(bytes_per),
    )
    return out
