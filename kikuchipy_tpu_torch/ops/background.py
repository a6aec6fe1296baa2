"""Background removal: kernel D (``csrc/background.cu``) and its plain
version.

Replaces XLA code of the JAX package, not a TPU kernel:
``kikuchipy_tpu/ops/pattern.py`` ``_remove_background`` under
``remove_static_background`` and ``remove_dynamic_background`` (frequency
domain, whose blur is ``fft_barnes.separable_filter``: ``R @ p @ C^T``).

:func:`remove_background` removes a static background (``static_bg``) or
each pattern's own frequency-domain blur (``row_op`` and ``col_op``, the two
operators of :class:`~kikuchipy_tpu_torch.ops.fft_barnes.SeparableFilterPlan`)
by subtraction or division, then rescales each pattern by its min and max to
``[omin, omax]`` and casts to ``dtype_out``. For a CPU tensor it returns its
plain version (:func:`remove_background_plain`); for a CUDA tensor it
launches kernel D once for the whole batch or raises, and counts the launch
in its own ``.launches`` (and in ``.mode_launches["static"]`` or
``["dynamic"]``, and each mode's kernel in ``["static-warp"]`` or
``["static-block"]``, as :func:`static_path` chooses, and in
``["dynamic-pair"]`` or ``["dynamic-block"]``, as :func:`dynamic_path`
chooses). The static mode equals the plain version bit for bit on the card;
the dynamic mode sums its products in another order than cuBLAS, so integer
outputs may differ by one gray level where a value lands on an integer
boundary. Both dynamic kernels sum each output in the same ascending-k FMA
chain, so they give the same bytes.
"""

from __future__ import annotations

import ctypes

import torch

from kikuchipy_tpu_torch.ops.fft_barnes import separable_filter
from kikuchipy_tpu_torch.ops.pattern_io import CODES, SMEM_BUDGET, check_storage, remove_and_rescale, sig_max, sig_min
from kikuchipy_tpu_torch.utils.dtypes import torch_dtype

__all__ = ["DYNAMIC_SIDE", "SMEM_BUDGET", "WARP_VECTORS", "dynamic_path", "dynamic_smem_bytes", "remove_background",
           "remove_background_plain", "smem_bytes", "static_path"]

# Blocks that run when the images live in scratch: the scratch is
# (_WORK_BLOCKS, 2, sy, sx) float32.
_WORK_BLOCKS = 1024
# Threads a block of either kernel (csrc/background.cu kThreads).
_THREADS = 256
# The static warp kernel's sizes: 16-byte vectors a lane (csrc/background.cu
# static_kernel), so patterns of up to 32 x 16 x 16 = 8,192 uint8 pixels.
WARP_VECTORS = (2, 4, 8, 16)
# The static warp kernel truncates through int32, which gives PyTorch's
# byte (through int64) for every value within +-2^31: it takes output
# ranges within +-2^30.
_WARP_RANGE = 2.0**30
# The dynamic pair kernel's sizes (csrc/background.cu kDynSide, kDynTStride,
# kDynMaxPairs): patterns of at most 64 x 64 pixels, the row product's
# transpose 68 floats a row, at most 8 patterns in flight a block.
DYNAMIC_SIDE = 64
_DYN_TSTRIDE = 68
_DYN_MAX_PAIRS = 8


def _check(patterns, operation, static_bg, row_op, col_op) -> None:
    if operation not in ("subtract", "divide"):
        raise ValueError(f"operation must be 'subtract' or 'divide', got {operation!r}")
    if (static_bg is None) == (row_op is None) or (row_op is None) != (col_op is None):
        raise ValueError("pass static_bg (static mode) or row_op and col_op (dynamic mode)")
    if patterns.ndim < 2 or patterns.shape[-1] < 1 or patterns.shape[-2] < 1:
        raise ValueError(f"patterns must be (..., sy, sx), got {tuple(patterns.shape)}")
    sy, sx = patterns.shape[-2:]
    if static_bg is not None and tuple(static_bg.shape) != (sy, sx):
        raise ValueError(f"static_bg must be ({sy}, {sx}), got {tuple(static_bg.shape)}")
    if row_op is not None and (tuple(row_op.shape) != (sy, sy) or tuple(col_op.shape) != (sx, sx)):
        raise ValueError(f"row_op must be ({sy}, {sy}) and col_op ({sx}, {sx}), got {tuple(row_op.shape)}, "
                         f"{tuple(col_op.shape)}")


def _unit_background(bg: torch.Tensor) -> torch.Tensor:
    """The background rescaled to ``[0, 1]``: the first step of ``scale_bg``'s
    rescale, shared by every pattern."""
    return (bg - bg.min()) / (bg.max() - bg.min())


def remove_background_plain(patterns, operation: str, omin: float, omax: float, dtype_out, static_bg=None,
                            scale_bg: bool = False, row_op=None, col_op=None) -> torch.Tensor:
    """Kernel D's function in PyTorch operations: the JAX package's op order
    (``remove_static_background`` / ``remove_dynamic_background``)."""
    _check(patterns, operation, static_bg, row_op, col_op)
    p = patterns.to(torch.float32)
    if row_op is not None:
        bg = separable_filter(p, row_op, col_op)
    else:
        bg = static_bg.to(torch.float32)
        if scale_bg:
            pmin, pmax = sig_min(p), sig_max(p)
            bg = _unit_background(bg) * (pmax - pmin) + pmin
    out = remove_and_rescale(p, bg, operation, float(omin), float(omax))
    return out.to(torch_dtype(dtype_out))


def smem_bytes(sy: int, sx: int, dynamic: bool) -> int:
    """Shared memory of one block of kernel D with everything resident: the
    operators' row bands, R, C and two images (dynamic), or the background
    and one image."""
    return 4 * (2 * (sy + sx) + sy * sy + sx * sx + 2 * sy * sx if dynamic else 2 * sy * sx)


def static_path(sy: int, sx: int, dtype_in, dtype_out, omin: float = 0.0, omax: float = 255.0,
                aligned: bool = True) -> tuple[str, int]:
    """The kernel a static-mode call on the card takes: ``("warp", vec)``,
    one warp a pattern holding ``vec`` 16-byte vectors a lane in registers,
    for uint8 in and out where a pattern is a whole number of vectors (so
    each starts on a 16-byte boundary, as the data must: ``aligned``), at
    most ``32 * vec`` of them, and the output range lies within +-2^30; else
    ``("block", 0)``, one block a pattern, for every shape and storage
    type."""
    npix = sy * sx
    fits = (torch_dtype(dtype_in) == torch.uint8 and torch_dtype(dtype_out) == torch.uint8 and aligned
            and npix % 16 == 0 and max(abs(float(omin)), abs(float(omax))) <= _WARP_RANGE)
    for vec in WARP_VECTORS:
        if fits and npix <= 32 * 16 * vec:
            return "warp", vec
    return "block", 0


def dynamic_smem_bytes(sy: int, sx: int, pairs: int) -> int:
    """Shared memory of a block of the dynamic pair kernel: the two
    transposed operators (64 floats a row) and, for each of ``pairs``
    patterns in flight, the row product's transpose, two pattern buffers and
    its min and max (``csrc/background.cu`` ``dyn_smem``)."""
    return 4 * DYNAMIC_SIDE * (sy + sx) + pairs * (4 * sx * _DYN_TSTRIDE + 2 * sy * sx + 16)


def dynamic_path(sy: int, sx: int, dtype_in, dtype_out, omin: float = 0.0, omax: float = 255.0,
                 aligned: bool = True) -> tuple[str, int]:
    """The kernel a dynamic-mode call on the card takes: ``("pair",
    pairs)``, a pair of warps a pattern and ``pairs`` patterns a block, the
    operators and each pattern in shared memory and each pair's removed
    values in registers, for uint8 in and out, patterns of at most 64 x 64
    pixels whose width is a multiple of 4 and which are whole 16-byte
    vectors on 16-byte boundaries (``aligned``), and output ranges within
    +-2^30; else ``("block", 0)``, one block a pattern, for every shape and
    storage type (in device-memory scratch past the shared-memory budget)."""
    fits = (torch_dtype(dtype_in) == torch.uint8 and torch_dtype(dtype_out) == torch.uint8 and aligned
            and 1 <= sy <= DYNAMIC_SIDE and 4 <= sx <= DYNAMIC_SIDE and sx % 4 == 0 and (sy * sx) % 16 == 0
            and max(abs(float(omin)), abs(float(omax))) <= _WARP_RANGE)
    if not fits:
        return "block", 0
    pairs = _DYN_MAX_PAIRS
    while dynamic_smem_bytes(sy, sx, pairs) > SMEM_BUDGET:
        pairs -= 1
    return "pair", pairs


def _library():
    from kikuchipy_tpu_torch.ops._build import library

    lib = library("background")
    if lib.background_launch.argtypes is None:
        lib.background_blocks.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
        lib.background_launch.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
                                          + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                                          + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.background_static_launch.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
                                                 + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        lib.background_dynamic_launch.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                                                  + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                                     ctypes.c_void_p])
        for fn in (lib.background_blocks, lib.background_launch, lib.background_static_launch,
                   lib.background_dynamic_launch):
            fn.restype = ctypes.c_int
    return lib


# Blocks each kernel of csrc/background.cu runs at once, by device index,
# kernel (vectors a lane, divide, scale_bg; 0 vectors: the block kernel, -1:
# the dynamic pair kernel), threads and shared-memory bytes: found once, by
# background_blocks.
_BLOCKS: dict[tuple[int, int, int, int, int, int], int] = {}


def _blocks(lib, vec: int, divide: int, scale: int, smem: int, threads: int = _THREADS) -> int:
    key = (torch.cuda.current_device(), vec, divide, scale, smem, threads)
    blocks = _BLOCKS.get(key)
    if blocks is None:
        out = ctypes.c_int(0)
        err = lib.background_blocks(vec, divide, scale, threads, smem, SMEM_BUDGET, ctypes.byref(out))
        if err:
            raise RuntimeError(f"background kernel {key[1:4]} with {smem} bytes of shared memory: cudaError_t {err}")
        blocks = _BLOCKS[key] = out.value
    return blocks


def remove_background(patterns, operation: str, omin: float, omax: float, dtype_out, static_bg=None,
                      scale_bg: bool = False, row_op=None, col_op=None) -> torch.Tensor:
    """Remove a background from every pattern ``(..., sy, sx)`` and rescale
    each to ``[omin, omax]`` in ``dtype_out``.

    Static mode: ``static_bg (sy, sx)``, optionally rescaled to each
    pattern's own range (``scale_bg``). Dynamic mode: ``row_op (sy, sy)`` and
    ``col_op (sx, sx)``, the background being ``row_op @ p @ col_op.T``. On
    the card one launch of kernel D for all patterns."""
    _check(patterns, operation, static_bg, row_op, col_op)
    if patterns.device.type == "cpu":
        return remove_background_plain(patterns, operation, omin, omax, dtype_out, static_bg, scale_bg, row_op,
                                       col_op)
    dev = patterns.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out_dtype = torch_dtype(dtype_out)
    check_storage("kernel D", patterns.dtype, out_dtype)
    dynamic = row_op is not None
    ops = (row_op, col_op) if dynamic else (static_bg,)
    if any(t.device != dev for t in ops):
        raise ValueError("the background or operators must be on the patterns' device")
    sy, sx = patterns.shape[-2:]
    n = patterns.numel() // (sy * sx)
    src = patterns.contiguous()
    out = torch.empty(patterns.shape, dtype=out_dtype, device=dev)
    if n == 0:
        return out
    if dynamic:
        row = row_op.to(torch.float32).contiguous()
        col = col_op.to(torch.float32).contiguous()
        bg = None
    else:
        row = col = None
        bg = static_bg.to(torch.float32)
        bg = (_unit_background(bg) if scale_bg else bg).contiguous()
    divide, scale = int(operation == "divide"), int(bool(scale_bg) and not dynamic)
    aligned = src.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0
    path, vec = (dynamic_path if dynamic else static_path)(sy, sx, src.dtype, out_dtype, omin, omax, aligned=aligned)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if path == "pair":
            smem = dynamic_smem_bytes(sy, sx, vec)
            grid = min(_blocks(lib, -1, divide, 0, smem, 64 * vec), -(-n // vec))
            err = lib.background_dynamic_launch(src.data_ptr(), out.data_ptr(), row.data_ptr(), col.data_ptr(), n, sy,
                                                sx, divide, float(omin), float(omax) - float(omin), vec, grid, stream)
        elif path == "warp":
            if bg.data_ptr() % 16:
                bg = bg.clone()
            grid = min(_blocks(lib, vec, divide, scale, 4 * sy * sx), -(-n // (_THREADS // 32)))
            err = lib.background_static_launch(src.data_ptr(), out.data_ptr(), bg.data_ptr(), n, sy * sx, vec, divide,
                                               scale, float(omin), float(omax) - float(omin), grid, stream)
        else:
            work = None
            if smem_bytes(sy, sx, dynamic) > SMEM_BUDGET:
                work = torch.empty((min(n, _WORK_BLOCKS), 2, sy, sx), dtype=torch.float32, device=dev)
                grid = work.shape[0]
            else:
                grid = min(n, _blocks(lib, 0, 0, 0, smem_bytes(sy, sx, dynamic)))

            def ptr(t):
                return None if t is None else t.data_ptr()

            err = lib.background_launch(
                src.data_ptr(), CODES[src.dtype], out.data_ptr(), CODES[out_dtype], ptr(bg), ptr(row), ptr(col),
                ptr(work), n, sy, sx, int(dynamic), divide, scale, float(omin), float(omax) - float(omin), grid,
                stream,
            )
    if err:
        raise RuntimeError(f"background launch failed: cudaError_t {err}")
    remove_background.launches += 1
    mode = "dynamic" if dynamic else "static"
    remove_background.mode_launches[mode] += 1
    remove_background.mode_launches[f"{mode}-{path}"] += 1
    return out


remove_background.launches = 0
remove_background.mode_launches = {"static": 0, "dynamic": 0, "static-warp": 0, "static-block": 0, "dynamic-pair": 0,
                                   "dynamic-block": 0}
