"""Navigation-neighbourhood operations: neighbour-pattern averaging on
kernel G (``csrc/neighbours.cu``) and the neighbour dot-product maps.

The port of ``kikuchipy_tpu/ops/neighbors.py``. :func:`average_neighbours`
is kernel G's wrapper: for a CPU tensor it returns its plain version
(:func:`average_neighbours_plain`, shift-and-accumulate in float64
PyTorch); for a CUDA tensor it launches kernel G once for the whole scan or
raises, and counts the launch in its ``.launches`` (and by route, the
vector or the general kernel that :func:`neighbours_plan` chooses, in its
``.mode_launches``). The two agree bit for
bit. The dot-product maps are a diagnostic and stay plain PyTorch on the
patterns' device, as they were XLA code in JAX.

Public functions take ``device=None`` (the card); pass ``device="cpu"`` to
run on the CPU.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from kikuchipy_tpu_torch.filters.window import Window
from kikuchipy_tpu_torch.ops.pattern_io import CODES, SMEM_BUDGET, check_storage, rescale_with_min_max, sig_max, sig_min
from kikuchipy_tpu_torch.utils.device import as_tensor, resolve_device
from kikuchipy_tpu_torch.utils.dtypes import get_dtype_range, numpy_dtype, torch_dtype

__all__ = [
    "FIXED_TAPS",
    "MAX_TAPS",
    "NeighboursPlan",
    "average_dot_product_map",
    "average_neighbour_patterns",
    "average_neighbours",
    "average_neighbours_plain",
    "neighbour_dot_product_matrices",
    "neighbours_plan",
    "table_bytes",
    "unit_weights",
    "window_taps",
]

# The most nonzero weights passed to kernel G as a launch argument
# (csrc/neighbours.cu kMaxTaps); a larger window goes through a device table.
MAX_TAPS = 128
# Blocks that run when a pattern's float32 averages pass the shared-memory
# budget: they then live in a (_WORK_BLOCKS, sy, sx) float32 scratch.
_WORK_BLOCKS = 1024
# Kernel G's vector kernel: the storage types it reads and writes (16-byte
# input vectors, so 16 uint8, 8 uint16 or 4 float32 elements a thread), the
# tap counts it unrolls at compile time, and the most vectors a pattern (a
# map point a block).
_VEC_TYPES = (torch.uint8, torch.uint16, torch.float32)
FIXED_TAPS = (5, 9)
MAX_VECTORS = 1024


@dataclass(frozen=True)
class NeighboursPlan:
    """How kernel G takes a call (``neighbours_plan``): ``route`` "vector"
    (``neighbours_vec_kernel``) or "general" (``neighbours_kernel``);
    ``taps`` the vector kernel's tap instantiation (5, 9, or 0 for any);
    ``integer`` its integer route; ``warps`` the warps of a block of it (a
    map point); ``table`` the taps from a device table;
    ``work`` the general kernel's averages in a device-memory scratch and
    ``list_in_device`` its tap lists there too."""

    route: str
    taps: int = 0
    integer: bool = False
    warps: int = 0
    table: bool = False
    work: bool = False
    list_in_device: bool = False


def table_bytes(n_taps: int, dtype_out) -> int:
    """Shared memory of one map point's table on kernel G's integer route:
    an output (of ``dtype_out``) for every sum from 0 to 255 times the tap
    count, rounded up to 16 bytes (``csrc/neighbours.cu`` ``table_bytes``)."""
    size = torch.empty((), dtype=torch_dtype(dtype_out)).element_size()
    return -(-(255 * n_taps + 1) * size // 16) * 16


def unit_weights(weights, dtype_in) -> bool:
    """Whether kernel G's integer route gives the float64 sums' bits: uint8
    input and every weight 1, so every product and partial sum is an
    integer below 2^16, exact in float64 and float32 (with 5 or 9 taps the
    route has an instantiation; :func:`neighbours_plan` checks that and the
    table's room)."""
    return torch_dtype(dtype_in) == torch.uint8 and all(float(w) == 1.0 for w in weights)


def neighbours_plan(dtype_in, dtype_out, npix: int, weights, aligned_in: int, aligned_out: int) -> NeighboursPlan:
    """Kernel G's route for patterns of ``npix`` pixels and these taps.
    ``aligned_in`` and ``aligned_out``: the largest powers of two (at most
    16) dividing the input's and the output's data pointers. The vector
    kernel takes uint8, uint16 or float32 in and out where a pattern is a
    whole number of 16-byte input vectors, at most :data:`MAX_VECTORS` (512
    on the uint8 float64 route) and the pointers are aligned to the vectors
    (the input's to 16 bytes, the output's to a vector's outputs or 16);
    every other call takes the general kernel, with its averages in a
    device-memory scratch past the shared-memory budget and its tap lists
    there too where the two pass it."""
    t_in, t_out = torch_dtype(dtype_in), torch_dtype(dtype_out)
    n_taps = len(weights)
    table = n_taps > MAX_TAPS
    if t_in in _VEC_TYPES and t_out in _VEC_TYPES:
        size_in, size_out = torch.empty((), dtype=t_in).element_size(), torch.empty((), dtype=t_out).element_size()
        per_vec = 16 // size_in
        nvec = npix // per_vec
        fixed = n_taps if (n_taps in FIXED_TAPS and not table) else 0
        tables = table_bytes(n_taps, t_out)
        integer = bool(fixed) and unit_weights(weights, t_in) and tables <= SMEM_BUDGET
        cap = 512 if (t_in == torch.uint8 and not integer) else MAX_VECTORS
        if (npix % per_vec == 0 and nvec <= cap and aligned_in >= 16
                and aligned_out >= min(16, per_vec * size_out)):
            return NeighboursPlan("vector", fixed, integer, -(-nvec // 32), table)
    list_bytes = -(-4 * n_taps // 16) * 16
    work = 4 * npix > SMEM_BUDGET
    list_in_device = list_bytes + (0 if work else 4 * npix) > SMEM_BUDGET
    return NeighboursPlan("general", table=table, work=work, list_in_device=list_in_device)


def _alignment(ptr: int) -> int:
    """The largest power of two, at most 16, dividing ``ptr``."""
    return 16 if ptr % 16 == 0 else (ptr & -ptr)


def _resolve_window(window, window_shape, **kwargs) -> np.ndarray:
    if isinstance(window, np.ndarray):
        w = np.asarray(window, dtype=np.float64)
    else:
        w = np.asarray(Window(window or "circular", shape=window_shape, **kwargs), dtype=np.float64)
    if w.ndim == 1:
        w = w[:, None]
    return w


def window_taps(w: np.ndarray) -> tuple[list[tuple[int, int]], list[float]]:
    """The window's nonzero weights in row-major order and each one's
    navigation offset ``(dy, dx)``: the output at ``(y, x)`` takes
    ``w_k * p[y - dy_k, x - dx_k]`` (a correlation about the window's
    center ``shape // 2``)."""
    offsets, _ = _window_offsets(w)
    return offsets, [float(v) for v in w[w != 0]]


def _overlap(n: int, d: int) -> tuple[slice, slice]:
    """Destination and source slices of a shift by ``d`` along an axis of
    ``n``: ``dst[i] = src[i - d]`` where ``0 <= i - d < n`` (both empty
    where ``|d| >= n``)."""
    return (slice(min(max(d, 0), n), max(n + min(d, 0), 0)),
            slice(min(max(-d, 0), n), max(n + min(-d, 0), 0)))


def _shift2d(x: torch.Tensor, dy: int, dx: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The two leading (navigation) axes of ``x`` shifted by ``(dy, dx)``
    with zero fill, and the ``(ny, nx)`` mask of the points whose neighbour
    is inside the map."""
    ny, nx = x.shape[0], x.shape[1]
    (yd, ys), (xd, xs) = _overlap(ny, dy), _overlap(nx, dx)
    shifted = torch.zeros_like(x)
    shifted[yd, xd] = x[ys, xs]
    mask = torch.zeros((ny, nx), dtype=torch.bool, device=x.device)
    mask[yd, xd] = True
    return shifted, mask


def _check_scan(patterns) -> None:
    if patterns.ndim != 4:
        raise ValueError(f"patterns must be 4D (ny, nx, sy, sx); got shape {tuple(patterns.shape)}")


def average_neighbours_plain(patterns: torch.Tensor, offsets, weights, dtype_out) -> torch.Tensor:
    """Kernel G's function in PyTorch operations, in JAX's order
    (``_average_impl``): float64 sums over the taps, the float32 quotient by
    the per-point weight sum, then the per-pattern min/max rescale to
    ``dtype_out``'s range and the cast."""
    _check_scan(patterns)
    p = patterns.to(torch.float32).to(torch.float64)
    acc = torch.zeros_like(p)
    norm = torch.zeros(p.shape[:2], dtype=torch.float64, device=p.device)
    for (dy, dx), w in zip(offsets, weights):
        shifted, mask = _shift2d(p, dy, dx)
        acc = acc + w * shifted
        norm = norm + w * mask.to(torch.float64)
    out = acc.to(torch.float32) / norm.to(torch.float32)[:, :, None, None]
    omin, omax = get_dtype_range(numpy_dtype(dtype_out))
    out = rescale_with_min_max(out, sig_min(out), sig_max(out), float(omin), float(omax))
    return out.to(torch_dtype(dtype_out))


def _library():
    from kikuchipy_tpu_torch.ops._build import library

    lib = library("neighbours")
    if lib.neighbours_launch.argtypes is None:
        lib.neighbours_launch.argtypes = (
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 5
            + [ctypes.POINTER(ctypes.c_double)] + [ctypes.POINTER(ctypes.c_int)] * 2
            + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
            + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        )
        lib.neighbours_launch.restype = ctypes.c_int
        lib.neighbours_max_taps.argtypes = []
        lib.neighbours_max_taps.restype = ctypes.c_int
        if lib.neighbours_max_taps() != MAX_TAPS:
            raise RuntimeError(f"csrc/neighbours.cu holds {lib.neighbours_max_taps()} taps, the wrapper {MAX_TAPS}")
    return lib


def average_neighbours(patterns: torch.Tensor, offsets, weights, dtype_out) -> torch.Tensor:
    """Average every pattern of the scan ``(ny, nx, sy, sx)`` with its
    neighbours at ``offsets`` (``(dy, dx)`` pairs) weighted by ``weights``,
    rescale each to ``dtype_out``'s range and cast. On the card one launch
    of kernel G for the whole scan, on the route :func:`neighbours_plan`
    chooses: the vector kernel (uint8, uint16, float32; the main path's
    uint8 scan with 5 taps of weight 1 on its integer route) or the general
    kernel. A window of at most :data:`MAX_TAPS` weights passes as the
    launch's argument, a larger one as a device table; on the general
    kernel a pattern whose float32 averages pass the shared-memory budget
    keeps them in a device-memory scratch."""
    _check_scan(patterns)
    if len(offsets) != len(weights) or not offsets:
        raise ValueError(f"need one offset a weight and at least one of each, got {len(offsets)} and {len(weights)}")
    if patterns.device.type == "cpu":
        return average_neighbours_plain(patterns, offsets, weights, dtype_out)
    dev = patterns.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out_dtype = torch_dtype(dtype_out)
    check_storage("kernel G", patterns.dtype, out_dtype)
    ny, nx, sy, sx = patterns.shape
    npix = sy * sx
    src = patterns.contiguous()
    out = torch.empty(patterns.shape, dtype=out_dtype, device=dev)
    if src.numel() == 0:
        return out
    omin, omax = get_dtype_range(numpy_dtype(out_dtype))
    n_taps = len(weights)
    plan = neighbours_plan(src.dtype, out_dtype, npix, weights, _alignment(src.data_ptr()),
                           _alignment(out.data_ptr()))
    dy_list = [int(o[0]) for o in offsets]
    dx_list = [int(o[1]) for o in offsets]
    w = dy = dx = table_w = table_off = None
    if not plan.table:
        w = (ctypes.c_double * n_taps)(*weights)
        dy = (ctypes.c_int * n_taps)(*dy_list)
        dx = (ctypes.c_int * n_taps)(*dx_list)
    else:
        table_w = torch.tensor([float(v) for v in weights], dtype=torch.float64, device=dev)
        table_off = torch.tensor(dy_list + dx_list, dtype=torch.int32, device=dev)
    work = tlist = None
    if plan.work:
        work = torch.empty((min(ny * nx, _WORK_BLOCKS), sy, sx), dtype=torch.float32, device=dev)
    if plan.list_in_device:
        rows = work.shape[0] if work is not None else ny * nx
        tlist = torch.empty((rows, n_taps), dtype=torch.int32, device=dev)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.neighbours_launch(src.data_ptr(), CODES[src.dtype], out.data_ptr(), CODES[out_dtype], ny, nx, npix,
                                    n_taps, w, dy, dx, None if table_w is None else table_w.data_ptr(),
                                    None if table_off is None else table_off.data_ptr(),
                                    None if work is None else work.data_ptr(),
                                    0 if work is None else work.shape[0],
                                    None if tlist is None else tlist.data_ptr(),
                                    int(plan.route == "vector"), plan.taps, int(plan.integer), plan.warps,
                                    float(omin), float(omax) - float(omin), SMEM_BUDGET, stream)
    if err:
        raise RuntimeError(f"neighbours launch failed ({plan}): cudaError_t {err}")
    average_neighbours.launches += 1
    average_neighbours.mode_launches[plan.route] += 1
    return out


average_neighbours.launches = 0
# Launches by route ("vector", "general"), as the smoke reads them.
average_neighbours.mode_launches = {"vector": 0, "general": 0}


def average_neighbour_patterns(
    patterns,
    window=None,
    window_shape: tuple[int, ...] = (3, 3),
    dtype_out=None,
    device=None,
    **kwargs,
) -> torch.Tensor:
    """Average each pattern with its neighbours, weighted by ``window``
    (map borders zero-extended, the weights normalized per point), then
    rescale each pattern to the output dtype's range (kikuchipy's
    ``EBSD.average_neighbour_patterns``). ``(1,)`` and ``(1, 1)`` windows
    return the input. On the card one launch of kernel G."""
    patterns = as_tensor(patterns, resolve_device(device))
    _check_scan(patterns)
    if dtype_out is None:
        dtype_out = patterns.dtype
    w = _resolve_window(window, window_shape, **kwargs)
    if w.shape in ((1,), (1, 1)):
        return patterns
    offsets, weights = window_taps(w)
    return average_neighbours(patterns, offsets, weights, dtype_out)


def _normalized_maps(patterns: torch.Tensor, zero_mean: bool, normalize: bool) -> torch.Tensor:
    p = patterns.to(torch.float32)
    if zero_mean:
        p = p - torch.mean(p, dim=(-2, -1), keepdim=True)
    if normalize:
        p = p / torch.sqrt(torch.sum(torch.square(p), dim=(-2, -1), keepdim=True))
    return p


def _window_offsets(w: np.ndarray) -> tuple[list, int]:
    """Nonzero window offsets (neighbour shift per coefficient) and the
    index of the origin among them."""
    oy, ox = w.shape[0] // 2, w.shape[1] // 2
    offsets = []
    center = -1
    for iy in range(w.shape[0]):
        for ix in range(w.shape[1]):
            if w[iy, ix] != 0:
                if (iy, ix) == (oy, ox):
                    center = len(offsets)
                offsets.append((oy - iy, ox - ix))
    return offsets, center


def _dot_products(patterns: torch.Tensor, offsets, zero_mean: bool, normalize: bool) -> np.ndarray:
    """``(ny, nx, n_offsets)`` float32 dot products of each pattern with its
    neighbour at each offset, NaN where the neighbour is outside the map."""
    p = _normalized_maps(patterns, zero_mean, normalize)
    ny, nx = p.shape[:2]
    out = torch.full((ny, nx, len(offsets)), float("nan"), dtype=torch.float32, device=p.device)
    for k, (dy, dx) in enumerate(offsets):
        (yd, ys), (xd, xs) = _overlap(ny, dy), _overlap(nx, dx)
        out[yd, xd, k] = torch.sum(p[yd, xd] * p[ys, xs], dim=(-2, -1))
    return out.cpu().numpy()


def neighbour_dot_product_matrices(
    patterns,
    window=None,
    window_shape: tuple[int, ...] = (3, 3),
    zero_mean: bool = True,
    normalize: bool = True,
    device=None,
    **kwargs,
) -> np.ndarray:
    """Matrices of dot products between each pattern and its window
    neighbours, ``(ny, nx, wy, wx)`` float32; NaN where the window weight is
    zero or the neighbour is outside the map (kikuchipy's
    ``EBSD.get_neighbour_dot_product_matrices``)."""
    patterns = as_tensor(patterns, resolve_device(device))
    _check_scan(patterns)
    w = _resolve_window(window, window_shape, **kwargs)
    offsets, _ = _window_offsets(w)
    dps = _dot_products(patterns, offsets, zero_mean, normalize)
    ny, nx = dps.shape[:2]
    out = np.full((ny, nx, w.shape[0], w.shape[1]), np.nan, dtype=np.float32)
    k = 0
    for iy in range(w.shape[0]):
        for ix in range(w.shape[1]):
            if w[iy, ix] != 0:
                out[:, :, iy, ix] = dps[:, :, k]
                k += 1
    return out


def average_dot_product_map(
    patterns,
    window=None,
    window_shape: tuple[int, ...] = (3, 3),
    zero_mean: bool = True,
    normalize: bool = True,
    device=None,
    **kwargs,
) -> np.ndarray:
    """Average dot product (ADP) map: the mean dot product between each
    pattern and its window neighbours, the origin excluded (kikuchipy's
    ``EBSD.get_average_neighbour_dot_product_map``)."""
    patterns = as_tensor(patterns, resolve_device(device))
    _check_scan(patterns)
    w = _resolve_window(window, window_shape, **kwargs)
    offsets, center = _window_offsets(w)
    neighbour_offsets = [off for i, off in enumerate(offsets) if i != center]
    return np.nanmean(_dot_products(patterns, neighbour_offsets, zero_mean, normalize), axis=-1)
