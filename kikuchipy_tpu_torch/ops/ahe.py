"""Contrast-limited adaptive histogram equalization (CLAHE), batched: kernel
E (``csrc/clahe.cu``) and its plain version.

The port of ``kikuchipy_tpu/ops/ahe.py``: per-tile histograms of 128 bins
(by default) over tiles of a quarter of the pattern, optional
clip-and-redistribute, per-tile CDF mappings, and a bilinear blend of the
mappings between tile centres (``_blend_weights``), then a rescale of each
pattern to the output dtype's range.

:func:`clahe` takes the normalized-and-binned steps and the blend of
``_clahe_batch``: for a CPU tensor it returns its plain version
(:func:`clahe_plain`: the JAX package's computation, the one-hot product
written as a gather); for a CUDA tensor it launches kernel E once for the
whole batch or raises, and counts the launch in its own ``.launches`` and
in ``.mode_launches["pair"]`` or ``["block"]``, the kernel
:func:`clahe_path` chose. The pair kernel takes the main path's case
(uint8 in and out, 128 bins, 4 x 4 tiles that cover the pattern, at most
4,096 pixels): a pair of warps a pattern, eight patterns a block, each
pixel's four blend weights in shared memory once a block and the blended
values in registers. The block kernel takes every other call: it keeps
each pattern's ``n_tiles * nbins`` tables and the rows' and columns' blend
tables in shared memory, and its blended values there too where they fit
(else in a device-memory scratch); a configuration whose tables pass
:data:`SMEM_BUDGET` is refused on the card with ``ValueError`` (JAX has no
such limit). Both kernels give the same bytes.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from kikuchipy_tpu_torch.ops.pattern_io import CODES, SMEM_BUDGET, check_storage
from kikuchipy_tpu_torch.utils.device import as_tensor, resolve_device
from kikuchipy_tpu_torch.utils.dtypes import get_dtype_range, numpy_dtype, torch_dtype

__all__ = ["SMEM_BUDGET", "adaptive_histogram_equalization", "clahe", "clahe_pair_smem_bytes", "clahe_path",
           "clahe_plain", "clahe_smem_bytes"]


@lru_cache(maxsize=32)
def _blend_weights(sy: int, sx: int, ky: int, kx: int) -> np.ndarray:
    """Static ``(n_tiles, sy, sx)`` bilinear blend weights: pixel
    (y, x)'s output is ``sum_t W[t, y, x] * V_t[y, x]`` where ``V_t``
    is tile t's CDF mapping applied to the pattern."""
    n_ty = -(-sy // ky)
    n_tx = -(-sx // kx)
    yy = np.arange(sy, dtype=np.float64)
    xx = np.arange(sx, dtype=np.float64)
    ty = (yy - (ky - 1) / 2) / ky
    tx = (xx - (kx - 1) / 2) / kx
    ty0 = np.clip(np.floor(ty).astype(int), 0, n_ty - 1)
    tx0 = np.clip(np.floor(tx).astype(int), 0, n_tx - 1)
    ty1 = np.clip(ty0 + 1, 0, n_ty - 1)
    tx1 = np.clip(tx0 + 1, 0, n_tx - 1)
    wy = np.clip(ty - ty0, 0.0, 1.0)
    wx = np.clip(tx - tx0, 0.0, 1.0)

    W = np.zeros((n_ty * n_tx, sy, sx), dtype=np.float32)
    corners = [
        (ty0, tx0, (1 - wy)[:, None] * (1 - wx)[None, :]),
        (ty0, tx1, (1 - wy)[:, None] * wx[None, :]),
        (ty1, tx0, wy[:, None] * (1 - wx)[None, :]),
        (ty1, tx1, wy[:, None] * wx[None, :]),
    ]
    yi = np.arange(sy)[:, None]
    xi = np.arange(sx)[None, :]
    for t_y, t_x, w in corners:
        tid = t_y[:, None] * n_tx + t_x[None, :]
        np.add.at(W, (tid, np.broadcast_to(yi, tid.shape), np.broadcast_to(xi, tid.shape)), w)
    return W


@lru_cache(maxsize=32)
def _reflect_pad_indices(n: int, total: int) -> np.ndarray:
    """numpy's "reflect" source index (no edge repeat) of each position of
    an axis of length ``n`` padded at its end to ``total``."""
    if n == 1:
        return np.zeros(total, dtype=np.int64)
    q = np.mod(np.arange(total), 2 * (n - 1))
    return np.where(q < n, q, 2 * (n - 1) - q)


def _clahe_batch(imgs: torch.Tensor, ky: int, kx: int, nbins: int, clip_limit: float) -> torch.Tensor:
    """CLAHE of a batch of normalized [0, 1] float32 images ``(n, sy, sx)``
    (``kikuchipy_tpu/ops/ahe.py:_clahe_batch``)."""
    n, sy, sx = imgs.shape
    n_ty = -(-sy // ky)
    n_tx = -(-sx // kx)
    n_tiles = n_ty * n_tx
    dev = imgs.device
    iy = torch.as_tensor(_reflect_pad_indices(sy, n_ty * ky), device=dev)
    ix = torch.as_tensor(_reflect_pad_indices(sx, n_tx * kx), device=dev)
    padded = imgs.index_select(1, iy).index_select(2, ix)

    bins = torch.clamp((padded * nbins).to(torch.int32), 0, nbins - 1)
    tiles = bins.reshape(n, n_ty, ky, n_tx, kx).permute(0, 1, 3, 2, 4).reshape(n, n_tiles, ky * kx)
    hist = torch.zeros((n, n_tiles, nbins), dtype=torch.float32, device=dev)
    hist.scatter_add_(2, tiles.long(), torch.ones(tiles.shape, dtype=torch.float32, device=dev))

    if clip_limit > 0:
        limit = max(clip_limit * ky * kx / nbins, 1.0)
        excess = torch.sum(torch.clamp_min(hist - limit, 0.0), dim=-1, keepdim=True)
        hist = torch.clamp_max(hist, limit) + excess / nbins

    cdf = torch.cumsum(hist, dim=-1)
    mapping = cdf / cdf[..., -1:]  # (n, n_tiles, nbins)

    # Every tile's mapping at every pixel's bin (the one-hot product of the
    # JAX package, exact), then the static bilinear blend over the tiles.
    pix_bins = bins[:, :sy, :sx].reshape(n, 1, sy * sx).expand(n, n_tiles, sy * sx)
    values = torch.gather(mapping, 2, pix_bins.long())  # (n, n_tiles, sy * sx)
    W = torch.as_tensor(_blend_weights(sy, sx, ky, kx), device=dev).reshape(n_tiles, sy * sx)
    out = torch.einsum("ntp,tp->np", values, W)
    return out.reshape(n, sy, sx)


def _normalized(patterns: torch.Tensor) -> torch.Tensor:
    """Patterns as float32 in [0, 1]: integer input by its dtype's range,
    float input by each pattern's min and max."""
    p = patterns.to(torch.float32)
    if not patterns.dtype.is_floating_point:
        imin, imax = get_dtype_range(patterns.dtype)
        return (p - float(imin)) / (float(imax) - float(imin))
    imin = torch.amin(p, dim=(-2, -1), keepdim=True)
    imax = torch.amax(p, dim=(-2, -1), keepdim=True)
    return (p - imin) / (imax - imin)


def _rescaled(out: torch.Tensor, dtype_out) -> torch.Tensor:
    omin, omax = get_dtype_range(dtype_out)
    omin_ = torch.amin(out, dim=(-2, -1), keepdim=True)
    omax_ = torch.amax(out, dim=(-2, -1), keepdim=True)
    out = (out - omin_) / (omax_ - omin_) * (omax - omin) + omin
    return out.to(torch_dtype(dtype_out))


def clahe_plain(patterns: torch.Tensor, ky: int, kx: int, nbins: int, clip_limit: float, dtype_out,
                chunk: int = 512) -> torch.Tensor:
    """Kernel E's function in PyTorch operations, ``chunk`` patterns at a
    time: normalize, :func:`_clahe_batch`, rescale to ``dtype_out``."""
    sy, sx = patterns.shape[-2:]
    flat = _normalized(patterns).reshape(-1, sy, sx)
    parts = [_clahe_batch(flat[s:s + chunk], ky, kx, nbins, float(clip_limit)) for s in range(0, flat.shape[0], chunk)]
    out = torch.cat(parts) if parts else flat
    return _rescaled(out.reshape(patterns.shape), dtype_out)


# Blocks that run when the blended values live in scratch: the scratch is
# (_WORK_BLOCKS, sy, sx) float32.
_WORK_BLOCKS = 1024


def clahe_smem_bytes(sy: int, sx: int, ky: int, kx: int, nbins: int, resident: bool = True) -> int:
    """Shared memory of one block of kernel E: the blend tables (24 bytes a
    row and a column), the ``n_tiles x nbins`` mappings (float32) and, with
    ``resident``, the blended values (float32 a pixel)."""
    n_ty, n_tx = -(-sy // ky), -(-sx // kx)
    return 24 * (sy + sx) + 4 * n_ty * n_tx * nbins + (4 * sy * sx if resident else 0)


# The pair kernel's case (csrc/clahe.cu kPairBins, kPairSide, kPairMaxPix,
# kPairMaxPairs, kPairHist).
_PAIR_BINS = 128
_PAIR_SIDE = 4
_PAIR_MAX_PIX = 4096
_PAIR_MAX_PAIRS = 8
_PAIR_HIST = _PAIR_SIDE * _PAIR_SIDE * _PAIR_BINS


def clahe_pair_smem_bytes(sy: int, sx: int, pairs: int) -> int:
    """Shared memory of a block of the pair kernel: each pixel's four blend
    weights, each column's and row's two tile offsets, each pixel of a
    tile's offset, and for each of ``pairs`` patterns in flight its tables,
    two buffers of its bytes and its min and max (``csrc/clahe.cu``
    ``pair_smem``)."""
    tables = 16 * sy * sx + 4 * (sy + sx) + 2 * (sy // _PAIR_SIDE) * (sx // _PAIR_SIDE)
    return -(-tables // 16) * 16 + pairs * (4 * _PAIR_HIST + 2 * sy * sx + 16)


def clahe_path(sy: int, sx: int, ky: int, kx: int, nbins: int, dtype_in, dtype_out,
               aligned: bool = True) -> tuple[str, int]:
    """The kernel a call on the card takes: ``("pair", pairs)``, a pair of
    warps a pattern and ``pairs`` patterns a block, for uint8 in and out,
    128 bins and 4 x 4 tiles that cover the pattern (``sy == 4 * ky``,
    ``sx == 4 * kx``: no reflect pad) of at most 4,096 pixels, on 16-byte
    boundaries (``aligned``); else ``("block", 0)``, one block a pattern,
    for every shape, tiling, bin count and storage type."""
    fits = (torch_dtype(dtype_in) == torch.uint8 and torch_dtype(dtype_out) == torch.uint8 and aligned
            and nbins == _PAIR_BINS and ky >= 1 and kx >= 1 and sy == _PAIR_SIDE * ky and sx == _PAIR_SIDE * kx
            and sy * sx <= _PAIR_MAX_PIX)
    if not fits:
        return "block", 0
    pairs = _PAIR_MAX_PAIRS
    while clahe_pair_smem_bytes(sy, sx, pairs) > SMEM_BUDGET:
        pairs -= 1
    return "pair", pairs


def _library():
    from kikuchipy_tpu_torch.ops._build import library

    lib = library("clahe")
    if lib.clahe_launch.argtypes is None:
        lib.clahe_launch.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                                     + [ctypes.c_int] * 8 + [ctypes.c_float] * 6 + [ctypes.c_void_p])
        lib.clahe_pair_launch.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_float] * 4
                                          + [ctypes.c_int, ctypes.c_void_p])
        for fn in (lib.clahe_launch, lib.clahe_pair_launch):
            fn.restype = ctypes.c_int
    return lib


def clahe(patterns: torch.Tensor, ky: int, kx: int, nbins: int, clip_limit: float, dtype_out,
          chunk: int = 512) -> torch.Tensor:
    """CLAHE of every pattern ``(..., sy, sx)`` with ``ky x kx`` tiles and
    ``nbins`` bins, rescaled to ``dtype_out``'s range. On the card one launch
    of kernel E for all patterns (``chunk`` only bounds the plain version's
    intermediate)."""
    sy, sx = patterns.shape[-2:]
    if ky < 1 or kx < 1 or nbins < 1:
        raise ValueError(f"kernel_size and nbins must be positive, got ({ky}, {kx}), {nbins}")
    if patterns.device.type == "cpu":
        return clahe_plain(patterns, ky, kx, nbins, clip_limit, dtype_out, chunk)
    dev = patterns.device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out_dtype = torch_dtype(dtype_out)
    check_storage("kernel E", patterns.dtype, out_dtype)
    n = patterns.numel() // (sy * sx)
    src = patterns.contiguous()
    out = torch.empty(patterns.shape, dtype=out_dtype, device=dev)
    path, pairs = clahe_path(sy, sx, ky, kx, nbins, src.dtype, out_dtype,
                             aligned=src.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0)
    smem = clahe_smem_bytes(sy, sx, ky, kx, nbins, resident=False)
    if path == "block" and smem > SMEM_BUDGET:
        raise ValueError(f"CLAHE of {sy} x {sx} patterns with {ky} x {kx} tiles and {nbins} bins needs {smem} bytes "
                         f"of shared memory a block for its tables, more than kernel E's {SMEM_BUDGET}")
    if n == 0:
        return out
    work = None
    if path == "block" and clahe_smem_bytes(sy, sx, ky, kx, nbins) > SMEM_BUDGET:
        work = torch.empty((min(n, _WORK_BLOCKS), sy, sx), dtype=torch.float32, device=dev)
    int_input = not patterns.dtype.is_floating_point
    in_min = in_inv = 0.0
    if int_input:
        imin, imax = get_dtype_range(patterns.dtype)
        # PyTorch divides a CUDA tensor by a number as a product with the
        # number's float32 reciprocal.
        in_min, in_inv = float(imin), float(np.float32(1.0) / np.float32(float(imax) - float(imin)))
    limit = float(max(clip_limit * ky * kx / nbins, 1.0)) if clip_limit > 0 else 0.0
    inv_nbins = float(np.float32(1.0) / np.float32(nbins))
    omin, omax = get_dtype_range(out_dtype)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if path == "pair":
            err = lib.clahe_pair_launch(src.data_ptr(), out.data_ptr(), n, sy, sx, ky, kx, limit, inv_nbins,
                                        float(omin), float(omax - omin), pairs, stream)
        else:
            err = lib.clahe_launch(
                src.data_ptr(), CODES[src.dtype], out.data_ptr(), CODES[out_dtype],
                None if work is None else work.data_ptr(), _WORK_BLOCKS, n, sy, sx, ky, kx, nbins,
                int(int_input), in_min, in_inv, limit, inv_nbins, float(omin), float(omax - omin), stream,
            )
    if err:
        raise RuntimeError(f"clahe launch failed ({path} kernel): cudaError_t {err}")
    clahe.launches += 1
    clahe.mode_launches[path] += 1
    return out


clahe.launches = 0
clahe.mode_launches = {"pair": 0, "block": 0}


def adaptive_histogram_equalization(
    patterns,
    kernel_size: tuple[int, int] | None = None,
    clip_limit: float = 0.0,
    nbins: int = 128,
    dtype_out=None,
    chunk: int = 512,
    device=None,
) -> torch.Tensor:
    """CLAHE each pattern and rescale to the output dtype range.

    Default ``kernel_size`` is a quarter of the signal shape, 128 bins,
    ``clip_limit=0`` (no contrast limiting); ``chunk`` bounds the plain
    version's ``(chunk, n_tiles, sy * sx)`` intermediate
    (``kikuchipy_tpu/ops/ahe.py:adaptive_histogram_equalization``).
    """
    patterns = as_tensor(patterns, resolve_device(device))
    dtype_out = numpy_dtype(patterns.dtype if dtype_out is None else dtype_out)
    sy, sx = patterns.shape[-2:]
    if kernel_size is None:
        kernel_size = (max(sy // 4, 1), max(sx // 4, 1))
    ky, kx = (int(k) for k in kernel_size)
    return clahe(patterns, ky, kx, int(nbins), float(clip_limit), dtype_out, int(chunk))
