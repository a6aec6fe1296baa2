"""Batched EBSD pattern operations on tensors.

Every function takes a batch of patterns ``(..., sy, sx)`` and works in
float32 with integer storage dtypes at the edges, in the op order of
``kikuchipy_tpu/ops/pattern.py`` (itself the reference kikuchipy's
order), so integer outputs agree with the JAX package to the last gray
level but for float round-off at integer boundaries.

Static and frequency-domain dynamic background removal run on kernel D
(:mod:`kikuchipy_tpu_torch.ops.background`): one launch for the batch on
the card, its plain version on the CPU. The spatial-domain blur, the FFT
tools, image quality and binning are PyTorch operations, as the JAX package
leaves them to XLA.

Public functions take ``device=None`` (the card); pass ``device="cpu"``
to run on the CPU.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from kikuchipy_tpu_torch.filters.window import gaussian_window_2d
from kikuchipy_tpu_torch.ops.background import remove_background
from kikuchipy_tpu_torch.ops.fft_barnes import FFTFilterPlan, SeparableFilterPlan, separable_filter
from kikuchipy_tpu_torch.ops.pattern_io import remove_and_rescale, rescale_with_min_max, sig_max, sig_min
from kikuchipy_tpu_torch.utils.device import as_tensor, constant_tensor, resolve_device
from kikuchipy_tpu_torch.utils.dtypes import get_dtype_range, numpy_dtype, torch_dtype

__all__ = [
    "rescale_intensity",
    "normalize_intensity",
    "remove_static_background",
    "remove_dynamic_background",
    "get_dynamic_background",
    "fft",
    "ifft",
    "fft_spectrum",
    "fft_filter",
    "fft_frequency_vectors",
    "get_image_quality",
    "bin2d",
    "downsample",
    "dynamic_background_plan",
    "dynamic_background_separable_plan",
]

_SIG_AXES = (-2, -1)


def _out_range(dtype_out, out_range):
    if out_range is None:
        return get_dtype_range(dtype_out)
    return out_range


def _comparable(patterns: torch.Tensor) -> torch.Tensor:
    """``patterns`` as a type that ``amin`` / ``amax`` take (PyTorch has no
    min or max of uint16), holding the same values."""
    return patterns.to(torch.int32) if patterns.dtype == torch.uint16 else patterns


def rescale_intensity(
    patterns,
    in_range: tuple[float, float] | None = None,
    out_range: tuple[float, float] | None = None,
    dtype_out=None,
    percentiles: tuple[float, float] | None = None,
    relative: bool = False,
    device=None,
) -> torch.Tensor:
    """Rescale pattern intensities (per pattern) to a target range
    (``kikuchipy_tpu/ops/pattern.py:rescale_intensity``)."""
    patterns = as_tensor(patterns, resolve_device(device))
    if in_range is not None and percentiles is not None:
        raise ValueError("'percentiles' must be None if 'in_range' is not None")
    if relative and in_range is not None:
        raise ValueError("'in_range' must be None if 'relative' is True")
    if relative:
        in_range = (float(_comparable(patterns).min()), float(_comparable(patterns).max()))
    dtype_out = numpy_dtype(patterns.dtype if dtype_out is None else dtype_out)

    if percentiles is not None:
        flat = patterns.to(torch.float32).flatten(-2)
        q = torch.tensor(
            [percentiles[0] / 100, percentiles[1] / 100], device=patterns.device
        )
        lims = torch.quantile(flat, q, dim=-1)[..., None, None]
        imin, imax = lims[0], lims[1]
        patterns = torch.clamp(patterns.to(torch.float32), imin, imax)
    elif in_range is not None:
        imin, imax = in_range
        patterns = torch.clamp(patterns.to(torch.float32), float(imin), float(imax))
    else:
        imin, imax = sig_min(_comparable(patterns)), sig_max(_comparable(patterns))
    if isinstance(imin, torch.Tensor):
        imin, imax = imin.to(torch.float32), imax.to(torch.float32)

    omin, omax = _out_range(dtype_out, out_range)
    out = rescale_with_min_max(
        patterns.to(torch.float32), imin, imax, float(omin), float(omax)
    )
    return out.to(torch_dtype(dtype_out))


def normalize_intensity(
    patterns,
    num_std: float = 1,
    divide_by_square_root: bool = False,
    dtype_out=None,
    device=None,
) -> torch.Tensor:
    """Normalize each pattern to zero mean and ``1 / num_std`` standard
    deviation (optionally scaled by ``1 / sqrt(n_pixels)``), cast to
    ``dtype_out`` (the input's dtype by default, truncating toward zero)
    (``kikuchipy_tpu/ops/pattern.py:normalize_intensity``)."""
    patterns = as_tensor(patterns, resolve_device(device))
    p = patterns if patterns.dtype.is_floating_point else patterns.to(torch.float32)
    mean = torch.mean(p, dim=_SIG_AXES, keepdim=True)
    std = torch.std(p, dim=_SIG_AXES, keepdim=True, correction=0)
    centered = p - mean
    denom = num_std * std
    if divide_by_square_root:
        n = patterns.shape[-1] * patterns.shape[-2]
        denom = denom * float(np.sqrt(float(n)))
    out = centered / denom
    if dtype_out is None:
        dtype_out = patterns.dtype
    return out.to(torch_dtype(dtype_out))


def remove_static_background(
    patterns,
    static_bg,
    operation: str = "subtract",
    scale_bg: bool = False,
    dtype_out=None,
    out_range: tuple[float, float] | None = None,
    device=None,
) -> torch.Tensor:
    """Remove a shared static background from each pattern, then rescale
    each pattern to the output dtype range: one launch of kernel D on the
    card (``kikuchipy_tpu/ops/pattern.py:remove_static_background``)."""
    dev = resolve_device(device)
    patterns = as_tensor(patterns, dev)
    dtype_out = numpy_dtype(patterns.dtype if dtype_out is None else dtype_out)
    omin, omax = _out_range(dtype_out, out_range)
    bg = constant_tensor(static_bg, dev, torch.float32)
    return remove_background(patterns, operation, omin, omax, dtype_out, static_bg=bg, scale_bg=scale_bg)


# ------------------------- Dynamic background ------------------------- #


@lru_cache(maxsize=16)
def dynamic_background_plan(sig_shape: tuple[int, int], std: float, truncate: float = 4.0) -> FFTFilterPlan:
    """FFT plan of the frequency-domain Gaussian blur of dynamic background
    estimation."""
    return FFTFilterPlan(tuple(sig_shape), gaussian_window_2d(std, truncate))


@lru_cache(maxsize=16)
def dynamic_background_separable_plan(
    sig_shape: tuple[int, int], std: float, truncate: float = 4.0
) -> SeparableFilterPlan:
    """Separable dense-matmul plan of the frequency-domain Gaussian blur
    used for dynamic background estimation."""
    return SeparableFilterPlan(sig_shape, gaussian_window_2d(std, truncate))


def _separable_operators(sig_shape, std: float, truncate: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    plan = dynamic_background_separable_plan(tuple(sig_shape), std, truncate)
    return constant_tensor(plan.row_op, device), constant_tensor(plan.col_op, device)


def _frequency_blur(p32: torch.Tensor, std: float, truncate: float) -> torch.Tensor:
    """The reference's frequency-domain Gaussian blur as two float32
    matrix products per pattern."""
    return separable_filter(p32, *_separable_operators(p32.shape[-2:], std, truncate, p32.device))


def _gaussian_kernel_1d(sigma: float, truncate: float) -> np.ndarray:
    """scipy.ndimage-compatible 1D Gaussian kernel."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _reflect_indices(n: int, radius: int) -> np.ndarray:
    """Index map implementing scipy.ndimage's 'reflect' boundary
    (symmetric, repeated) for positions ``[-radius, n + radius)``."""
    p = np.arange(-radius, n + radius)
    q = np.mod(p, 2 * n)
    return np.where(q >= n, 2 * n - 1 - q, q)


def _gaussian_blur_spatial(patterns: torch.Tensor, sigma: float, truncate: float, quantize_dtype=None) -> torch.Tensor:
    """Separable Gaussian blur with ``reflect`` (symmetric, repeated)
    boundary, equivalent to ``scipy.ndimage.gaussian_filter``.

    Each 1D pass is a sum over the taps of shifted slices times the tap's
    float32 weight, taken in float64: the passes are elementwise products, so no cuDNN convolution (and its TF32
    default) is involved. ``quantize_dtype``: for integer inputs the
    reference calls scipy on the raw integer array, which computes each
    pass in float64 and truncates it to the integer dtype; passing the
    storage dtype reproduces that, truncating the float64 sum, so a sum
    within float32 rounding of an integer falls on scipy's side of it.
    Without it each pass is rounded to float32."""
    kernel = _gaussian_kernel_1d(sigma, truncate)
    radius = kernel.shape[0] // 2
    x = patterns.to(torch.float32)
    sy, sx = x.shape[-2:]
    dev = x.device
    x = x.index_select(-2, torch.as_tensor(_reflect_indices(sy, radius), device=dev))
    x = x.index_select(-1, torch.as_tensor(_reflect_indices(sx, radius), device=dev))
    weights = [float(w) for w in kernel]

    def one_pass(img, axis, n):
        img = img.to(torch.float64)
        acc = img.narrow(axis, 0, n) * weights[0]
        for k in range(1, len(weights)):
            acc = acc + img.narrow(axis, k, n) * weights[k]
        if quantize_dtype is not None:
            acc = acc.to(torch_dtype(quantize_dtype))
        return acc.to(torch.float32)

    x = one_pass(x, -2, sy)
    return one_pass(x, -1, sx)


def _blur(p32: torch.Tensor, filter_domain: str, std: float, truncate: float, quantize_dtype=None) -> torch.Tensor:
    if filter_domain == "frequency":
        return _frequency_blur(p32, std, truncate)
    if filter_domain == "spatial":
        return _gaussian_blur_spatial(p32, std, truncate, quantize_dtype)
    raise ValueError(
        f"filter_domain must be 'frequency' or 'spatial', got {filter_domain!r}"
    )


def get_dynamic_background(
    patterns,
    filter_domain: str = "frequency",
    std: float | None = None,
    truncate: float = 4.0,
    device=None,
) -> torch.Tensor:
    """Per-pattern dynamic (low-frequency) background by a Gaussian blur
    in the frequency or spatial domain. Preserves dtype. In the spatial
    domain an integer input is truncated to its dtype between the two
    passes, as the reference's scipy call on the raw array does."""
    patterns = as_tensor(patterns, resolve_device(device))
    if std is None:
        std = patterns.shape[-1] / 8
    qdt = None if patterns.dtype.is_floating_point else patterns.dtype
    bg = _blur(patterns.to(torch.float32), filter_domain, float(std), float(truncate), qdt)
    return bg.to(patterns.dtype)


def remove_dynamic_background(
    patterns,
    operation: str = "subtract",
    filter_domain: str = "frequency",
    std: float | None = None,
    truncate: float = 4.0,
    dtype_out=None,
    out_range: tuple[float, float] | None = None,
    device=None,
) -> torch.Tensor:
    """Remove each pattern's own blurred version (dynamic background) and
    rescale to the output dtype range: in the frequency domain one launch
    of kernel D on the card, in the spatial domain PyTorch operations
    (``kikuchipy_tpu/ops/pattern.py:remove_dynamic_background``)."""
    patterns = as_tensor(patterns, resolve_device(device))
    if std is None:
        std = patterns.shape[-1] / 8
    dtype_out = numpy_dtype(patterns.dtype if dtype_out is None else dtype_out)
    omin, omax = _out_range(dtype_out, out_range)
    if filter_domain == "frequency":
        row_op, col_op = _separable_operators(patterns.shape[-2:], float(std), float(truncate), patterns.device)
        return remove_background(patterns, operation, omin, omax, dtype_out, row_op=row_op, col_op=col_op)
    p32 = patterns.to(torch.float32)
    bg = _blur(p32, filter_domain, float(std), float(truncate))
    out = remove_and_rescale(p32, bg, operation, float(omin), float(omax))
    return out.to(torch_dtype(dtype_out))


# ----------------------------- FFT tools ------------------------------ #


def fft(
    patterns,
    apodization_window=None,
    shift: bool = False,
    real_fft_only: bool = False,
    device=None,
) -> torch.Tensor:
    """2D FFT of patterns with optional apodization and fftshift
    (``kikuchipy_tpu/ops/pattern.py:fft``)."""
    p = as_tensor(patterns, resolve_device(device)).to(torch.float32)
    if apodization_window is not None:
        p = p * as_tensor(apodization_window, p.device, p.dtype)
    out = torch.fft.rfft2(p, dim=_SIG_AXES) if real_fft_only else torch.fft.fft2(p, dim=_SIG_AXES)
    if shift:
        out = torch.fft.fftshift(out, dim=_SIG_AXES)
    return out


def ifft(
    fft_patterns,
    shift: bool = False,
    real_fft_only: bool = False,
    device=None,
) -> torch.Tensor:
    """Real part of the inverse 2D FFT (``kikuchipy_tpu/ops/pattern.py:ifft``)."""
    f = as_tensor(fft_patterns, resolve_device(device))
    if shift:
        f = torch.fft.ifftshift(f, dim=_SIG_AXES)
    out = torch.fft.irfft2(f, dim=_SIG_AXES) if real_fft_only else torch.fft.ifft2(f, dim=_SIG_AXES)
    return torch.real(out)


def fft_spectrum(fft_patterns, device=None) -> torch.Tensor:
    """Magnitude spectrum ``sqrt(re^2 + im^2)``."""
    f = as_tensor(fft_patterns, resolve_device(device))
    return torch.sqrt(torch.real(f) ** 2 + torch.imag(f) ** 2)


def fft_filter(
    patterns,
    transfer_function,
    apodization_window=None,
    shift: bool = False,
    device=None,
) -> torch.Tensor:
    """Filter patterns in the frequency domain with a transfer function
    defined on the (optionally fft-shifted) full FFT spectrum; float64 input
    stays float64, anything else is float32
    (``kikuchipy_tpu/ops/pattern.py:fft_filter``)."""
    patterns = as_tensor(patterns, resolve_device(device))
    p = patterns.to(torch.float64 if patterns.dtype == torch.float64 else torch.float32)
    if apodization_window is not None:
        p = p * as_tensor(apodization_window, p.device, p.dtype)
    f = torch.fft.fft2(p, dim=_SIG_AXES)
    if shift:
        f = torch.fft.fftshift(f, dim=_SIG_AXES)
    tf = as_tensor(transfer_function, p.device)
    tf = tf.to(f.dtype if tf.is_complex() else p.dtype)
    f = f * tf
    if shift:
        f = torch.fft.ifftshift(f, dim=_SIG_AXES)
    return torch.real(torch.fft.ifft2(f, dim=_SIG_AXES))


def fft_frequency_vectors(shape: tuple[int, int]) -> np.ndarray:
    """Squared-frequency weights for the image-quality metric; host-side
    constant."""
    sy, sx = shape
    linex = np.arange(sx) + 1
    linex[sx // 2 :] -= sx + 1
    liney = np.arange(sy) + 1
    liney[sy // 2 :] -= sy + 1
    return liney[:, None] ** 2 + linex[None, :] ** 2 - 1


def get_image_quality(
    patterns,
    normalize: bool = True,
    frequency_vectors: np.ndarray | None = None,
    inertia_max: float | None = None,
    device=None,
) -> torch.Tensor:
    """Krieger Lassen image quality per pattern:
    ``1 - inertia(spectrum * freq_weights) / inertia_max``
    (``kikuchipy_tpu/ops/pattern.py:get_image_quality``)."""
    patterns = as_tensor(patterns, resolve_device(device)).to(torch.float32)
    if frequency_vectors is None:
        frequency_vectors = fft_frequency_vectors(patterns.shape[-2:])
    if inertia_max is None:
        sy, sx = patterns.shape[-2:]
        inertia_max = np.sum(frequency_vectors) / (sy * sx)
    if normalize:
        patterns = normalize_intensity(patterns, device=patterns.device)
    f = torch.fft.fft2(patterns, dim=_SIG_AXES)
    spectrum = torch.sqrt(torch.real(f) ** 2 + torch.imag(f) ** 2)
    fv = as_tensor(frequency_vectors, spectrum.device, spectrum.dtype)
    inertia = torch.sum(spectrum * fv, dim=_SIG_AXES) / torch.sum(spectrum, dim=_SIG_AXES)
    return 1 - inertia / float(inertia_max)


# ------------------------------ Binning ------------------------------- #


def bin2d(patterns, factor: int, device=None) -> torch.Tensor:
    """Sum-bin each pattern by an integer ``factor`` (the remainder rows and
    columns are dropped)."""
    patterns = as_tensor(patterns, resolve_device(device))
    sy, sx = patterns.shape[-2:]
    ny, nx = sy // factor, sx // factor
    lead = patterns.shape[:-2]
    p = patterns[..., : ny * factor, : nx * factor]
    p = p.reshape(lead + (ny, factor, nx, factor))
    return torch.sum(p, dim=(-3, -1))


def downsample(
    patterns,
    factor: int,
    dtype_out=None,
    out_range: tuple[float, float] | None = None,
    device=None,
) -> torch.Tensor:
    """Sum-bin then per-pattern rescale to the output dtype range
    (``kikuchipy_tpu/ops/pattern.py:downsample``)."""
    patterns = as_tensor(patterns, resolve_device(device))
    dtype_out = numpy_dtype(patterns.dtype if dtype_out is None else dtype_out)
    omin, omax = _out_range(dtype_out, out_range)
    binned = bin2d(patterns.to(torch.float32), factor, device=patterns.device)
    out = rescale_with_min_max(binned, sig_min(binned), sig_max(binned), float(omin), float(omax))
    return out.to(torch_dtype(dtype_out))
