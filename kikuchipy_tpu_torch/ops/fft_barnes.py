"""Barnes FFT image filtering (frequency-domain convolution with
replicated-edge padding), batched over patterns.

:func:`barnes_fft_filter` pads each pattern with the reference's replicate
layout, multiplies its real FFT by the window's transfer function
(computed once on the host by :class:`FFTFilterPlan`), inverse-transforms
and crops (``kikuchipy_tpu/ops/fft_barnes.py``). The JAX package leaves these
FFTs to XLA, outside any Pallas kernel; here they are ``torch.fft``.

The pipeline is linear and, for a rank-1 window, separable per axis; each
axis folds into one small dense operator built on the host in float64
(:class:`SeparableFilterPlan`), so the filter is two float32 matrix
products per pattern (:func:`separable_filter`). Dynamic background
removal runs that product inside kernel D (``ops/background.py``).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.fft import next_fast_len, rfft2

from kikuchipy_tpu_torch.utils.device import as_tensor, matmul_precision, resolve_device

__all__ = ["FFTFilterPlan", "SeparableFilterPlan", "barnes_fft_filter", "fft_filter_setup", "separable_filter"]


class FFTFilterPlan:
    """Plan of the Barnes FFT filter: the padded FFT shape, the window's
    transfer function (the rFFT of the flipped window in the padded array's
    corner, complex64 NumPy) and the pad/crop offsets."""

    def __init__(self, image_shape: tuple[int, int], window: np.ndarray) -> None:
        window = np.asarray(window, dtype=np.float64)
        wy, wx = window.shape
        iy, ix = image_shape
        self.image_shape = (int(iy), int(ix))
        self.window_shape = (int(wy), int(wx))
        self.fft_shape = (
            next_fast_len(iy + wy - 1, real=True),
            next_fast_len(ix + wx - 1, real=True),
        )
        window_pad = np.zeros(self.fft_shape, dtype=np.float32)
        window_pad[:wy, :wx] = np.flipud(np.fliplr(window))
        self.transfer_function = np.asarray(rfft2(window_pad))
        self.offset_before = (wy - (wy - 1) // 2 - 1, wx - (wx - 1) // 2 - 1)
        self.offset_after = ((wy - 1) // 2, (wx - 1) // 2)


class SeparableFilterPlan:
    """Dense-matmul formulation of the Barnes filter for a rank-1
    window: ``out = R @ pattern @ C.T`` (float32 operators)."""

    def __init__(self, image_shape: tuple[int, int], window: np.ndarray):
        window = np.asarray(window, dtype=np.float64)
        u, s, vt = np.linalg.svd(window)
        if window.ndim != 2 or (s.size > 1 and s[1] > 1e-12 * s[0]):
            raise ValueError("SeparableFilterPlan requires a rank-1 window")
        ky = u[:, 0] * s[0]
        kx = vt[0]
        self.image_shape = tuple(int(v) for v in image_shape)
        plan = FFTFilterPlan(image_shape, window)
        self.fft_shape = plan.fft_shape

        def axis_operator(n, f, kernel, n_last, n_first, crop0):
            w = kernel.shape[0]
            pad = np.zeros((f, n))
            pad[np.arange(n), np.arange(n)] = 1.0
            pad[n : n + n_last, n - 1] = 1.0
            if n_first:
                pad[f - n_first :, 0] = 1.0
            # Circular convolution with the flipped kernel at the start
            # of the padded axis (the rfft product with the padded
            # window's transfer function).
            kern_pad = np.zeros(f)
            kern_pad[:w] = kernel[::-1]
            i = np.arange(f)
            circ = kern_pad[(i[:, None] - i[None, :]) % f]
            return (circ @ pad)[crop0 : crop0 + n]

        (iy, ix), (fy, fx) = self.image_shape, plan.fft_shape
        wy, wx = plan.window_shape
        oy_b, ox_b = plan.offset_before
        oy_a, ox_a = plan.offset_after
        self.row_op = np.asarray(
            axis_operator(iy, fy, ky, (wy - 1) // 2, oy_b, oy_a), dtype=np.float32
        )
        self.col_op = np.asarray(
            axis_operator(ix, fx, kx, (wx - 1) // 2, ox_b, ox_a), dtype=np.float32
        )


def separable_filter(
    patterns: torch.Tensor, row_op: torch.Tensor, col_op: torch.Tensor
) -> torch.Tensor:
    """Apply a :class:`SeparableFilterPlan`: ``row_op @ p @ col_op.T`` per
    pattern, in IEEE float32 (the JAX package uses
    ``Precision.HIGHEST``); the caller's TF32 flags are restored after."""
    x = patterns.to(torch.float32)
    with matmul_precision(False):
        return torch.matmul(torch.matmul(row_op, x), col_op.T)


def fft_filter_setup(image_shape: tuple[int, int], window: np.ndarray) -> FFTFilterPlan:
    """Build an :class:`FFTFilterPlan` for filtering ``image_shape``
    patterns with ``window``."""
    return FFTFilterPlan(image_shape, window)


def _replicate_pad_axis(x: torch.Tensor, axis: int, total: int, n_last: int, n_first: int) -> torch.Tensor:
    """Pad ``x`` along ``axis`` to length ``total`` with the layout
    ``[x, last-slice * n_last, zeros, first-slice * n_first]``."""
    n = x.shape[axis]
    n_zero = total - n - n_last - n_first
    parts = [x]
    if n_last > 0:
        parts.append(x.narrow(axis, n - 1, 1).repeat_interleave(n_last, dim=axis))
    if n_zero > 0:
        shape = list(x.shape)
        shape[axis] = n_zero
        parts.append(x.new_zeros(shape))
    if n_first > 0:
        parts.append(x.narrow(axis, 0, 1).repeat_interleave(n_first, dim=axis))
    return torch.cat(parts, dim=axis)


def _barnes_filter_impl(patterns: torch.Tensor, transfer_function: torch.Tensor, fft_shape: tuple[int, int],
                        window_shape: tuple[int, int], offsets: tuple[int, int, int, int]) -> torch.Tensor:
    oy_b, ox_b, oy_a, ox_a = offsets
    wy, wx = window_shape
    iy, ix = patterns.shape[-2], patterns.shape[-1]
    x = patterns.to(torch.float32)
    # Rows, then columns: padding in sequence gives the corner fills of the
    # reference's _pad_image.
    x = _replicate_pad_axis(x, -2, fft_shape[0], (wy - 1) // 2, oy_b)
    x = _replicate_pad_axis(x, -1, fft_shape[1], (wx - 1) // 2, ox_b)
    x_fft = torch.fft.rfft2(x, dim=(-2, -1))
    out = torch.fft.irfft2(x_fft * transfer_function, s=fft_shape, dim=(-2, -1))
    return out[..., oy_a : oy_a + iy, ox_a : ox_a + ix]


def barnes_fft_filter(patterns, plan: FFTFilterPlan, device=None) -> torch.Tensor:
    """Filter a batch of patterns ``(..., sy, sx)`` with a precomputed
    plan. Returns float32 patterns of the same shape."""
    patterns = as_tensor(patterns, resolve_device(device))
    tf = torch.as_tensor(plan.transfer_function, device=patterns.device)
    return _barnes_filter_impl(patterns, tf, plan.fft_shape, plan.window_shape, plan.offset_before + plan.offset_after)
