"""Barnes frequency-domain filtering as two dense matrix products.

The Barnes pipeline (replicate-pad -> circular FFT convolution -> offset
crop) is linear and, for a rank-1 window, separable per axis; each axis
folds into one small dense operator built on the host in float64
(``kikuchipy_tpu/ops/fft_barnes.py:SeparableFilterPlan``). On the device
the filter is two float32 matrix products per pattern.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.fft import next_fast_len

from kikuchipy_tpu_torch.utils.device import matmul_precision

__all__ = ["FFTFilterPlan", "SeparableFilterPlan", "separable_filter"]


class FFTFilterPlan:
    """Geometry of the Barnes FFT filter: padded FFT shape and the
    pad/crop offsets (the reference's ``filters/fft_barnes.py:97-177``)."""

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
