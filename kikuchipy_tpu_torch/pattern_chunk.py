"""kikuchipy's ``kikuchipy.pattern.chunk`` functions over the batched
operations of :mod:`kikuchipy_tpu_torch.ops.pattern`.

kikuchipy loops per-pattern functions over NumPy chunks for Dask's
``map_blocks``; here the operations take the whole batch, so these wrappers
call them on ``device`` (``None`` is the card) and return NumPy arrays, as
the JAX package's ``pattern_chunk`` does.
"""

from __future__ import annotations

import numpy as np

from kikuchipy_tpu_torch.utils.device import host_array

__all__ = ["get_dynamic_background", "fft_filter"]


def get_dynamic_background(
    patterns: np.ndarray,
    filter_func=None,
    dtype_out=None,
    device=None,
    **kwargs,
) -> np.ndarray:
    """Dynamic backgrounds of a chunk of patterns (reference
    ``pattern/chunk.py:33``). ``filter_func`` is accepted for signature
    compatibility; the frequency-domain (Barnes rFFT) path is used, with
    ``std``/``truncate`` keywords honored.
    """
    from kikuchipy_tpu_torch.ops.pattern import get_dynamic_background as _batched

    patterns = host_array(patterns)
    if dtype_out is None:
        dtype_out = patterns.dtype
    out = host_array(_batched(patterns, device=device, **kwargs))
    return out.astype(dtype_out)


def fft_filter(
    patterns: np.ndarray,
    filter_func=None,
    transfer_function=None,
    dtype_out=None,
    device=None,
    **kwargs,
) -> np.ndarray:
    """FFT-filter a chunk of patterns (reference ``pattern/chunk.py:75``)."""
    from kikuchipy_tpu_torch.ops.pattern import fft_filter as _batched

    patterns = host_array(patterns)
    if dtype_out is None:
        dtype_out = patterns.dtype
    if transfer_function is None:
        transfer_function = kwargs.pop("transfer_function")
    out = host_array(_batched(patterns, transfer_function, device=device, **kwargs))
    return out.astype(dtype_out)
