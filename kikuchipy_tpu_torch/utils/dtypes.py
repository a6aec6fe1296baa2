"""Intensity ranges of image dtypes: integer dtypes map to their full
range, floating dtypes to ``(-1, 1)`` (``skimage.util.dtype.dtype_range``
as the reference kikuchipy uses it)."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["dtype_range", "get_dtype_range", "numpy_dtype", "torch_dtype"]

_FLOAT_RANGE = (-1.0, 1.0)

dtype_range: dict[type, tuple[float, float]] = {
    np.bool_: (False, True),
    np.uint8: (0, 255),
    np.uint16: (0, 65535),
    np.uint32: (0, 2**32 - 1),
    np.uint64: (0, 2**64 - 1),
    np.int8: (-128, 127),
    np.int16: (-32768, 32767),
    np.int32: (-(2**31), 2**31 - 1),
    np.int64: (-(2**63), 2**63 - 1),
    np.float16: _FLOAT_RANGE,
    np.float32: _FLOAT_RANGE,
    np.float64: _FLOAT_RANGE,
}

_TORCH_TO_NUMPY = {
    torch.bool: np.bool_,
    torch.uint8: np.uint8,
    torch.uint16: np.uint16,
    torch.uint32: np.uint32,
    torch.uint64: np.uint64,
    torch.int8: np.int8,
    torch.int16: np.int16,
    torch.int32: np.int32,
    torch.int64: np.int64,
    torch.float16: np.float16,
    torch.float32: np.float32,
    torch.float64: np.float64,
}
_NUMPY_TO_TORCH = {np.dtype(v): k for k, v in _TORCH_TO_NUMPY.items()}


def numpy_dtype(dtype) -> np.dtype:
    """A NumPy dtype from a NumPy or torch dtype (or a name)."""
    if isinstance(dtype, torch.dtype):
        return np.dtype(_TORCH_TO_NUMPY[dtype])
    return np.dtype(dtype)


def torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a NumPy or torch dtype (or a name)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _NUMPY_TO_TORCH[np.dtype(dtype)]


def get_dtype_range(dtype) -> tuple[float, float]:
    """Return the output intensity range ``(omin, omax)`` for ``dtype``.

    Raises
    ------
    KeyError
        If the dtype is not a recognized image dtype.
    """
    dt = numpy_dtype(dtype)
    try:
        return dtype_range[dt.type]
    except KeyError:
        raise KeyError(
            f"Could not set output intensity range, since data type '{dt}' is "
            f"not recognised. Use any of '{list(dtype_range)}'."
        )
