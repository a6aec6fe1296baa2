"""Navigator images for map plotting (kikuchipy's
``draw/_navigators.py:27``; a copy of ``kikuchipy_tpu/draw/navigators.py``)."""

from __future__ import annotations

import numpy as np

__all__ = ["get_rgb_navigator"]


def get_rgb_navigator(image: np.ndarray, dtype=np.uint8) -> np.ndarray:
    """Normalize an ``(ny, nx, 3)`` RGB array into a navigator image of
    the requested integer dtype."""
    image = np.asarray(image, dtype=np.float64)
    mn, mx = np.nanmin(image), np.nanmax(image)
    out = (image - mn) / (mx - mn) * np.iinfo(np.dtype(dtype)).max
    return out.astype(dtype)
