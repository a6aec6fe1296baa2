"""Filter windows (host-side NumPy).

Only the Gaussian window of frequency-domain dynamic background removal
is ported so far; the named-window ``Window`` class of
``kikuchipy_tpu/filters/window.py`` waits (see ROADMAP.md).
"""

from __future__ import annotations

import numpy as np
from scipy.signal import get_window

__all__ = ["gaussian_window_2d"]


def gaussian_window_2d(std: float, truncate: float = 4.0) -> np.ndarray:
    """Normalized 2D Gaussian window of shape ``(int(truncate * std),) * 2``,
    as used for frequency-domain dynamic background estimation
    (``kikuchipy_tpu/filters/window.py:gaussian_window_2d``)."""
    n = int(truncate * std)
    w1 = get_window(("gaussian", std), n, fftbins=False)
    w = np.outer(w1, w1)
    w = w / (2 * np.pi * std**2)
    return w / np.sum(w)
