"""Filter windows (host-side NumPy)."""

from kikuchipy_tpu_torch.filters.window import (
    Window,
    distance_to_origin,
    highpass_fft_filter,
    lowpass_fft_filter,
    modified_hann,
)

__all__ = ["Window", "distance_to_origin", "highpass_fft_filter", "lowpass_fft_filter", "modified_hann"]
