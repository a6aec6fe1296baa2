"""Per-pattern processing functions (kikuchipy's ``kikuchipy.pattern``
namespace; the batched operations of :mod:`kikuchipy_tpu_torch.ops.pattern`)."""

from kikuchipy_tpu_torch import pattern_chunk as chunk
from kikuchipy_tpu_torch.ops.pattern import (
    fft,
    fft_filter,
    fft_frequency_vectors,
    fft_spectrum,
    get_dynamic_background,
    get_image_quality,
    ifft,
    normalize_intensity,
    remove_dynamic_background,
    remove_static_background,
    rescale_intensity,
)

__all__ = [
    "fft",
    "fft_filter",
    "chunk",
    "fft_frequency_vectors",
    "fft_spectrum",
    "get_dynamic_background",
    "get_image_quality",
    "ifft",
    "normalize_intensity",
    "remove_dynamic_background",
    "remove_static_background",
    "rescale_intensity",
]
