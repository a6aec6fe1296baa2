"""What the preprocessing kernels share: the Python side of
``csrc/pattern_io.cuh``.

Kernel D (:mod:`~kikuchipy_tpu_torch.ops.background`) and kernel E
(:mod:`~kikuchipy_tpu_torch.ops.ahe`) read and write the storage types of
:data:`CODES`, by the codes their CUDA sources use, and take at most
:data:`SMEM_BUDGET` bytes of shared memory a block. The min/max rescale
helpers are the plain versions' own and :mod:`~kikuchipy_tpu_torch.ops.pattern`'s.
"""

from __future__ import annotations

import torch

__all__ = ["CODES", "SMEM_BUDGET", "check_storage", "remove_and_rescale", "rescale_with_min_max", "sig_max",
           "sig_min"]

_SIG_AXES = (-2, -1)
# Storage types kernels D and E read and write, by their type codes
# (csrc/pattern_io.cuh Code).
CODES = {torch.uint8: 0, torch.int8: 1, torch.uint16: 2, torch.int16: 3, torch.int32: 4, torch.float32: 5,
         torch.float64: 6}
# Shared memory a block of kernel D or E may take: a Hopper SM's 227 KB less
# the kernels' own static reduction buffer and a margin.
SMEM_BUDGET = 227 * 1024 - 1024


def check_storage(kernel: str, dtype_in: torch.dtype, dtype_out: torch.dtype) -> None:
    """Raise ``TypeError`` unless ``kernel`` reads ``dtype_in`` and writes
    ``dtype_out``."""
    if dtype_in not in CODES or dtype_out not in CODES:
        raise TypeError(f"{kernel} reads and writes {sorted(str(t) for t in CODES)}, got {dtype_in} -> {dtype_out}")


def sig_min(p: torch.Tensor) -> torch.Tensor:
    return torch.amin(p, dim=_SIG_AXES, keepdim=True)


def sig_max(p: torch.Tensor) -> torch.Tensor:
    return torch.amax(p, dim=_SIG_AXES, keepdim=True)


def rescale_with_min_max(pattern, imin, imax, omin, omax):
    """``(p - imin) / (imax - imin) * (omax - omin) + omin`` in the
    reference's op order."""
    rescaled = (pattern - imin) / (imax - imin)
    return rescaled * (omax - omin) + omin


def remove_and_rescale(patterns, background, operation: str, omin: float, omax: float):
    """Subtract or divide out a background, then per-pattern min/max
    rescale to ``[omin, omax]`` (``kikuchipy_tpu/ops/pattern.py:_remove_background``)."""
    if operation == "subtract":
        patterns = patterns - background
    elif operation == "divide":
        patterns = patterns / background
    else:
        raise ValueError(f"operation must be 'subtract' or 'divide', got {operation!r}")
    return rescale_with_min_max(patterns, sig_min(patterns), sig_max(patterns), omin, omax)
