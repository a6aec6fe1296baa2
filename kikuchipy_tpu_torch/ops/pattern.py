"""Batched EBSD pattern operations on tensors.

Every function takes a batch of patterns ``(..., sy, sx)`` and works in
float32 with integer storage dtypes at the edges, in the op order of
``kikuchipy_tpu/ops/pattern.py`` (itself the reference kikuchipy's
order), so integer outputs agree with the JAX package to the last gray
level but for float round-off at integer boundaries.

Public functions take ``device=None`` (the card); pass ``device="cpu"``
to run on the CPU.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from kikuchipy_tpu_torch.filters.window import gaussian_window_2d
from kikuchipy_tpu_torch.ops.fft_barnes import SeparableFilterPlan, separable_filter
from kikuchipy_tpu_torch.utils.device import as_tensor, resolve_device
from kikuchipy_tpu_torch.utils.dtypes import get_dtype_range, numpy_dtype, torch_dtype

__all__ = [
    "rescale_intensity",
    "remove_static_background",
    "remove_dynamic_background",
    "get_dynamic_background",
    "dynamic_background_separable_plan",
]

_SIG_AXES = (-2, -1)


def _sig_min(p: torch.Tensor) -> torch.Tensor:
    return torch.amin(p, dim=_SIG_AXES, keepdim=True)


def _sig_max(p: torch.Tensor) -> torch.Tensor:
    return torch.amax(p, dim=_SIG_AXES, keepdim=True)


def _rescale_with_min_max(pattern, imin, imax, omin, omax):
    """``(p - imin) / (imax - imin) * (omax - omin) + omin`` in the
    reference's op order."""
    rescaled = (pattern - imin) / (imax - imin)
    return rescaled * (omax - omin) + omin


def _out_range(dtype_out, out_range):
    if out_range is None:
        return get_dtype_range(dtype_out)
    return out_range


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
        in_range = (float(patterns.min()), float(patterns.max()))
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
        imin, imax = _sig_min(patterns), _sig_max(patterns)
    if isinstance(imin, torch.Tensor):
        imin, imax = imin.to(torch.float32), imax.to(torch.float32)

    omin, omax = _out_range(dtype_out, out_range)
    out = _rescale_with_min_max(
        patterns.to(torch.float32), imin, imax, float(omin), float(omax)
    )
    return out.to(torch_dtype(dtype_out))


def _remove_background(patterns, background, operation: str, omin: float, omax: float):
    """Subtract or divide out a background, then per-pattern min/max
    rescale to ``[omin, omax]``."""
    if operation == "subtract":
        patterns = patterns - background
    elif operation == "divide":
        patterns = patterns / background
    else:
        raise ValueError(f"operation must be 'subtract' or 'divide', got {operation!r}")
    return _rescale_with_min_max(patterns, _sig_min(patterns), _sig_max(patterns), omin, omax)


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
    each pattern to the output dtype range
    (``kikuchipy_tpu/ops/pattern.py:remove_static_background``)."""
    dev = resolve_device(device)
    patterns = as_tensor(patterns, dev)
    dtype_out = numpy_dtype(patterns.dtype if dtype_out is None else dtype_out)
    omin, omax = _out_range(dtype_out, out_range)

    p = patterns.to(torch.float32)
    bg = as_tensor(static_bg, dev, torch.float32)
    if scale_bg:
        bg = _rescale_with_min_max(bg, bg.min(), bg.max(), _sig_min(p), _sig_max(p))
    out = _remove_background(p, bg, operation, float(omin), float(omax))
    return out.to(torch_dtype(dtype_out))


@lru_cache(maxsize=16)
def dynamic_background_separable_plan(
    sig_shape: tuple[int, int], std: float, truncate: float = 4.0
) -> SeparableFilterPlan:
    """Separable dense-matmul plan of the frequency-domain Gaussian blur
    used for dynamic background estimation."""
    return SeparableFilterPlan(sig_shape, gaussian_window_2d(std, truncate))


def _frequency_blur(p32: torch.Tensor, std: float, truncate: float) -> torch.Tensor:
    """The reference's frequency-domain Gaussian blur as two float32
    matrix products per pattern."""
    plan = dynamic_background_separable_plan(tuple(p32.shape[-2:]), std, truncate)
    row_op = torch.as_tensor(plan.row_op, device=p32.device)
    col_op = torch.as_tensor(plan.col_op, device=p32.device)
    return separable_filter(p32, row_op, col_op)


def _blur(p32: torch.Tensor, filter_domain: str, std: float, truncate: float) -> torch.Tensor:
    if filter_domain == "frequency":
        return _frequency_blur(p32, std, truncate)
    if filter_domain == "spatial":
        raise NotImplementedError(
            "filter_domain='spatial' is not ported yet (see ROADMAP.md, "
            "queue A); use filter_domain='frequency'"
        )
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
    in the frequency domain. Preserves dtype."""
    patterns = as_tensor(patterns, resolve_device(device))
    if std is None:
        std = patterns.shape[-1] / 8
    bg = _blur(patterns.to(torch.float32), filter_domain, float(std), float(truncate))
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
    rescale to the output dtype range
    (``kikuchipy_tpu/ops/pattern.py:remove_dynamic_background``)."""
    patterns = as_tensor(patterns, resolve_device(device))
    if std is None:
        std = patterns.shape[-1] / 8
    dtype_out = numpy_dtype(patterns.dtype if dtype_out is None else dtype_out)
    omin, omax = _out_range(dtype_out, out_range)
    p32 = patterns.to(torch.float32)
    bg = _blur(p32, filter_domain, float(std), float(truncate))
    out = _remove_background(p32, bg, operation, float(omin), float(omax))
    return out.to(torch_dtype(dtype_out))
