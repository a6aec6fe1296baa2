"""EDAX TSL binary ``.up1``/``.up2`` pattern file reader
(``kikuchipy_tpu/io/plugins/edax_binary.py``).

The format (kikuchipy's ``edax_binary/_api.py``): a little-endian header
``(version, sx, sy, pattern_offset)`` as uint32, with version >= 3 adding
``(nx, ny)`` (after one skipped byte), a hexagonal-grid flag and float64
step sizes; patterns are raw uint8 (.up1) or uint16 (.up2).
"""

from __future__ import annotations

import warnings
from pathlib import Path

import numpy as np

from kikuchipy_tpu_torch.signals.ebsd import EBSD
from kikuchipy_tpu_torch.utils.device import resolve_device
from kikuchipy_tpu_torch.utils.staging import to_device

__all__ = ["file_reader"]


def file_reader(filename: str | Path, lazy: bool = False, device=None):
    """Read an EDAX binary scan: an :class:`EBSD` on ``device`` (None: the
    card), or with ``lazy=True`` a :class:`~kikuchipy_tpu_torch.signals.
    lazy.LazyEBSD` over a memory map of the patterns."""
    device = resolve_device(device)
    filename = Path(filename)
    ext = filename.suffix.lower().lstrip(".")
    dtype = {"up1": np.uint8, "up2": np.uint16}[ext]

    with open(filename, "rb") as f:
        version = np.fromfile(f, "uint32", 1)[0]
        if version == 2:
            raise ValueError("Only files with version 1 or >= 3, not 2, can be read")
        sx, sy, pattern_offset = np.fromfile(f, "uint32", 3)
        file_size = filename.stat().st_size
        itemsize = np.dtype(dtype).itemsize
        metadata: dict = {"version": int(version)}
        if version == 1:
            nav_shape = (int((file_size - pattern_offset) // (sx * sy * itemsize)),)
        else:
            nx, ny = np.fromfile(f, "uint32", 2, offset=1)
            if bool(np.fromfile(f, "uint8", 1)[0]):
                warnings.warn("Returned signal has one navigation dimension since an hexagonal grid is not supported")
                nav_shape = (int((file_size - pattern_offset) // (sx * sy * itemsize)),)
            else:
                nav_shape = (int(ny), int(nx))
            dx, dy = np.fromfile(f, "float64", 2)
            metadata.update(step_x=float(dx), step_y=float(dy))

    count = int(np.prod(nav_shape)) * int(sx) * int(sy)
    # Patterns page in only when they are copied.
    data = np.memmap(filename, dtype=dtype, mode="r", offset=int(pattern_offset), shape=(count,))
    data = data.reshape(nav_shape + (int(sy), int(sx)))
    if lazy:
        from kikuchipy_tpu_torch.signals.lazy import ArraySource, LazyEBSD

        return LazyEBSD(source=ArraySource(data, nav_shape), metadata=metadata, device=device)
    return EBSD(data=to_device(data, device), metadata=metadata, device=device)
