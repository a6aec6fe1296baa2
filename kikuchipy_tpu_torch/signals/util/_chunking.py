"""Chunking policy helpers (``kikuchipy_tpu/signals/util/_chunking.py``),
API-compatible with kikuchipy's Dask utilities
(``signals/util/_dask.py``).

:func:`get_chunking` is Dask-free arithmetic: navigation axes chunked to
about ``chunk_bytes``, signal axes whole. :func:`get_dask_array` imports
Dask when called and raises ``ImportError`` where it is missing; out-of-core
scans are :class:`~kikuchipy_tpu_torch.signals.lazy.LazyEBSD` here.
"""

from __future__ import annotations

import math
import re

import numpy as np

from kikuchipy_tpu_torch.utils.dtypes import numpy_dtype

__all__ = ["get_chunking", "get_dask_array"]

_BYTE_UNITS = {
    "b": 1,
    "kb": 10**3,
    "mb": 10**6,
    "gb": 10**9,
    "tb": 10**12,
    "kib": 2**10,
    "mib": 2**20,
    "gib": 2**30,
    "tib": 2**40,
}


def _parse_bytes(limit: int | float | str) -> int:
    """Parse a byte limit like ``30e6``, ``"30 MB"`` or ``"30MiB"``."""
    if isinstance(limit, (int, float)):
        return int(limit)
    m = re.fullmatch(r"\s*([0-9.]+)\s*([A-Za-z]*)\s*", str(limit))
    if not m:
        raise ValueError(f"Cannot parse byte limit {limit!r}")
    value = float(m.group(1))
    unit = m.group(2).lower() or "b"
    if unit not in _BYTE_UNITS:
        raise ValueError(f"Unknown byte unit {m.group(2)!r} in {limit!r}")
    return int(value * _BYTE_UNITS[unit])


def _axis_chunks(length: int, size: int) -> tuple[int, ...]:
    """Split ``length`` into blocks of ``size`` (last block may be
    smaller), matching dask's chunk-tuple convention."""
    size = max(1, min(size, length))
    n_full, rem = divmod(length, size)
    return (size,) * n_full + ((rem,) if rem else ())


def get_chunking(
    signal=None,
    data_shape: tuple[int, ...] | None = None,
    nav_dim: int | None = None,
    sig_dim: int | None = None,
    chunk_shape: int | None = None,
    chunk_bytes: int | float | str | None = 30e6,
    dtype=None,
) -> tuple:
    """Chunk tuple for a pattern array: signal axes whole, navigation
    axes chunked to ``chunk_shape`` or auto-sized to ~``chunk_bytes``.

    Mirrors the reference ``kikuchipy.signals.util.get_chunking``
    (``signals/util/_dask.py:33-111``) without requiring Dask: the
    return value is a tuple with one entry per dimension, each a tuple
    of block lengths along that axis.

    Parameters
    ----------
    signal
        Any object with ``data.shape``/``data.dtype`` plus either
        HyperSpy-style ``axes_manager`` or this framework's
        ``navigation_shape``/``signal_shape`` attributes. If not given,
        ``data_shape``, ``nav_dim``, ``sig_dim`` and ``dtype`` must be.
    chunk_shape
        Per-axis navigation chunk length. Auto-sized from
        ``chunk_bytes`` if not given.
    chunk_bytes
        Approximate chunk size; accepts ``30e6``, ``"30 MB"``,
        ``"30MiB"``, ... Default 30 MB (the reference's policy).
    """
    if signal is not None:
        data_shape = tuple(signal.data.shape)
        am = getattr(signal, "axes_manager", None)
        if am is not None:
            nav_dim = am.navigation_dimension
            sig_dim = am.signal_dimension
        else:
            nav_dim = len(getattr(signal, "navigation_shape", data_shape[:-2]))
            sig_dim = len(data_shape) - nav_dim
        if dtype is None:
            dtype = numpy_dtype(signal.data.dtype)
    if data_shape is None or nav_dim is None or sig_dim is None:
        raise ValueError(
            "Either signal or all of data_shape, nav_dim and sig_dim "
            "must be given"
        )
    if dtype is None:
        raise ValueError("dtype must be given when signal is not")
    dtype = numpy_dtype(dtype)
    if len(data_shape) != nav_dim + sig_dim:
        raise ValueError(
            f"data_shape {data_shape} does not match nav_dim={nav_dim} + "
            f"sig_dim={sig_dim}"
        )

    nav_shape = data_shape[:nav_dim]
    sig_shape = data_shape[nav_dim:]

    if chunk_shape is not None:
        nav_sizes = [int(chunk_shape)] * nav_dim
    else:
        limit = _parse_bytes(30e6 if chunk_bytes is None else chunk_bytes)
        sig_elems = int(np.prod(sig_shape)) if sig_dim else 1
        budget = max(1, limit // max(1, dtype.itemsize * sig_elems))
        # Shrink navigation axes as evenly as possible (squarish chunks,
        # like dask's "auto" policy): per-axis target is the geometric
        # mean share of the budget, clipped to the axis length; axes
        # shorter than their share donate the slack to the others.
        nav_sizes = [int(n) for n in nav_shape]
        while int(np.prod(nav_sizes)) > budget:
            share = budget
            free = [i for i, n in enumerate(nav_sizes) if n > 1]
            if not free:
                break
            # Clipped geometric-mean target over the still-free axes.
            fixed = 1
            for i, n in enumerate(nav_sizes):
                if i not in free:
                    fixed *= n
            target = max(1.0, (share / max(fixed, 1)) ** (1.0 / len(free)))
            changed = False
            for i in free:
                new = min(nav_sizes[i], max(1, math.floor(target)))
                if new < nav_sizes[i]:
                    nav_sizes[i] = new
                    changed = True
            if not changed:
                # All free axes already at/below target but the product
                # still exceeds the budget (rounding): shrink the largest.
                j = max(free, key=lambda i: nav_sizes[i])
                nav_sizes[j] = max(1, nav_sizes[j] - 1)

    chunks = tuple(
        _axis_chunks(int(n), s) for n, s in zip(nav_shape, nav_sizes)
    )
    chunks += tuple((int(s),) for s in sig_shape)
    return chunks


def get_dask_array(signal, dtype=None, **kwargs):
    """A Dask array of the signal's patterns (copied to the host) with this
    policy's chunking (``signals/util/_dask.py``). Dask is imported here and
    is optional: without it this raises ``ImportError``."""
    dtype = numpy_dtype(signal.data.dtype if dtype is None else dtype)
    try:
        import dask.array as da
    except ImportError as exc:
        raise ImportError(
            "get_dask_array requires the optional dependency dask. In "
            "kikuchipy_tpu_torch, out-of-core scans are LazyEBSD "
            "(EBSD.as_lazy, load(..., lazy=True)) instead of Dask task graphs."
        ) from exc
    if isinstance(signal.data, da.Array):
        return signal.data.astype(dtype)
    chunks = get_chunking(
        signal=signal,
        dtype=dtype,
        chunk_shape=kwargs.pop("chunk_shape", None),
        chunk_bytes=kwargs.pop("chunk_bytes", None),
    )
    data = signal.data.cpu().numpy() if hasattr(signal.data, "cpu") else np.asarray(signal.data)
    return da.from_array(data, chunks=chunks).astype(dtype)
