"""Host-to-card copies of pattern arrays through page-locked memory.

A pattern file read with ``np.memmap`` pages in as it is copied. Both
helpers copy it once, into page-locked (pinned) host buffers, from several
threads (NumPy releases the interpreter lock while it copies), and move
each buffer to the card with one ``non_blocking`` copy on a copy stream, so
that the next slab pages in while the last one crosses the bus.

- :func:`to_device`: a whole array, slab by slab through two pinned
  buffers (the eager readers);
- :class:`ChunkStager`: one chunk at a time into two device buffers, the
  next chunk's copy overlapping the operations on the current one
  (:class:`~kikuchipy_tpu_torch.signals.lazy.LazyEBSD`).

On the CPU there is no staging: the array is copied once into a tensor.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from kikuchipy_tpu_torch.utils.dtypes import torch_dtype

__all__ = ["ChunkStager", "copy_rows", "to_device"]

# Below this many bytes one thread copies.
_THREADED_BYTES = 8 << 20
# Bytes of one pinned slab of to_device.
_SLAB_BYTES = 32 << 20


def _copy_threads() -> int:
    return max(1, min(4, os.cpu_count() or 1))


def copy_rows(dst: np.ndarray, src) -> None:
    """``dst[...] = src`` (same shape), split by leading rows over a few
    threads when the copy is large (a memory map pages in on all of them)."""
    n = dst.shape[0] if dst.ndim else 0
    threads = _copy_threads()
    if dst.nbytes < _THREADED_BYTES or n < 2 or threads == 1:
        np.copyto(dst, src, casting="no")
        return
    bounds = np.linspace(0, n, min(threads, n) + 1).astype(int)
    with ThreadPoolExecutor(max_workers=len(bounds) - 1) as pool:
        futures = [pool.submit(np.copyto, dst[a:b], src[a:b], casting="no")
                   for a, b in zip(bounds[:-1], bounds[1:])]
        for f in futures:
            f.result()


def _rows(array: np.ndarray) -> np.ndarray:
    """``array`` as ``(rows, elements)`` without copying where its strides
    allow (a memory map's records keep their inner axes contiguous)."""
    if array.ndim == 0:
        return array.reshape(1, 1)
    return array.reshape(array.shape[0], -1)


def to_device(array, device) -> torch.Tensor:
    """``array`` (NumPy array, memory map or tensor) as a tensor on
    ``device``: one host copy into page-locked slabs and one
    ``non_blocking`` copy a slab on the card; on the CPU a tensor that owns
    a copy of ``array``'s values."""
    device = torch.device(device)
    if isinstance(array, torch.Tensor):
        return array.to(device)
    arr = np.asarray(array)
    if device.type != "cuda":
        return torch.from_numpy(np.array(arr, order="C", copy=True))
    out = torch.empty(arr.shape, dtype=torch_dtype(arr.dtype), device=device)
    if arr.size == 0:
        return out
    src = _rows(arr)
    dst = out.view(src.shape)
    row_bytes = max(1, src.shape[1] * arr.dtype.itemsize)
    slab = max(1, min(src.shape[0], _SLAB_BYTES // row_bytes))
    pinned = [torch.empty((slab, src.shape[1]), dtype=out.dtype, pin_memory=True) for _ in range(2)]
    copied: list = [None, None]
    stream = torch.cuda.Stream(device)
    # The copies write `out`, allocated on the current stream.
    stream.wait_stream(torch.cuda.current_stream(device))
    for i, r0 in enumerate(range(0, src.shape[0], slab)):
        k = i % 2
        r1 = min(r0 + slab, src.shape[0])
        if copied[k] is not None:
            copied[k].synchronize()  # the pinned slab's last copy is done
        host = pinned[k][: r1 - r0]
        copy_rows(host.numpy(), src[r0:r1])
        with torch.cuda.stream(stream):
            dst[r0:r1].copy_(host, non_blocking=True)
            copied[k] = torch.cuda.Event()
            copied[k].record(stream)
    torch.cuda.current_stream(device).wait_stream(stream)
    for event in copied:
        if event is not None:
            event.synchronize()
    return out


class ChunkStager:
    """Chunks of up to ``rows`` patterns of ``row_shape`` onto the card
    through two page-locked host buffers and two device buffers.

    :meth:`put` copies a chunk into the next pinned buffer (waiting for that
    buffer's previous copy), queues its copy into the matching device buffer
    on a copy stream (after the operations that read that buffer two chunks
    ago), makes the current stream wait for it, and returns the device
    buffer's rows. The rows stay valid until the chunk after next is put;
    call :meth:`release` once the operations that read them are queued.
    """

    def __init__(self, rows: int, row_shape: tuple[int, ...], dtype, device):
        self.device = torch.device(device)
        dtype = torch_dtype(dtype)
        shape = (int(rows),) + tuple(row_shape)
        self._pinned = [torch.empty(shape, dtype=dtype, pin_memory=True) for _ in range(2)]
        self._buffers = [torch.empty(shape, dtype=dtype, device=self.device) for _ in range(2)]
        self._copied: list = [None, None]
        self._released: list = [None, None]
        self._stream = torch.cuda.Stream(self.device)
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        self._next = 0
        self._last = None

    def put(self, chunk) -> torch.Tensor:
        """Stage ``chunk`` (``(n, *row_shape)``, ``n <= rows``) on the card;
        returns the device rows."""
        k = self._next
        self._next ^= 1
        n = int(chunk.shape[0])
        if self._copied[k] is not None:
            self._copied[k].synchronize()
        host = self._pinned[k][:n]
        copy_rows(host.numpy(), chunk)
        with torch.cuda.stream(self._stream):
            if self._released[k] is not None:
                self._stream.wait_event(self._released[k])
            self._buffers[k][:n].copy_(host, non_blocking=True)
            self._copied[k] = torch.cuda.Event()
            self._copied[k].record(self._stream)
        torch.cuda.current_stream(self.device).wait_event(self._copied[k])
        self._last = k
        return self._buffers[k][:n]

    def release(self) -> None:
        """Mark the last chunk's device rows free once the current stream's
        queued operations (those that read them) are done."""
        if self._last is None:
            return
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        self._released[self._last] = event
        self._last = None
