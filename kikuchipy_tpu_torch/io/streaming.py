"""Out-of-core scan streaming (``kikuchipy_tpu/io/streaming.py``): process
scans larger than device (or host) memory by overlapping chunked HDF5 reads
with device compute.

A background thread reads navigation chunks from disk while the device
processes the previous chunk. ``h5py`` is imported in the functions that
read HDF5, so importing this module needs none.

:func:`dictionary_index_streamed` is the HDF5 reader in front of
:func:`_index_chunks`, the on-device loop, which takes any iterator of
``(start, chunk)`` (a memory map's slices, say): each chunk goes to the
device (through :class:`~kikuchipy_tpu_torch.utils.staging.ChunkStager` on
the card), is prepared and matched against the dictionary, prepared (and
for ``"int8"`` quantized) once; results are read back one chunk late and
written to an npz checkpoint with the JAX package's keys
(``scores_{start}``, ``idx_{start}``), so a checkpoint of either package
resumes in the other.
"""

from __future__ import annotations

import queue
import threading
import time
from pathlib import Path
from typing import Callable, Iterable, Iterator

import numpy as np

__all__ = ["stream_patterns", "map_streamed", "dictionary_index_streamed"]


def stream_patterns(
    filename: str | Path,
    dataset: str = "Scan 1/EBSD/Data/patterns",
    chunk_size: int = 1024,
    prefetch: int = 2,
) -> Iterator[tuple[int, np.ndarray]]:
    """Yield ``(start_index, chunk)`` of flattened-navigation pattern
    chunks from an HDF5 dataset, with a background reader thread
    prefetching ``prefetch`` chunks ahead.
    """
    import h5py

    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def reader():
        try:
            with h5py.File(filename, "r") as f:
                ds = f[dataset]
                n = ds.shape[0]
                for start in range(0, n, chunk_size):
                    if stop.is_set():
                        return
                    q.put((start, ds[start : start + chunk_size][()]))
        finally:
            q.put(None)

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                break
            yield item
    finally:
        stop.set()
        # Drain so the reader can exit.
        while not q.empty():
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=5)


def map_streamed(
    filename: str | Path,
    fn: Callable[[np.ndarray], np.ndarray],
    out: np.ndarray | None = None,
    dataset: str = "Scan 1/EBSD/Data/patterns",
    chunk_size: int = 1024,
    out_path: str | Path | None = None,
    out_dataset: str = "Scan 1/EBSD/Data/patterns",
    copy_metadata: bool = True,
) -> np.ndarray | None:
    """Apply a per-chunk function over a streamed scan.

    Results (a NumPy array or a tensor a chunk) are written into ``out``
    (preallocated array), or streamed to ``out_path`` (HDF5, created on
    first chunk) when the result does not fit in memory, or collected into
    a new array otherwise. Only one chunk of input and one of output are
    in memory at a time. With ``copy_metadata`` (default), every
    group/dataset of the input file EXCEPT the pattern dataset is copied
    into ``out_path``, so preprocessing an h5ebsd scan yields a loadable
    h5ebsd scan (header, PCs, crystal map and all).
    """
    import h5py

    from kikuchipy_tpu_torch.utils.device import host_array

    collected = []
    h5out = None
    out_ds = None
    try:
        for start, chunk in stream_patterns(filename, dataset=dataset, chunk_size=chunk_size):
            result = host_array(fn(chunk))
            if out is not None:
                out[start : start + result.shape[0]] = result
            elif out_path is not None:
                if h5out is None:
                    h5out = h5py.File(out_path, "w")
                    with h5py.File(filename, "r") as fin:
                        n = fin[dataset].shape[0]
                        if copy_metadata:
                            _copy_h5_except(fin, h5out, skip=dataset)
                    out_ds = h5out.create_dataset(out_dataset, shape=(n,) + result.shape[1:], dtype=result.dtype)
                out_ds[start : start + result.shape[0]] = result
            else:
                collected.append(result)
    finally:
        if h5out is not None:
            h5out.close()
    if out is not None:
        return out
    if out_path is not None:
        return None
    return np.concatenate(collected, axis=0)


def _copy_h5_except(fin, fout, skip: str) -> None:
    """Copy all groups/datasets/attrs of ``fin`` into ``fout`` except
    the (possibly nested) dataset path ``skip``."""
    skip_parts = skip.strip("/").split("/")

    def visit(src, dst, parts):
        for key, item in src.items():
            if parts and key == parts[0]:
                if len(parts) == 1:
                    continue  # the pattern dataset itself
                sub = dst.require_group(key)
                for a, v in item.attrs.items():
                    sub.attrs[a] = v
                visit(item, sub, parts[1:])
                continue
            src.copy(key, dst, name=key)
        for a, v in src.attrs.items():
            dst.attrs[a] = v

    visit(fin, fout, skip_parts)


def dictionary_index_streamed(
    filename: str | Path,
    dictionary,
    preprocess_fn: Callable | None = None,
    dataset: str = "Scan 1/EBSD/Data/patterns",
    chunk_size: int = 4096,
    keep_n: int = 20,
    metric: str = "ncc",
    signal_mask: np.ndarray | None = None,
    checkpoint_path: str | Path | None = None,
    preprocess_on_device: bool = False,
    device=None,
    **di_kwargs,
):
    """Index a scan too large for device memory: stream experimental
    chunks from an HDF5 file (prefetch overlapped with compute), index each
    chunk against the dictionary on ``device`` (None: the card), and
    concatenate the results.

    With ``checkpoint_path``, partial results are saved after each chunk
    (npz) and a restarted run resumes from the last completed chunk.

    With ``preprocess_on_device``, ``preprocess_fn`` takes the chunk as a
    tensor on the device, after the host-to-device copy (raw uint8 chunks
    cross the bus in 4x fewer bytes than float32); otherwise it takes the
    NumPy chunk on the host, in the reader's thread.

    ``di_kwargs``: ``n_per_iteration``, ``precision`` (one of
    :func:`~kikuchipy_tpu_torch.indexing.di._index_resident`'s:
    ``"pallas-int8"`` and unknown names raise ``ValueError``) and
    ``approx_topk``. Returns a
    :class:`~kikuchipy_tpu_torch.indexing.di.DictionaryIndexingResult`
    covering the full scan.
    """
    return _index_chunks(
        stream_patterns(filename, dataset=dataset, chunk_size=chunk_size),
        dictionary,
        preprocess_fn=preprocess_fn,
        chunk_size=chunk_size,
        keep_n=keep_n,
        metric=metric,
        signal_mask=signal_mask,
        checkpoint_path=checkpoint_path,
        preprocess_on_device=preprocess_on_device,
        device=device,
        **di_kwargs,
    )


def _load_checkpoint(checkpoint_path) -> dict[int, tuple[np.ndarray, np.ndarray]]:
    chunks: dict[int, tuple[np.ndarray, np.ndarray]] = {}
    if checkpoint_path is not None and Path(checkpoint_path).exists():
        with np.load(checkpoint_path, allow_pickle=False) as ckpt:
            for key in ckpt.files:
                if key.startswith("scores_"):
                    start = int(key.split("_")[1])
                    chunks[start] = (ckpt[key], ckpt[f"idx_{start}"])
    return chunks


def _write_checkpoint(checkpoint_path, chunks: dict[int, tuple[np.ndarray, np.ndarray]]) -> None:
    payload = {}
    for s0, (sc, ix) in chunks.items():
        payload[f"scores_{s0}"] = sc
        payload[f"idx_{s0}"] = ix
    tmp = Path(str(checkpoint_path) + ".tmp")
    with open(tmp, "wb") as fh:
        np.savez(fh, **payload)
    tmp.replace(checkpoint_path)


def _index_chunks(
    chunks: Iterable[tuple[int, np.ndarray]],
    dictionary,
    preprocess_fn: Callable | None = None,
    chunk_size: int = 4096,
    keep_n: int = 20,
    metric: str = "ncc",
    signal_mask: np.ndarray | None = None,
    checkpoint_path: str | Path | None = None,
    preprocess_on_device: bool = False,
    device=None,
    **di_kwargs,
):
    """The on-device loop of :func:`dictionary_index_streamed` over any
    iterable of ``(start, chunk)``; the arguments are its own."""
    from kikuchipy_tpu_torch.indexing.di import (
        DictionaryIndexingResult,
        _check_resident_precision,
        _default_tile,
        _index_resident,
        _resident_dictionary,
    )
    from kikuchipy_tpu_torch.indexing.metrics import get_metric
    from kikuchipy_tpu_torch.utils.device import as_tensor, resolve_device
    from kikuchipy_tpu_torch.utils.staging import ChunkStager

    dev = resolve_device(device)
    n_per_iteration = di_kwargs.pop("n_per_iteration", None)
    precision = di_kwargs.pop("precision", "highest")
    approx = di_kwargs.pop("approx_topk", False)
    if di_kwargs:
        raise TypeError(f"Unknown arguments: {sorted(di_kwargs)}")
    _check_resident_precision(precision)

    done = _load_checkpoint(checkpoint_path)

    # The dictionary is prepared (and quantized) on the device once.
    metric_obj = get_metric(metric)
    dict_prepared, dict_q, dict_scale, keep_idx = _resident_dictionary(dictionary, metric_obj, signal_mask,
                                                                       precision, dev)
    m = dict_prepared.shape[0]
    keep_n_eff = min(keep_n, m)
    tile = min(n_per_iteration or _default_tile(chunk_size), m)

    # Reading and host preprocessing run in a pipeline thread that touches
    # no device tensor; results are read back one chunk late, so the
    # checkpoint write of chunk i overlaps the products of chunk i+1.
    def produce():
        for start, chunk in chunks:
            if start in done:
                continue
            if preprocess_fn is not None and not preprocess_on_device:
                chunk = preprocess_fn(chunk)
            yield start, chunk

    def finish(item) -> int:
        start, sc, ix = item
        done[start] = (sc.cpu().numpy(), ix.cpu().numpy())
        if checkpoint_path is not None:
            _write_checkpoint(checkpoint_path, done)
        return done[start][0].shape[0]

    # Host chunks reach the card through two pinned and two device buffers,
    # made anew if a chunk outgrows them or changes its rows' shape or type.
    stager = stager_key = None
    total = 0
    t0 = time.perf_counter()
    pending = None
    for start, chunk in _pipelined(produce(), depth=2):
        if isinstance(chunk, np.ndarray) and dev.type == "cuda":
            rows, key = max(chunk_size, chunk.shape[0]), (chunk.shape[1:], chunk.dtype)
            if stager is None or chunk.shape[0] > stager_key[0] or key != stager_key[1]:
                stager, stager_key = ChunkStager(rows, chunk.shape[1:], chunk.dtype, dev), (rows, key)
            chunk_dev = stager.put(chunk)
        else:
            stager = None
            chunk_dev = as_tensor(chunk, dev)
        if preprocess_fn is not None and preprocess_on_device:
            chunk_dev = preprocess_fn(chunk_dev)
        exp_prepared = metric_obj.prepare(chunk_dev, keep_idx)
        scores_d, idx_d = _index_resident(
            exp_prepared, dict_prepared, keep_n_eff, tile, precision, approx, dict_q, dict_scale
        )
        if stager is not None:
            stager.release()
        if pending is not None:
            total += finish(pending)
        pending = (start, scores_d, idx_d)
    if pending is not None:
        total += finish(pending)
    dt = time.perf_counter() - t0

    starts = sorted(done)
    return DictionaryIndexingResult(
        scores=np.concatenate([done[s][0] for s in starts], axis=0),
        simulation_indices=np.concatenate([done[s][1] for s in starts], axis=0),
        patterns_per_second=total / dt if total else 0.0,
        comparisons_per_second=total * m / dt if total else 0.0,
    )


def _pipelined(it: Iterator, depth: int = 2) -> Iterator:
    """Run an iterator's work in a background thread with a bounded
    queue, so producing the next item (disk read + host preprocess)
    overlaps consuming the current one (device compute)."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    error: list[BaseException] = []

    def worker():
        try:
            for item in it:
                q.put(item)
        except BaseException as exc:  # propagate to consumer
            error.append(exc)
        finally:
            q.put(None)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is None:
            break
        yield item
    t.join(timeout=10)
    if error:
        raise error[0]
