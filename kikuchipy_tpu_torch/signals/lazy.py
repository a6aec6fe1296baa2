"""Out-of-core (lazy) EBSD scans (``kikuchipy_tpu/signals/lazy.py``).

:class:`LazyEBSD` records a chain of operations over a chunked *source* (a
memory-mapped file, an HDF5 dataset, a NumPy array or a tensor) and runs it
a navigation chunk at a time on the device, through the eager
:class:`~kikuchipy_tpu_torch.signals.ebsd.EBSD` methods, so lazy and eager
results are the same bytes.

On the card a chunk read from the host goes through
:class:`~kikuchipy_tpu_torch.utils.staging.ChunkStager`: it is copied once
into one of two page-locked buffers and from there, on a copy stream, into
one of two device buffers, so the next chunk's copy overlaps the current
chunk's operations. A chunk of a tensor already on the device is a slice.
The halo rows that neighbour averaging (kernel G) reads are trimmed by
slicing on the device.

Kept lazy end to end:

- the preprocessing chain (``remove_static_background``,
  ``remove_dynamic_background``, ``get_dynamic_background``,
  ``fft_filter``, ``rescale_intensity``, ``normalize_intensity``,
  ``adaptive_histogram_equalization``, ``downsample``/``rebin``,
  ``change_dtype`` and, with halo rows, ``average_neighbour_patterns``);
- ``compute``, every chunk written into one device tensor;
- ``dictionary_indexing``, against a dictionary prepared once;
- ``refine_orientation``, a chunk at a time;
- ``save`` to kikuchipy h5ebsd, a chunk at a time.

Any other attribute computes the processed scan once (cached) and is read
from it.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from kikuchipy_tpu_torch.utils.device import resolve_device
from kikuchipy_tpu_torch.utils.dtypes import numpy_dtype
from kikuchipy_tpu_torch.utils.staging import ChunkStager, to_device

_logger = logging.getLogger(__name__)

__all__ = ["LazyEBSD", "ArraySource", "H5Source"]


class ArraySource:
    """Chunk source over an in-memory array, an ``np.memmap`` or a tensor;
    :meth:`read` returns a view (a memory map pages in only when it is
    copied)."""

    def __init__(self, array, nav_shape: tuple[int, ...]):
        self._array = array
        self.nav_shape = tuple(nav_shape)
        self.signal_shape = tuple(array.shape[-2:])
        self.dtype = numpy_dtype(array.dtype)

    def read(self, start: int, stop: int):
        flat = self._array.reshape((-1,) + self.signal_shape)
        if isinstance(flat, torch.Tensor):
            return flat[start:stop]
        return np.asarray(flat[start:stop])


class H5Source:
    """Chunk source over an HDF5 dataset (opened per read; ``h5py`` is
    imported here)."""

    def __init__(
        self,
        filename: str | Path,
        dataset: str = "Scan 1/EBSD/Data/patterns",
        nav_shape: tuple[int, ...] | None = None,
    ):
        import h5py

        self.filename = str(filename)
        self.dataset = dataset
        with h5py.File(self.filename, "r") as f:
            ds = f[dataset]
            shape = ds.shape
            self.dtype = ds.dtype
        self.signal_shape = tuple(shape[-2:])
        self.nav_shape = tuple(nav_shape) if nav_shape is not None else tuple(shape[:-2])

    def read(self, start: int, stop: int) -> np.ndarray:
        import h5py

        with h5py.File(self.filename, "r") as f:
            ds = f[self.dataset]
            if ds.ndim == 2:  # one pattern
                return ds[()][None][start:stop]
            if ds.ndim == 3:  # (n, sy, sx)
                return ds[start:stop][()]
            # (ny, nx, sy, sx): whole rows (h5py slices an axis at a time).
            nx = ds.shape[1]
            stop = min(stop, ds.shape[0] * nx)
            r0, r1 = start // nx, (stop - 1) // nx + 1
            rows = ds[r0:r1][()].reshape((-1,) + self.signal_shape)
            return rows[start - r0 * nx : stop - r0 * nx]


def _on(tensor: torch.Tensor, device: torch.device) -> bool:
    return tensor.device.type == device.type and (device.index is None or tensor.device.index == device.index)


@dataclasses.dataclass
class LazyEBSD:
    """A lazily evaluated scan over a chunked source.

    Build with :meth:`~kikuchipy_tpu_torch.signals.ebsd.EBSD.as_lazy` or
    ``kikuchipy_tpu_torch.load(..., lazy=True)``. ``device`` is where the
    chunks are processed; ``None`` is the card.
    """

    source: Any
    detector: Any = None
    static_background: np.ndarray | None = None
    xmap: Any = None
    metadata: dict = dataclasses.field(default_factory=dict)
    ops: tuple = ()  # ((method name, kwargs, halo rows), ...)
    chunk_size: int = 1024
    _probe: Any = dataclasses.field(default=None, repr=False)
    _computed: Any = dataclasses.field(default=None, repr=False)
    device: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)

    @property
    def navigation_shape(self) -> tuple[int, ...]:
        return self.source.nav_shape

    @property
    def navigation_size(self) -> int:
        return int(np.prod(self.navigation_shape)) if self.navigation_shape else 1

    @property
    def signal_shape(self) -> tuple[int, int]:
        return self._probe_signal().signal_shape

    @property
    def dtype(self) -> np.dtype:
        return numpy_dtype(self._probe_signal().data.dtype)

    @property
    def data(self) -> torch.Tensor:
        """The processed scan (computed, then cached)."""
        return self.compute().data

    # ---------------------------- chunks ---------------------------- #

    def _chunk_signal(self, chunk: torch.Tensor):
        from kikuchipy_tpu_torch.signals.ebsd import EBSD

        return EBSD(data=chunk, detector=self.detector, static_background=self.static_background, device=self.device)

    def _stager(self, rows: int) -> ChunkStager | None:
        """Staging for chunks of up to ``rows`` patterns read from the host
        onto the card; ``None`` where a chunk is already a device slice or
        the device is the CPU."""
        src = getattr(self.source, "_array", None)
        if self.device.type != "cuda" or (isinstance(src, torch.Tensor) and _on(src, self.device)):
            return None
        return ChunkStager(rows, self.source.signal_shape, self.source.dtype, self.device)

    def _read(self, start: int, stop: int, stager: ChunkStager | None = None) -> torch.Tensor:
        rows = self.source.read(start, stop)
        if isinstance(rows, torch.Tensor):
            if _on(rows, self.device):
                return rows
            rows = rows.cpu().numpy()
        if stager is not None:
            return stager.put(rows)
        return to_device(rows, self.device)

    def _probe_signal(self):
        """The chain run on the first pattern: the output's signal shape,
        dtype and attributes (detector binning, the downsampled static
        background) from one pattern."""
        if self._probe is None:
            s = self._chunk_signal(self._read(0, 1))
            for name, kwargs, _halo in self.ops:
                if name == "average_neighbour_patterns":
                    continue  # keeps the shape and dtype of a pattern
                s = getattr(s, name)(**kwargs)
            object.__setattr__(self, "_probe", s)
        return self._probe

    def _apply_ops(self, s, nav_rows=None):
        """The chain on a chunk signal ``s``; ``nav_rows`` is the (rows, nx)
        shape of a chunk of whole map rows (operations on neighbourhoods need
        it)."""
        for name, kwargs, halo in self.ops:
            if halo:
                if nav_rows is None:
                    raise ValueError(f"{name} requires 2D-navigation chunked execution")
                s2 = dataclasses.replace(s, data=s.data.reshape(tuple(nav_rows) + s.signal_shape))
                s2 = getattr(s2, name)(**kwargs)
                s = dataclasses.replace(s2, data=s2.data.reshape((-1,) + s2.signal_shape))
            else:
                s = getattr(s, name)(**kwargs)
        return s

    def _iter_chunks(self):
        """Yield ``(start, stop, processed chunk signal)`` over the flat
        navigation axis; with operations on neighbourhoods in the chain, a
        chunk is whole map rows read with their halo rows. A chunk's data
        may be a view of a staging buffer: use it before the next chunk is
        taken."""
        n = self.navigation_size
        total_halo = sum(h for _, _, h in self.ops)
        if total_halo == 0:
            blocks = [(a, min(a + self.chunk_size, n), 0, 0, None) for a in range(0, n, self.chunk_size)]
            rows = min(self.chunk_size, n)
        else:
            nav_shape = self.navigation_shape
            if len(nav_shape) != 2:
                raise ValueError(f"navigation-neighborhood ops require a 2D navigation shape, got {nav_shape}")
            ny, nx = nav_shape
            per = max(1, self.chunk_size // max(nx, 1))
            blocks = []
            for r0 in range(0, ny, per):
                r1 = min(r0 + per, ny)
                h0, h1 = min(total_halo, r0), min(total_halo, ny - r1)
                blocks.append((r0 * nx, r1 * nx, h0 * nx, h1 * nx, (r1 - r0 + h0 + h1, nx)))
            rows = min(per + 2 * total_halo, ny) * nx
        stager = self._stager(rows)
        for start, stop, lead, trail, nav_rows in blocks:
            s = self._apply_ops(self._chunk_signal(self._read(start - lead, stop + trail, stager)), nav_rows)
            if nav_rows is not None:
                # The halo rows' patterns, dropped by slicing on the device.
                s = dataclasses.replace(s, data=s.data[lead : lead + stop - start])
            yield start, stop, s
            if stager is not None:
                stager.release()

    # --------------------------- the chain --------------------------- #

    def _append(self, name: str, kwargs: dict, halo: int = 0) -> "LazyEBSD":
        return dataclasses.replace(self, ops=self.ops + ((name, dict(kwargs), halo),), _probe=None, _computed=None)

    def rescale_intensity(self, **kwargs) -> "LazyEBSD":
        return self._append("rescale_intensity", kwargs)

    def normalize_intensity(self, **kwargs) -> "LazyEBSD":
        return self._append("normalize_intensity", kwargs)

    def remove_static_background(self, *args, **kwargs) -> "LazyEBSD":
        if args:
            kwargs["operation"] = args[0]
        if kwargs.get("static_bg") is None and self.static_background is None:
            raise ValueError(
                "`static_bg` is not a valid NumPy array: none was passed "
                "and the signal has no static_background attribute"
            )
        return self._append("remove_static_background", kwargs)

    def remove_dynamic_background(self, *args, **kwargs) -> "LazyEBSD":
        if args:
            kwargs["operation"] = args[0]
        return self._append("remove_dynamic_background", kwargs)

    def get_dynamic_background(self, **kwargs) -> "LazyEBSD":
        return self._append("get_dynamic_background", kwargs)

    def fft_filter(self, transfer_function, **kwargs) -> "LazyEBSD":
        kwargs["transfer_function"] = transfer_function
        return self._append("fft_filter", kwargs)

    def adaptive_histogram_equalization(self, **kwargs) -> "LazyEBSD":
        return self._append("adaptive_histogram_equalization", kwargs)

    def downsample(self, factor: int, **kwargs) -> "LazyEBSD":
        kwargs["factor"] = factor
        return self._append("downsample", kwargs)

    def rebin(self, scale=None, **kwargs) -> "LazyEBSD":
        kwargs["scale"] = scale
        return self._append("rebin", kwargs)

    def change_dtype(self, dtype) -> "LazyEBSD":
        return self._append("change_dtype", {"dtype": dtype})

    def average_neighbour_patterns(self, window=None, **kwargs) -> "LazyEBSD":
        """Neighbour averaging with halo rows: the window's half height (at
        least 1) from the window the eager method resolves (JAX reads a
        ``shape`` argument that the method does not take, so its halo
        misses a ``window_shape`` taller than 3)."""
        from kikuchipy_tpu_torch.ops.neighbours import _resolve_window

        extra = {k: v for k, v in kwargs.items() if k not in ("window_shape", "dtype_out")}
        w = _resolve_window(window, kwargs.get("window_shape", (3, 3)), **extra)
        halo = max(int(w.shape[0] // 2), int(w.shape[-1] // 2), 1)
        kwargs["window"] = window
        return self._append("average_neighbour_patterns", kwargs, halo=halo)

    # ------------------------ running the chain ------------------------ #

    def as_lazy(self) -> "LazyEBSD":
        return self

    def compute(self):
        """Run the chain a chunk at a time into one tensor on the device and
        return the eager :class:`~kikuchipy_tpu_torch.signals.ebsd.EBSD`
        (cached)."""
        if self._computed is None:
            probe = self._probe_signal()
            out = torch.empty((self.navigation_size,) + probe.signal_shape, dtype=probe.data.dtype,
                              device=self.device)
            for start, stop, s in self._iter_chunks():
                out[start:stop] = s.data
            eager = dataclasses.replace(
                probe, data=out.reshape(self.navigation_shape + probe.signal_shape), xmap=self.xmap
            )
            eager.metadata = dict(self.metadata)
            object.__setattr__(self, "_computed", eager)
        return self._computed

    def dictionary_indexing(
        self,
        dictionary,
        metric: str = "ncc",
        keep_n: int = 20,
        n_per_iteration: int | None = None,
        signal_mask: np.ndarray | None = None,
        navigation_mask: np.ndarray | None = None,
        **kwargs,
    ):
        """Dictionary indexing a chunk at a time: each chunk is read, run
        through the chain and indexed against the dictionary, prepared (and
        for ``precision="int8"`` quantized) once on the device; the scan is
        never whole in memory. ``precision`` is one of
        :func:`~kikuchipy_tpu_torch.indexing.di._index_resident`'s (default
        "highest"): ``"pallas-int8"`` raises ``ValueError`` (the JAX
        package's streamed path has no such tier and raises too).
        ``approx_topk`` as in the eager call; with ``navigation_mask`` the
        processed scan is computed first. Returns the eager method's
        :class:`~kikuchipy_tpu_torch.crystallography.crystal_map.CrystalMap`.
        """
        from kikuchipy_tpu_torch.crystallography.crystal_map import CrystalMap, Phase, PhaseList
        from kikuchipy_tpu_torch.indexing.di import (
            _check_resident_precision,
            _default_tile,
            _index_resident,
            _resident_dictionary,
        )
        from kikuchipy_tpu_torch.indexing.metrics import get_metric

        if navigation_mask is not None:
            return self.compute().dictionary_indexing(
                dictionary, metric=metric, keep_n=keep_n, n_per_iteration=n_per_iteration,
                signal_mask=signal_mask, navigation_mask=navigation_mask, **kwargs,
            )
        precision = kwargs.pop("precision", "highest")
        approx = kwargs.pop("approx_topk", False)
        _check_resident_precision(precision)
        metric_obj = get_metric(metric)
        dict_xmap = getattr(dictionary, "xmap", None)
        if dict_xmap is None:
            raise ValueError("dictionary has no xmap with rotations")
        dict_data = dictionary.data
        dict_prepared, dict_q, dict_scale, keep_idx = _resident_dictionary(
            dict_data.reshape((-1,) + tuple(dict_data.shape[-2:])), metric_obj, signal_mask, precision, self.device,
            n_pixels=int(np.prod(self.signal_shape)),
        )
        m = dict_prepared.shape[0]
        keep_n_eff = min(keep_n, m)
        tile = min(n_per_iteration or _default_tile(self.chunk_size), m)

        t0 = time.perf_counter()
        scores_parts, idx_parts = [], []
        for _start, _stop, s in self._iter_chunks():
            exp = metric_obj.prepare(s.data, keep_idx)
            sc, ix = _index_resident(exp, dict_prepared, keep_n_eff, tile, precision, approx, dict_q, dict_scale)
            scores_parts.append(sc)
            idx_parts.append(ix)
        idx = torch.cat(idx_parts).cpu().numpy()
        scores = torch.cat(scores_parts).cpu().numpy()
        n = self.navigation_size
        _logger.info("Streamed DI: %d patterns at %.0f patterns/s", n, n / max(time.perf_counter() - t0, 1e-9))

        rot = dict_xmap.best_rotations[idx]
        if idx.shape[1] == 1:
            rot = rot[:, 0]
        phases = dict_xmap.phases if len(dict_xmap.phases) else PhaseList(Phase())
        nav_shape = self.navigation_shape
        return CrystalMap(
            rotations=rot,
            shape=nav_shape if len(nav_shape) == 2 else (n,),
            prop={"scores": scores, "simulation_indices": idx},
            phases=phases,
        )

    def refine_orientation(self, nav_chunk: int | None = None, **kwargs):
        """Orientation refinement a chunk at a time: each chunk is read, run
        through the chain and refined by
        :func:`~kikuchipy_tpu_torch.indexing.refinement.refine_orientation`
        (``kwargs``) from the crystal map's rotations of its points; the
        scan is never whole in memory."""
        from kikuchipy_tpu_torch.crystallography.crystal_map import CrystalMap
        from kikuchipy_tpu_torch.indexing.refinement import RefinementResult, _finalize_xmap, refine_orientation

        xmap = kwargs.pop("xmap", None) or self.xmap
        detector = kwargs.pop("detector", None) or self.detector
        if xmap is None:
            raise ValueError("refine_orientation requires an xmap")
        n = self.navigation_size
        q0 = np.asarray(xmap.best_rotations)
        per_point_pc = detector is not None and detector.navigation_size == n
        pcs = detector.pc.reshape(-1, 3) if per_point_pc else None

        rot_parts, score_parts, ev_parts = [], [], []
        for start, stop, s in self._iter_chunks():
            det = dataclasses.replace(detector, pc=pcs[start:stop]) if per_point_pc else detector
            sub_xmap = CrystalMap(rotations=q0[start:stop], shape=(stop - start,), phases=xmap.phases)
            sub = dataclasses.replace(s, detector=det, xmap=sub_xmap)
            res = refine_orientation(sub, xmap=sub_xmap, detector=det, nav_chunk=nav_chunk, **kwargs)
            rot_parts.append(np.asarray(res.xmap.best_rotations))
            score_parts.append(np.asarray(res.xmap.prop["scores"]))
            ev_parts.append(np.asarray(res.xmap.prop["num_evals"]))

        new_xmap = _finalize_xmap(
            xmap, np.concatenate(rot_parts), np.concatenate(score_parts), np.concatenate(ev_parts),
            self.navigation_shape,
        )
        return RefinementResult(xmap=new_xmap, detector=detector)

    def save(self, filename, **kwargs) -> None:
        """Save a chunk at a time to kikuchipy h5ebsd (``h5py`` needed): the
        header first, over a zero placeholder of the patterns (``np.zeros``
        maps no memory until written), then each chunk as it is processed.
        Other formats save the computed scan."""
        from kikuchipy_tpu_torch.io._io import save as io_save

        filename = str(filename)
        if not filename.endswith((".h5", ".hdf5", ".h5ebsd")):
            io_save(filename, self.compute(), **kwargs)
            return
        import h5py

        from kikuchipy_tpu_torch.io.plugins.kikuchipy_h5ebsd import file_writer

        probe = self._probe_signal()
        header = dataclasses.replace(
            probe,
            data=np.zeros(self.navigation_shape + probe.signal_shape, dtype=numpy_dtype(probe.data.dtype)),
            xmap=self.xmap,
            device="cpu",
        )
        header.metadata = dict(self.metadata)
        file_writer(filename, header, **kwargs)
        with h5py.File(filename, "r+") as f:
            ds = f["Scan 1/EBSD/Data/patterns"]
            for start, stop, s in self._iter_chunks():
                ds[start:stop] = s.data.cpu().numpy()

    def __getattr__(self, name: str):
        # Only names that are no field or method reach here: compute the
        # processed scan once (cached) and read the name from it.
        if name.startswith("_"):
            raise AttributeError(name)
        eager = self.compute()
        if not hasattr(eager, name):
            raise AttributeError(name)
        _logger.info("LazyEBSD.%s is not lazy; the processed scan was computed", name)
        return getattr(eager, name)

    def __repr__(self) -> str:
        return (
            f"<LazyEBSD, nav {self.navigation_shape}, signal "
            f"{self.source.signal_shape}, {len(self.ops)} pending ops>"
        )
