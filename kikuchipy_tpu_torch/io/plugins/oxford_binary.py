"""Oxford Instruments binary ``.ebsp`` pattern file reader
(``kikuchipy_tpu/io/plugins/oxford_binary.py``).

The format (kikuchipy's ``oxford_binary/_api.py``): an int64 version (stored negated;
absent in version 0), a table of int64 per-pattern byte positions (zero
when a pattern is missing), then per pattern: an int32 header
``([map_x, map_y (v>=5),] is_compressed, nrows, ncols, n_bytes)``, the
raw uint8/uint16 pattern, and a footer with optional beam x/y positions
(version-dependent). Patterns may be stored out of order; they are
sorted into map order via the position table, and the navigation shape
is recovered from the beam positions. The patterns are read from a memory
map of the file.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from kikuchipy_tpu_torch.signals.ebsd import EBSD
from kikuchipy_tpu_torch.utils.device import resolve_device
from kikuchipy_tpu_torch.utils.staging import to_device

__all__ = ["file_reader"]

_MAX_PIXELS = 1024 * 1344


class _EbspReader:
    def __init__(self, filename: Path) -> None:
        self.filename = filename
        self.file = open(filename, "rb")
        self.version = self._read_version()
        self.header_fields = self._header_fields()
        self.header_size = 4 * len(self.header_fields)
        self.n_patterns = self._guess_n_patterns()
        self.pattern_starts = self._read_pattern_starts()
        self.present = self.pattern_starts != 0

        first = int(self.pattern_starts[self.present][0])
        hdr = self._read_header(first)
        if hdr["is_compressed"]:
            raise NotImplementedError(
                f"Cannot read compressed EBSD patterns from '{filename}'"
            )
        self.signal_shape = (hdr["nrows"], hdr["ncols"])
        self.n_bytes = hdr["n_bytes"]
        self.dtype = (
            np.uint8
            if self.n_bytes == self.signal_shape[0] * self.signal_shape[1]
            else np.uint16
        )
        self.footer_fields, self.footer_size = self._footer_fields(first)

    def close(self):
        self.file.close()

    # ----------------------------- Layout ---------------------------- #

    def _read_version(self) -> int:
        self.file.seek(0)
        v = struct.unpack("<q", self.file.read(8))[0]
        return -v if v < 0 else 0

    @property
    def table_position(self) -> int:
        if self.version == 0:
            return 0
        if self.version > 3:
            return 9
        return 8

    def _header_fields(self):
        fields = ["is_compressed", "nrows", "ncols", "n_bytes"]
        if self.version >= 5:
            fields = ["map_x", "map_y"] + fields
        return fields

    def _guess_n_patterns(self, min_assumed_n_pixels: int = 1600) -> int:
        """Infer the pattern count from the byte-position table."""
        self.file.seek(self.table_position)
        file_size = self.filename.stat().st_size
        max_n = file_size // (min_assumed_n_pixels + self.header_size)
        starts = np.fromfile(self.file, np.int64, max_n)
        diff = np.diff(starts)
        max_pattern_size = _MAX_PIXELS * 2 + self.header_size
        jump = np.abs(diff) > 20 * max_pattern_size
        n = int(np.nonzero(jump)[0][0])
        if self.version < 5:
            n += 1
        return n

    def _read_pattern_starts(self) -> np.ndarray:
        self.file.seek(self.table_position)
        return np.fromfile(self.file, np.int64, self.n_patterns)

    @property
    def first_pattern_position(self) -> int:
        return self.table_position + self.n_patterns * 8

    def _read_header(self, offset: int) -> dict:
        self.file.seek(offset)
        vals = np.fromfile(self.file, np.int32, len(self.header_fields))
        return dict(zip(self.header_fields, (int(v) for v in vals)))

    def _footer_fields(self, offset: int):
        """Footer layout after the pattern bytes."""
        self.file.seek(offset + self.header_size + self.n_bytes)
        fields = []
        size = 0
        if self.version == 1:
            fields = [("beam_x", np.float64), ("beam_y", np.float64)]
            size = 16
        elif self.version > 1:
            size = 2
            if struct.unpack("?", self.file.read(1))[0]:
                fields += [("has_beam_x", np.bool_), ("beam_x", np.float64)]
                size += 8
                self.file.seek(8, 1)
            if struct.unpack("?", self.file.read(1))[0]:
                fields += [("has_beam_y", np.bool_), ("beam_y", np.float64)]
                size += 8
        return fields, size

    # ----------------------------- Reading --------------------------- #

    def _memmap(self):
        record = [(name, np.int32) for name in self.header_fields]
        record.append(("pattern", self.dtype, self.signal_shape))
        record += [(name, dt) for name, dt in self.footer_fields]
        return np.memmap(
            self.filename,
            dtype=np.dtype(record),
            mode="r",
            offset=self.first_pattern_position,
            shape=(int(self.present.sum()),),
        )

    def read(self, lazy: bool = False, device=None):
        mm = self._memmap()
        # A strided view into the file mapping: no pattern is read until
        # it is copied.
        data = mm["pattern"]
        names = [n for n, _ in self.footer_fields]
        has_positions = "beam_x" in names and "beam_y" in names
        all_present = bool(self.present.all())

        metadata = {"version": self.version}
        if has_positions:
            metadata["beam_x"] = np.asarray(mm["beam_x"], dtype=np.float64)
            metadata["beam_y"] = np.asarray(mm["beam_y"], dtype=np.float64)
        if not all_present or not has_positions:
            nav_shape = (data.shape[0],)
        else:
            bx = metadata["beam_x"]
            by = metadata["beam_y"]
            # Patterns may be stored out of map order; the grid comes from
            # the beam positions' extents.
            ux = np.unique(bx)
            step = float(np.min(np.diff(ux))) if ux.size > 1 else 1.0
            nrows = int(round((by.max() - by.min()) / step)) + 1
            ncols = int(round((bx.max() - bx.min()) / step)) + 1
            nav_shape = (nrows, ncols)
            metadata.update(step_x=float(step), step_y=float(step))

            # Out-of-order storage: gather into map order by the byte-position
            # table (reads the patterns; the threaded native gather where it
            # builds).
            bytes_per = self.header_size + self.n_bytes + self.footer_size
            order = ((self.pattern_starts - self.first_pattern_position) // bytes_per).astype(np.int64)
            if not np.array_equal(order, np.arange(order.size)):
                from kikuchipy_tpu_torch import native

                data = native.reorder_patterns(np.asarray(data), order)

        n_expected = int(np.prod(nav_shape))
        if lazy:
            from kikuchipy_tpu_torch.signals.lazy import ArraySource, LazyEBSD

            return LazyEBSD(source=ArraySource(data[:n_expected], nav_shape), metadata=metadata, device=device)
        data = to_device(data[:n_expected], device)
        return EBSD(data=data.reshape(nav_shape + self.signal_shape), metadata=metadata, device=device)


def file_reader(filename: str | Path, lazy: bool = False, device=None):
    """Read an Oxford binary scan: an :class:`EBSD` on ``device`` (None: the
    card), or with ``lazy=True`` a :class:`~kikuchipy_tpu_torch.signals.
    lazy.LazyEBSD` over the file's memory map."""
    device = resolve_device(device)
    reader = _EbspReader(Path(filename))
    try:
        return reader.read(lazy=lazy, device=device)
    finally:
        reader.close()
