"""NORDIF calibration pattern reader
(``kikuchipy_tpu/io/plugins/nordif_calibration_patterns.py``).

Reads the ``Calibration (x,y).bmp`` patterns referenced from a NORDIF
``Setting.txt`` file (kikuchipy's ``nordif_calibration_patterns/_api.py``):
the calibration coordinates are listed in the ``[Calibration patterns]``
block and each pattern is a BMP image next to the setting file, read with
``PIL`` (imported only here).
"""

from __future__ import annotations

import re
import warnings
from pathlib import Path

import numpy as np

from kikuchipy_tpu_torch.geometry.detector import EBSDDetector
from kikuchipy_tpu_torch.io.plugins.nordif import parse_settings
from kikuchipy_tpu_torch.signals.ebsd import EBSD

__all__ = ["file_reader"]


def file_reader(filename: str | Path, lazy: bool = False, device=None) -> EBSD:
    """Read calibration patterns given a NORDIF ``Setting.txt`` path, into an
    :class:`EBSD` on ``device`` (None: the card); ``lazy`` is accepted and
    ignored (a few patterns)."""
    filename = Path(filename)
    folder = filename.parent
    content = filename.read_text(encoding="latin-1").splitlines()

    coords = []
    in_block = False
    for line in content:
        if "[Calibration patterns]" in line:
            in_block = True
            continue
        if in_block:
            m = re.search(r"Calibration \((\d+),(\d+)\)", line)
            if m:
                coords.append((int(m.group(1)), int(m.group(2))))
            elif line.startswith("["):
                break

    if not coords:
        # Fall back to globbing the folder.
        for p in sorted(folder.glob("Calibration (*).bmp")):
            m = re.search(r"\((\d+),(\d+)\)", p.name)
            if m:
                coords.append((int(m.group(1)), int(m.group(2))))
    if not coords:
        raise ValueError(f"No calibration patterns found in {filename}")

    from PIL import Image

    patterns = []
    kept_coords = []
    for x, y in coords:
        p = folder / f"Calibration ({x},{y}).bmp"
        if not p.is_file():
            warnings.warn(f"Could not read calibration pattern '{p}'")
            continue
        patterns.append(np.asarray(Image.open(p).convert("L")))
        kept_coords.append((x, y))

    data = np.stack(patterns, axis=0)
    settings = parse_settings(filename, pattern_type="calibration")
    detector = EBSDDetector(
        **{**settings["detector"], "shape": data.shape[-2:]}
    )
    metadata = {
        "calibration_coordinates": np.asarray(kept_coords),
        "beam_energy": settings["beam_energy"],
        "microscope": settings["microscope"],
    }
    return EBSD(data=data, detector=detector, metadata=metadata, device=device)
