"""Directory-of-images EBSD reader (``kikuchipy_tpu/io/plugins/
ebsd_directory.py``).

Reads a scan stored as one image file per pattern (kikuchipy's
``ebsd_directory/_api.py``): tif/bmp/png files, read with ``PIL`` (imported
only here), whose names encode the navigation coordinates, e.g.
``pattern_x0y0.tif``. The navigation shape is inferred from the extracted
x/y indices (or the file count when no pattern matches).
"""

from __future__ import annotations

import re
import warnings
from pathlib import Path

import numpy as np

from kikuchipy_tpu_torch.signals.ebsd import EBSD

__all__ = ["file_reader"]

_EXTENSIONS = (".tif", ".tiff", ".bmp", ".png")
_XY_PATTERNS = (
    re.compile(r"x(\d+)[_-]?y(\d+)", re.IGNORECASE),
    re.compile(r"[_-](\d+)[_-](\d+)\."),
)


def file_reader(
    filename: str | Path,
    xy_pattern: str | None = None,
    lazy: bool = False,
    device=None,
) -> EBSD:
    """Read all pattern images in a directory into an :class:`EBSD` on
    ``device`` (None: the card); ``lazy`` is accepted and ignored."""
    folder = Path(filename)
    files = sorted(
        p for p in folder.iterdir() if p.suffix.lower() in _EXTENSIONS
    )
    if not files:
        raise IOError(f"No image files found in directory {folder}")

    patterns_re = (
        [re.compile(xy_pattern)] if xy_pattern else list(_XY_PATTERNS)
    )

    from PIL import Image

    coords = []
    images = []
    for p in files:
        img = np.asarray(Image.open(p))
        if img.ndim == 3:
            img = img[..., 0]
        images.append(img)
        xy = None
        for rx in patterns_re:
            m = rx.search(p.name)
            if m:
                xy = (int(m.group(1)), int(m.group(2)))
                break
        coords.append(xy)

    data = np.stack(images, axis=0)
    if all(c is not None for c in coords):
        xs = np.array([c[0] for c in coords])
        ys = np.array([c[1] for c in coords])
        nx = xs.max() - xs.min() + 1
        ny = ys.max() - ys.min() + 1
        if nx * ny == len(files):
            grid = np.zeros((ny, nx) + data.shape[-2:], dtype=data.dtype)
            grid[ys - ys.min(), xs - xs.min()] = data
            data = grid
        else:
            warnings.warn(
                "Returned signal has one navigation dimension since the file "
                "names did not form a full rectangular grid"
            )
    else:
        warnings.warn(
            "Returned signal has one navigation dimension since navigation "
            "coordinates could not be parsed from the file names"
        )
    return EBSD(data=data, metadata={"directory": str(folder)}, device=device)
