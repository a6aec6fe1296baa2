"""Bruker Nano h5ebsd reader (``kikuchipy_tpu/io/plugins/bruker_h5ebsd.py``).

The layout (kikuchipy's ``bruker_h5ebsd/_api.py``): ``Scan N/EBSD/Data/RawPatterns`` with header
datasets ``NCOLS/NROWS/PatternWidth/PatternHeight/PCX/PCY/DD/
CameraTilt/Sample Tilt/XSTEP/YSTEP/StaticBackground`` and SEM metadata
under ``Scan N/EBSD/SEM``. Region-of-interest scans (``Data/X BEAM``/
``Y BEAM`` indices) are supported for rectangular ROIs. ``h5py`` is imported when a
file is read.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from kikuchipy_tpu_torch.geometry.detector import EBSDDetector
from kikuchipy_tpu_torch.signals.ebsd import EBSD
from kikuchipy_tpu_torch.utils.device import resolve_device
from kikuchipy_tpu_torch.utils.staging import to_device

__all__ = ["file_reader"]


def _scalar(ds, default=None):
    try:
        return np.asarray(ds).ravel()[0]
    except Exception:
        return default


def file_reader(
    filename: str | Path,
    scan_group_names: str | list[str] | None = None,
    lazy: bool = False,
    device=None,
) -> EBSD | list[EBSD]:
    """Read one or more scans: a single :class:`EBSD` (the first or the
    named scan) on ``device`` (None: the card), or a list when a list of
    names is given; ``lazy`` is accepted and ignored."""
    import h5py

    device = resolve_device(device)
    single = not isinstance(scan_group_names, list)
    out = []
    with h5py.File(filename, "r") as f:
        available = [k for k in f if isinstance(f[k], h5py.Group) and "EBSD" in f[k]]
        if not available:
            raise IOError(f"No scan groups with EBSD data found in {filename}")
        if scan_group_names is None:
            names = [available[0]]
        elif isinstance(scan_group_names, str):
            names = [scan_group_names]
        else:
            names = scan_group_names

        for name in names:
            g = f[name]["EBSD"]
            header = g["Header"]
            data_group = g["Data"]
            ny = int(_scalar(header["NROWS"]))
            nx = int(_scalar(header["NCOLS"]))
            sy = int(_scalar(header["PatternHeight"]))
            sx = int(_scalar(header["PatternWidth"]))
            patterns = data_group["RawPatterns"][()]

            if "X BEAM" in data_group and "Y BEAM" in data_group:
                # Region of interest: map patterns to their beam indices.
                xb = data_group["X BEAM"][()].astype(int)
                yb = data_group["Y BEAM"][()].astype(int)
                x0, x1 = xb.min(), xb.max()
                y0, y1 = yb.min(), yb.max()
                roi_nx = x1 - x0 + 1
                roi_ny = y1 - y0 + 1
                filled = np.zeros((roi_ny, roi_nx), dtype=bool)
                filled[yb - y0, xb - x0] = True
                if not filled.all():
                    raise ValueError(
                        "Only a rectangular region of interest is supported"
                    )
                full = np.zeros((roi_ny, roi_nx, sy, sx), patterns.dtype)
                full[yb - y0, xb - x0] = patterns.reshape(-1, sy, sx)
                patterns = full
                ny, nx = roi_ny, roi_nx
            else:
                patterns = patterns.reshape((ny, nx, sy, sx))

            pcx = np.asarray(header["PCX"][()], dtype=float)
            pcy = np.asarray(header["PCY"][()], dtype=float)
            dd = np.asarray(header["DD"][()], dtype=float)
            pc = np.stack(
                [np.atleast_1d(pcx), np.atleast_1d(pcy), np.atleast_1d(dd)],
                axis=-1,
            )
            if pc.shape[0] == 1:
                pc = pc[0]
            elif pc.shape[0] == ny * nx:
                pc = pc.reshape((ny, nx, 3))

            detector = EBSDDetector(
                shape=(sy, sx),
                tilt=float(_scalar(header.get("CameraTilt"), 0.0) or 0.0),
                sample_tilt=float(_scalar(header.get("Sample Tilt"), 70.0) or 70.0),
                pc=pc,
                convention="bruker",
            )
            static_background = (
                header["StaticBackground"][()]
                if "StaticBackground" in header
                else None
            )
            metadata = {
                "step_x": float(_scalar(header.get("XSTEP"), 1.0) or 1.0),
                "step_y": float(_scalar(header.get("YSTEP"), 1.0) or 1.0),
            }
            sem = g.get("SEM")
            if sem is not None:
                for src, dst in (
                    ("KV", "beam_energy"),
                    ("Magnification", "magnification"),
                    ("WD", "working_distance"),
                ):
                    if src in sem:
                        metadata[dst] = float(_scalar(sem[src]))
            out.append(
                EBSD(
                    data=to_device(patterns, device),
                    detector=detector,
                    static_background=static_background,
                    metadata=metadata,
                    device=device,
                )
            )
    return out[0] if single else out
