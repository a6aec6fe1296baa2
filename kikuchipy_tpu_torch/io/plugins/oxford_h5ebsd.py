"""Oxford Instruments h5oina reader (``kikuchipy_tpu/io/plugins/
oxford_h5ebsd.py``).

The layout (kikuchipy's ``oxford_h5ebsd/_api.py``): scan groups ``"1", "2", ...`` each with
``EBSD/Data/Processed Patterns`` (or ``Unprocessed Patterns``), header
``X Cells/Y Cells/Pattern Height/Pattern Width/X Step/Y Step``, PCs in
``Pattern Center X/Y`` + ``Detector Distance`` (Oxford convention,
per-pattern), ``Tilt Angle`` (detector tilt, radians in h5oina),
``Processed Static Background``, and SEM metadata (``Beam Voltage``,
``Magnification``, ``Working Distance``). ``h5py`` is imported when a
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
    processed: bool = True,
    lazy: bool = False,
    device=None,
) -> EBSD | list[EBSD]:
    """Read one or more scans (processed patterns unless
    ``processed=False``): a single :class:`EBSD` on ``device`` (None: the
    card), or a list when a list of names is given; ``lazy`` is accepted
    and ignored."""
    import h5py

    device = resolve_device(device)
    single = not isinstance(scan_group_names, list)
    out = []
    with h5py.File(filename, "r") as f:
        available = [
            k for k in f if isinstance(f[k], h5py.Group) and "EBSD" in f[k]
        ]
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
            ny = int(_scalar(header["Y Cells"]))
            nx = int(_scalar(header["X Cells"]))
            sy = int(_scalar(header["Pattern Height"]))
            sx = int(_scalar(header["Pattern Width"]))
            key = "Processed Patterns" if processed else "Unprocessed Patterns"
            if key not in data_group:
                key = (
                    "Unprocessed Patterns"
                    if "Unprocessed Patterns" in data_group
                    else "Processed Patterns"
                )
            patterns = data_group[key][()].reshape((ny, nx, sy, sx))

            if "Pattern Center X" in data_group:
                pc = np.stack(
                    [
                        data_group["Pattern Center X"][()],
                        data_group["Pattern Center Y"][()],
                        data_group["Detector Distance"][()],
                    ],
                    axis=-1,
                ).reshape((ny, nx, 3))
            else:
                pc = (0.5, 0.5, 0.5)
            tilt = np.rad2deg(float(_scalar(header.get("Tilt Angle"), 0.0) or 0.0))
            detector = EBSDDetector(
                shape=(sy, sx),
                tilt=tilt,
                sample_tilt=70.0,
                pc=pc,
                convention="oxford",
            )
            static_background = None
            if "Processed Static Background" in header:
                static_background = header["Processed Static Background"][()]
            metadata = {
                "step_x": float(_scalar(header.get("X Step"), 1.0) or 1.0),
                "step_y": float(_scalar(header.get("Y Step"), 1.0) or 1.0),
            }
            for src, dst in (
                ("Beam Voltage", "beam_energy"),
                ("Magnification", "magnification"),
                ("Working Distance", "working_distance"),
            ):
                if src in header:
                    metadata[dst] = float(_scalar(header[src]))
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
