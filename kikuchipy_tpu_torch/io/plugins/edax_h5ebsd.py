"""EDAX TSL h5ebsd reader (``kikuchipy_tpu/io/plugins/edax_h5ebsd.py``).

The layout (kikuchipy's ``edax_h5ebsd/_api.py``): ``Scan N/EBSD/Data/Pattern`` with header
``nRows/nColumns/Pattern Height/Pattern Width``, PC calibration
``Pattern Center Calibration/{x-star,y-star,z-star}`` (TSL convention),
``Sample Tilt``, ``Camera Elevation Angle``, ``Camera Azimuthal Angle``,
and ``Step X/Y``. ``h5py`` is imported when a file is read.
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
            ny = int(_scalar(header["nRows"]))
            nx = int(_scalar(header["nColumns"]))
            sy = int(_scalar(header["Pattern Height"]))
            sx = int(_scalar(header["Pattern Width"]))
            patterns = data_group["Pattern"][()].reshape((ny, nx, sy, sx))

            xmap = None
            if all(k in data_group for k in ("Phi1", "Phi", "Phi2")):
                import torch

                from kikuchipy_tpu_torch.crystallography.crystal_map import (
                    CrystalMap,
                    Phase,
                    PhaseList,
                )
                from kikuchipy_tpu_torch.geometry.quaternion import from_euler

                euler = np.stack(
                    [
                        data_group["Phi1"][()],
                        data_group["Phi"][()],
                        data_group["Phi2"][()],
                    ],
                    axis=-1,
                ).astype(np.float64)
                prop = {}
                for src, dst in (("CI", "ci"), ("IQ", "iq"), ("Fit", "fit")):
                    if src in data_group:
                        prop[dst] = data_group[src][()]
                phases = PhaseList()
                phase_group = header.get("Phase")
                if phase_group is not None:
                    for i, pid in enumerate(phase_group):
                        pg = phase_group[pid]
                        pname = _scalar(pg.get("MaterialName"), b"")
                        phases.add(
                            i,
                            Phase(
                                name=(
                                    pname.decode()
                                    if isinstance(pname, bytes)
                                    else str(pname)
                                )
                            ),
                        )
                xmap = CrystalMap(
                    rotations=from_euler(torch.as_tensor(euler)).numpy(),
                    phase_id=(
                        data_group["Phase"][()].astype(np.int64) - 1
                        if "Phase" in data_group
                        else None
                    ),
                    shape=(ny, nx),
                    prop=prop,
                    phases=phases,
                )

            pc_group = header.get("Pattern Center Calibration")
            if pc_group is not None:
                pc = (
                    float(_scalar(pc_group["x-star"])),
                    float(_scalar(pc_group["y-star"])),
                    float(_scalar(pc_group["z-star"])),
                )
            else:
                pc = (0.5, 0.5, 0.5)
            detector = EBSDDetector(
                shape=(sy, sx),
                tilt=float(
                    _scalar(header.get("Camera Elevation Angle"), 0.0) or 0.0
                ),
                azimuthal=float(
                    _scalar(header.get("Camera Azimuthal Angle"), 0.0) or 0.0
                ),
                sample_tilt=float(
                    _scalar(header.get("Sample Tilt"), 70.0) or 70.0
                ),
                pc=pc,
                convention="tsl",
            )
            metadata = {
                "step_x": float(_scalar(header.get("Step X"), 1.0) or 1.0),
                "step_y": float(_scalar(header.get("Step Y"), 1.0) or 1.0),
            }
            if "Working Distance" in header:
                metadata["working_distance"] = float(
                    _scalar(header["Working Distance"])
                )
            out.append(
                EBSD(
                    data=to_device(patterns, device),
                    detector=detector,
                    xmap=xmap,
                    metadata=metadata,
                    device=device,
                )
            )
    return out[0] if single else out
