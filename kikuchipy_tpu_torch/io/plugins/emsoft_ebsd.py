"""EMsoft simulated EBSD pattern file reader (``kikuchipy_tpu/io/plugins/
emsoft_ebsd.py``).

Reads dynamically simulated patterns from EMsoft's ``EMEBSD`` program
(kikuchipy's ``emsoft_ebsd/_api.py``): patterns in ``EMData/EBSD/EBSDPatterns``, orientations in
``EMData/EBSD/EulerAngles``, detector geometry in
``NMLparameters/EBSDNameList``, and the crystal in ``CrystalData``. ``h5py`` is imported when a file is
read.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from kikuchipy_tpu_torch.crystallography.crystal_map import CrystalMap, Phase, PhaseList
from kikuchipy_tpu_torch.geometry.detector import EBSDDetector
from kikuchipy_tpu_torch.signals.ebsd import EBSD
from kikuchipy_tpu_torch.utils.device import resolve_device
from kikuchipy_tpu_torch.utils.staging import to_device

__all__ = ["file_reader"]


def _scalar(ds):
    return np.asarray(ds).ravel()[0]


def file_reader(
    filename: str | Path, scan_size: int | tuple[int, int] | None = None,
    lazy: bool = False,
    device=None,
) -> EBSD:
    """Read the simulated patterns into an :class:`EBSD` on ``device`` (None:
    the card) with a crystal map of their orientations; ``lazy`` is
    accepted and ignored."""
    import h5py
    import torch

    device = resolve_device(device)
    with h5py.File(filename, "r") as f:
        if "EMData/EBSD/EBSDPatterns" not in f:
            raise IOError(
                f"'{filename}' is not an EMsoft simulated EBSD file"
            )
        patterns = f["EMData/EBSD/EBSDPatterns"][()]
        euler = f["EMData/EBSD/EulerAngles"][()]

        n = patterns.shape[0]
        if scan_size is None:
            nav_shape = (n,)
        elif isinstance(scan_size, int):
            nav_shape = (scan_size,)
        else:
            nav_shape = tuple(scan_size)
        patterns = patterns.reshape(nav_shape + patterns.shape[-2:])

        nml = f["NMLparameters/EBSDNameList"]
        sy, sx = patterns.shape[-2:]
        binning = int(_scalar(nml["binning"])) if "binning" in nml else 1
        px_size = float(_scalar(nml["delta"])) if "delta" in nml else 1.0
        # EMsoft PC (xpc, ypc, L) -> emsoft5 convention.
        pc = np.array(
            [
                float(_scalar(nml["xpc"])) if "xpc" in nml else 0.0,
                float(_scalar(nml["ypc"])) if "ypc" in nml else 0.0,
                float(_scalar(nml["L"])) if "L" in nml else sy * px_size,
            ]
        )
        detector = EBSDDetector(
            shape=(sy, sx),
            px_size=px_size,
            binning=binning,
            tilt=float(_scalar(nml["thetac"])) if "thetac" in nml else 0.0,
            sample_tilt=float(_scalar(nml["sig"])) if "sig" in nml else 70.0,
            pc=pc,
            convention="emsoft5",
        )

        phase = Phase(name="")
        if "CrystalData" in f:
            cd = f["CrystalData"]
            if "SpaceGroupNumber" in cd:
                phase.space_group = int(_scalar(cd["SpaceGroupNumber"]))
            if "LatticeParameters" in cd:
                phase.lattice = tuple(
                    np.asarray(cd["LatticeParameters"]).ravel()
                )
        if "EMData/EBSD/xtalname" in f:
            raw = _scalar(f["EMData/EBSD/xtalname"])
            name = raw.decode() if isinstance(raw, bytes) else str(raw)
            phase.name = name.replace(".xtal", "")

        from kikuchipy_tpu_torch.geometry.quaternion import from_euler

        rotations = from_euler(torch.as_tensor(euler.astype(np.float64))).numpy()
        xmap = CrystalMap(
            rotations=rotations, shape=nav_shape, phases=PhaseList(phase)
        )

        metadata = {}
        if "EMheader/EBSD/ProgramName" in f:
            raw = _scalar(f["EMheader/EBSD/ProgramName"])
            metadata["program"] = (
                raw.decode() if isinstance(raw, bytes) else str(raw)
            )

    return EBSD(data=to_device(patterns, device), detector=detector, xmap=xmap, metadata=metadata, device=device)
