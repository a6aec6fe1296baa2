"""NORDIF binary ``.dat`` reader and writer
(``kikuchipy_tpu/io/plugins/nordif.py``).

The format (kikuchipy's ``nordif/_api.py``): raw uint8 patterns stored
image by image, the scan geometry in a ``Setting.txt`` beside the data file
and the static background in ``Background acquisition pattern.bmp`` (read
and written with ``PIL``, imported only for it).
"""

from __future__ import annotations

import re
import warnings
from pathlib import Path

import numpy as np
import torch

from kikuchipy_tpu_torch.geometry.detector import EBSDDetector
from kikuchipy_tpu_torch.signals.ebsd import EBSD
from kikuchipy_tpu_torch.utils.device import host_array, resolve_device
from kikuchipy_tpu_torch.utils.staging import to_device

__all__ = ["file_reader", "file_writer", "parse_settings"]


def parse_settings(setting_file: Path, pattern_type: str = "acquisition") -> dict:
    """Parse a NORDIF ``Setting.txt`` file.

    Returns a dict with scan geometry (``ny, nx, sy, sx, step``),
    detector parameters, and microscope metadata.
    """
    content = Path(setting_file).read_text(encoding="latin-1").splitlines()

    def find_block(name):
        for i, line in enumerate(content):
            if name in line:
                return i
        return -1

    def get(line_no, pattern):
        if 0 <= line_no < len(content):
            m = re.search(pattern, content[line_no])
            if m:
                return m.group(1)
        return None

    l_mic = find_block("[Microscope]")
    l_ang = find_block("[Detector angles]")
    l_acq = find_block(f"[{pattern_type.capitalize()} settings]")
    l_area = find_block("[Area]")

    out: dict = {"header": content}
    out["beam_energy"] = float(get(l_mic + 5, r"Accelerating voltage\t(.*)\tkV") or 0)
    out["magnification"] = int(get(l_mic + 3, r"Magnification\t(.*)\t#") or 0)
    out["microscope"] = (
        (get(l_mic + 1, r"Manufacturer\t(.*)\t") or "")
        + " "
        + (get(l_mic + 2, r"Model\t(.*)\t") or "")
    ).strip()
    out["working_distance"] = float(get(l_mic + 6, r"Working distance\t(.*)\tmm") or 0)

    num_samp = get(l_area + 6, r"Number of samples\t(.*)\t#")
    ny, nx = (int(v) for v in num_samp.split("x"))
    res = get(l_acq + 2, r"Resolution\t(.*)\tpx")
    sx, sy = (int(v) for v in res.split("x"))
    out.update(
        ny=ny,
        nx=nx,
        sy=sy,
        sx=sx,
        step=float(get(l_area + 5, r"Step size\t(.*)\t") or 1.0),
    )

    tilt = -float(get(l_ang + 5, r"Elevation\t(.*)\t") or 0)
    out["detector"] = dict(
        shape=(sy, sx),
        sample_tilt=float(get(l_mic + 7, r"Tilt angle\t(.*)\t") or 70),
        tilt=0.0 if np.isclose(tilt, 0) else tilt,
        azimuthal=float(get(l_ang + 4, r"Azimuthal\t(.*)\t") or 0),
    )
    return out


def file_reader(
    filename: str | Path,
    scan_size: int | tuple[int, int] | None = None,
    pattern_size: tuple[int, int] | None = None,
    setting_file: str | Path | None = None,
    lazy: bool = False,
    device=None,
):
    """Read a NORDIF ``.dat`` scan: an :class:`EBSD` on ``device`` (None:
    the card), the file paged in once through page-locked memory; with
    ``lazy=True`` a :class:`~kikuchipy_tpu_torch.signals.lazy.LazyEBSD`
    over a memory map of the file."""
    device = resolve_device(device)
    filename = Path(filename)
    folder = filename.parent
    if setting_file is None:
        setting_file = folder / "Setting.txt"

    metadata: dict = {}
    detector_kw = None
    step = 1.0
    if Path(setting_file).is_file():
        settings = parse_settings(setting_file)
        if scan_size is None:
            scan_size = (settings["nx"], settings["ny"])
        if pattern_size is None:
            pattern_size = (settings["sx"], settings["sy"])
        detector_kw = settings["detector"]
        step = settings["step"]
        metadata = {k: settings[k] for k in ("beam_energy", "magnification", "microscope", "working_distance")}
    elif scan_size is None or pattern_size is None:
        raise ValueError(
            "No setting file found and no scan_size or pattern_size detected "
            "in input arguments. These must be set if no setting file is "
            "provided"
        )

    if isinstance(scan_size, int):
        nx, ny = scan_size, 1
    else:
        nx, ny = scan_size
    sx, sy = pattern_size

    expected = ny * nx * sy * sx
    file_size = filename.stat().st_size
    if file_size != expected and not (lazy and file_size > expected):
        warnings.warn(
            "Pattern size and scan size larger than file size! Will "
            "attempt to load by zero padding incomplete frames."
        )
    if file_size >= expected:
        # Patterns page in only when they are copied.
        data = np.memmap(filename, dtype=np.uint8, mode="r", shape=(expected,))
    else:
        data = np.pad(np.fromfile(filename, dtype=np.uint8), (0, expected - file_size))
    data = data.reshape((ny, nx, sy, sx))

    static_bg = None
    bg_path = folder / "Background acquisition pattern.bmp"
    if bg_path.is_file():
        from PIL import Image

        static_bg = np.asarray(Image.open(bg_path).convert("L"))
    else:
        warnings.warn(
            f"Could not read static background pattern '{bg_path}', however "
            "it can be set as 'EBSD.static_background'"
        )

    metadata.update(step_x=step, step_y=step)
    detector = EBSDDetector(**detector_kw) if detector_kw else None
    if lazy:
        from kikuchipy_tpu_torch.signals.lazy import ArraySource, LazyEBSD

        return LazyEBSD(
            source=ArraySource(data, (ny, nx)), detector=detector, static_background=static_bg,
            metadata=metadata, device=device,
        )
    return EBSD(
        data=to_device(data, device), detector=detector, static_background=static_bg, metadata=metadata,
        device=device,
    )


def file_writer(filename: str | Path, signal: EBSD) -> None:
    """Write the patterns to a raw NORDIF ``.dat`` file (uint8, pattern by
    pattern; other dtypes are rescaled to uint8 first). A static background
    is written beside it as ``Background acquisition pattern.bmp``, through
    ``PIL``."""
    filename = Path(filename)
    data = signal.data
    if data.dtype != torch.uint8:
        from kikuchipy_tpu_torch.ops.pattern import rescale_intensity

        data = rescale_intensity(data, dtype_out=np.uint8, device=data.device)
    data.cpu().numpy().tofile(filename)
    bg = getattr(signal, "static_background", None)
    if bg is not None:
        from PIL import Image

        bg = host_array(bg)
        if bg.dtype != np.uint8:
            bg = np.clip(np.round(bg), 0, 255).astype(np.uint8)
        Image.fromarray(bg, mode="L").save(filename.parent / "Background acquisition pattern.bmp")
