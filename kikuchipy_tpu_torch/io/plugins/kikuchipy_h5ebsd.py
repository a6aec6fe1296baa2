"""kikuchipy h5ebsd reader and writer
(``kikuchipy_tpu/io/plugins/kikuchipy_h5ebsd.py``).

kikuchipy's own HDF5 scan format (``kikuchipy_h5ebsd/_api.py``): top-level
``manufacturer``/``version``, one ``Scan N`` group per scan with
``EBSD/Data/patterns``, header datasets (shape, PCs, tilts, static
background) and an orix-style crystal map under
``EBSD/CrystalMap/crystal_map``. ``h5py`` is imported when a file is read
or written.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from kikuchipy_tpu_torch.crystallography.crystal_map import CrystalMap, Phase, PhaseList
from kikuchipy_tpu_torch.geometry.detector import EBSDDetector
from kikuchipy_tpu_torch.geometry.quaternion import from_euler, to_euler
from kikuchipy_tpu_torch.signals.ebsd import EBSD
from kikuchipy_tpu_torch.utils.device import host_array, resolve_device
from kikuchipy_tpu_torch.utils.staging import to_device

__all__ = ["file_reader", "file_writer"]


def _scalar(ds) -> float:
    v = np.asarray(ds)
    return float(v.ravel()[0])


def _read_crystal_map(group, nav_shape) -> CrystalMap | None:
    if "CrystalMap" not in group:
        return None
    cm = group["CrystalMap/crystal_map"]
    data = cm["data"]
    euler = np.stack(
        [data["phi1"][()], data["Phi"][()], data["phi2"][()]], axis=-1
    )
    rotations = from_euler(torch.as_tensor(euler, dtype=torch.float64)).numpy()
    phases = PhaseList()
    header = cm["header"]
    if "phases" in header:
        for pid in header["phases"]:
            pg = header[f"phases/{pid}"]
            name = pg["name"][()][0]
            phases.add(
                int(pid),
                Phase(
                    name=name.decode() if isinstance(name, bytes) else str(name),
                    space_group=int(pg["space_group"][()][0])
                    if "space_group" in pg
                    else None,
                ),
            )
    prop = {}
    for key in ("scores", "simulation_indices"):
        if key in data:
            prop[key] = data[key][()]
    return CrystalMap(
        rotations=rotations,
        phase_id=data["phase_id"][()] if "phase_id" in data else None,
        x=data["x"][()] if "x" in data else None,
        y=data["y"][()] if "y" in data else None,
        prop=prop,
        phases=phases,
        shape=nav_shape,
        is_in_data=data["is_in_data"][()] if "is_in_data" in data else None,
    )


def file_reader(
    filename: str | Path,
    scan_group_names: str | list[str] | None = None,
    lazy: bool = False,
    device=None,
):
    """Read one or more scans: a single :class:`EBSD` (the first or the
    named scan) on ``device`` (None: the card), or a list when a list of
    names is given; with ``lazy=True`` each a
    :class:`~kikuchipy_tpu_torch.signals.lazy.LazyEBSD` reading its chunks
    from the file."""
    import h5py

    device = resolve_device(device)
    single = not isinstance(scan_group_names, list)
    out = []
    with h5py.File(filename, "r") as f:
        available = [k for k in f if k.lower().startswith("scan")]
        if not available:
            raise IOError(f"No 'Scan N' groups found in {filename}")
        if scan_group_names is None:
            names = [available[0]]
        elif isinstance(scan_group_names, str):
            names = [scan_group_names]
        else:
            names = scan_group_names
        for name in names:
            if name not in f:
                raise IOError(
                    f"Scan group {name!r} not in {filename}; available: "
                    f"{available}"
                )
            g = f[name]["EBSD"]
            header = g["Header"]
            ny = int(_scalar(header["n_rows"]))
            nx = int(_scalar(header["n_columns"]))
            sy = int(_scalar(header["pattern_height"]))
            sx = int(_scalar(header["pattern_width"]))
            if lazy:
                patterns = None  # read chunk-at-a-time via H5Source
            else:
                patterns = to_device(g["Data/patterns"][()].reshape((ny, nx, sy, sx)), device)

            pc = np.stack(
                [header["pcx"][()], header["pcy"][()], header["pcz"][()]],
                axis=-1,
            )
            if pc.ndim == 1:
                pc = pc[None]
            detector = EBSDDetector(
                shape=(sy, sx),
                px_size=_scalar(header["detector_pixel_size"])
                if "detector_pixel_size" in header
                else 1.0,
                binning=int(_scalar(header["binning"]))
                if "binning" in header
                else 1,
                tilt=_scalar(header["elevation_angle"])
                if "elevation_angle" in header
                else 0.0,
                azimuthal=_scalar(header["azimuth_angle"])
                if "azimuth_angle" in header
                else 0.0,
                sample_tilt=_scalar(header["sample_tilt"])
                if "sample_tilt" in header
                else 70.0,
                pc=pc,
            )
            static_background = (
                header["static_background"][()]
                if "static_background" in header
                else None
            )
            metadata = {
                "scan": name,
                "step_x": _scalar(header["step_x"]) if "step_x" in header else 1.0,
                "step_y": _scalar(header["step_y"]) if "step_y" in header else 1.0,
            }
            if "SEM" in f[name]:
                sem = f[name]["SEM/Header"]
                for k in ("beam_energy", "magnification", "working_distance"):
                    if k in sem:
                        metadata[k] = _scalar(sem[k])
            xmap = _read_crystal_map(g, (ny, nx))
            if lazy:
                from kikuchipy_tpu_torch.signals.lazy import H5Source, LazyEBSD

                out.append(
                    LazyEBSD(
                        source=H5Source(
                            filename,
                            f"{name}/EBSD/Data/patterns",
                            nav_shape=(ny, nx),
                        ),
                        detector=detector,
                        static_background=static_background,
                        xmap=xmap,
                        metadata=metadata,
                        device=device,
                    )
                )
            else:
                out.append(
                    EBSD(
                        data=patterns,
                        detector=detector,
                        static_background=static_background,
                        xmap=xmap,
                        metadata=metadata,
                        device=device,
                    )
                )
    if single:
        return out[0]
    return out


def file_writer(
    filename: str | Path,
    signal: EBSD,
    scan_number: int = 1,
    add_scan: bool = False,
) -> None:
    """Write an :class:`EBSD` signal to a kikuchipy h5ebsd file (the
    patterns copied to the host), or with ``add_scan=True`` add it as scan
    ``scan_number`` of an existing file."""
    import h5py

    mode = "r+" if (add_scan and Path(filename).exists()) else "w"
    data = host_array(signal.data)
    if data.ndim == 3:
        data = data[None]
    ny, nx, sy, sx = data.shape
    det = signal.detector or EBSDDetector(shape=(sy, sx))

    with h5py.File(filename, mode) as f:
        if "manufacturer" not in f:
            f.create_dataset(
                "manufacturer", data=np.array([b"kikuchipy_tpu"])
            )
            f.create_dataset("version", data=np.array([b"0.1.0"]))
        scan_name = f"Scan {scan_number}"
        if scan_name in f:
            raise IOError(
                f"{scan_name} already exists in {filename}; pass a different "
                "scan_number"
            )
        g = f.create_group(f"{scan_name}/EBSD")
        g.create_dataset(
            "Data/patterns", data=data.reshape((ny * nx, sy, sx))
        )
        h = g.create_group("Header")
        h.create_dataset("n_rows", data=np.array([ny]))
        h.create_dataset("n_columns", data=np.array([nx]))
        h.create_dataset("pattern_height", data=np.array([sy]))
        h.create_dataset("pattern_width", data=np.array([sx]))
        h.create_dataset("sample_tilt", data=np.array([det.sample_tilt]))
        h.create_dataset("elevation_angle", data=np.array([det.tilt]))
        h.create_dataset("azimuth_angle", data=np.array([det.azimuthal]))
        h.create_dataset("binning", data=np.array([det.binning]))
        h.create_dataset("detector_pixel_size", data=np.array([det.px_size]))
        h.create_dataset("step_x", data=np.array([signal.metadata.get("step_x", 1.0)]))
        h.create_dataset("step_y", data=np.array([signal.metadata.get("step_y", 1.0)]))
        pc = det.pc
        if det.navigation_size == 1:
            pcx = np.full((ny, nx), pc[..., 0].ravel()[0])
            pcy = np.full((ny, nx), pc[..., 1].ravel()[0])
            pcz = np.full((ny, nx), pc[..., 2].ravel()[0])
        else:
            pcx = pc[..., 0].reshape(ny, nx)
            pcy = pc[..., 1].reshape(ny, nx)
            pcz = pc[..., 2].reshape(ny, nx)
        h.create_dataset("pcx", data=pcx)
        h.create_dataset("pcy", data=pcy)
        h.create_dataset("pcz", data=pcz)
        if signal.static_background is not None:
            h.create_dataset(
                "static_background", data=host_array(signal.static_background)
            )
        if signal.xmap is not None:
            _write_crystal_map(g, signal.xmap)


def _write_crystal_map(g, xmap: CrystalMap) -> None:
    cm = g.create_group("CrystalMap/crystal_map")
    data = cm.create_group("data")
    euler = to_euler(torch.as_tensor(np.asarray(xmap.best_rotations), dtype=torch.float64)).numpy()
    data.create_dataset("phi1", data=euler[:, 0])
    data.create_dataset("Phi", data=euler[:, 1])
    data.create_dataset("phi2", data=euler[:, 2])
    data.create_dataset("phase_id", data=np.asarray(xmap.phase_id))
    data.create_dataset("id", data=np.arange(xmap.size))
    data.create_dataset("is_in_data", data=np.asarray(xmap.is_in_data))
    data.create_dataset("x", data=np.asarray(xmap.x))
    data.create_dataset("y", data=np.asarray(xmap.y))
    for key, val in xmap.prop.items():
        data.create_dataset(key, data=np.asarray(val))
    header = cm.create_group("header")
    shape = xmap.shape if len(xmap.shape) == 2 else (1,) + tuple(xmap.shape)
    header.create_dataset("ny", data=np.array([shape[0]]))
    header.create_dataset("nx", data=np.array([shape[1]]))
    phases = header.create_group("phases")
    for pid in xmap.phases.ids:
        ph = xmap.phases[pid]
        pg = phases.create_group(str(pid))
        pg.create_dataset("name", data=np.array([ph.name.encode()]))
        if ph.space_group is not None:
            pg.create_dataset("space_group", data=np.array([ph.space_group]))
