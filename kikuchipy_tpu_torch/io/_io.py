"""IO entry points: :func:`load` and :func:`save` with a plugin registry
(``kikuchipy_tpu/io/_io.py``).

Plugins are modules registered with their extensions; an HDF5 file's
vendor is told from its manufacturer dataset or its datasets' footprints
(kikuchipy's ``_plugin_from_footprints``). Readers return signals with
their patterns on the device (``device=None``: the card), or a
:class:`~kikuchipy_tpu_torch.signals.lazy.LazyEBSD` with ``lazy=True``.

The binary formats (NORDIF ``.dat``, EDAX ``.up1``/``.up2``, Oxford
``.ebsp``) need only NumPy; the HDF5 formats import ``h5py`` and the image
formats ``PIL`` when they read.
"""

from __future__ import annotations

import importlib
from pathlib import Path

from kikuchipy_tpu_torch.utils.device import resolve_device

__all__ = ["load", "save", "plugins"]

# Plugin module name -> (extensions, writable)
_PLUGINS: dict[str, dict] = {
    "kikuchipy_h5ebsd": {"extensions": [".h5", ".hdf5", ".h5ebsd"], "writes": True},
    "bruker_h5ebsd": {"extensions": [".h5", ".hdf5", ".h5ebsd"], "writes": False},
    "edax_h5ebsd": {"extensions": [".h5", ".hdf5", ".h5ebsd"], "writes": False},
    "oxford_h5ebsd": {"extensions": [".h5oina"], "writes": False},
    "emsoft_ebsd": {"extensions": [".h5", ".hdf5"], "writes": False},
    "emsoft_ebsd_master_pattern": {"extensions": [".h5", ".hdf5"], "writes": False},
    "emsoft_ecp_master_pattern": {"extensions": [".h5", ".hdf5"], "writes": False},
    "emsoft_tkd_master_pattern": {"extensions": [".h5", ".hdf5"], "writes": False},
    "nordif": {"extensions": [".dat"], "writes": True},
    "nordif_calibration_patterns": {"extensions": [".txt"], "writes": False},
    "edax_binary": {"extensions": [".up1", ".up2"], "writes": False},
    "oxford_binary": {"extensions": [".ebsp"], "writes": False},
    "ebsd_directory": {"extensions": [""], "writes": False},
}

_HDF5_EXTENSIONS = {".h5", ".hdf5", ".h5ebsd", ".h5oina"}


def plugins() -> dict[str, dict]:
    """Registered IO plugins and their capabilities."""
    return {k: dict(v) for k, v in _PLUGINS.items()}


def _get_plugin(name: str):
    return importlib.import_module(f"kikuchipy_tpu_torch.io.plugins.{name}")


def _sniff_hdf5_plugin(path: Path) -> str:
    """Pick the HDF5 plugin by manufacturer dataset or dataset
    footprints."""
    import h5py

    with h5py.File(path, "r") as f:
        # Manufacturer string at top level (kikuchipy/EDAX/Bruker style).
        # Some vendor files have stray whitespace in the key (e.g. EDAX
        # writes " Manufacturer").
        man_keys = [k for k in f.keys() if k.strip().lower() == "manufacturer"]
        for key in man_keys:
            if isinstance(f[key], h5py.Dataset):
                value = f[key][()]
                if isinstance(value, (bytes, str)):
                    man = value
                else:
                    man = value[0]
                man = (man.decode() if isinstance(man, bytes) else man).lower()
                if "kikuchipy" in man:
                    return "kikuchipy_h5ebsd"
                if "edax" in man:
                    return "edax_h5ebsd"
                if "bruker" in man:
                    return "bruker_h5ebsd"
        # EMsoft footprints
        if "EMData" in f:
            g = f["EMData"]
            if "EBSDmaster" in g:
                return "emsoft_ebsd_master_pattern"
            if "ECPmaster" in g:
                return "emsoft_ecp_master_pattern"
            if "TKDmaster" in g:
                return "emsoft_tkd_master_pattern"
            if "EBSD" in g:
                return "emsoft_ebsd"
        # Oxford h5oina footprint
        if "Format Version" in f:
            return "oxford_h5ebsd"
    raise IOError(
        f"Could not determine the HDF5 flavor of {path}; no plugin footprint "
        "matched"
    )


def load(filename: str | Path, device=None, **kwargs):
    """Load a supported EBSD or master-pattern file into a signal
    (``kikuchipy.load``).

    Parameters
    ----------
    filename
        Path to the file (or directory for image-directory scans).
    device
        Where the signal's patterns go and its operations run; ``None`` is
        the card. With ``lazy=True`` the scan stays in its file and its
        chunks go there as they are processed.
    **kwargs
        Passed on to the plugin's ``file_reader`` (e.g. ``lazy``).
    """
    device = resolve_device(device)
    path = Path(filename)
    if not path.exists():
        raise FileNotFoundError(f"No filename matches '{filename}'")
    if path.is_dir():
        plugin = "ebsd_directory"
    else:
        ext = path.suffix.lower()
        if ext in _HDF5_EXTENSIONS:
            plugin = _sniff_hdf5_plugin(path)
        else:
            matches = [
                name
                for name, spec in _PLUGINS.items()
                if ext in spec["extensions"] and ext
            ]
            if not matches:
                raise IOError(
                    f"Could not read '{filename}'. If the file format is "
                    "supported, the plugin may not be registered"
                )
            plugin = matches[0]
    return _get_plugin(plugin).file_reader(path, device=device, **kwargs)


def save(
    filename: str | Path, signal, overwrite: bool | None = None, **kwargs
) -> None:
    """Save a signal to a writable format chosen by extension: kikuchipy
    h5ebsd (``.h5``, ``.hdf5``, ``.h5ebsd``; needs ``h5py``) or NORDIF
    ``.dat``.

    ``overwrite``: what to do when ``filename`` already exists: ``None``
    (default) raises, ``True`` replaces the file, ``False`` returns without
    writing. ``add_scan=True`` (kikuchipy h5ebsd only) appends a new scan
    group to the existing file and is exempt from the overwrite check.
    """
    path = Path(filename)
    ext = path.suffix.lower()
    if ext in (".h5", ".hdf5", ".h5ebsd"):
        plugin = "kikuchipy_h5ebsd"
    elif ext == ".dat":
        plugin = "nordif"
    else:
        raise IOError(
            f"'{ext}' does not correspond to any supported writable format "
            "(.h5/.hdf5/.h5ebsd or .dat)"
        )
    if path.exists() and not kwargs.get("add_scan"):
        if overwrite is None:
            raise FileExistsError(
                f"{path} exists; pass overwrite=True to replace it "
                "(or overwrite=False to skip silently)"
            )
        if overwrite is False:
            return
    _get_plugin(plugin).file_writer(path, signal, **kwargs)
