"""Example datasets (kikuchipy's ``data`` accessors; a copy of
``kikuchipy_tpu/data/__init__.py``).

Files are looked up under ``KP_TPU_DATA_DIR`` first, then in kikuchipy's
own in-package data directory where kikuchipy is installed (the files its
``nickel_ebsd_small`` and ``nickel_ebsd_master_pattern_small`` accessors
ship); the download-backed datasets (``nickel_ebsd_large``, ``ni_gain``,
``si_wafer``, ...) are registered but raise a clear error when their files
are absent. Every accessor reads its file with
:func:`kikuchipy_tpu_torch.load`, so it takes ``device`` (``None`` is the
card) among its keyword arguments.
"""

from __future__ import annotations

import importlib.util
import os
from pathlib import Path

__all__ = [
    "nickel_ebsd_small",
    "nickel_ebsd_master_pattern_small",
    "nickel_ebsd_large",
    "data_path",
]


def _reference_data() -> Path | None:
    """kikuchipy's in-package data directory, where kikuchipy is installed
    (found without importing it)."""
    spec = importlib.util.find_spec("kikuchipy")
    if spec is None or not spec.submodule_search_locations:
        return None
    return Path(list(spec.submodule_search_locations)[0]) / "data"


def _cache_dir() -> Path:
    env = os.environ.get("KP_TPU_DATA_DIR")
    return Path(env) if env else Path.home() / ".cache" / "kikuchipy_tpu"


def data_path() -> Path:
    """Root directory of the example data files: ``KP_TPU_DATA_DIR``, else
    kikuchipy's in-package data directory, else the download cache."""
    env = os.environ.get("KP_TPU_DATA_DIR")
    if env:
        return Path(env)
    return _reference_data() or _cache_dir()


def _require(
    relpath: str,
    allow_download: bool = False,
    check_hash: bool = False,
) -> Path:
    """Resolve a dataset file: the cache dir (``KP_TPU_DATA_DIR``)
    first, then kikuchipy's in-package data directory; optionally
    download into the cache dir and verify the registered MD5
    (see :mod:`kikuchipy_tpu_torch.data._registry`)."""
    from kikuchipy_tpu_torch.data._registry import fetch, verify

    env = os.environ.get("KP_TPU_DATA_DIR")
    candidates = [Path(env)] if env else []
    reference = _reference_data()
    if reference is not None and reference.exists():
        candidates.append(reference)
    for root in candidates:
        p = root / relpath
        if p.exists():
            if check_hash and not verify(p, relpath):
                raise ValueError(f"MD5 mismatch for {p}")
            return p
    return fetch(
        relpath, _cache_dir(), allow_download=allow_download, check_hash=check_hash
    )


def _fetch_opts(kwargs):
    """Pop fetch-related options from an accessor's kwargs."""
    return dict(
        allow_download=kwargs.pop("allow_download", False),
        check_hash=kwargs.pop("check_hash", False),
    )


def nickel_ebsd_small(**kwargs):
    """3x3 nickel scan of 60x60 patterns with PCs, static background and
    orientations (reference ``data/_data.py:97``)."""
    from kikuchipy_tpu_torch.io._io import load

    opts = _fetch_opts(kwargs)
    return load(_require("kikuchipy_h5ebsd/patterns.h5", **opts), **kwargs)


def nickel_ebsd_master_pattern_small(
    projection: str = "stereographic", hemisphere: str = "upper", **kwargs
):
    """Nickel EBSD master pattern at 20 kV, 401x401 px (reference
    ``data/_data.py:455``)."""
    from kikuchipy_tpu_torch.io._io import load

    opts = _fetch_opts(kwargs)
    return load(
        _require(
            "emsoft_ebsd_master_pattern/ni_mc_mp_20kv_uint8_gzip_opts9.h5",
            **opts,
        ),
        projection=projection,
        hemisphere=hemisphere,
        **kwargs,
    )


def nickel_ebsd_large(**kwargs):
    """55x75 nickel scan (download-backed in the reference,
    ``data/_data.py:129``); requires a cached copy."""
    from kikuchipy_tpu_torch.io._io import load

    opts = _fetch_opts(kwargs)
    return load(_require("nickel_ebsd_large/patterns.h5", **opts), **kwargs)


def ni_gain(number: int = 1, **kwargs):
    """NORDIF (149, 200) nickel scan at one of ten camera gains
    (reference ``data/_data.py:179``; download-backed -- requires a
    cached copy under ``ni_gain/<number>/``)."""
    from kikuchipy_tpu_torch.io._io import load

    if not 1 <= int(number) <= 10:
        raise ValueError("number must be in [1, 10]")
    opts = _fetch_opts(kwargs)
    return load(_require(f"ni_gain/{int(number)}/Pattern.dat", **opts), **kwargs)


def ni_gain_calibration(number: int = 1, **kwargs):
    """NORDIF calibration patterns for the ``ni_gain`` datasets
    (reference ``data/_data.py:249``)."""
    from kikuchipy_tpu_torch.io._io import load

    if not 1 <= int(number) <= 10:
        raise ValueError("number must be in [1, 10]")
    opts = _fetch_opts(kwargs)
    return load(
        _require(f"ni_gain/{int(number)}/Setting.txt", **opts),
        reader="nordif_calibration_patterns",
        **kwargs,
    )


def si_ebsd_moving_screen(distance: int = 0, **kwargs):
    """Single-crystal Si pattern at screen distance 0, 5 or 10 mm
    (reference ``data/_data.py:321``; for moving-screen PC
    calibration)."""
    from kikuchipy_tpu_torch.io._io import load

    names = {0: "si_in.h5", 5: "si_out5mm.h5", 10: "si_out10mm.h5"}
    if distance not in names:
        raise ValueError("distance must be 0, 5 or 10 (mm)")
    opts = _fetch_opts(kwargs)
    return load(
        _require(f"silicon_ebsd_moving_screen/{names[distance]}", **opts),
        **kwargs,
    )


def si_wafer(**kwargs):
    """(50, 50) Si-wafer scan of (480, 480) patterns (reference
    ``data/_data.py:392``; download-backed)."""
    from kikuchipy_tpu_torch.io._io import load

    opts = _fetch_opts(kwargs)
    return load(_require("si_wafer/Pattern.dat", **opts), **kwargs)


_MASTER_PATTERN_PHASES = (
    "al", "ni", "si", "austenite", "ferrite", "steel_chi", "steel_sigma",
    "steel_sigma2", "r", "pi", "cr2n", "al6mn", "alpha_almnsi",
)


def ebsd_master_pattern(
    phase: str,
    energy=None,
    projection: str = "stereographic",
    hemisphere: str = "upper",
    **kwargs,
):
    """(1001, 1001) EMsoft master pattern of a named phase (reference
    ``data/_data.py:517``; download-backed)."""
    from kikuchipy_tpu_torch.io._io import load

    if phase not in _MASTER_PATTERN_PHASES:
        raise ValueError(
            f"phase must be one of {_MASTER_PATTERN_PHASES}, got {phase!r}"
        )
    opts = _fetch_opts(kwargs)
    return load(
        _require(f"ebsd_master_pattern/{phase}_mc_mp_20kv.h5", **opts),
        energy=energy,
        projection=projection,
        hemisphere=hemisphere,
        **kwargs,
    )


def clear_cache() -> None:
    """Delete cached dataset files under ``KP_TPU_DATA_DIR`` (reference
    ``data/_data.py:55``). The read-only in-package files are never
    touched."""
    import shutil

    env = os.environ.get("KP_TPU_DATA_DIR")
    if not env:
        return
    p = Path(env)
    if p.exists() and p != _reference_data():
        shutil.rmtree(p)


__all__ += [
    "clear_cache",
    "ebsd_master_pattern",
    "ni_gain",
    "ni_gain_calibration",
    "si_ebsd_moving_screen",
    "si_wafer",
]
