"""Carry state from the JAX package into the port's objects.

The JAX side's arrays come in as NumPy arrays (or as objects with the
same attributes; nothing of ``kikuchipy_tpu`` is imported here), so that
both packages can run on the same master pattern, detector and prepared
dictionary.
"""

from __future__ import annotations

import numpy as np
import torch

from kikuchipy_tpu_torch.crystallography.crystal_map import CrystalMap, Phase, PhaseList
from kikuchipy_tpu_torch.geometry.detector import EBSDDetector
from kikuchipy_tpu_torch.indexing.di import PreparedDictionary
from kikuchipy_tpu_torch.projection.spherical import SphericalProjector
from kikuchipy_tpu_torch.signals.master_pattern import EBSDMasterPattern, ECPMasterPattern, KikuchiMasterPattern
from kikuchipy_tpu_torch.signals.virtual_bse_image import VirtualBSEImage
from kikuchipy_tpu_torch.utils.device import as_tensor, resolve_device

__all__ = [
    "crystal_map_from_state",
    "detector_from_state",
    "ecp_master_pattern_from_state",
    "kikuchi_master_pattern_from_state",
    "master_pattern_from_state",
    "prepared_dictionary_from_state",
    "spherical_projector_from_state",
    "virtual_bse_image_from_state",
]


def master_pattern_from_state(
    data,
    phase_name: str = "",
    point_group: str | None = None,
    space_group: int | None = None,
    hemisphere: str = "both",
    projection: str = "lambert",
    energies=None,
    device=None,
    signal_class: type[KikuchiMasterPattern] = EBSDMasterPattern,
) -> KikuchiMasterPattern:
    """An :class:`EBSDMasterPattern` (or ``signal_class``) from packed
    hemispheres ``(2, npy, npx)`` (or any shape the JAX class takes) and its
    fields."""
    return signal_class(
        data=np.asarray(data),
        phase=Phase(name=phase_name, space_group=space_group, point_group=point_group),
        hemisphere=hemisphere,
        projection=projection,
        energies=None if energies is None else np.asarray(energies),
        device=device,
    )


def kikuchi_master_pattern_from_state(data, **fields) -> KikuchiMasterPattern:
    """A :class:`KikuchiMasterPattern` (the base class) from a master
    pattern's data and fields (:func:`master_pattern_from_state`'s)."""
    return master_pattern_from_state(data, signal_class=KikuchiMasterPattern, **fields)


def ecp_master_pattern_from_state(data, **fields) -> ECPMasterPattern:
    """An :class:`ECPMasterPattern` from a master pattern's data and fields
    (:func:`master_pattern_from_state`'s)."""
    return master_pattern_from_state(data, signal_class=ECPMasterPattern, **fields)


def virtual_bse_image_from_state(data, metadata: dict | None = None, device=None) -> VirtualBSEImage:
    """A :class:`VirtualBSEImage` from an image ``(ny, nx)`` or ``(ny, nx,
    3)`` and its metadata."""
    return VirtualBSEImage(data=np.array(data), metadata=dict(metadata or {}), device=device)


def detector_from_state(
    shape,
    pc,
    sample_tilt: float = 70.0,
    tilt: float = 0.0,
    px_size: float = 1.0,
    binning: int = 1,
    convention: str = "bruker",
    azimuthal: float = 0.0,
    twist: float = 0.0,
) -> EBSDDetector:
    """An :class:`EBSDDetector` from a detector's fields. A JAX-side
    detector stores its PCs in Bruker's convention, so pass its ``pc``
    with ``convention="bruker"``."""
    return EBSDDetector(
        shape=tuple(shape),
        pc=np.asarray(pc, dtype=np.float64),
        sample_tilt=float(sample_tilt),
        tilt=float(tilt),
        px_size=float(px_size),
        binning=int(binning),
        azimuthal=float(azimuthal),
        twist=float(twist),
        convention=convention,
    )


def crystal_map_from_state(
    rotations,
    shape=None,
    phase_id=None,
    prop: dict | None = None,
    phase_name: str = "",
    point_group: str | None = None,
    space_group: int | None = None,
) -> CrystalMap:
    """A :class:`CrystalMap` from a crystal map's rotations ``(n, 4)`` (or
    ``(n, k, 4)``), navigation shape, phase ids and property arrays, with
    one phase."""
    return CrystalMap(
        rotations=np.asarray(rotations, dtype=np.float64),
        phase_id=None if phase_id is None else np.asarray(phase_id),
        shape=None if shape is None else tuple(shape),
        prop={k: np.asarray(v) for k, v in (prop or {}).items()},
        phases=PhaseList(Phase(name=phase_name, space_group=space_group, point_group=point_group)),
    )


def prepared_dictionary_from_state(
    prepared,
    q8: tuple | None = None,
    metric_name: str = "ncc",
    mask_hash: int | None = None,
    device=None,
) -> PreparedDictionary:
    """A :class:`PreparedDictionary` from a prepared ``(m, d)`` array, an
    optional ``(q int8 (m, d), scale (m,))`` pair, the metric name and
    the mask hash."""
    dev = resolve_device(device)
    prep = PreparedDictionary(
        prepared=as_tensor(prepared, dev, torch.float32),
        metric_name=metric_name,
        mask_hash=mask_hash,
    )
    if q8 is not None:
        q, s = q8
        prep._q8 = (as_tensor(q, dev, torch.int8), as_tensor(s, dev, torch.float32))
    return prep


def spherical_projector_from_state(coeffs, L: int, device=None) -> SphericalProjector:
    """A :class:`SphericalProjector` from a spherical projector's
    coefficients ``((L+1)^2,)`` and band limit ``L``, on ``device`` (None:
    the card), so that both packages synthesize from the same expansion."""
    coeffs = np.array(coeffs, dtype=np.float32)
    if coeffs.shape != ((int(L) + 1) ** 2,):
        raise ValueError(f"coeffs must be ({(int(L) + 1) ** 2},) for L={L}, got {coeffs.shape}")
    return SphericalProjector(coeffs=as_tensor(coeffs, resolve_device(device), torch.float32), L=int(L))
