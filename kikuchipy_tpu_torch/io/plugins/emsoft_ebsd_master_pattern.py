"""EMsoft EBSD master pattern HDF5 reader (``kikuchipy_tpu/io/plugins/
emsoft_ebsd_master_pattern.py``).

Reads master patterns simulated with EMsoft's ``EMEBSDmaster`` program
(kikuchipy's ``_emsoft_master_pattern.py`` and
``emsoft_ebsd_master_pattern/_api.py``): square Lambert hemispheres ``EMData/EBSDmaster/mLPNH``/``mLPSH`` of
shape ``(numset, n_energy, 2*npx+1, 2*npx+1)`` or stereographic
``masterSPNH``/``masterSPSH``, with the energy grid in ``EkeVs`` and the
crystal in ``CrystalData``. ``h5py`` is imported when a file is read.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from kikuchipy_tpu_torch.crystallography.crystal_map import Phase
from kikuchipy_tpu_torch.signals.master_pattern import EBSDMasterPattern
from kikuchipy_tpu_torch.utils.device import resolve_device

__all__ = ["file_reader", "read_emsoft_master_pattern"]


def _read_phase(f, data_group: str) -> Phase:
    phase = Phase(name="")
    if "CrystalData" in f:
        cd = f["CrystalData"]
        if "SpaceGroupNumber" in cd:
            phase.space_group = int(np.asarray(cd["SpaceGroupNumber"]).ravel()[0])
        if "LatticeParameters" in cd:
            phase.lattice = tuple(np.asarray(cd["LatticeParameters"]).ravel())
        # EMsoft AtomData rows: (x, y, z, occupancy, Debye-Waller), one
        # column per atom; Atomtypes holds the atomic numbers.
        if "AtomData" in cd and "Atomtypes" in cd:
            atom_data = np.atleast_2d(np.asarray(cd["AtomData"]))
            types = np.atleast_1d(np.asarray(cd["Atomtypes"])).ravel()
            # EMsoft stores (5, n_atoms): rows x, y, z, occupancy, DW.
            if atom_data.shape[0] == 5 and atom_data.shape[1] == types.size:
                atom_data = atom_data.T  # -> (n_atoms, 5)
            atoms = []
            for i, z in enumerate(types[: atom_data.shape[0]]):
                x, y, zc = atom_data[i, :3]
                occ = atom_data[i, 3] if atom_data.shape[1] > 3 else 1.0
                atoms.append((int(z), float(x), float(y), float(zc), float(occ)))
            phase.atoms = atoms
    name_ds = f.get(f"{data_group}/xtalname")
    if name_ds is not None:
        raw = np.asarray(name_ds).ravel()[0]
        name = raw.decode() if isinstance(raw, bytes) else str(raw)
        phase.name = name.replace(".xtal", "")
    return phase


def file_reader(
    filename: str | Path,
    projection: str = "stereographic",
    hemisphere: str = "upper",
    energy: float | tuple[float, float] | None = None,
    lazy: bool = False,
    device=None,
) -> EBSDMasterPattern:
    """Read an EMsoft EBSD master pattern.

    Parameters
    ----------
    filename
        EMsoft HDF5 file.
    projection
        "stereographic" (default, matching the reference) or "lambert".
    hemisphere
        "upper", "lower", or "both".
    energy
        Single energy (kV) or ``(min, max)`` range to keep; all energy
        bins if not given.
    lazy
        Accepted and ignored (master patterns stay in memory).
    device
        Where the master pattern's operations run; ``None`` is the card.
    """
    return read_emsoft_master_pattern(
        filename,
        data_group="EMData/EBSDmaster",
        energy_string="EkeVs",
        signal_class=EBSDMasterPattern,
        projection=projection,
        hemisphere=hemisphere,
        energy=energy,
        device=device,
    )


def read_emsoft_master_pattern(
    filename: str | Path,
    data_group: str,
    energy_string: str,
    signal_class,
    projection: str = "stereographic",
    hemisphere: str = "upper",
    energy: float | tuple[float, float] | None = None,
    device=None,
):
    """Shared EMsoft master-pattern reading core (the EBSD, ECP and TKD
    variants differ only in data group and energy dataset name)."""
    import h5py

    device = resolve_device(device)
    with h5py.File(filename, "r") as f:
        if data_group not in f:
            raise IOError(
                f"{filename} is not an EMsoft master pattern file (missing "
                f"{data_group})"
            )
        g = f[data_group]
        energies = np.atleast_1d(np.asarray(g[energy_string][()]))

        if projection == "lambert":
            upper_name, lower_name = "mLPNH", "mLPSH"
        elif projection == "stereographic":
            upper_name, lower_name = "masterSPNH", "masterSPSH"
        else:
            raise ValueError(
                f"projection must be 'lambert' or 'stereographic', got "
                f"{projection!r}"
            )

        def read_hemi(name):
            arr = g[name][()]
            # (numset, nE, y, x) -> sum sites; (nE, y, x) stays
            if arr.ndim == 4:
                if arr.shape[0] > 1:
                    arr = arr.sum(axis=0)
                else:
                    arr = arr[0]
            return arr

        upper = read_hemi(upper_name)
        lower = read_hemi(lower_name)

        # Energy selection
        if energy is not None:
            if np.isscalar(energy):
                idx = np.array([np.abs(energies - energy).argmin()])
            else:
                lo, hi = energy
                idx = np.nonzero((energies >= lo) & (energies <= hi))[0]
            upper, lower = upper[idx], lower[idx]
            energies = energies[idx]

        if hemisphere == "upper":
            data = upper
        elif hemisphere == "lower":
            data = lower
        elif hemisphere == "both":
            data = np.stack([upper, lower], axis=-3)  # (nE, 2, y, x)
        else:
            raise ValueError(
                f"hemisphere must be 'upper', 'lower' or 'both', got "
                f"{hemisphere!r}"
            )
        if data.shape[0] == 1 and data.ndim >= 3:
            data = data[0]

        phase = _read_phase(f, data_group)

    return signal_class(
        data=data,
        phase=phase,
        hemisphere=hemisphere,
        projection=projection,
        energies=energies,
        metadata={"filename": str(filename)},
        device=device,
    )
