"""Crystallography: symmetry, orientation sampling, crystal maps, IPF
colors, and reciprocal-lattice and space-group tools."""

from kikuchipy_tpu_torch.crystallography.crystal_map import CrystalMap, Phase, PhaseList
from kikuchipy_tpu_torch.crystallography.ipf import IPFColorKeyTSL, ipf_color
from kikuchipy_tpu_torch.crystallography.reciprocal import Lattice, ReciprocalLatticeVectors, electron_wavelength
from kikuchipy_tpu_torch.crystallography.sampling import (
    cu2ho,
    cubochoric_sampling,
    disorientation_angle,
    get_sample_fundamental,
    ho2qu,
    in_fundamental_zone,
    reduce_to_fundamental_zone,
    sample_fundamental_zone,
    super_fibonacci,
)
from kikuchipy_tpu_torch.crystallography.spacegroup import (
    centering_letter,
    centering_translations,
    expand_atoms,
    general_positions,
)
from kikuchipy_tpu_torch.crystallography.symmetry import (
    PointGroup,
    get_point_group,
    point_group_from_space_group,
    proper_rotations,
)

__all__ = [
    "CrystalMap",
    "IPFColorKeyTSL",
    "ipf_color",
    "Lattice",
    "centering_letter",
    "centering_translations",
    "expand_atoms",
    "general_positions",
    "Phase",
    "PhaseList",
    "PointGroup",
    "ReciprocalLatticeVectors",
    "cu2ho",
    "cubochoric_sampling",
    "disorientation_angle",
    "electron_wavelength",
    "get_point_group",
    "get_sample_fundamental",
    "ho2qu",
    "in_fundamental_zone",
    "point_group_from_space_group",
    "proper_rotations",
    "reduce_to_fundamental_zone",
    "sample_fundamental_zone",
    "super_fibonacci",
]
