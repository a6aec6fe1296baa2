"""Crystallography: symmetry, orientation sampling and crystal maps."""

from kikuchipy_tpu_torch.crystallography.crystal_map import CrystalMap, Phase, PhaseList
from kikuchipy_tpu_torch.crystallography.sampling import (
    disorientation_angle,
    in_fundamental_zone,
    reduce_to_fundamental_zone,
    sample_fundamental_zone,
    super_fibonacci,
)
from kikuchipy_tpu_torch.crystallography.symmetry import (
    PointGroup,
    get_point_group,
    point_group_from_space_group,
    proper_rotations,
)

__all__ = [
    "CrystalMap",
    "Phase",
    "PhaseList",
    "PointGroup",
    "disorientation_angle",
    "get_point_group",
    "in_fundamental_zone",
    "point_group_from_space_group",
    "proper_rotations",
    "reduce_to_fundamental_zone",
    "sample_fundamental_zone",
    "super_fibonacci",
]
