"""Crystallography: symmetry, orientation sampling and crystal maps."""

from kikuchipy_tpu_torch.crystallography.crystal_map import CrystalMap, Phase, PhaseList
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
    "cu2ho",
    "cubochoric_sampling",
    "disorientation_angle",
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
