"""Device-mesh and multi-process parallelism (``kikuchipy_tpu/parallel``)
on ``torch.distributed``."""

from kikuchipy_tpu_torch.parallel.refine import (
    sharded_refine_orientation,
    sharded_refine_orientation_projection_center,
    sharded_refine_projection_center,
)
from kikuchipy_tpu_torch.parallel.mesh import (
    make_mesh,
    sharded_dictionary_index,
    sharded_fused_dictionary_index,
    sharded_match_topk,
)
from kikuchipy_tpu_torch.parallel.multihost import (
    host_navigation_slice,
    multihost_dictionary_index,
    multihost_mesh,
    multihost_refine_orientation,
)

__all__ = [
    "host_navigation_slice",
    "make_mesh",
    "multihost_dictionary_index",
    "multihost_mesh",
    "multihost_refine_orientation",
    "sharded_dictionary_index",
    "sharded_fused_dictionary_index",
    "sharded_match_topk",
    "sharded_refine_orientation",
    "sharded_refine_orientation_projection_center",
    "sharded_refine_projection_center",
]
