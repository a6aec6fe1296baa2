"""Signal objects: EBSD scans (eager and lazy), master patterns and virtual
BSE images (``kikuchipy_tpu/signals``)."""

from kikuchipy_tpu_torch.signals import util
from kikuchipy_tpu_torch.signals.ebsd import EBSD
from kikuchipy_tpu_torch.signals.lazy import LazyEBSD
from kikuchipy_tpu_torch.signals.master_pattern import EBSDMasterPattern, ECPMasterPattern
from kikuchipy_tpu_torch.signals.virtual_bse_image import VirtualBSEImage

# Master patterns and virtual BSE images are small and stay in memory, so
# their Lazy* names are the eager classes, as in the JAX package; scans have
# a true out-of-core class, LazyEBSD.
LazyEBSDMasterPattern = EBSDMasterPattern
LazyECPMasterPattern = ECPMasterPattern
LazyVirtualBSEImage = VirtualBSEImage

__all__ = [
    "EBSD",
    "EBSDMasterPattern",
    "ECPMasterPattern",
    "LazyEBSD",
    "LazyEBSDMasterPattern",
    "LazyECPMasterPattern",
    "LazyVirtualBSEImage",
    "VirtualBSEImage",
    "util",
]
