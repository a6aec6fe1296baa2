"""Signal objects: EBSD scans and master patterns."""

from kikuchipy_tpu_torch.signals.ebsd import EBSD
from kikuchipy_tpu_torch.signals.master_pattern import EBSDMasterPattern

__all__ = ["EBSD", "EBSDMasterPattern"]
