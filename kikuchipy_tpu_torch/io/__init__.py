"""Reading and writing scans and master patterns (``kikuchipy_tpu/io``)."""

from kikuchipy_tpu_torch.io._io import load, plugins, save

__all__ = ["load", "plugins", "save"]
