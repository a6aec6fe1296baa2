"""kikuchipy_tpu_torch: the port of kikuchipy_tpu to PyTorch and CUDA.

The module layout and public names mirror ``kikuchipy_tpu``; entry points
run on the card (``torch.device("cuda")``) unless given ``device="cpu"``.
The fused int8 indexing kernel is hand-written CUDA for Hopper
(``csrc/ncc_topk_int8.cu``), built with ``nvcc`` at first use.
"""

from kikuchipy_tpu_torch.crystallography.crystal_map import CrystalMap, Phase, PhaseList
from kikuchipy_tpu_torch.geometry.detector import EBSDDetector
from kikuchipy_tpu_torch.indexing.di import dictionary_index, prepare_dictionary
from kikuchipy_tpu_torch.signals import EBSD, EBSDMasterPattern

__all__ = [
    "CrystalMap",
    "EBSD",
    "EBSDDetector",
    "EBSDMasterPattern",
    "Phase",
    "PhaseList",
    "dictionary_index",
    "prepare_dictionary",
]
