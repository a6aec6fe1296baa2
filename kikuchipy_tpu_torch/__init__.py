"""kikuchipy_tpu_torch: the port of kikuchipy_tpu to PyTorch and CUDA.

The module layout and public names mirror ``kikuchipy_tpu``; entry points
run on the card (``torch.device("cuda")``) unless given ``device="cpu"``.
The kernels are hand-written CUDA for Hopper (``csrc/``), built with
``nvcc`` at first use. ``load`` reads a scan or master pattern from a file
(``lazy=True``: a :class:`~kikuchipy_tpu_torch.signals.lazy.LazyEBSD` that
reads and processes it a chunk at a time); ``save`` writes one.
``simulation`` (its alias ``simulations``) computes kinematical master
patterns on the card and geometrical simulations on a detector; ``draw``
and the plotting methods import ``matplotlib`` only when they run.
"""

from kikuchipy_tpu_torch import (
    crystallography,
    data,
    detectors,
    draw,
    filters,
    imaging,
    indexing,
    io,
    ops,
    pattern,
    signals,
    simulation,
    simulations,
)
from kikuchipy_tpu_torch.crystallography.crystal_map import CrystalMap, Phase, PhaseList
from kikuchipy_tpu_torch.geometry.detector import EBSDDetector
from kikuchipy_tpu_torch.indexing.di import dictionary_index, prepare_dictionary
from kikuchipy_tpu_torch.io._io import load, save
from kikuchipy_tpu_torch.signals import EBSD, EBSDMasterPattern, ECPMasterPattern, LazyEBSD, VirtualBSEImage
from kikuchipy_tpu_torch.utils.logging import set_log_level

__version__ = "0.1.0"

__all__ = [
    "CrystalMap",
    "EBSD",
    "EBSDDetector",
    "EBSDMasterPattern",
    "ECPMasterPattern",
    "LazyEBSD",
    "Phase",
    "PhaseList",
    "VirtualBSEImage",
    "__version__",
    "crystallography",
    "data",
    "detectors",
    "dictionary_index",
    "draw",
    "filters",
    "imaging",
    "indexing",
    "io",
    "load",
    "ops",
    "pattern",
    "prepare_dictionary",
    "save",
    "set_log_level",
    "signals",
    "simulation",
    "simulations",
]
