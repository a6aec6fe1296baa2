"""Simulation: kinematical master patterns and geometrical simulations on
a detector (the JAX package's ``simulation``, kikuchipy's
``simulations``)."""

from kikuchipy_tpu_torch.simulation.features import (
    KikuchiPatternLine,
    KikuchiPatternZoneAxis,
)
from kikuchipy_tpu_torch.simulation.kikuchi_pattern_simulator import (
    GeometricalKikuchiPatternSimulation,
    KikuchiPatternSimulator,
)

__all__ = [
    "GeometricalKikuchiPatternSimulation",
    "KikuchiPatternLine",
    "KikuchiPatternSimulator",
    "KikuchiPatternZoneAxis",
]
