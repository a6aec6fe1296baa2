"""Alias of :mod:`kikuchipy_tpu_torch.simulation` under kikuchipy's
``kikuchipy.simulations`` name."""

from kikuchipy_tpu_torch.simulation import (
    GeometricalKikuchiPatternSimulation,
    KikuchiPatternLine,
    KikuchiPatternSimulator,
    KikuchiPatternZoneAxis,
)

__all__ = [
    "GeometricalKikuchiPatternSimulation",
    "KikuchiPatternLine",
    "KikuchiPatternSimulator",
    "KikuchiPatternZoneAxis",
]
