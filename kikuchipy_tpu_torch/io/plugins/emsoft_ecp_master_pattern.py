"""EMsoft ECP (electron channeling pattern) master pattern reader
(``kikuchipy_tpu/io/plugins/emsoft_ecp_master_pattern.py``): data under ``EMData/ECPmaster``, read
as an :class:`ECPMasterPattern`."""

from __future__ import annotations

from pathlib import Path

from kikuchipy_tpu_torch.io.plugins.emsoft_ebsd_master_pattern import (
    read_emsoft_master_pattern,
)
from kikuchipy_tpu_torch.signals.master_pattern import ECPMasterPattern

__all__ = ["file_reader"]


def file_reader(filename: str | Path, **kwargs) -> ECPMasterPattern:
    return read_emsoft_master_pattern(
        filename,
        data_group="EMData/ECPmaster",
        energy_string="EkeV",
        signal_class=ECPMasterPattern,
        **kwargs,
    )
