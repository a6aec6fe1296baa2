"""EMsoft TKD master pattern reader
(``kikuchipy_tpu/io/plugins/emsoft_tkd_master_pattern.py``): data under ``EMData/TKDmaster``, read
as an :class:`EBSDMasterPattern`."""

from __future__ import annotations

from pathlib import Path

from kikuchipy_tpu_torch.io.plugins.emsoft_ebsd_master_pattern import (
    read_emsoft_master_pattern,
)
from kikuchipy_tpu_torch.signals.master_pattern import EBSDMasterPattern

__all__ = ["file_reader"]


def file_reader(filename: str | Path, **kwargs) -> EBSDMasterPattern:
    return read_emsoft_master_pattern(
        filename,
        data_group="EMData/TKDmaster",
        energy_string="EkeVs",
        signal_class=EBSDMasterPattern,
        **kwargs,
    )
