"""Logging control (``kikuchipy_tpu/utils/logging.py``)."""

from __future__ import annotations

import logging

__all__ = ["set_log_level"]


def set_log_level(level: int | str) -> None:
    """Set the log level of all ``kikuchipy_tpu_torch`` loggers.

    Parameters
    ----------
    level
        Any :mod:`logging` level, e.g. "DEBUG", "INFO", "WARNING".
    """
    logging.basicConfig()
    logging.getLogger("kikuchipy_tpu_torch").setLevel(level)
