"""Profiling helpers.

- :func:`trace`: a :mod:`torch.profiler` capture (CPU and, where there is a
  card, CUDA activities) that writes a TensorBoard-compatible Chrome trace
  into a directory, as JAX's ``jax.profiler.trace`` does;
- :class:`StageTimer`: per-stage wall time and item counts with items/s a
  stage (a copy of JAX's; it does not synchronize the card, so time work
  that ends in a host read or a ``torch.cuda.synchronize()``).
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from pathlib import Path

import torch

__all__ = ["trace", "StageTimer"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device trace into ``log_dir`` (one
    ``<host>_<pid>.<time>.pt.trace.json`` a capture, TensorBoard's name for
    it; view with TensorBoard or Perfetto). The card is synchronized before
    the capture ends, so the trace holds every kernel queued inside the
    block. Yields the :class:`torch.profiler.profile`."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    path = Path(log_dir)
    path.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path / f"{socket.gethostname()}_{os.getpid()}.{time.time_ns()}.pt.trace.json"))


class StageTimer:
    """Accumulate wall time and item counts per named pipeline stage.

    Example
    -------
    >>> timer = StageTimer()
    >>> with timer.stage("preprocess", items=1024):
    ...     pass  # run the stage
    >>> report = timer.report()
    """

    def __init__(self) -> None:
        self._stages: dict[str, tuple[float, int]] = {}

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            prev_t, prev_n = self._stages.get(name, (0.0, 0))
            self._stages[name] = (prev_t + dt, prev_n + items)

    def report(self) -> dict[str, dict[str, float]]:
        """Per-stage seconds, items, and items/s."""
        out = {}
        for name, (seconds, items) in self._stages.items():
            out[name] = {
                "seconds": seconds,
                "items": items,
                "items_per_second": items / seconds if seconds > 0 else 0.0,
            }
        return out

    def __repr__(self) -> str:
        rows = [
            f"{name}: {v['seconds']:.3f}s"
            + (f", {v['items_per_second']:.1f} items/s" if v["items"] else "")
            for name, v in self.report().items()
        ]
        return "StageTimer(" + "; ".join(rows) + ")"
