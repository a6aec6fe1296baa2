"""TSL ``.ang`` crystal-map writer (``kikuchipy_tpu/io/plugins/ang.py``).

kikuchipy exports crystal maps through orix; this is a self-contained
writer of the EDAX/TSL .ang text format, so indexing results load in
vendor tools: one row per map point with Euler angles (radians), position,
image quality, confidence index and phase id.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from kikuchipy_tpu_torch.crystallography.crystal_map import CrystalMap
from kikuchipy_tpu_torch.geometry.quaternion import to_euler

__all__ = ["file_writer"]


def file_writer(
    filename: str | Path,
    xmap: CrystalMap,
    iq_prop: str = "scores",
    ci_prop: str = "scores",
    step_sizes: tuple[float, float] = (1.0, 1.0),
) -> None:
    """Write a crystal map to a .ang file."""
    euler = to_euler(torch.as_tensor(np.asarray(xmap.best_rotations), dtype=torch.float64)).numpy()
    n = xmap.size
    x = np.asarray(xmap.x) * step_sizes[1]
    y = np.asarray(xmap.y) * step_sizes[0]

    def _prop(name, default=0.0):
        v = xmap.prop.get(name)
        if v is None:
            return np.full(n, default)
        v = np.asarray(v, dtype=float)
        return v[:, 0] if v.ndim > 1 else v

    iq = _prop(iq_prop)
    ci = _prop(ci_prop)
    phase_id = np.asarray(xmap.phase_id)

    header_lines = ["# TEM_PIXperUM          1.000000"]
    for pid in xmap.phases.ids:
        phase = xmap.phases[pid]
        header_lines += [
            f"# Phase {pid + 1}",
            f"# MaterialName  \t{phase.name}",
            f"# Symmetry              {phase.space_group or 1}",
        ]
        if phase.lattice is not None:
            a, b, c, al, be, ga = phase.lattice[:6]
            header_lines.append(
                f"# LatticeConstants      {a:.3f} {b:.3f} {c:.3f}"
                f" {al:.3f} {be:.3f} {ga:.3f}"
            )
    header_lines += [
        "# GRID: SqrGrid",
        f"# XSTEP: {step_sizes[1]:.6f}",
        f"# YSTEP: {step_sizes[0]:.6f}",
        f"# NCOLS_ODD: {xmap.shape[-1]}",
        f"# NCOLS_EVEN: {xmap.shape[-1]}",
        f"# NROWS: {xmap.shape[0] if len(xmap.shape) == 2 else 1}",
        "# OPERATOR: kikuchipy_tpu",
        "#",
    ]
    rows = np.column_stack(
        [
            euler[:, 0],
            euler[:, 1],
            euler[:, 2],
            x,
            y,
            iq,
            ci,
            phase_id + 1,
            np.ones(n),  # detector signal
            np.zeros(n),  # fit
        ]
    )
    with open(filename, "w") as f:
        f.write("\n".join(header_lines) + "\n")
        np.savetxt(
            f,
            rows,
            fmt="%9.5f %9.5f %9.5f %12.5f %12.5f %7.3f %6.3f %2d %6d %6.3f",
        )
