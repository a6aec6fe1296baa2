"""Multi-device refinement: map points data-parallel over the ``scan``
mesh axis (``kikuchipy_tpu/parallel/refine.py``).

The refinement objectives (orientation, projection center, and joint) are
elementwise over map points (solver state is per point), so partitioning
is pure data parallelism: the points are padded to a multiple of the scan
axis and each scan shard is refined by the same single-device call on its
shard's device (by default one launch of the Nelder-Mead kernel a shard on
the card), with no communication. The shards run one after another.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "sharded_refine_orientation",
    "sharded_refine_projection_center",
    "sharded_refine_orientation_projection_center",
]


def _sharded_refine(
    refine_fn,
    signal,
    xmap=None,
    detector=None,
    master_pattern=None,
    energy: float | None = None,
    mesh=None,
    pc_per_point: bool = False,
    **kwargs,
):
    """Run ``refine_fn`` (one of the three refinement modes) on each scan
    shard of the mesh, on the shard's device.

    Map points are padded to a multiple of the scan-axis size by repeating
    point 0 (per-point PCs pad with the patterns); results (rotations,
    properties, per-point PCs of the PC and joint modes, for which
    ``pc_per_point`` is set) are concatenated and unpadded on the way out.
    """
    from kikuchipy_tpu_torch.crystallography.crystal_map import CrystalMap
    from kikuchipy_tpu_torch.indexing.refinement import RefinementResult
    from kikuchipy_tpu_torch.parallel.mesh import make_mesh
    from kikuchipy_tpu_torch.signals.ebsd import EBSD

    if mesh is None:
        mesh = make_mesh()
    n_scan = mesh.devices.shape[0]

    xmap = xmap if xmap is not None else signal.xmap
    n = signal.navigation_size
    pad = (-n) % n_scan

    data = signal.data.reshape((n,) + signal.signal_shape)
    q0 = np.asarray(xmap.best_rotations)
    if pad:
        data = torch.cat([data, data[:1].expand((pad,) + tuple(data.shape[1:]))])
        q0 = np.concatenate([q0, np.repeat(q0[:1], pad, axis=0)])

    det = detector if detector is not None else signal.detector
    if det is not None and det.navigation_size not in (1, n + pad):
        # Per-point PCs must pad with the patterns.
        pc = np.asarray(det.pc).reshape(-1, 3)
        if pc.shape[0] != n:
            raise ValueError(f"detector has {pc.shape[0]} PCs for {n} map points")
        if pad:
            pc = np.concatenate([pc, np.repeat(pc[:1], pad, axis=0)])
        det = dataclasses.replace(det, pc=pc)
    per_point_in = det is not None and det.navigation_size == n + pad and n + pad > 1

    rows = (n + pad) // n_scan
    results = []
    for s in range(n_scan):
        sl = slice(s * rows, (s + 1) * rows)
        dev = mesh.devices[s, 0]
        det_s = dataclasses.replace(det, pc=np.asarray(det.pc).reshape(-1, 3)[sl]) if per_point_in else det
        shard = EBSD(data=data[sl].to(dev), detector=det_s, static_background=signal.static_background, device=dev)
        results.append(refine_fn(
            shard,
            xmap=CrystalMap(rotations=q0[sl], shape=(rows,), phases=xmap.phases),
            detector=det_s,
            master_pattern=master_pattern,
            energy=energy,
            **kwargs,
        ))

    first = results[0].xmap
    trimmed_xmap = CrystalMap(
        rotations=np.concatenate([np.asarray(r.xmap.rotations) for r in results])[:n],
        phase_id=np.asarray(xmap.phase_id),
        shape=signal.navigation_shape,
        prop={k: np.concatenate([np.asarray(r.xmap.prop[k]) for r in results])[:n] for k in first.prop},
        phases=first.phases,
    )
    det_out = results[0].detector
    if det_out is not None and (per_point_in or pc_per_point):
        # One PC per (padded) point: trim the padding and restore the
        # navigation shape unconditionally, whether or not the scan size
        # divided the mesh.
        nav_shape = signal.navigation_shape
        pc = np.concatenate([np.asarray(r.detector.pc).reshape(-1, 3) for r in results])[:n]
        det_out = dataclasses.replace(det_out, pc=pc.reshape(nav_shape + (3,) if len(nav_shape) == 2 else (-1, 3)))
    return RefinementResult(xmap=trimmed_xmap, detector=det_out)


def sharded_refine_orientation(signal, **kwargs):
    """:func:`~kikuchipy_tpu_torch.indexing.refinement.refine_orientation`
    scan-sharded over the mesh (see :func:`_sharded_refine`)."""
    from kikuchipy_tpu_torch.indexing.refinement import refine_orientation

    return _sharded_refine(refine_orientation, signal, **kwargs)


def sharded_refine_projection_center(signal, **kwargs):
    """:func:`~kikuchipy_tpu_torch.indexing.refinement.
    refine_projection_center` scan-sharded over the mesh; per-point
    refined PCs come back unpadded."""
    from kikuchipy_tpu_torch.indexing.refinement import refine_projection_center

    return _sharded_refine(refine_projection_center, signal, pc_per_point=True, **kwargs)


def sharded_refine_orientation_projection_center(signal, **kwargs):
    """:func:`~kikuchipy_tpu_torch.indexing.refinement.
    refine_orientation_projection_center` scan-sharded over the mesh."""
    from kikuchipy_tpu_torch.indexing.refinement import refine_orientation_projection_center

    return _sharded_refine(refine_orientation_projection_center, signal, pc_per_point=True, **kwargs)
