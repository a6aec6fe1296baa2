"""Master-pattern projection: detector direction cosines and batched
projection of EBSD patterns from square-Lambert master patterns.

Counterpart of ``kikuchipy_tpu/projection/master_pattern.py`` (XLA code
there, not a TPU kernel): quaternion rotate -> Lambert -> bilinear gather
over all (rotation, pixel) pairs, both hemispheres packed into one "quad
texture" so the four bilinear taps and the hemisphere select are one
gather. :func:`project_patterns` runs that gather as one hand-written
kernel on the card (:func:`kikuchipy_tpu_torch.ops.lambert_project.
lambert_project`) and as plain PyTorch on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from kikuchipy_tpu_torch.geometry.lambert import SQRT_PI_HALF, vector_to_lambert
from kikuchipy_tpu_torch.ops.lambert_project import lambert_project
from kikuchipy_tpu_torch.utils.device import resolve_device

__all__ = [
    "direction_cosines",
    "direction_cosines_from_detector",
    "lambert_interpolation_weights",
    "project_patterns",
    "project_single_pattern",
    "quad_texture",
]


def direction_cosines(
    gnomonic_bounds: torch.Tensor,
    pcz: torch.Tensor,
    nrows: int,
    ncols: int,
    om_detector_to_sample: torch.Tensor,
    signal_mask: np.ndarray | None = None,
) -> torch.Tensor:
    """Unit direction cosines from the beam source to the detector pixels,
    in the sample frame: ``(n_pixels, 3)`` for bounds ``(4,)``, or
    ``(n_pc, n_pixels, 3)`` for bounds ``(n_pc, 4)``. Pixel centers are
    half a pixel in from the gnomonic bounds, y decreasing from the top.
    """
    squeeze = gnomonic_bounds.ndim == 1
    gb = torch.atleast_2d(gnomonic_bounds)
    pcz_arr = torch.reshape(pcz, (-1, 1))

    idx = np.arange(nrows * ncols)
    if signal_mask is not None:
        idx = idx[np.asarray(signal_mask).ravel()]
    rows = torch.as_tensor(idx // ncols, device=gb.device)
    cols = torch.as_tensor(idx % ncols, device=gb.device)

    x_scale = (gb[:, 1:2] - gb[:, 0:1]) / ncols
    y_scale = (gb[:, 3:4] - gb[:, 2:3]) / nrows
    x = (gb[:, 0:1] + cols[None, :] * x_scale + x_scale / 2) * pcz_arr
    y = (gb[:, 3:4] - rows[None, :] * y_scale - y_scale / 2) * pcz_arr
    z = torch.broadcast_to(pcz_arr, x.shape)
    r = torch.stack([x, y, z], dim=-1)

    r = r @ om_detector_to_sample.T
    r = r / torch.linalg.norm(r, dim=-1, keepdim=True)
    return r[0] if squeeze else r


def direction_cosines_from_detector(
    detector, signal_mask: np.ndarray | None = None, dtype=torch.float32, device=None
) -> torch.Tensor:
    """Direction cosines of an :class:`~kikuchipy_tpu_torch.geometry.
    detector.EBSDDetector`, computed in float64 and cast to ``dtype``:
    ``(n_pixels, 3)`` for one PC, ``(nav_size, n_pixels, 3)`` for many. On
    the card unless ``device`` says otherwise."""
    f64 = dict(dtype=torch.float64, device=resolve_device(device))
    om = torch.as_tensor(detector.detector_to_sample, **f64)
    if detector.navigation_size == 1:
        gb = torch.as_tensor(np.asarray(detector.gnomonic_bounds, dtype=np.float64).reshape(4), **f64)
        pcz = torch.as_tensor(float(np.asarray(detector.pcz).reshape(())), **f64)
    else:
        gb = torch.as_tensor(np.asarray(detector.gnomonic_bounds, dtype=np.float64).reshape(-1, 4), **f64)
        pcz = torch.as_tensor(np.asarray(detector.pcz, dtype=np.float64).ravel(), **f64)
    dc = direction_cosines(gb, pcz, detector.nrows, detector.ncols, om, signal_mask=signal_mask)
    return dc.to(dtype)


def lambert_interpolation_weights(v: torch.Tensor, npx: int, npy: int, scale: float):
    """Bilinear indices and weights on the square-Lambert grid for unit
    vectors ``v (..., 3)``: ``(nii, nij, niip, nijp, weights)`` with
    ``weights (..., 4)`` ordered ``(dim*djm, di*djm, dim*dj, di*dj)``."""
    xy = scale * vector_to_lambert(v) / SQRT_PI_HALF
    i = xy[..., 1]
    j = xy[..., 0]

    # Truncation of (coord + scale); coords are >= 0 so this floors.
    nii = (i + scale).to(torch.int32)
    nij = (j + scale).to(torch.int32)
    niip = torch.clamp(nii + 1, max=npx - 1)
    nijp = torch.clamp(nij + 1, max=npy - 1)
    nii = torch.where(nii < 0, niip, nii)
    nij = torch.where(nij < 0, nijp, nij)

    di = i - nii.to(i.dtype) + scale
    dj = j - nij.to(j.dtype) + scale
    # Outside the Lambert square both taps collapse to the clamped
    # index, so the "+1" weight must vanish (keeps the quad texture
    # exact; the four weights still sum to one). A maximum and a minimum,
    # as jnp.clip is: their tangents split evenly at a tie, so a weight at
    # exactly 0 or 1 has JAX's derivative (torch.clamp passes all of it).
    zero, one = di.new_zeros(()), di.new_ones(())
    di = torch.minimum(torch.maximum(di, zero), one)
    dj = torch.minimum(torch.maximum(dj, zero), one)
    dim = 1.0 - di
    djm = 1.0 - dj
    weights = torch.stack([dim * djm, di * djm, dim * dj, di * dj], dim=-1)
    return nii, nij, niip, nijp, weights


def quad_texture(master: torch.Tensor) -> torch.Tensor:
    """Pack each 2x2 bilinear neighbourhood of the ``(2, npy, npx)``
    master into one row of a ``(2 * npy * npx, 4)`` table (edge rows and
    columns replicated, matching the clamped indices)."""
    m = master
    m_i1 = torch.cat([m[:, 1:], m[:, -1:]], dim=1)
    quad = torch.stack(
        [
            m,
            m_i1,
            torch.cat([m[:, :, 1:], m[:, :, -1:]], dim=2),
            torch.cat([m_i1[:, :, 1:], m_i1[:, :, -1:]], dim=2),
        ],
        dim=-1,
    )
    return quad.reshape(-1, 4)


def _bilinear_gather(quad: torch.Tensor, npy: int, npx: int, hemi, nii, nij, weights) -> torch.Tensor:
    idx = hemi * (npy * npx) + nii * npx + nij
    taps = quad[idx.long()]
    return torch.sum(taps * weights, dim=-1)


def project_patterns(
    rotations: torch.Tensor,
    dc: torch.Tensor,
    master: torch.Tensor,
    npx: int,
    npy: int,
    scale: float,
    rescale: bool = False,
    out_min: float = 0.0,
    out_max: float = 1.0,
    quad: torch.Tensor | None = None,
) -> torch.Tensor:
    """Project a batch of patterns ``(n, n_pixels)`` for rotations
    ``(n, 4)`` from the packed master ``(2, npy, npx)`` (upper first).

    ``dc`` is ``(n_pixels, 3)`` (one PC) or ``(n, n_pixels, 3)``;
    ``scale`` is ``(npx - 1) / 2``; ``rescale`` maps each pattern's
    min/max to ``[out_min, out_max]``. ``quad`` may pass a precomputed
    :func:`quad_texture` of ``master``. On the card float32 operands go
    through one launch of the projection kernel.
    """
    if quad is None:
        quad = quad_texture(master)
    return lambert_project(rotations, dc, quad, npx, npy, scale, rescale, out_min, out_max)


def project_single_pattern(
    rotation: torch.Tensor, dc: torch.Tensor, master: torch.Tensor, npx: int, npy: int, scale: float, **kwargs
) -> torch.Tensor:
    """Project one pattern ``(n_pixels,)`` for a rotation ``(4,)`` (a
    convenience wrapper over :func:`project_patterns`)."""
    return project_patterns(rotation[None], dc, master, npx, npy, scale, **kwargs)[0]
