"""Master-pattern projection and projection-NCC: the two kernels of
``csrc/lambert_project.cu`` and their plain PyTorch twins.

Both replace XLA code of the JAX package, not TPU kernels:

==========================  ==============================================
port                        JAX function (XLA code)
==========================  ==============================================
:func:`lambert_project`     ``projection/master_pattern.py``
                            ``project_patterns`` (rotate, Lambert, four-tap
                            gather, optional min/max rescale)
:func:`lambert_project_ncc` ``indexing/refinement.py`` ``_project_at`` then
                            ``_ncc_centered``: ``1 - NCC`` of the centred
                            experimental rows against the projection
==========================  ==============================================

For CPU tensors a wrapper returns its ``_plain`` twin; for CUDA tensors it
launches its kernel or raises, and counts the launch in its own
``.launches``. The twins define the function, and run in any float dtype.
Both kernels compute each pixel with ``csrc/lambert_common.cuh``
``lambert_pixel`` (approximate reciprocals, a polynomial ``atan``, every
product, sum and FMA written out, and no cancellation near the Lambert
poles), which the Nelder-Mead kernel and kernel F share, so the host loops
over kernel B and those kernels round every pixel alike. Its yardstick is
the twin run on float64 operands: each kernel is held to be no further from
it than the float32 twin is (``chip_smoke.py`` ``projection_checks`` and
``ncc_kernel_checks``, ``tests/test_torch_gpu.py``); kernel B also within
2e-6 of the float32 twin's ``1 - NCC``.

Arguments of both: ``rotations (B, 4)`` float32 unit quaternions; ``dc``
direction cosines ``(P, 3)`` shared by all rotations or ``(B, P, 3)``, one
set per rotation; ``quad`` the master pattern's
:func:`~kikuchipy_tpu_torch.projection.master_pattern.quad_texture`
``(2 * npy * npx, 4)``; ``npx``, ``npy`` the master's shape and ``scale``
``(npx - 1) / 2``.
"""

from __future__ import annotations

import ctypes

import torch

__all__ = [
    "lambert_project",
    "lambert_project_plain",
    "lambert_project_ncc",
    "lambert_project_ncc_plain",
    "ncc_centered",
]


_ARGTYPES = {
    "lambert_project": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int]
    + [ctypes.c_float] * 2 + [ctypes.c_void_p],
    "lambert_project_ncc": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p],
}


def _function(name: str):
    """``<name>_launch`` of ``csrc/lambert_project.cu``, built on first use."""
    from kikuchipy_tpu_torch.ops._build import library

    fn = getattr(library("lambert_project"), f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _check(rotations, dc, quad, npx: int, npy: int, exp=None, sq_norm=None) -> None:
    if rotations.ndim != 2 or rotations.shape[1] != 4 or rotations.shape[0] < 1:
        raise ValueError(f"rotations must be (B, 4), got {tuple(rotations.shape)}")
    B = rotations.shape[0]
    if not (dc.ndim == 2 and dc.shape[1] == 3) and not (dc.ndim == 3 and dc.shape[0] == B and dc.shape[2] == 3):
        raise ValueError(f"dc must be (P, 3) or ({B}, P, 3), got {tuple(dc.shape)}")
    if dc.shape[-2] < 1:
        raise ValueError("dc holds no pixels")
    if tuple(quad.shape) != (2 * npy * npx, 4):
        raise ValueError(f"quad must be ({2 * npy * npx}, 4) for a {npy} x {npx} master, got {tuple(quad.shape)}")
    P = dc.shape[-2]
    if exp is not None and (tuple(exp.shape) != (B, P) or tuple(sq_norm.shape) != (B,)):
        raise ValueError(f"exp must be ({B}, {P}) and sq_norm ({B},), got {tuple(exp.shape)}, {tuple(sq_norm.shape)}")


def _cuda_operands(*tensors: torch.Tensor) -> list[torch.Tensor]:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    out = []
    for t in tensors:
        if t.device != dev:
            raise ValueError("all operands must be on one device")
        if t.dtype != torch.float32:
            raise TypeError(f"the kernels take float32, got {t.dtype}")
        out.append(t.contiguous())
    if out[2].data_ptr() % 16:
        raise ValueError("quad must be 16-byte aligned (one float4 a neighbourhood)")
    return out


# --------------------------- plain twins --------------------------- #


def _project_plain(rotations, dc, quad, npx: int, npy: int, scale: float, taps: bool = False):
    from kikuchipy_tpu_torch.geometry.quaternion import rotate_vector
    from kikuchipy_tpu_torch.projection.master_pattern import _bilinear_gather, lambert_interpolation_weights

    rotated = rotate_vector(rotations[:, None, :], dc if dc.ndim == 3 else dc[None, :, :])
    nii, nij, _, _, weights = lambert_interpolation_weights(rotated, npx, npy, scale)
    hemi = (rotated[..., 2] < 0).to(torch.int32)
    patterns = _bilinear_gather(quad, npy, npx, hemi, nii, nij, weights)
    return (patterns, hemi * (npy * npx) + nii * npx + nij) if taps else patterns


def lambert_project_plain(
    rotations, dc, quad, npx: int, npy: int, scale: float, rescale: bool = False,
    out_min: float = 0.0, out_max: float = 1.0, taps: bool = False,
):
    """Patterns ``(B, P)``: the JAX ``project_patterns`` in PyTorch ops;
    with ``taps`` also the quad-texture row ``(B, P)`` int32 each pixel
    read."""
    _check(rotations, dc, quad, npx, npy)
    patterns, tap = _project_plain(rotations, dc, quad, npx, npy, scale, taps=True)
    if rescale:
        imin = torch.amin(patterns, dim=-1, keepdim=True)
        imax = torch.amax(patterns, dim=-1, keepdim=True)
        patterns = (patterns - imin) / (imax - imin) * (out_max - out_min) + out_min
    return (patterns, tap) if taps else patterns


def ncc_centered(exp_centered, exp_sq_norm, sim) -> torch.Tensor:
    """NCC of centred experimental rows against raw simulated rows (the
    JAX package's ``_ncc_centered``)."""
    sim = sim - torch.mean(sim, dim=-1, keepdim=True)
    num = torch.sum(exp_centered * sim, dim=-1)
    den = torch.sqrt(exp_sq_norm * torch.sum(torch.square(sim), dim=-1))
    return num / den


def lambert_project_ncc_plain(rotations, dc, quad, npx: int, npy: int, scale: float, exp, sq_norm) -> torch.Tensor:
    """``1 - NCC`` ``(B,)`` of ``exp (B, P)`` (centred) with squared norms
    ``sq_norm (B,)`` against the projections at ``rotations``."""
    _check(rotations, dc, quad, npx, npy, exp, sq_norm)
    return 1.0 - ncc_centered(exp, sq_norm, _project_plain(rotations, dc, quad, npx, npy, scale))


# ----------------------------- kernels ----------------------------- #


def lambert_project(
    rotations, dc, quad, npx: int, npy: int, scale: float, rescale: bool = False,
    out_min: float = 0.0, out_max: float = 1.0, taps: bool = False,
):
    """Patterns ``(B, P)`` float32 projected at ``rotations``, optionally
    min/max-rescaled per pattern to ``[out_min, out_max]``; with ``taps``
    also the quad-texture row ``(B, P)`` int32 each pixel read. On the
    card one launch of ``lambert_project_kernel`` for all ``B`` rotations."""
    if rotations.device.type == "cpu":
        return lambert_project_plain(rotations, dc, quad, npx, npy, scale, rescale, out_min, out_max, taps)
    _check(rotations, dc, quad, npx, npy)
    rotations, dc, quad = _cuda_operands(rotations, dc, quad)
    B, P = rotations.shape[0], dc.shape[-2]
    out = torch.empty((B, P), dtype=torch.float32, device=rotations.device)
    tap = torch.empty((B, P), dtype=torch.int32, device=rotations.device) if taps else None
    fn = _function("lambert_project")
    with torch.cuda.device(rotations.device):
        err = fn(
            rotations.data_ptr(), dc.data_ptr(), quad.data_ptr(), out.data_ptr(), 0 if tap is None else tap.data_ptr(),
            B, P, int(dc.ndim == 3), npx, npy, float(scale), int(rescale), float(out_min), float(out_max - out_min),
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"lambert_project launch failed: cudaError_t {err}")
    lambert_project.launches += 1
    return (out, tap) if taps else out


def lambert_project_ncc(rotations, dc, quad, npx: int, npy: int, scale: float, exp, sq_norm) -> torch.Tensor:
    """``1 - NCC`` ``(B,)`` of the centred rows ``exp (B, P)`` (squared
    norms ``sq_norm (B,)``) against the patterns projected at
    ``rotations``; the projection never reaches device memory. On the card
    one launch of ``lambert_project_ncc_kernel``."""
    _check(rotations, dc, quad, npx, npy, exp, sq_norm)
    if rotations.device.type == "cpu":
        return lambert_project_ncc_plain(rotations, dc, quad, npx, npy, scale, exp, sq_norm)
    B, P = rotations.shape[0], dc.shape[-2]
    rotations, dc, quad, exp, sq_norm = _cuda_operands(rotations, dc, quad, exp, sq_norm)
    out = torch.empty(B, dtype=torch.float32, device=rotations.device)
    fn = _function("lambert_project_ncc")
    with torch.cuda.device(rotations.device):
        err = fn(
            rotations.data_ptr(), dc.data_ptr(), quad.data_ptr(), exp.data_ptr(), sq_norm.data_ptr(), out.data_ptr(),
            B, P, int(dc.ndim == 3), npx, npy, float(scale), torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"lambert_project_ncc launch failed: cudaError_t {err}")
    lambert_project_ncc.launches += 1
    return out


lambert_project.launches = 0
lambert_project_ncc.launches = 0
