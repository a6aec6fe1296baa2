"""Nelder-Mead refinement in one launch: the kernel of ``csrc/refine_nm.cu``
in its three modes, and their plain versions.

Replaces XLA code of the JAX package, not a TPU kernel: the
``jax.lax.while_loop`` of ``kikuchipy_tpu/utils/optimize.py``
``nelder_mead_batched`` over one of the objectives of
``kikuchipy_tpu/indexing/refinement.py``, as the three ``refine_*``
functions run it:

==================================================  ==========================
wrapper                                             objective (here, and JAX's)
==================================================  ==========================
:func:`nelder_mead_orientation`                     :func:`orientation_objective`
                                                    (``_objective_orientation``)
:func:`nelder_mead_projection_center`               :func:`pc_objective`
                                                    (``_objective_pc``)
:func:`nelder_mead_orientation_projection_center`   :func:`joint_objective`
                                                    (``_objective_joint``)
==================================================  ==========================

Each wrapper minimizes ``1 - NCC`` for every point at once and returns a
:class:`NelderMeadKernelResult` (the solver's four fields and the
evaluations each point made). For CPU tensors
it returns its plain version (``..._plain``): the batched host loop
(:func:`~kikuchipy_tpu_torch.utils.optimize.nelder_mead_batched`, with its
evaluations counted) over its
objective. For CUDA tensors it launches the kernel or raises, and counts the
launch in its own ``.launches``. The kernel runs each point's simplex to
convergence on its own, in the host loop's rounding, so on the card the two
give the same points and values (``csrc/refine_nm.cu`` says where that
rests); only the evaluation count differs, since the kernel skips the second
candidate of an iteration that accepts the reflection, which the lockstep
loop evaluates and drops. Kernel B and the kernel share one pixel
(``csrc/lambert_common.cuh`` ``lambert_pixel``), which is not the float32
plain twin's rounding: on the card the kernel's points are held against the
host loop over that twin by the float64 twin's score (``chip_smoke.py``
``float64_check``). :func:`nelder_mead_plan` chooses the kernel's shape from
the pixel count and the mode: in orientation mode a point's first pixels
keep their last tap in shared memory (a tap cache, as large as four blocks
an SM leave within 196 KB), in the PC modes the row and pattern alone, and
past ``RESIDENT_SMEM_BYTES`` the two-pass branch.

In the PC modes the objectives build the direction cosines of every
candidate PC with :func:`pc_direction_cosines`, which states the order of
every float32 operation; the kernel computes the same per pixel and never
holds them in memory.

Arguments. Orientation mode: ``euler0 (n, 3)`` float32 starting angles
(radians); ``exp (n, P)`` centred experimental rows and ``sq_norm (n,)``
their squared norms; ``dc`` direction cosines ``(P, 3)`` shared by all
points or ``(n, P, 3)``; ``quad`` the master pattern's quad texture ``(2 *
npy * npx, 4)``; ``npx``, ``npy``, ``scale`` its shape and ``(npx - 1) /
2``. PC mode: ``pc0 (n, 3)``, ``exp``, ``sq_norm``, ``q0 (n, 4)`` the
points' fixed rotations, ``quad``, ``om (3, 3)`` the detector-to-sample
matrix (``detector.sample_to_detector.T``), ``mask_take`` the signal
mask's kept pixel indices ``(P,)`` or None, ``npx``, ``npy``, ``scale``,
and the detector's ``nrows`` and ``ncols``. Joint mode: ``x0 (n, 6)``
(Euler angles, then PC) and the PC mode's arguments without ``q0``. Then
:func:`nelder_mead_batched`'s ``initial_step``, ``max_iters``, ``fatol``,
``xatol`` and bounds (``(d,)`` or ``(n, d)``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from kikuchipy_tpu_torch.geometry.quaternion import from_euler
from kikuchipy_tpu_torch.ops.lambert_project import lambert_project_ncc
from kikuchipy_tpu_torch.utils.optimize import _nelder_mead_counted, initial_step_per_element

__all__ = [
    "NelderMeadKernelResult",
    "NelderMeadPlan",
    "RESIDENT_SMEM_BYTES",
    "joint_objective",
    "nelder_mead_orientation",
    "nelder_mead_orientation_plain",
    "nelder_mead_orientation_projection_center",
    "nelder_mead_orientation_projection_center_plain",
    "nelder_mead_plan",
    "cache_plan",
    "nelder_mead_projection_center",
    "nelder_mead_projection_center_plain",
    "orientation_objective",
    "pc_direction_cosines",
    "pc_objective",
    "resident",
]


class NelderMeadKernelResult(NamedTuple):
    """What the Nelder-Mead kernel's wrappers and their plain versions
    return: :class:`~kikuchipy_tpu_torch.utils.optimize.NelderMeadResult`'s
    four fields and the objective evaluations each point made."""

    x: torch.Tensor          # (n, d) best point per element
    fun: torch.Tensor        # (n,) best value per element
    n_iter: torch.Tensor     # (n,) iterations until convergence
    converged: torch.Tensor  # (n,) convergence mask
    n_evals: torch.Tensor    # (n,) objective evaluations made

# Shared memory a block may take for its experimental row and simulated
# pattern: about half of a Hopper SM's, so two blocks fit. Beyond it the
# kernel keeps the row in device memory and projects twice.
RESIDENT_SMEM_BYTES = 113 * 1024
# Shared memory of one Hopper SM (228 KB), and what a block takes of it
# besides its dynamic shared memory: the 1 KB the card reserves a block and
# the kernel's own arrays (reductions, simplex, point index; under 0.5 KB).
SM_SMEM_BYTES = 228 * 1024
BLOCK_OVERHEAD_SMEM_BYTES = 1024 + 512
# Threads a point: one block, each thread a strided set of pixels
# (csrc/lambert_common.cuh kThreads; kernel B and kernel F reduce alike).
THREADS = 256
# Blocks an SM the kernel's build leaves registers for (csrc/refine_nm.cu
# REFINE_NM_MIN_BLOCKS: 64 registers a thread).
REGISTER_BLOCKS = 4
# The cache route's shape by mode: (blocks an SM, shared memory those blocks
# may take in all): the tap cache holds what they leave beside their rows
# and patterns (20 bytes a cached pixel: its last float4 and quad-texture
# row). Leaving L1 part of the SM keeps orientation mode's direction cosines
# there. None: no cache. refine_variants.py times these shapes.
CACHE_SHAPE = {"orientation": (4, 196 * 1024), "pc": None, "joint": None}
_ROUTE = {"two-pass": 0, "resident": 1, "cache": 2}

_MODE = {"pc": 1, "joint": 2}
_ARGTYPES = {
    "refine_nm": [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int]
    + [ctypes.c_float] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p],
    "refine_nm_pc": [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.POINTER(ctypes.c_float)] + [ctypes.c_void_p] * 7
    + [ctypes.c_int] * 4 + [ctypes.c_float] * 5 + [ctypes.c_int] + [ctypes.c_float] * 2 + [ctypes.c_int] * 2
    + [ctypes.c_void_p],
}


def _function(name: str = "refine_nm"):
    """``<name>_launch`` of ``csrc/refine_nm.cu``, built on first use."""
    from kikuchipy_tpu_torch.ops._build import library

    fn = getattr(library("refine_nm"), f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


class NelderMeadPlan(NamedTuple):
    """How the Nelder-Mead kernel holds a point (:func:`nelder_mead_plan`)."""

    route: str           # "cache", "resident" or "two-pass"
    threads: int         # threads a point: one block
    blocks_per_sm: int   # blocks an SM holds at once: registers and shared memory allowing
    smem_bytes: int      # dynamic shared memory a block
    cached_pixels: int   # pixels with a tap-cache entry: the first of the point's


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


def _blocks(smem: int) -> int:
    return min(REGISTER_BLOCKS, SM_SMEM_BYTES // (smem + BLOCK_OVERHEAD_SMEM_BYTES))


def cache_plan(P: int, blocks: int | None, sm_bytes: int = SM_SMEM_BYTES) -> NelderMeadPlan:
    """The kernel's shape for ``P`` pixels (within ``RESIDENT_SMEM_BYTES``)
    with the tap cache sized for ``blocks`` blocks an SM taking at most
    ``sm_bytes`` of its shared memory: the first pixels of the point, as
    many as those blocks leave room for beside their rows and patterns at
    20 bytes a pixel (all of them at most); the resident route where
    ``blocks`` is None or leaves no room for a thread's pixel each."""
    resident = 8 * _pad4(P)
    cached = 0
    if blocks is not None:
        room = sm_bytes // blocks - BLOCK_OVERHEAD_SMEM_BYTES - resident
        cached = min(P, room // 20 // 4 * 4)
    if cached < min(P, THREADS):
        return NelderMeadPlan("resident", THREADS, _blocks(resident), resident, 0)
    smem = resident + 20 * _pad4(cached)
    return NelderMeadPlan("cache", THREADS, _blocks(smem), smem, cached)


def nelder_mead_plan(P: int, mode: str = "orientation") -> NelderMeadPlan:
    """The kernel's shape for a point of ``P`` pixels in ``mode``: within
    ``RESIDENT_SMEM_BYTES`` of row and pattern (8 bytes a pixel) the cache
    route of ``CACHE_SHAPE[mode]`` (``cache_plan``), or the resident route
    where that is None or leaves the cache no room; else the two-pass branch
    (the row in device memory, every pixel projected twice).
    ``csrc/refine_objective.cuh`` ``route_smem_bytes`` takes the same
    bytes."""
    if 8 * _pad4(P) > RESIDENT_SMEM_BYTES:
        return NelderMeadPlan("two-pass", THREADS, _blocks(0), 0, 0)
    shape = CACHE_SHAPE[mode]
    return cache_plan(P, *shape) if shape else cache_plan(P, None)


def resident(P: int) -> bool:
    """Whether a point's row and pattern of ``P`` pixels sit in shared
    memory (the cache and resident routes; else the two-pass branch)."""
    return nelder_mead_plan(P).route != "two-pass"


# ---------------------------- the objectives ---------------------------- #


def orientation_objective(euler_b, exp, sq_norm, dc, quad, npx, npy, scale) -> torch.Tensor:
    """``1 - NCC`` at Euler angles ``(n, 3)``: one launch of kernel B on
    the card (the JAX package's ``_objective_orientation``)."""
    q = from_euler(euler_b).to(torch.float32)
    return lambert_project_ncc(q, dc, quad, npx, npy, scale, exp, sq_norm)


def _f32(v: float) -> float:
    """``v`` rounded to float32, as PyTorch rounds a Python scalar operand."""
    return float(np.float32(v))


def _detector_scalars(nrows: int, ncols: int) -> tuple[float, float, float, float]:
    """float32 ``ncols / nrows``, its negative, ``1 / ncols`` and ``1 /
    nrows`` (the reciprocals as float32 divisions)."""
    aspect = ncols / nrows
    return (_f32(aspect), _f32(-aspect), float(np.float32(1) / np.float32(ncols)),
            float(np.float32(1) / np.float32(nrows)))


def pc_direction_cosines(pc_b, nrows: int, ncols: int, om, mask_take=None) -> torch.Tensor:
    """Unit direction cosines ``(n, P, 3)`` float32 of the detector's pixels
    (all, or those of ``mask_take``) for candidate PCs ``pc_b (n, 3)``,
    with ``om (3, 3)`` the detector-to-sample matrix: the JAX package's
    ``_dc_for_pc`` over ``direction_cosines``, with every float32 operation
    in a stated order, so that the PC modes' kernel rounds each alike:

    - bounds ``gb0 = (pcx * -aspect) / pcz``, ``gb1 = ((1 - pcx) * aspect) /
      pcz``, ``gb2 = -(1 - pcy) / pcz``, ``gb3 = pcy / pcz``;
    - pitches ``x_scale = (gb1 - gb0) * (1 / ncols)`` and ``y_scale = (gb3 -
      gb2) * (1 / nrows)``, each reciprocal a float32;
    - pixel ``x = ((gb0 + col * x_scale) + x_scale * 0.5) * pcz``, ``y =
      ((gb3 - row * y_scale) - y_scale * 0.5) * pcz``, ``z = pcz``;
    - ``r_k = (x * om[k, 0] + y * om[k, 1]) + z * om[k, 2]``;
    - ``r_k / sqrt((r_0^2 + r_1^2) + r_2^2)``, the square root
      ``torch.sqrt``'s: correctly rounded on the card, as the kernel's
      ``__fsqrt_rn``; PyTorch's vectorized float32 square root on the CPU
      can be an ulp off.

    Every other step is one elementwise PyTorch operation, rounded alike on
    the CPU and on the card (the product by the float32 reciprocal is what
    PyTorch does on the card where it divides by a Python int)."""
    aspect, neg_aspect, inv_ncols, inv_nrows = _detector_scalars(nrows, ncols)
    pc_b = pc_b.to(torch.float32)
    dev = pc_b.device
    pcx, pcy, pcz = pc_b[:, 0:1], pc_b[:, 1:2], pc_b[:, 2:3]
    gb0 = pcx * neg_aspect / pcz
    gb1 = (1.0 - pcx) * aspect / pcz
    gb2 = -(1.0 - pcy) / pcz
    gb3 = pcy / pcz
    x_scale = (gb1 - gb0) * inv_ncols
    y_scale = (gb3 - gb2) * inv_nrows
    idx = torch.arange(nrows * ncols, device=dev) if mask_take is None else mask_take.to(dev).long()
    col = (idx % ncols).to(torch.float32)[None, :]
    row = (idx // ncols).to(torch.float32)[None, :]
    x = ((gb0 + col * x_scale) + x_scale * 0.5) * pcz
    y = ((gb3 - row * y_scale) - y_scale * 0.5) * pcz
    z = torch.broadcast_to(pcz, x.shape)
    om = om.to(device=dev, dtype=torch.float32)
    r = [(x * om[k, 0] + y * om[k, 1]) + z * om[k, 2] for k in range(3)]
    norm = torch.sqrt((r[0] * r[0] + r[1] * r[1]) + r[2] * r[2])
    return torch.stack([r[0] / norm, r[1] / norm, r[2] / norm], dim=-1)


def pc_objective(pc_b, exp, sq_norm, q0, quad, om, mask_take, npx, npy, scale, nrows, ncols) -> torch.Tensor:
    """``1 - NCC`` at PCs ``(n, 3)``, rotations ``q0`` fixed: the JAX
    package's ``_objective_pc``; kernel B a launch on the card."""
    dc = pc_direction_cosines(pc_b, nrows, ncols, om, mask_take)
    return lambert_project_ncc(q0, dc, quad, npx, npy, scale, exp, sq_norm)


def joint_objective(x_b, exp, sq_norm, quad, om, mask_take, npx, npy, scale, nrows, ncols) -> torch.Tensor:
    """``1 - NCC`` at ``(n, 6)``: Euler angles, then PC (the JAX package's
    ``_objective_joint``); kernel B a launch on the card."""
    q = from_euler(x_b[:, :3]).to(torch.float32)
    dc = pc_direction_cosines(x_b[:, 3:], nrows, ncols, om, mask_take)
    return lambert_project_ncc(q, dc, quad, npx, npy, scale, exp, sq_norm)


# ------------------------------- checks ------------------------------- #


def _check_common(name, x0, d, exp, sq_norm, quad, npx, npy, P, max_iters, lower_bounds, upper_bounds, tensors):
    if max_iters < 0:
        raise ValueError(f"max_iters must be >= 0, got {max_iters}")
    if not isinstance(x0, torch.Tensor) or x0.ndim != 2 or x0.shape[1] != d or x0.shape[0] < 1:
        raise ValueError(f"{name} must be a (n, {d}) tensor, got {getattr(x0, 'shape', type(x0))}")
    n = x0.shape[0]
    if P < 1:
        raise ValueError("no pixels")
    if tuple(quad.shape) != (2 * npy * npx, 4):
        raise ValueError(f"quad must be ({2 * npy * npx}, 4) for a {npy} x {npx} master, got {tuple(quad.shape)}")
    if tuple(exp.shape) != (n, P) or tuple(sq_norm.shape) != (n,):
        raise ValueError(f"exp must be ({n}, {P}) and sq_norm ({n},), got {tuple(exp.shape)}, {tuple(sq_norm.shape)}")
    tensors = [x0, exp, sq_norm, quad] + list(tensors)
    for bname, b in (("lower_bounds", lower_bounds), ("upper_bounds", upper_bounds)):
        if b is None:
            continue
        if not isinstance(b, torch.Tensor) or tuple(b.shape) not in ((d,), (n, d)):
            raise ValueError(f"{bname} must be a ({d},) or ({n}, {d}) tensor, got {getattr(b, 'shape', type(b))}")
        tensors.append(b)
    dev = x0.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError("all operands must be on one device")
        if t.dtype != torch.float32:
            raise TypeError(f"the Nelder-Mead wrappers take float32, got {t.dtype}")


def _check_args(euler0, exp, sq_norm, dc, quad, npx, npy, max_iters, lower_bounds, upper_bounds) -> None:
    n = euler0.shape[0] if isinstance(euler0, torch.Tensor) and euler0.ndim == 2 else None
    if not (dc.ndim == 2 and dc.shape[1] == 3) and not (dc.ndim == 3 and dc.shape[0] == n and dc.shape[2] == 3):
        raise ValueError(f"dc must be (P, 3) or ({n}, P, 3), got {tuple(dc.shape)}")
    _check_common("euler0", euler0, 3, exp, sq_norm, quad, npx, npy, dc.shape[-2], max_iters, lower_bounds,
                  upper_bounds, [dc])


def _check_pc_args(name, x0, d, exp, sq_norm, q0, quad, om, mask_take, npx, npy, nrows, ncols, max_iters,
                   lower_bounds, upper_bounds) -> int:
    """The PC modes' checks; returns P."""
    if int(nrows) < 1 or int(ncols) < 1:
        raise ValueError(f"the detector must have rows and columns, got {nrows} x {ncols}")
    if not isinstance(om, torch.Tensor) or tuple(om.shape) != (3, 3):
        raise ValueError(f"om must be a (3, 3) tensor, got {getattr(om, 'shape', type(om))}")
    P = nrows * ncols
    if mask_take is not None:
        if not isinstance(mask_take, torch.Tensor) or mask_take.ndim != 1 or mask_take.dtype.is_floating_point:
            raise ValueError("mask_take must be a 1-D integer tensor of pixel indices")
        if mask_take.device != x0.device:
            raise ValueError("all operands must be on one device")
        if mask_take.numel() and (int(mask_take.min()) < 0 or int(mask_take.max()) >= nrows * ncols):
            raise ValueError(f"mask_take holds pixel indices outside [0, {nrows * ncols})")
        P = mask_take.numel()
    tensors = [om]
    if q0 is not None:
        n = x0.shape[0] if isinstance(x0, torch.Tensor) and x0.ndim == 2 else None
        if not isinstance(q0, torch.Tensor) or tuple(q0.shape) != (n, 4):
            raise ValueError(f"q0 must be a ({n}, 4) tensor, got {getattr(q0, 'shape', type(q0))}")
        tensors.append(q0)
    _check_common(name, x0, d, exp, sq_norm, quad, npx, npy, P, max_iters, lower_bounds, upper_bounds, tensors)
    return P


# ------------------------------- launches ------------------------------- #


def _outputs(n: int, d: int, dev):
    return (torch.empty((n, d), dtype=torch.float32, device=dev), torch.empty(n, dtype=torch.float32, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev), torch.empty(n, dtype=torch.bool, device=dev),
            torch.empty(n, dtype=torch.int32, device=dev), torch.zeros(1, dtype=torch.int32, device=dev))


def _steps_and_box(x0, initial_step, lower_bounds, upper_bounds):
    n, d = x0.shape
    step = initial_step_per_element(x0, initial_step).to(torch.float32).contiguous()
    lower, upper = (None if b is None else torch.broadcast_to(b, (n, d)).contiguous()
                    for b in (lower_bounds, upper_bounds))
    return step, lower, upper


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _aligned(quad) -> None:
    if quad.data_ptr() % 16:
        raise ValueError("quad must be 16-byte aligned (one float4 a neighbourhood)")


def pixel_table(mask_take, nrows: int, ncols: int, device) -> torch.Tensor:
    """``(P, 2)`` float32 (column, row) of each kept pixel: the PC modes'
    kernel computes each pixel's direction cosine from it."""
    idx = torch.arange(nrows * ncols, device=device) if mask_take is None else mask_take.to(device).long()
    return torch.stack([idx % ncols, idx // ncols], dim=-1).to(torch.float32).contiguous()


def _launch_pc(mode: str, x0, exp, sq_norm, q0, quad, om, mask_take, npx, npy, scale, nrows, ncols, initial_step,
               max_iters, fatol, xatol, lower_bounds, upper_bounds) -> NelderMeadKernelResult:
    dev = x0.device
    n, d = x0.shape
    x0, exp, sq_norm, quad = (t.contiguous() for t in (x0, exp, sq_norm, quad))
    q0 = None if q0 is None else q0.contiguous()
    _aligned(quad)
    P = exp.shape[1]
    step, lower, upper = _steps_and_box(x0, initial_step, lower_bounds, upper_bounds)
    pix = pixel_table(mask_take, nrows, ncols, dev)
    om_host = (ctypes.c_float * 9)(*om.detach().to("cpu", torch.float32).reshape(9).tolist())
    aspect, neg_aspect, inv_ncols, inv_nrows = _detector_scalars(nrows, ncols)
    outs = _outputs(n, d, dev)
    plan = nelder_mead_plan(P, mode)
    fn = _function("refine_nm_pc")
    with torch.cuda.device(dev):
        err = fn(
            _MODE[mode], _ptr(x0), _ptr(step), _ptr(lower), _ptr(upper), _ptr(exp), _ptr(sq_norm), _ptr(q0),
            _ptr(pix), om_host, _ptr(quad), *[t.data_ptr() for t in outs], n, P, npx, npy, float(scale), aspect,
            neg_aspect, inv_ncols, inv_nrows, int(max_iters), float(fatol), float(xatol), _ROUTE[plan.route],
            plan.cached_pixels, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"refine_nm_pc launch ({mode} mode) failed: cudaError_t {err}")
    x, fun, n_iter, converged, n_evals, _ = outs
    return NelderMeadKernelResult(x=x, fun=fun, n_iter=n_iter, converged=converged, n_evals=n_evals)


# ------------------------------ orientation ------------------------------ #


def _host_loop(objective, x0, initial_step, max_iters, fatol, xatol, lower_bounds, upper_bounds,
               args) -> NelderMeadKernelResult:
    res, n_evals = _nelder_mead_counted(objective, x0, initial_step, max_iters, fatol, xatol, lower_bounds,
                                        upper_bounds, args)
    return NelderMeadKernelResult(*res, n_evals=n_evals)


def nelder_mead_orientation_plain(
    euler0, exp, sq_norm, dc, quad, npx: int, npy: int, scale: float, initial_step=None, max_iters: int = 150,
    fatol: float = 1e-5, xatol: float = 1e-4, lower_bounds=None, upper_bounds=None,
) -> NelderMeadKernelResult:
    """The host loop: ``utils/optimize.py`` ``nelder_mead_batched`` over
    :func:`orientation_objective` (kernel B a launch on the card, its plain
    twin on the CPU)."""
    _check_args(euler0, exp, sq_norm, dc, quad, npx, npy, max_iters, lower_bounds, upper_bounds)
    return _host_loop(orientation_objective, euler0, initial_step, max_iters, fatol, xatol, lower_bounds, upper_bounds,
                      (exp, sq_norm, dc, quad, npx, npy, scale))


def nelder_mead_orientation(
    euler0, exp, sq_norm, dc, quad, npx: int, npy: int, scale: float, initial_step=None, max_iters: int = 150,
    fatol: float = 1e-5, xatol: float = 1e-4, lower_bounds=None, upper_bounds=None,
) -> NelderMeadKernelResult:
    """Minimize ``1 - NCC`` over the Euler angles of every point. On the
    card one launch of ``refine_nm_kernel`` for all points; its
    ``n_evals`` are the evaluations it made."""
    _check_args(euler0, exp, sq_norm, dc, quad, npx, npy, max_iters, lower_bounds, upper_bounds)
    if euler0.device.type == "cpu":
        return nelder_mead_orientation_plain(
            euler0, exp, sq_norm, dc, quad, npx, npy, scale, initial_step, max_iters, fatol, xatol, lower_bounds,
            upper_bounds,
        )
    dev = euler0.device
    n, P = euler0.shape[0], dc.shape[-2]
    euler0, exp, sq_norm, dc, quad = (t.contiguous() for t in (euler0, exp, sq_norm, dc, quad))
    _aligned(quad)
    step, lower, upper = _steps_and_box(euler0, initial_step, lower_bounds, upper_bounds)
    outs = _outputs(n, 3, dev)
    plan = nelder_mead_plan(P)
    fn = _function()
    with torch.cuda.device(dev):
        err = fn(
            _ptr(euler0), _ptr(step), _ptr(lower), _ptr(upper), _ptr(exp), _ptr(sq_norm), _ptr(dc), _ptr(quad),
            *[t.data_ptr() for t in outs], n, P, int(dc.ndim == 3), npx, npy, float(scale), int(max_iters),
            float(fatol), float(xatol), _ROUTE[plan.route], plan.cached_pixels, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"refine_nm launch failed: cudaError_t {err}")
    nelder_mead_orientation.launches += 1
    x, fun, n_iter, converged, n_evals, _ = outs
    return NelderMeadKernelResult(x=x, fun=fun, n_iter=n_iter, converged=converged, n_evals=n_evals)


# ------------------------------ PC and joint ------------------------------ #


def nelder_mead_projection_center_plain(
    pc0, exp, sq_norm, q0, quad, om, mask_take, npx: int, npy: int, scale: float, nrows: int, ncols: int,
    initial_step=None, max_iters: int = 150, fatol: float = 1e-5, xatol: float = 1e-4, lower_bounds=None,
    upper_bounds=None,
) -> NelderMeadKernelResult:
    """The host loop: ``utils/optimize.py`` ``nelder_mead_batched`` over :func:`pc_objective`
    (kernel B a launch on the card, its plain twin on the CPU)."""
    _check_pc_args("pc0", pc0, 3, exp, sq_norm, q0, quad, om, mask_take, npx, npy, nrows, ncols, max_iters,
                   lower_bounds, upper_bounds)
    return _host_loop(pc_objective, pc0, initial_step, max_iters, fatol, xatol, lower_bounds, upper_bounds,
                      (exp, sq_norm, q0, quad, om, mask_take, npx, npy, scale, nrows, ncols))


def nelder_mead_projection_center(
    pc0, exp, sq_norm, q0, quad, om, mask_take, npx: int, npy: int, scale: float, nrows: int, ncols: int,
    initial_step=None, max_iters: int = 150, fatol: float = 1e-5, xatol: float = 1e-4, lower_bounds=None,
    upper_bounds=None,
) -> NelderMeadKernelResult:
    """Minimize ``1 - NCC`` over the PC of every point, its rotation fixed.
    On the card one launch of the kernel's PC mode for all points, the
    direction cosines computed from each candidate PC inside it."""
    _check_pc_args("pc0", pc0, 3, exp, sq_norm, q0, quad, om, mask_take, npx, npy, nrows, ncols, max_iters,
                   lower_bounds, upper_bounds)
    if pc0.device.type == "cpu":
        return nelder_mead_projection_center_plain(
            pc0, exp, sq_norm, q0, quad, om, mask_take, npx, npy, scale, nrows, ncols, initial_step, max_iters,
            fatol, xatol, lower_bounds, upper_bounds,
        )
    res = _launch_pc("pc", pc0, exp, sq_norm, q0, quad, om, mask_take, npx, npy, scale, nrows, ncols,
                     initial_step, max_iters, fatol, xatol, lower_bounds, upper_bounds)
    nelder_mead_projection_center.launches += 1
    return res


def nelder_mead_orientation_projection_center_plain(
    x0, exp, sq_norm, quad, om, mask_take, npx: int, npy: int, scale: float, nrows: int, ncols: int,
    initial_step=None, max_iters: int = 200, fatol: float = 1e-5, xatol: float = 1e-4, lower_bounds=None,
    upper_bounds=None,
) -> NelderMeadKernelResult:
    """The host loop: ``utils/optimize.py`` ``nelder_mead_batched`` over
    :func:`joint_objective` (kernel B a launch on the card, its plain twin
    on the CPU)."""
    _check_pc_args("x0", x0, 6, exp, sq_norm, None, quad, om, mask_take, npx, npy, nrows, ncols, max_iters,
                   lower_bounds, upper_bounds)
    return _host_loop(joint_objective, x0, initial_step, max_iters, fatol, xatol, lower_bounds, upper_bounds,
                      (exp, sq_norm, quad, om, mask_take, npx, npy, scale, nrows, ncols))


def nelder_mead_orientation_projection_center(
    x0, exp, sq_norm, quad, om, mask_take, npx: int, npy: int, scale: float, nrows: int, ncols: int,
    initial_step=None, max_iters: int = 200, fatol: float = 1e-5, xatol: float = 1e-4, lower_bounds=None,
    upper_bounds=None,
) -> NelderMeadKernelResult:
    """Minimize ``1 - NCC`` over the Euler angles and PC of every point
    (``x0 (n, 6)``). On the card one launch of the kernel's joint mode."""
    _check_pc_args("x0", x0, 6, exp, sq_norm, None, quad, om, mask_take, npx, npy, nrows, ncols, max_iters,
                   lower_bounds, upper_bounds)
    if x0.device.type == "cpu":
        return nelder_mead_orientation_projection_center_plain(
            x0, exp, sq_norm, quad, om, mask_take, npx, npy, scale, nrows, ncols, initial_step, max_iters, fatol,
            xatol, lower_bounds, upper_bounds,
        )
    res = _launch_pc("joint", x0, exp, sq_norm, None, quad, om, mask_take, npx, npy, scale, nrows, ncols,
                     initial_step, max_iters, fatol, xatol, lower_bounds, upper_bounds)
    nelder_mead_orientation_projection_center.launches += 1
    return res


nelder_mead_orientation.launches = 0
nelder_mead_projection_center.launches = 0
nelder_mead_orientation_projection_center.launches = 0
