"""The tangent kernel (kernel C, ``csrc/refine_lm.cu``) in its three modes,
and their plain versions; the residuals and objectives of Levenberg-Marquardt
and gradient refinement.

Replaces XLA code of the JAX package, not a TPU kernel:
``kikuchipy_tpu/utils/optimize.py`` ``jac_and_res`` (a residual and its
Jacobian from one primal and ``d`` forward-mode tangents) and the two
einsums of its loop, over one of the residuals of
``kikuchipy_tpu/indexing/refinement.py``:

===============================================  ==========================
wrapper                                          residual (here, and JAX's)
===============================================  ==========================
:func:`tangent_orientation`                      :func:`orientation_residual`
                                                 (``_residual_orientation_delta``)
:func:`tangent_projection_center`                :func:`pc_residual`
                                                 (``_residual_pc_delta``)
:func:`tangent_orientation_projection_center`    :func:`joint_residual`
                                                 (``_residual_joint_gibbs``)
===============================================  ==========================

Each wrapper returns, for every point at its trial parameters ``x``, the
tuple ``(f, g, jtj)``: ``f = 0.5 ||r||^2`` ``(n,)``, ``g = J^T r`` ``(n,
d)`` and ``J^T J`` ``(n, d, d)``, with ``r = sim_unit(sim) - exp_unit`` and
``J`` its Jacobian in ``x``. That is what
:mod:`~kikuchipy_tpu_torch.utils.optimize`'s LM loop
(``_levenberg_marquardt_normal``, the loop under
``levenberg_marquardt_batched``) consumes, and ``(f, g)`` is what the
gradient method's Adam loop consumes:
with both rows centred and unit, ``0.5 ||r||^2 = 1 - NCC``. For CPU tensors
a wrapper returns its plain version (``..._plain``: ``torch.func.jvp`` of
the residual along each of the ``d`` axes, over the plain projection
``ops/lambert_project.py`` ``_project_plain``, then JAX's einsums); for
CUDA tensors it launches kernel C or raises, and counts the launch in its
own ``.launches``.

On the card the kernel's pixel is kernel A's (``csrc/lambert_common.cuh``
``lambert_pixel_grad``: its projected values are
:func:`~kikuchipy_tpu_torch.ops.lambert_project.lambert_project`'s bit for
bit; the rotation and the candidate PC are computed here with the plain
version's PyTorch operations) and its tangent is analytic, so its yardstick
is the plain version run on float64 operands (every ``*_plain`` takes
float32 or float64): ``g`` and ``J^T J`` no further from it than the
float32 plain version's twice, ``f`` within 2e-6 of the float32 plain
version's (``chip_smoke.py`` ``[lm-check]``, ``tests/test_torch_gpu.py``).

Levenberg-Marquardt in one launch (``refine_lm_loop_kernel`` of the same
source): :func:`levenberg_marquardt_orientation`,
:func:`levenberg_marquardt_projection_center` and
:func:`levenberg_marquardt_orientation_projection_center` take a tangent
wrapper's arguments, the starts ``x0`` in place of ``x``, and
:func:`~kikuchipy_tpu_torch.utils.optimize.levenberg_marquardt_batched`'s
``max_iters``, ``ftol``, ``lambda0`` and ``blocks``, and return an
:class:`LMKernelResult`: its :class:`~kikuchipy_tpu_torch.utils.optimize.LMResult`
and the evaluations each point made. For CPU tensors each
returns its plain version (``..._plain``: the batched host loop
``utils/optimize.py`` ``_levenberg_marquardt_normal`` over the mode's
tangent wrapper, which on the card launches kernel C an iteration);
for CUDA tensors it launches the loop kernel once for all points or raises,
and counts the launch in its own ``.launches``. The kernel runs each point's
loop by the host loop's rules and in its rounding on the card: each
evaluation is kernel C's arithmetic, the trial rotation and PC
(:func:`trial_point`) and the d x d solve (:func:`solve`) are the host
loop's PyTorch operations and ``torch.linalg.solve_ex`` bit for bit, so
the two loops take the same path (``chip_smoke.py`` ``[lm-loop-check]``).
``blocks``: None, or one ``(3, max_norm)`` block for each three
parameters.

Arguments, as the JAX residuals take them. Orientation: ``delta (n, 3)``
rotation vectors, ``q0 (n, 4)`` the start rotations, ``exp_unit (n, P)``
the centred experimental rows made unit, ``dc`` direction cosines ``(P,
3)`` or ``(n, P, 3)``, ``quad`` the master's quad texture, ``npx``, ``npy``,
``scale``. PC: ``dpc (n, 3)`` PC shifts, ``pc0 (n, 3)``, ``exp_unit``,
``q0 (n, 4)`` the fixed rotations, ``quad``, ``om (3, 3)`` the
detector-to-sample matrix, ``mask_take`` the kept pixels ``(P,)`` or None,
``npx``, ``npy``, ``scale``, ``nrows``, ``ncols``. Joint: ``x (n, 6)``
(rotation vector, PC shift), ``q0``, ``pc0``, ``exp_unit`` and the PC
mode's arguments after it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from kikuchipy_tpu_torch.geometry.quaternion import multiply
from kikuchipy_tpu_torch.ops.lambert_project import _project_plain, lambert_project_ncc
from kikuchipy_tpu_torch.ops.refine_nm import _aligned, _detector_scalars, _ptr, pc_direction_cosines, pixel_table
from kikuchipy_tpu_torch.projection.master_pattern import direction_cosines
from kikuchipy_tpu_torch.utils.optimize import _levenberg_marquardt_normal, _normal_equations

__all__ = [
    "LMKernelResult",
    "RESIDENT_SMEM_BYTES",
    "exp_map",
    "joint_delta_objective",
    "joint_residual",
    "levenberg_marquardt_orientation",
    "levenberg_marquardt_orientation_plain",
    "levenberg_marquardt_orientation_projection_center",
    "levenberg_marquardt_orientation_projection_center_plain",
    "levenberg_marquardt_projection_center",
    "levenberg_marquardt_projection_center_plain",
    "loop_residency",
    "orientation_delta_objective",
    "orientation_residual",
    "pc_delta_objective",
    "pc_residual",
    "resident",
    "sim_unit",
    "tangent_orientation",
    "tangent_orientation_plain",
    "tangent_orientation_projection_center",
    "tangent_orientation_projection_center_plain",
    "tangent_projection_center",
    "tangent_projection_center_plain",
    "unit_rows",
]


class LMKernelResult(NamedTuple):
    """What the LM loop kernel's wrappers and their plain versions return:
    :class:`~kikuchipy_tpu_torch.utils.optimize.LMResult`'s four fields and
    the evaluations each point made (the start and one an iteration)."""

    x: torch.Tensor          # (n, d) best point per element
    fun: torch.Tensor        # (n,) 0.5 * ||r||^2 at the best point
    n_iter: torch.Tensor     # (n,) LM iterations taken
    converged: torch.Tensor  # (n,) convergence mask
    n_evals: torch.Tensor    # (n,) evaluations made

_f32 = torch.float32

# Shared memory a block may take for a point's pattern and its d tangents
# ((1 + d) P floats): half of a Hopper SM's 227 KB, so two blocks fit.
# Beyond it the kernel recomputes them in each of its three passes.
RESIDENT_SMEM_BYTES = 113 * 1024

_MODE = {"orientation": 0, "pc": 1, "joint": 2}
_ARGTYPES = (
    [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
    + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float] * 5 + [ctypes.c_int, ctypes.c_void_p]
)


_ARGTYPES_LOOP = (
    [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
    + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_float] * 5 + [ctypes.c_int, ctypes.c_float,
    ctypes.c_float, ctypes.c_int, ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_void_p]
)
_ARGTYPES_TRIAL = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
_ARGTYPES_SOLVE = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
_ARGTYPES_ATTRIBUTES = [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _function(name: str = "refine_lm"):
    """``<name>_launch`` of ``csrc/refine_lm.cu``, built on first use."""
    from kikuchipy_tpu_torch.ops._build import library

    fn = getattr(library("refine_lm"), f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = {"refine_lm": _ARGTYPES, "refine_lm_loop": _ARGTYPES_LOOP, "refine_lm_trial": _ARGTYPES_TRIAL,
                       "refine_lm_solve": _ARGTYPES_SOLVE, "refine_lm_attributes": _ARGTYPES_ATTRIBUTES}[name]
        fn.restype = ctypes.c_int
    return fn


def resident(P: int, d: int) -> bool:
    """Whether the kernel holds a point's pattern and its ``d`` tangents of
    ``P`` pixels in shared memory (else it recomputes them)."""
    return 4 * (1 + d) * P <= RESIDENT_SMEM_BYTES


# A Hopper SM's shared memory and threads, and what a block of the loop
# kernel takes beside its dynamic shared memory (its static scratch and LM
# state, about 1.7 KB, and the 1 KB the card reserves a block), rounded up.
_SM_SHARED_BYTES = 228 * 1024
_SM_BLOCKS = 2048 // 256
_BLOCK_SHARED_EXTRA = 2560


def loop_residency(P: int, d: int) -> int:
    """What the LM loop kernel holds in shared memory: 2 the pattern, its
    tangents and the point's experimental row, where that fits
    ``RESIDENT_SMEM_BYTES`` and leaves as many blocks an SM as without the
    row (the d = 3 modes at P = 3600: three; not joint mode, where it would
    leave one of two); 1 the pattern and tangents; 0 nothing (it recomputes
    them)."""
    if not resident(P, d):
        return 0
    base = 4 * (1 + d) * P
    with_row = 4 * (-(-(1 + d) * P // 4) * 4 + P)
    blocks = [min(_SM_BLOCKS, _SM_SHARED_BYTES // (b + _BLOCK_SHARED_EXTRA)) for b in (base, with_row)]
    return 2 if with_row <= RESIDENT_SMEM_BYTES and blocks[1] == blocks[0] else 1


# ------------------------- residuals and objectives ------------------------- #


def exp_map(delta: torch.Tensor) -> torch.Tensor:
    """Gibbs (Cayley) rotation vectors ``(n, 3)`` to unit quaternions ``(n,
    4)``: ``(1, delta / 2) / sqrt(1 + |delta / 2|^2)``, the JAX package's
    ``_exp_map`` (smooth at 0)."""
    half = delta / 2.0
    w = torch.ones(delta.shape[:-1] + (1,), dtype=delta.dtype, device=delta.device)
    q = torch.cat([w, half], dim=-1)
    return q / torch.sqrt(1.0 + torch.sum(torch.square(half), dim=-1, keepdim=True))


def unit_rows(p: torch.Tensor) -> torch.Tensor:
    """Each row over its Euclidean norm."""
    return p / torch.linalg.vector_norm(p, dim=-1, keepdim=True)


def sim_unit(sim: torch.Tensor) -> torch.Tensor:
    """Each row centred, then unit."""
    return unit_rows(sim - torch.mean(sim, dim=-1, keepdim=True))


def _rotation(q0, delta) -> torch.Tensor:
    return multiply(q0, exp_map(delta)).to(delta.dtype)


def _direction_cosines(pc, nrows, ncols, om, mask_take) -> torch.Tensor:
    """The pixels' direction cosines ``(n, P, 3)`` at the PCs ``pc (n,
    3)``: :func:`~kikuchipy_tpu_torch.ops.refine_nm.pc_direction_cosines`
    (the kernels' float32 order of operations), or for float64 operands (the
    float64 twin) the JAX package's ``_dc_for_pc`` in float64."""
    if pc.dtype != torch.float64:
        return pc_direction_cosines(pc, nrows, ncols, om, mask_take)
    aspect = ncols / nrows
    pcx, pcy, pcz = pc.unbind(-1)
    gb = torch.stack([-aspect * pcx / pcz, aspect * (1 - pcx) / pcz, -(1 - pcy) / pcz, pcy / pcz], dim=-1)
    dc = direction_cosines(gb, pcz, nrows, ncols, om.to(pc.dtype))
    return dc if mask_take is None else dc[:, mask_take.long()]


def orientation_residual(delta, q0, exp_unit, dc, quad, npx, npy, scale) -> torch.Tensor:
    """``(n, P)`` residuals at ``q0 (x) exp_map(delta)``."""
    return sim_unit(_project_plain(_rotation(q0, delta), dc, quad, npx, npy, scale)) - exp_unit


def pc_residual(dpc, pc0, exp_unit, q0, quad, om, mask_take, npx, npy, scale, nrows, ncols) -> torch.Tensor:
    """``(n, P)`` residuals at the PCs ``pc0 + dpc``, rotations ``q0``
    fixed."""
    dc = _direction_cosines(pc0 + dpc, nrows, ncols, om, mask_take)
    return sim_unit(_project_plain(q0, dc, quad, npx, npy, scale)) - exp_unit


def joint_residual(x, q0, pc0, exp_unit, quad, om, mask_take, npx, npy, scale, nrows, ncols) -> torch.Tensor:
    """``(n, P)`` residuals at ``q0 (x) exp_map(x[:, :3])`` and the PCs
    ``pc0 + x[:, 3:]``."""
    dc = _direction_cosines(pc0 + x[:, 3:], nrows, ncols, om, mask_take)
    return sim_unit(_project_plain(_rotation(q0, x[:, :3]), dc, quad, npx, npy, scale)) - exp_unit


def orientation_delta_objective(delta, q0, exp, sq_norm, dc, quad, npx, npy, scale) -> torch.Tensor:
    """``1 - NCC`` at ``q0 (x) exp_map(delta)`` of the centred rows ``exp``
    with squared norms ``sq_norm`` (the JAX package's
    ``_objective_orientation_delta``; kernel B a launch on the card)."""
    return lambert_project_ncc(_rotation(q0, delta), dc, quad, npx, npy, scale, exp, sq_norm)


def pc_delta_objective(dpc, pc0, exp, sq_norm, q0, quad, om, mask_take, npx, npy, scale, nrows, ncols):
    """``1 - NCC`` at the PCs ``pc0 + dpc`` (``_objective_pc_delta``)."""
    dc = pc_direction_cosines(pc0 + dpc, nrows, ncols, om, mask_take)
    return lambert_project_ncc(q0, dc, quad, npx, npy, scale, exp, sq_norm)


def joint_delta_objective(x, q0, pc0, exp, sq_norm, quad, om, mask_take, npx, npy, scale, nrows, ncols):
    """``1 - NCC`` at ``q0 (x) exp_map(x[:, :3])`` and ``pc0 + x[:, 3:]``
    (``_objective_joint_gibbs``)."""
    dc = pc_direction_cosines(pc0 + x[:, 3:], nrows, ncols, om, mask_take)
    return lambert_project_ncc(_rotation(q0, x[:, :3]), dc, quad, npx, npy, scale, exp, sq_norm)


# ------------------------------ plain versions ------------------------------ #


def tangent_orientation_plain(delta, q0, exp_unit, dc, quad, npx, npy, scale):
    """``(f, g, jtj)`` of :func:`orientation_residual` at ``delta``; every
    operand float32, or every one float64 (the float64 twin)."""
    _check("delta", delta, 3, q0, exp_unit, quad, npx, npy, dc.shape[-2], [dc], _PLAIN_DTYPES)
    return _normal_equations(orientation_residual, delta, (q0, exp_unit, dc, quad, npx, npy, scale))


def tangent_projection_center_plain(dpc, pc0, exp_unit, q0, quad, om, mask_take, npx, npy, scale, nrows, ncols):
    """``(f, g, jtj)`` of :func:`pc_residual` at ``dpc``; float32 or
    float64 operands."""
    _check_pc(dpc, 3, pc0, exp_unit, q0, quad, om, mask_take, npx, npy, nrows, ncols, _PLAIN_DTYPES)
    return _normal_equations(pc_residual, dpc, (pc0, exp_unit, q0, quad, om, mask_take, npx, npy, scale, nrows, ncols))


def tangent_orientation_projection_center_plain(x, q0, pc0, exp_unit, quad, om, mask_take, npx, npy, scale, nrows,
                                                ncols):
    """``(f, g, jtj)`` of :func:`joint_residual` at ``x``; float32 or
    float64 operands."""
    _check_pc(x, 6, pc0, exp_unit, q0, quad, om, mask_take, npx, npy, nrows, ncols, _PLAIN_DTYPES)
    return _normal_equations(joint_residual, x, (q0, pc0, exp_unit, quad, om, mask_take, npx, npy, scale, nrows,
                                                 ncols))


# --------------------------------- checks --------------------------------- #


# The operand types the kernels take, and what the plain versions take
# (every operand of one of them).
_KERNEL_DTYPES = (_f32,)
_PLAIN_DTYPES = (_f32, torch.float64)


def _check(name, x, d, q, exp_unit, quad, npx, npy, P, tensors, dtypes=_KERNEL_DTYPES) -> None:
    if not isinstance(x, torch.Tensor) or x.ndim != 2 or x.shape[1] != d or x.shape[0] < 1:
        raise ValueError(f"{name} must be a (n, {d}) tensor, got {getattr(x, 'shape', type(x))}")
    n = x.shape[0]
    if not isinstance(q, torch.Tensor) or tuple(q.shape) != (n, 4):
        raise ValueError(f"q0 must be a ({n}, 4) tensor, got {getattr(q, 'shape', type(q))}")
    if P < 1:
        raise ValueError("no pixels")
    if tuple(quad.shape) != (2 * npy * npx, 4):
        raise ValueError(f"quad must be ({2 * npy * npx}, 4) for a {npy} x {npx} master, got {tuple(quad.shape)}")
    if tuple(exp_unit.shape) != (n, P):
        raise ValueError(f"exp_unit must be ({n}, {P}), got {tuple(exp_unit.shape)}")
    dev = x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    for t in [x, q, exp_unit, quad] + list(tensors):
        if t.device != dev:
            raise ValueError("all operands must be on one device")
        if t.dtype not in dtypes or t.dtype != x.dtype:
            raise TypeError(f"the tangent wrappers take float32 (their plain versions float32 or float64, one for "
                            f"all operands), got {t.dtype} beside {x.dtype}")
    if name == "delta":
        dc = tensors[0]
        if not (dc.ndim == 2 and dc.shape[1] == 3) and not (dc.ndim == 3 and dc.shape[0] == n and dc.shape[2] == 3):
            raise ValueError(f"dc must be (P, 3) or ({n}, P, 3), got {tuple(dc.shape)}")


def _check_pc(x, d, pc0, exp_unit, q0, quad, om, mask_take, npx, npy, nrows, ncols, dtypes=_KERNEL_DTYPES) -> int:
    """The PC modes' checks; returns P."""
    if int(nrows) < 1 or int(ncols) < 1:
        raise ValueError(f"the detector must have rows and columns, got {nrows} x {ncols}")
    if not isinstance(om, torch.Tensor) or tuple(om.shape) != (3, 3):
        raise ValueError(f"om must be a (3, 3) tensor, got {getattr(om, 'shape', type(om))}")
    P = nrows * ncols
    if mask_take is not None:
        if not isinstance(mask_take, torch.Tensor) or mask_take.ndim != 1 or mask_take.dtype.is_floating_point:
            raise ValueError("mask_take must be a 1-D integer tensor of pixel indices")
        if mask_take.device != x.device:
            raise ValueError("all operands must be on one device")
        if mask_take.numel() and (int(mask_take.min()) < 0 or int(mask_take.max()) >= nrows * ncols):
            raise ValueError(f"mask_take holds pixel indices outside [0, {nrows * ncols})")
        P = mask_take.numel()
    n = x.shape[0] if isinstance(x, torch.Tensor) and x.ndim == 2 else None
    if not isinstance(pc0, torch.Tensor) or tuple(pc0.shape) != (n, 3):
        raise ValueError(f"pc0 must be a ({n}, 3) tensor, got {getattr(pc0, 'shape', type(pc0))}")
    _check("x" if d == 6 else "dpc", x, d, q0, exp_unit, quad, npx, npy, P, [om, pc0], dtypes)
    return P


# --------------------------------- kernel --------------------------------- #


def _launch(mode: str, q, q0, rotvec, pc, dc, pix, om, exp_unit, quad, npx, npy, scale, nrows=1, ncols=1, sim=None):
    """One launch of kernel C; returns ``(f, g, jtj)``."""
    dev = q.device
    n, P = exp_unit.shape
    d = 6 if mode == "joint" else 3
    exp_unit, quad = exp_unit.contiguous(), quad.contiguous()
    _aligned(quad)
    f = torch.empty(n, dtype=_f32, device=dev)
    g = torch.empty((n, d), dtype=_f32, device=dev)
    jtj = torch.empty((n, d, d), dtype=_f32, device=dev)
    om_host = None
    if om is not None:
        om_host = (ctypes.c_float * 9)(*om.detach().to("cpu", _f32).reshape(9).tolist())
    aspect, neg_aspect, inv_ncols, inv_nrows = _detector_scalars(nrows, ncols)
    fn = _function()
    with torch.cuda.device(dev):
        err = fn(
            _MODE[mode], _ptr(q), _ptr(q0), _ptr(rotvec), _ptr(pc), _ptr(dc), int(dc is not None and dc.ndim == 3),
            _ptr(pix), om_host, _ptr(exp_unit), _ptr(quad), _ptr(f), _ptr(g), _ptr(jtj), _ptr(sim), n, P, npx, npy,
            float(scale), aspect, neg_aspect, inv_ncols, inv_nrows, int(resident(P, d)),
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"refine_lm launch ({mode} mode) failed: cudaError_t {err}")
    return f, g, jtj


def tangent_orientation(delta, q0, exp_unit, dc, quad, npx: int, npy: int, scale: float, sim=None):
    """``(f, g, jtj)`` of :func:`orientation_residual` at ``delta``. On the
    card one launch of kernel C for all points; ``sim (n, P)``, if given,
    receives the projected patterns."""
    _check("delta", delta, 3, q0, exp_unit, quad, npx, npy, dc.shape[-2], [dc])
    if delta.device.type == "cpu":
        return tangent_orientation_plain(delta, q0, exp_unit, dc, quad, npx, npy, scale)
    q = _rotation(q0, delta).contiguous()
    out = _launch("orientation", q, q0.contiguous(), delta.contiguous(), None, dc.contiguous(), None, None,
                  exp_unit, quad, npx, npy, scale, sim=sim)
    tangent_orientation.launches += 1
    return out


def tangent_projection_center(dpc, pc0, exp_unit, q0, quad, om, mask_take, npx: int, npy: int, scale: float,
                              nrows: int, ncols: int, sim=None):
    """``(f, g, jtj)`` of :func:`pc_residual` at ``dpc``. On the card one
    launch of kernel C, each pixel's direction cosine computed from its
    candidate PC inside it."""
    _check_pc(dpc, 3, pc0, exp_unit, q0, quad, om, mask_take, npx, npy, nrows, ncols)
    if dpc.device.type == "cpu":
        return tangent_projection_center_plain(dpc, pc0, exp_unit, q0, quad, om, mask_take, npx, npy, scale, nrows,
                                               ncols)
    pc = (pc0 + dpc).contiguous()
    out = _launch("pc", q0.contiguous(), None, None, pc, None, pixel_table(mask_take, nrows, ncols, dpc.device), om,
                  exp_unit, quad, npx, npy, scale, nrows, ncols, sim=sim)
    tangent_projection_center.launches += 1
    return out


def tangent_orientation_projection_center(x, q0, pc0, exp_unit, quad, om, mask_take, npx: int, npy: int,
                                          scale: float, nrows: int, ncols: int, sim=None):
    """``(f, g, jtj)`` of :func:`joint_residual` at ``x (n, 6)``. On the card
    one launch of kernel C."""
    _check_pc(x, 6, pc0, exp_unit, q0, quad, om, mask_take, npx, npy, nrows, ncols)
    if x.device.type == "cpu":
        return tangent_orientation_projection_center_plain(x, q0, pc0, exp_unit, quad, om, mask_take, npx, npy, scale,
                                                           nrows, ncols)
    delta = x[:, :3].contiguous()
    q = _rotation(q0, delta).contiguous()
    pc = (pc0 + x[:, 3:]).contiguous()
    out = _launch("joint", q, q0.contiguous(), delta, pc, None, pixel_table(mask_take, nrows, ncols, x.device), om,
                  exp_unit, quad, npx, npy, scale, nrows, ncols, sim=sim)
    tangent_orientation_projection_center.launches += 1
    return out


tangent_orientation.launches = 0
tangent_projection_center.launches = 0
tangent_orientation_projection_center.launches = 0


# ----------------------- Levenberg-Marquardt in one launch ----------------------- #


def _check_loop(max_iters, blocks, d: int) -> list[float]:
    """The loop's checks; returns the norm of each block of 3 parameters."""
    if int(max_iters) < 0:
        raise ValueError(f"max_iters must be >= 0, got {max_iters}")
    if blocks is None:
        return []
    blocks = tuple(blocks)
    if any(int(size) != 3 for size, _ in blocks) or 3 * len(blocks) != d:
        raise ValueError(f"blocks must be None or one (3, max_norm) block for each 3 of the {d} parameters, "
                         f"got {blocks}")
    return [float(norm) for _, norm in blocks]


def _launch_loop(mode: str, x0, q0, pc0, dc, pix, om, exp_unit, quad, npx, npy, scale, nrows, ncols, max_iters, ftol,
                 lambda0, norms) -> LMKernelResult:
    """One launch of the loop kernel for all points."""
    dev = x0.device
    n, P = exp_unit.shape
    d = x0.shape[1]
    x0, q0, exp_unit, quad = (t.contiguous() for t in (x0, q0, exp_unit, quad))
    pc0 = None if pc0 is None else pc0.contiguous()
    dc = None if dc is None else dc.contiguous()
    _aligned(quad)
    x = torch.empty((n, d), dtype=_f32, device=dev)
    fun = torch.empty(n, dtype=_f32, device=dev)
    n_iter = torch.empty(n, dtype=torch.int32, device=dev)
    converged = torch.empty(n, dtype=torch.bool, device=dev)
    n_evals = torch.empty(n, dtype=torch.int32, device=dev)
    queue = torch.zeros(1, dtype=torch.int32, device=dev)
    om_host = None
    if om is not None:
        om_host = (ctypes.c_float * 9)(*om.detach().to("cpu", _f32).reshape(9).tolist())
    aspect, neg_aspect, inv_ncols, inv_nrows = _detector_scalars(nrows, ncols)
    fn = _function("refine_lm_loop")
    with torch.cuda.device(dev):
        err = fn(
            _MODE[mode], _ptr(x0), _ptr(q0), _ptr(pc0), _ptr(dc), int(dc is not None and dc.ndim == 3), _ptr(pix),
            om_host, _ptr(exp_unit), _ptr(quad), _ptr(x), _ptr(fun), _ptr(n_iter), _ptr(converged), _ptr(n_evals),
            _ptr(queue), n, P, npx, npy, float(scale), aspect, neg_aspect, inv_ncols, inv_nrows,
            int(max_iters), float(ftol), float(lambda0), len(norms), (ctypes.c_float * 2)(*norms, *[0.0] * (2 - len(norms))),
            loop_residency(P, d), torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"refine_lm_loop launch ({mode} mode) failed: cudaError_t {err}")
    return LMKernelResult(x=x, fun=fun, n_iter=n_iter, converged=converged, n_evals=n_evals)


def _host_loop(evaluate, x0, max_iters, ftol, lambda0, blocks, args) -> LMKernelResult:
    res = _levenberg_marquardt_normal(evaluate, x0, max_iters=max_iters, ftol=ftol, lambda0=lambda0, blocks=blocks,
                                      args=args)
    return LMKernelResult(*res, n_evals=res.n_iter + 1)


def levenberg_marquardt_orientation_plain(x0, q0, exp_unit, dc, quad, npx: int, npy: int, scale: float,
                                          max_iters: int = 30, ftol: float = 1e-7, lambda0: float = 1e-3,
                                          blocks=None) -> LMKernelResult:
    """The host loop: ``utils/optimize.py`` ``_levenberg_marquardt_normal`` over
    :func:`tangent_orientation` (kernel C a launch on the card, its plain
    version on the CPU)."""
    _check("delta", x0, 3, q0, exp_unit, quad, npx, npy, dc.shape[-2], [dc])
    _check_loop(max_iters, blocks, 3)
    return _host_loop(tangent_orientation, x0, max_iters, ftol, lambda0, blocks,
                      (q0, exp_unit, dc, quad, npx, npy, scale))


def levenberg_marquardt_orientation(x0, q0, exp_unit, dc, quad, npx: int, npy: int, scale: float,
                                    max_iters: int = 30, ftol: float = 1e-7, lambda0: float = 1e-3,
                                    blocks=None) -> LMKernelResult:
    """Minimize ``0.5 ||r||^2`` of :func:`orientation_residual` over the
    rotation vector of every point from ``x0 (n, 3)``. On the card one launch
    of the loop kernel for all points; its ``n_evals`` are the evaluations it
    made."""
    _check("delta", x0, 3, q0, exp_unit, quad, npx, npy, dc.shape[-2], [dc])
    norms = _check_loop(max_iters, blocks, 3)
    if x0.device.type == "cpu":
        return levenberg_marquardt_orientation_plain(x0, q0, exp_unit, dc, quad, npx, npy, scale, max_iters, ftol,
                                                     lambda0, blocks)
    res = _launch_loop("orientation", x0, q0, None, dc, None, None, exp_unit, quad, npx, npy, scale, 1, 1,
                       max_iters, ftol, lambda0, norms)
    levenberg_marquardt_orientation.launches += 1
    return res


def levenberg_marquardt_projection_center_plain(x0, pc0, exp_unit, q0, quad, om, mask_take, npx: int, npy: int,
                                                scale: float, nrows: int, ncols: int, max_iters: int = 30,
                                                ftol: float = 1e-7, lambda0: float = 1e-3, blocks=None) -> LMKernelResult:
    """The host loop over :func:`tangent_projection_center`."""
    _check_pc(x0, 3, pc0, exp_unit, q0, quad, om, mask_take, npx, npy, nrows, ncols)
    _check_loop(max_iters, blocks, 3)
    return _host_loop(tangent_projection_center, x0, max_iters, ftol, lambda0, blocks,
                      (pc0, exp_unit, q0, quad, om, mask_take, npx, npy, scale, nrows, ncols))


def levenberg_marquardt_projection_center(x0, pc0, exp_unit, q0, quad, om, mask_take, npx: int, npy: int,
                                          scale: float, nrows: int, ncols: int, max_iters: int = 30,
                                          ftol: float = 1e-7, lambda0: float = 1e-3, blocks=None) -> LMKernelResult:
    """Minimize ``0.5 ||r||^2`` of :func:`pc_residual` over the PC shift of
    every point from ``x0 (n, 3)``, its rotation fixed. On the card one
    launch of the loop kernel's PC mode."""
    _check_pc(x0, 3, pc0, exp_unit, q0, quad, om, mask_take, npx, npy, nrows, ncols)
    norms = _check_loop(max_iters, blocks, 3)
    if x0.device.type == "cpu":
        return levenberg_marquardt_projection_center_plain(x0, pc0, exp_unit, q0, quad, om, mask_take, npx, npy,
                                                           scale, nrows, ncols, max_iters, ftol, lambda0, blocks)
    res = _launch_loop("pc", x0, q0, pc0, None, pixel_table(mask_take, nrows, ncols, x0.device), om, exp_unit, quad,
                       npx, npy, scale, nrows, ncols, max_iters, ftol, lambda0, norms)
    levenberg_marquardt_projection_center.launches += 1
    return res


def levenberg_marquardt_orientation_projection_center_plain(x0, q0, pc0, exp_unit, quad, om, mask_take, npx: int,
                                                            npy: int, scale: float, nrows: int, ncols: int,
                                                            max_iters: int = 30, ftol: float = 1e-7,
                                                            lambda0: float = 1e-3, blocks=None) -> LMKernelResult:
    """The host loop over :func:`tangent_orientation_projection_center`."""
    _check_pc(x0, 6, pc0, exp_unit, q0, quad, om, mask_take, npx, npy, nrows, ncols)
    _check_loop(max_iters, blocks, 6)
    return _host_loop(tangent_orientation_projection_center, x0, max_iters, ftol, lambda0, blocks,
                      (q0, pc0, exp_unit, quad, om, mask_take, npx, npy, scale, nrows, ncols))


def levenberg_marquardt_orientation_projection_center(x0, q0, pc0, exp_unit, quad, om, mask_take, npx: int,
                                                      npy: int, scale: float, nrows: int, ncols: int,
                                                      max_iters: int = 30, ftol: float = 1e-7, lambda0: float = 1e-3,
                                                      blocks=None) -> LMKernelResult:
    """Minimize ``0.5 ||r||^2`` of :func:`joint_residual` over the rotation
    vector and PC shift of every point from ``x0 (n, 6)``. On the card one
    launch of the loop kernel's joint mode."""
    _check_pc(x0, 6, pc0, exp_unit, q0, quad, om, mask_take, npx, npy, nrows, ncols)
    norms = _check_loop(max_iters, blocks, 6)
    if x0.device.type == "cpu":
        return levenberg_marquardt_orientation_projection_center_plain(
            x0, q0, pc0, exp_unit, quad, om, mask_take, npx, npy, scale, nrows, ncols, max_iters, ftol, lambda0, blocks,
        )
    res = _launch_loop("joint", x0, q0, pc0, None, pixel_table(mask_take, nrows, ncols, x0.device), om, exp_unit,
                       quad, npx, npy, scale, nrows, ncols, max_iters, ftol, lambda0, norms)
    levenberg_marquardt_orientation_projection_center.launches += 1
    return res


levenberg_marquardt_orientation.launches = 0
levenberg_marquardt_projection_center.launches = 0
levenberg_marquardt_orientation_projection_center.launches = 0


def trial_point(mode: str, q0, pc0, x):
    """The loop kernel's rotation ``(n, 4)`` and PC ``(n, 3)`` at ``x (n,
    d)`` (None where the mode has none), from ``csrc/refine_lm.cu``'s own
    device code, to hold against :func:`_rotation` and ``pc0 + dpc`` on
    the card. CUDA tensors only."""
    n = x.shape[0]
    dev = x.device
    q = torch.empty((n, 4), dtype=_f32, device=dev) if mode != "pc" else None
    pc = torch.empty((n, 3), dtype=_f32, device=dev) if mode != "orientation" else None
    with torch.cuda.device(dev):
        err = _function("refine_lm_trial")(_MODE[mode], _ptr(q0), _ptr(pc0), _ptr(x.contiguous()), _ptr(q), _ptr(pc),
                                           n, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"refine_lm_trial launch failed: cudaError_t {err}")
    return q, pc


def solve(a, b):
    """The loop kernel's d x d solve (``lu_solve``) of ``a (n, d, d) x = b
    (n, d)``, d 3 or 6, to hold against ``torch.linalg.solve_ex`` on the
    card. CUDA tensors only."""
    n, d = b.shape
    x = torch.empty((n, d), dtype=_f32, device=b.device)
    with torch.cuda.device(b.device):
        err = _function("refine_lm_solve")(d, _ptr(a.contiguous()), _ptr(b.contiguous()), _ptr(x), n,
                                           torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"refine_lm_solve launch failed: cudaError_t {err}")
    return x


def kernel_attributes(kernel: str, mode: str, plan: int, P: int) -> dict[str, int]:
    """What the card built kernel C (``kernel="tangent"``, ``plan``
    :func:`resident`'s 0 or 1) or the loop kernel (``"loop"``, ``plan``
    :func:`loop_residency`'s 0-2) as in ``mode`` at ``P`` pixels: registers
    and local (spilled) bytes a thread, static shared memory a block, the
    blocks an SM holds, and the dynamic shared memory a block it launches
    with. Needs the card."""
    out = (ctypes.c_int * 5)()
    err = _function("refine_lm_attributes")(int(kernel == "loop"), _MODE[mode], int(plan), int(P), out)
    if err:
        raise RuntimeError(f"refine_lm_attributes failed: cudaError_t {err}")
    return dict(zip(("registers", "local_bytes", "static_smem_bytes", "blocks_per_sm", "dynamic_smem_bytes"), out))
