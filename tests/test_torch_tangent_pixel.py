"""The arithmetic of kernel C and the Levenberg-Marquardt loop kernel's one
evaluation (``csrc/refine_lm.cu`` ``tangent_point`` on
``csrc/lambert_common.cuh`` ``lambert_pixel_grad``), on the CPU.

The kernel runs only on the card. Its arithmetic is checked here:

- a float64 model of its pixel, written as the kernel computes it (the
  value in texel units, the gradient ``G = ds/do`` with respect to the
  rotated, unnormalised direction ``o`` with no normalisation step, and the
  tangents ``omega_k . (o x G)`` of the rotation vector and ``(N^T G)_j /
  |w|`` of the PC, ``N = M om`` with its first column times ``-ncols /
  nrows``), against ``torch.func.jvp`` of the float64 plain twin
  (``ops/lambert_project.py`` ``_project_plain`` over
  ``ops/refine_lm.py``'s rotation and direction cosines) pixel by pixel, in
  every mode: seeded random pixels and rotations, quaternions that are not
  unit, pixels on and within 1e-4 rad of a Lambert pole (the tangent 0 on
  it), pixels whose weight is exactly 0 or 1 (JAX's tie: half the
  tangent), and pixels whose minor component is 2e-8 to 1e-6 off the
  centre line (the interior's tangent; the first four lie in the band where
  the kernel's float32 coordinate rounds onto the centre and the kernel
  takes the tie instead, which the case measures). Tolerance 1e-7 of the case's largest tangent, and 1e-10 of the
  values: float64 rounding, except near a pole, where the twin's ``1 - |wz|``
  (about 5e-9 at 1e-4 rad) keeps about 8 digits;
- each mode's plain version run on float64 operands (the kernel's yardstick
  on the card) against JAX's ``jac_and_res`` and einsums under x64, over
  the JAX package's own projection, exp map and direction cosines composed
  in float64 (its residuals cast the rotation and the PC to float32): ``f``
  within 1e-12, ``J^T r`` and ``J^T J`` within 1e-9 of their norms (float64
  sums in other orders);
- the shared-memory plan (``resident``, ``loop_residency``) at the
  main-path shape.
"""

import importlib.util
import math
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kikuchipy_tpu.geometry import quaternion as jq
from kikuchipy_tpu.indexing import refinement as jr
from kikuchipy_tpu_torch.geometry import quaternion as tq
from kikuchipy_tpu_torch.geometry.detector import EBSDDetector
from kikuchipy_tpu_torch.ops import lambert_project as lp
from kikuchipy_tpu_torch.ops import refine_lm as rl
from kikuchipy_tpu_torch.projection.master_pattern import direction_cosines_from_detector, quad_texture

_SMOKE = Path(__file__).resolve().parents[1] / "chip_smoke.py"
SIDE = 101
SCALE = (SIDE - 1) / 2
SHAPE = (24, 32)
PC = (0.42, 0.28, 0.5)
f64 = torch.float64


@pytest.fixture(scope="module")
def master() -> np.ndarray:
    spec = importlib.util.spec_from_file_location("chip_smoke_inputs", _SMOKE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return np.asarray(mod.master_pattern_data(side=SIDE), dtype=np.float64)


@pytest.fixture(scope="module")
def detector():
    det = EBSDDetector(shape=SHAPE, pc=PC, sample_tilt=70)
    om = torch.as_tensor(np.ascontiguousarray(det.sample_to_detector.T), dtype=f64)
    return det, om


# ------------------------ the kernel's pixel in float64 ------------------------ #


def _matrix(q):
    """rotate_vector's matrix ``(..., 3, 3)`` of quaternions ``(..., 4)``
    (the quadratic form: ``|q|^2`` times a rotation)."""
    a, b, c, d = q.unbind(-1)
    aa, bb, cc, dd = a * a, b * b, c * c, d * d
    rows = [[aa + bb - cc - dd, 2 * (b * c - a * d), 2 * (a * c + b * d)],
            [2 * (a * d + b * c), aa - bb + cc - dd, 2 * (c * d - a * b)],
            [2 * (b * d - a * c), 2 * (a * b + c * d), aa - bb - cc + dd]]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _clip_tangent(w, tie):
    """The clip's tangent at an unclipped weight (``clip_tangent``): half at
    exactly 0 or 1 where ``tie`` says the offset is exact there."""
    edge = torch.where(torch.as_tensor(tie), 0.5, 1.0)
    return torch.where((w > 0) & (w < 1), 1.0, torch.where((w == 0) | (w == 1), edge, 0.0)).to(w.dtype)


def _model_pixel(o, quad):
    """The value and ``G = ds/do`` of ``lambert_pixel_grad`` at rotated
    directions ``o (..., 3)``, in float64 with exact reciprocals and
    square roots and ``atan`` for the kernel's polynomial."""
    ox, oy, oz = o.unbind(-1)
    rho2 = ox * ox + oy * oy
    r2 = oz * oz + rho2
    rr = 1 / torch.sqrt(r2)
    a = oz.abs()
    pole = rho2 == 0
    ys = torch.where(pole, 0.0, 1 / torch.sqrt(torch.where(pole, 1.0, SCALE**2 * rho2 * (a * r2 * rr + r2))))
    u = SCALE**2 * rho2 * ys
    first = oy.abs() <= ox.abs()
    major, minor = torch.where(first, ox, oy), torch.where(first, oy, ox)
    inv_major = torch.where(pole, 0.0, 1 / torch.maximum(ox.abs(), oy.abs()).clamp_min(1e-300))
    t = minor * inv_major
    at = (4 / math.pi) * torch.atan(t)
    c_major, c_minor = torch.copysign(u, major) + SCALE, u * at + SCALE
    ci, cj = torch.where(first, c_minor, c_major), torch.where(first, c_major, c_minor)
    nii, nij = torch.trunc(ci), torch.trunc(cj)
    ri, rj = ci - nii, cj - nij
    di, dj = ri.clamp(0, 1), rj.clamp(0, 1)
    nii = torch.where(nii < 0, torch.clamp(nii + 1, max=SIDE - 1), nii).long()
    nij = torch.where(nij < 0, torch.clamp(nij + 1, max=SIDE - 1), nij).long()
    q4 = quad[torch.where(oz < 0, SIDE * SIDE, 0) + nii * SIDE + nij]
    qx, qy, qz, qw = q4.unbind(-1)
    lo, hi = qx + di * (qy - qx), qz + di * (qw - qz)
    value = lo + dj * (hi - lo)
    # A tie only where the minor coordinate is the centre; elsewhere an offset
    # of exactly 0 is rounding of one inside (0, 1).
    gi = _clip_tangent(ri, first & (ci == SCALE)) * ((qy - qx) + dj * ((qw - qz) - (qy - qx)))
    gj = _clip_tangent(rj, ~first & (cj == SCALE)) * (hi - lo)
    g_minor, g_major = torch.where(first, gi, gj), torch.where(first, gj, gi)
    sgn_major = torch.copysign(torch.ones_like(major), major)
    K = 0.5 * SCALE**2 * (r2 * rr + a) * ys * rr * rr
    Pu = (g_major * sgn_major + g_minor * at) * K
    Ct = g_minor * u * (4 / math.pi) / (1 + t * t) * inv_major
    along_major = -Ct * t * sgn_major
    G = torch.stack([Pu * a * ox + torch.where(first, along_major, Ct), Pu * a * oy + torch.where(first, Ct, along_major),
                     -torch.sign(oz) * Pu * rho2], dim=-1)
    return value, torch.where(pole[..., None], 0.0, G)


def _omega(q0, delta):
    """``omega_k (n, 3, 3)`` (row k): ``2 vec(dq_k (x) q*) / |q|^2`` for
    ``q = q0 (x) exp_map(delta)``, ``dq_k = q0 (x) d exp_map / d delta_k``
    (``point_consts``)."""
    q = tq.multiply(q0, rl.exp_map(delta))
    h = delta / 2
    inv = 1 / torch.sqrt(1 + (h * h).sum(-1))
    conj = q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)
    rows = []
    for k in range(3):
        dp = torch.cat([(-0.5 * inv**3 * h[:, k])[:, None],
                        0.5 * inv[:, None] * torch.eye(3, dtype=q.dtype, device=q.device)[k] - 0.5 * inv[:, None] ** 3 * h * h[:, k:k + 1]],
                       dim=1)
        spin = tq.multiply(tq.multiply(q0, dp), conj)
        rows.append(2 * spin[:, 1:] / (q * q).sum(-1, keepdim=True))
    return torch.stack(rows, dim=1)


def _pixel_xyz(pc, take):
    """The pixels' unnormalised detector coordinates ``(n, P, 3)``: x =
    aspect ((col + 0.5) / ncols - pcx), y = pcy - (row + 0.5) / nrows, z =
    pcz."""
    nrows, ncols = SHAPE
    idx = torch.arange(nrows * ncols, device=pc.device) if take is None else take
    col, row = (idx % ncols).to(pc.dtype), (idx // ncols).to(pc.dtype)
    x = ncols / nrows * ((col + 0.5)[None, :] / ncols - pc[:, 0:1])
    y = pc[:, 1:2] - (row + 0.5)[None, :] / nrows
    return torch.stack([x, y, torch.broadcast_to(pc[:, 2:3], x.shape)], dim=-1)


def _model_tangents(mode, x, q0, pc0, dc, om, take, quad):
    """The model's values ``(n, P)`` and tangents ``(n, P, d)`` as
    ``Pixel`` computes them."""
    if mode == "pc":
        q = q0
    else:
        q = tq.multiply(q0, rl.exp_map(x[:, :3]))
    M = _matrix(q)
    if mode == "orientation":
        v, norm = dc if dc.ndim == 3 else dc.expand(x.shape[0], -1, -1), None
    else:
        w = _pixel_xyz(pc0 + x[:, -3:], take) @ om.T
        norm = torch.linalg.vector_norm(w, dim=-1)
        v = w / norm[..., None]
    o = torch.einsum("nij,npj->npi", M, v)
    value, G = _model_pixel(o, quad)
    parts = []
    if mode != "pc":
        parts.append(torch.einsum("nkj,npj->npk", _omega(q0, x[:, :3]), torch.cross(o, G, dim=-1)))
    if mode != "orientation":
        N = M @ om
        N = N * torch.tensor([-SHAPE[1] / SHAPE[0], 1.0, 1.0], dtype=N.dtype, device=N.device)
        parts.append(torch.einsum("nij,npi->npj", N, G) / norm[..., None])
    return value, torch.cat(parts, dim=-1)


def _twin_tangents(mode, x, q0, pc0, dc, om, take, quad):
    """The float64 plain twin's values and, by ``torch.func.jvp`` along each
    axis of ``x``, its tangents ``(n, P, d)``."""
    nrows, ncols = SHAPE

    def values(z):
        q = q0 if mode == "pc" else rl._rotation(q0, z[:, :3])
        d = dc if mode == "orientation" else rl._direction_cosines(pc0 + z[:, -3:], nrows, ncols, om, take)
        return lp._project_plain(q, d, quad, SIDE, SIDE, SCALE)

    n, dims = x.shape
    cols = []
    for k in range(dims):
        value, col = torch.func.jvp(values, (x,), (torch.eye(dims, dtype=f64)[k].expand(n, dims).contiguous(),))
        cols.append(col)
    return value, torch.stack(cols, dim=-1)


def _rotation_to_pole(v, tilt):
    """Quaternions ``(n, 4)`` turning unit ``v (n, 3)`` onto +z, then by
    ``tilt`` rad about x."""
    ez = torch.tensor([0.0, 0.0, 1.0], dtype=f64)
    axis = torch.cross(v, ez.expand_as(v), dim=-1)
    angle = torch.acos((v * ez).sum(-1).clamp(-1, 1))
    axis = axis / torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    q = torch.cat([torch.cos(angle / 2)[:, None], torch.sin(angle / 2)[:, None] * axis], dim=1)
    t = torch.tensor([math.cos(tilt / 2), math.sin(tilt / 2), 0.0, 0.0], dtype=f64)
    return tq.multiply(t.expand_as(q), q)


def _case(name, detector):
    """(mode, x, q0, pc0, dc, om, take) of a named case, float64."""
    det, om = detector
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    n = 8
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=f64)  # noqa: E731
    q0 = t(rng.normal(size=(n, 4)))
    q0 = q0 / torch.linalg.vector_norm(q0, dim=1, keepdim=True) * t(rng.uniform(0.9, 1.1, size=(n, 1)))
    pc0 = t(np.asarray(PC) + rng.normal(scale=0.01, size=(n, 3)))
    dc = direction_cosines_from_detector(det, dtype=f64, device="cpu")
    take = None
    mode = name.split("-")[0]
    d = 6 if mode == "joint" else 3
    x = t(rng.normal(scale=0.02 if mode == "orientation" else 0.005, size=(n, d)))
    if name.endswith("masked"):
        take = torch.as_tensor(np.sort(rng.choice(SHAPE[0] * SHAPE[1], 300, replace=False)))
        dc = dc[take]
    if name == "orientation-special":
        # At delta = 0 and q0 = 1.02 (1, 0, 0, 0): pixels exactly on the north
        # and south poles, within 1e-4 rad of them, and with the rotated y
        # or x exactly 0 (a weight exactly 0 and its partner exactly 1).
        q0 = t([[1.02, 0.0, 0.0, 0.0]] * n)
        x = torch.zeros((n, 3), dtype=f64)
        v = [[0, 0, 1], [0, 0, -1], [1e-4, 0.5e-4, 1], [-0.3e-4, 0.8e-4, -1], [0.6, 0, 0.8], [0, -0.6, 0.8],
             [0.48, 0, -0.64], [0, 0.3, 0.95]]
        v = t(v + rng.normal(size=(24, 3)).tolist())
        dc = v / torch.linalg.vector_norm(v, dim=1, keepdim=True)
    if name == "orientation-near_centre":
        # At delta = 0 and q0 = 1.02 (1, 0, 0, 0): pixels whose minor
        # component is 2e-8 to 1e-6 off 0; the twin and this float64 model
        # give them the interior's tangent.
        q0 = t([[1.02, 0.0, 0.0, 0.0]] * n)
        x = torch.zeros((n, 3), dtype=f64)
        v = [[0.6, 3e-8, 0.8], [-2e-8, -0.6, 0.8], [0.48, -3e-8, -0.64], [2e-8, 0.3, 0.95], [0.6, 1e-7, 0.8],
             [-1e-6, -0.6, 0.8], [0.48, 1e-6, -0.64], [-1e-7, 0.3, 0.95]]
        v = t(v + rng.normal(size=(24, 3)).tolist())
        dc = v / torch.linalg.vector_norm(v, dim=1, keepdim=True)
    if name == "pc-near_pole":
        # Each point's rotation turns its pixel 100 to within 1e-4 rad of the
        # pole, at dpc = 0, q0 not unit.
        x = torch.zeros((n, 3), dtype=f64)
        w = _pixel_xyz(pc0, None)[:, 100] @ om.T
        q0 = _rotation_to_pole(w / torch.linalg.vector_norm(w, dim=1, keepdim=True), 1e-4) * 0.97
    if name == "orientation-per_point":
        dc = dc[None].expand(n, -1, -1) + t(rng.normal(scale=0.01, size=(n,) + tuple(dc.shape)))
        dc = dc / torch.linalg.vector_norm(dc, dim=-1, keepdim=True)
    return mode, x, q0, pc0, dc, om, take


CASES = ["orientation", "orientation-masked", "orientation-per_point", "orientation-special",
         "orientation-near_centre", "pc", "pc-masked", "pc-near_pole", "joint", "joint-masked"]


@pytest.mark.parametrize("name", CASES)
def test_model_of_the_kernels_pixel_matches_the_float64_twins_jvp(name, master, detector):
    quad = quad_texture(torch.as_tensor(master))
    mode, x, q0, pc0, dc, om, take = _case(name, detector)
    value, tangent = _model_tangents(mode, x, q0, pc0, dc, om, take, quad)
    want_value, want = _twin_tangents(mode, x, q0, pc0, dc, om, take, quad)
    np.testing.assert_allclose(value.numpy(), want_value.numpy(), rtol=1e-10, atol=0)
    scale = float(want.abs().max())
    assert scale > 0
    err = (tangent - want).abs().max(dim=-1).values
    assert float(err.max()) <= 1e-7 * scale, (float(err.max()), scale)
    if name == "orientation-special":
        # On the poles no tangent (JAX's rule); near them a finite one; at
        # the ties half of the clipped axis's tangent, still not zero.
        assert float(tangent[:, :2].abs().max()) == 0.0
        assert float(tangent[:, 2:4].abs().max()) > 0.0
        assert float(tangent[:, 4:8].abs().max()) > 0.0
    if name == "orientation-near_centre":
        # The minor coordinate's distance from the centre, u (4 / pi)
        # atan(t), is not 0, and for the first four pixels under half an ulp
        # of SCALE in float32: the kernel's coordinate rounds onto the centre
        # there and it takes JAX's tie (half the tangent), where the twin
        # takes the interior's. Beyond the band both take the interior's.
        v = dc[:8]
        first = v[:, 1].abs() <= v[:, 0].abs()
        minor, major = torch.where(first, v[:, 1], v[:, 0]), torch.where(first, v[:, 0], v[:, 1])
        off = (SCALE * torch.sqrt(1 - v[:, 2].abs()) * (4 / math.pi) * torch.atan(minor / major.abs())).abs()
        half_ulp = float(np.spacing(np.float32(SCALE))) / 2
        assert bool((off[:4] < half_ulp).all()) and bool((off[:4] > 0).all()), off
        assert float((SCALE + off[:4].float()).sub(SCALE).abs().max()) == 0.0
        assert bool((off[4:] >= half_ulp).all()), off


def test_model_clip_tangent_is_jax_s_at_0_and_1():
    # The clip's tangent (jnp.clip: a maximum, then a minimum) at and around
    # both ends: the model's rule against JAX's jvp where the offset is exact
    # (a tie); where an offset of 0 or 1 is rounding, the interior's.
    w = np.array([-0.5, 0.0, 0.3, 1.0, 1.5])
    want = np.array([jax.jvp(lambda z: jnp.clip(z, 0.0, 1.0), (jnp.float64(v),), (jnp.float64(1.0),))[1] for v in w])
    np.testing.assert_array_equal(_clip_tangent(torch.as_tensor(w), True).numpy(), want)
    np.testing.assert_array_equal(want, [0.0, 0.5, 1.0, 0.5, 0.0])
    np.testing.assert_array_equal(_clip_tangent(torch.as_tensor(w), False).numpy(), [0.0, 1.0, 1.0, 1.0, 0.0])


def test_gradient_is_orthogonal_to_the_direction_and_of_degree_minus_one(master):
    # The coordinates are homogeneous of degree 0 in o: G . o = 0, and G(c o)
    # = G(o) / c, so a quaternion's length drops out of o x G.
    quad = quad_texture(torch.as_tensor(master))
    o = torch.as_tensor(np.random.default_rng(3).normal(size=(4096, 3)))
    _, G = _model_pixel(o, quad)
    rel = (G * o).sum(-1).abs() / (torch.linalg.vector_norm(G, dim=-1) * torch.linalg.vector_norm(o, dim=-1) + 1e-300)
    assert float(rel.max()) <= 1e-12
    _, G3 = _model_pixel(3.0 * o, quad)
    np.testing.assert_allclose(G3.numpy(), G.numpy() / 3.0, rtol=1e-12, atol=1e-15 * float(G.abs().max()))


# ------------------ the float64 plain versions against JAX under x64 ------------------ #


def _jax_normal_equations(residual, x, args):
    """JAX's ``jac_and_res`` (a vmapped jvp over the basis) and its einsums."""
    n, d = x.shape
    eye = jnp.eye(d, dtype=x.dtype)

    def one(tan):
        return jax.jvp(lambda z: residual(z, *args), (x,), (jnp.broadcast_to(tan, (n, d)),))

    r, cols = jax.vmap(one, out_axes=(None, 0))(eye)
    jac = jnp.moveaxis(cols, 0, -1)
    return (0.5 * jnp.sum(jnp.square(r), axis=-1), jnp.einsum("nmp,nm->np", jac, r),
            jnp.einsum("nmp,nmq->npq", jac, jac))


def _jax_residual(mode, nrows, ncols, take):
    """JAX's residual of ``mode`` from the JAX package's own functions, in
    float64 (its ``_residual_*`` cast the rotation and PC to float32)."""

    def dc_at(pc, om):
        dc = jr._dc_for_pc(pc, nrows, ncols, om, None)
        return dc if take is None else jnp.take(dc, take, axis=1)

    def rotation(q0, delta):
        return jq.multiply(q0, jr._exp_map(delta))

    if mode == "orientation":
        def residual(delta, q0, unit, dc, master):
            return jr._sim_unit(jr._project_at(rotation(q0, delta), dc, master, SIDE, SIDE, SCALE)) - unit
    elif mode == "pc":
        def residual(dpc, q0, unit, pc0, om, master):
            return jr._sim_unit(jr._project_at(q0, dc_at(pc0 + dpc, om), master, SIDE, SIDE, SCALE)) - unit
    else:
        def residual(x, q0, unit, pc0, om, master):
            q = rotation(q0, x[:, :3])
            return jr._sim_unit(jr._project_at(q, dc_at(pc0 + x[:, 3:], om), master, SIDE, SIDE, SCALE)) - unit
    return residual


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
@pytest.mark.parametrize("mode", ["orientation", "pc", "joint"])
def test_float64_plain_tangents_match_jax_under_x64(mode, masked, master, detector):
    det, om = detector
    nrows, ncols = SHAPE
    rng = np.random.default_rng(11)
    n = 6
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=f64)  # noqa: E731
    truth = t(rng.normal(size=(n, 4)))
    truth = truth / torch.linalg.vector_norm(truth, dim=1, keepdim=True)
    q0 = tq.multiply(tq.from_axis_angle(t(rng.normal(size=(n, 3))), np.deg2rad(1.0)), truth)
    pc0 = t(np.tile(np.asarray(PC) + [0.01, -0.01, 0.01], (n, 1)))
    quad = quad_texture(torch.as_tensor(master))
    take = torch.as_tensor(np.sort(rng.choice(nrows * ncols, 400, replace=False))) if masked else None
    dc = direction_cosines_from_detector(det, dtype=f64, device="cpu")
    dc = dc if take is None else dc[take]
    rows = lp._project_plain(truth, dc, quad, SIDE, SIDE, SCALE) + t(rng.normal(scale=0.02, size=(n, dc.shape[0])))
    unit = rl.sim_unit(rows)
    d = 6 if mode == "joint" else 3
    x = t(rng.normal(scale=0.01 if mode == "orientation" else 0.003, size=(n, d)))
    q_fixed = truth if mode == "pc" else q0
    j = lambda a: jnp.asarray(a.numpy())  # noqa: E731
    jtake = None if take is None else jnp.asarray(take.numpy())
    residual = _jax_residual(mode, nrows, ncols, jtake)
    jmaster = jnp.asarray(master)
    if mode == "orientation":
        got = rl.tangent_orientation_plain(x, q0, unit, dc.contiguous(), quad, SIDE, SIDE, SCALE)
        want = _jax_normal_equations(residual, j(x), (j(q0), j(unit), j(dc), jmaster))
    elif mode == "pc":
        got = rl.tangent_projection_center_plain(x, pc0, unit, q_fixed, quad, om, take, SIDE, SIDE, SCALE, nrows,
                                                 ncols)
        want = _jax_normal_equations(residual, j(x), (j(q_fixed), j(unit), j(pc0), j(om), jmaster))
    else:
        got = rl.tangent_orientation_projection_center_plain(x, q0, pc0, unit, quad, om, take, SIDE, SIDE, SCALE,
                                                             nrows, ncols)
        want = _jax_normal_equations(residual, j(x), (j(q0), j(unit), j(pc0), j(om), jmaster))
    assert all(a.dtype == f64 for a in got)
    f, g, h = (a.numpy() for a in got)
    jf, jg, jh = (np.asarray(a, dtype=np.float64) for a in want)
    assert jf.dtype == np.float64 and np.asarray(want[1]).dtype == np.float64
    np.testing.assert_allclose(f, jf, rtol=0, atol=1e-12)
    assert (np.linalg.norm(g - jg, axis=1) / np.linalg.norm(jg, axis=1)).max() <= 1e-9
    assert (np.linalg.norm(h - jh, axis=(1, 2)) / np.linalg.norm(jh, axis=(1, 2))).max() <= 1e-9


def test_float32_and_float64_operands_do_not_mix():
    # The plain versions take every operand float32 or every one float64;
    # the wrappers (the kernels') float32 alone.
    x = torch.zeros((2, 3), dtype=f64)
    args = (torch.ones((2, 4), dtype=f64), torch.ones((2, 5), dtype=f64), torch.ones((5, 3), dtype=f64),
            torch.ones((2 * 3 * 3, 4), dtype=torch.float32), 3, 3, 1.0)
    with pytest.raises(TypeError, match="float64"):
        rl.tangent_orientation_plain(x, *args)
    with pytest.raises(TypeError, match="float32"):
        rl.tangent_orientation(x, *args[:3], args[3].double(), *args[4:])


# ------------------------------ the shared-memory plan ------------------------------ #


@pytest.mark.parametrize("mode, tangent, loop", [("orientation", True, 2), ("pc", True, 2), ("joint", True, 1)])
def test_shared_memory_plan_at_the_main_path_shape(mode, tangent, loop):
    # 60 x 60 pixels: kernel C keeps the pattern and its d tangents in
    # shared memory in every mode; the loop kernel keeps the point's
    # experimental row beside them in the d = 3 modes (three blocks an SM
    # either way), not in joint mode (it would leave one block an SM of two).
    d = 6 if mode == "joint" else 3
    assert rl.resident(3600, d) is tangent
    assert rl.loop_residency(3600, d) == loop
