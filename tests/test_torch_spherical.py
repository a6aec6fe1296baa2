"""The spherical-harmonic projector of the port against the JAX package on
the CPU (``kikuchipy_tpu_torch/projection/spherical.py`` against
``kikuchipy_tpu/projection/spherical.py``).

State: seeded unit vectors and quaternions, coefficient vectors drawn from
a normal distribution, and a 2 x 33 x 33 band-sum master pattern (the
recipe of ``chip_smoke.py``) with a 16 x 16 detector; band limits up to 24.

Tolerances: the basis and the recursion's blocks are float64 on both sides
and agree to 1e-12 of their largest value (the same operations; the norm's
sum may round apart); the zyz tables are equal; the analysis agrees to 1e-5
of the coefficients' norm (float32 samples of the master); rotated
coefficients to 1e-5 of the norm, at gimbal lock too; projected patterns to
1e-4 of each pattern's norm.
"""

import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kikuchipy_tpu.geometry import quaternion as jq
from kikuchipy_tpu.geometry.detector import EBSDDetector as JDetector
from kikuchipy_tpu.projection import spherical as js
from kikuchipy_tpu.projection.master_pattern import direction_cosines_from_detector as j_dc
from kikuchipy_tpu.signals.master_pattern import EBSDMasterPattern as JMP
from kikuchipy_tpu_torch import interop
from kikuchipy_tpu_torch.geometry import quaternion as tq
from kikuchipy_tpu_torch.projection import spherical as ts

_SMOKE = Path(__file__).resolve().parents[1] / "chip_smoke.py"
PC = (0.42, 0.28, 0.5)


def _dirs(n, seed):
    d = np.random.default_rng(seed).normal(size=(n, 3))
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def _quats(n, seed):
    q = np.random.default_rng(seed).normal(size=(n, 4))
    return (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)


def _gimbal_quats():
    """Rotations at and within 1e-3 of gimbal lock: pure z-rotations (beta =
    0), beta = pi, and axes 1e-4 and 1e-3 off z."""
    z = jnp.asarray([0.0, 0.0, 1.0])
    qs = [np.asarray(jq.from_axis_angle(z, a)) for a in (0.0, 0.3, 2.1)]
    flip = np.asarray(jq.from_axis_angle(jnp.asarray([1.0, 0.0, 0.0]), np.pi))
    qs.append(np.asarray(jq.multiply(jnp.asarray(qs[1]), jnp.asarray(flip))))
    for off in (1e-4, 1e-3):
        qs.append(np.asarray(jq.from_axis_angle(jnp.asarray([off, off, 1.0]), 0.7)))
        qs.append(np.asarray(jq.multiply(jnp.asarray(qs[-1]), jnp.asarray(flip))))
    return np.stack(qs).astype(np.float32)


@pytest.fixture(scope="module")
def master():
    spec = importlib.util.spec_from_file_location("chip_smoke_inputs", _SMOKE)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.master_pattern_data(side=33).astype(np.float32)


def _rel(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


# ------------------------------- the basis ------------------------------- #


@pytest.mark.parametrize("L", [0, 1, 5, 24])
def test_sh_basis_matches_jax_in_float64(L):
    d = _dirs(300, 0)
    d[:2] = [[0.0, 0.0, 1.0], [0.0, 0.0, -1.0]]  # the poles, where s = 0
    want = js.sh_basis(d, L)
    got = ts.sh_basis(d, L, device="cpu")
    assert got.dtype == torch.float64 and got.shape == want.shape
    assert _rel(got.numpy(), want) <= 1e-12 * np.abs(want).max()
    # A float32 tensor is taken on its device, in float64.
    got32 = ts.sh_basis(torch.as_tensor(d.astype(np.float32)), L)
    assert _rel(got32.numpy(), js.sh_basis(d.astype(np.float32), L)) <= 1e-12 * np.abs(want).max()


def test_lm_of_columns_and_flip_index_match_jax():
    L = 9
    for a, b in zip(ts._lm_of_columns(L), js._lm_of_columns(L)):
        np.testing.assert_array_equal(a, b)
    ls, ms = js._lm_of_columns(L)
    c = (ls * 100 + ms).astype(np.float32)
    np.testing.assert_array_equal(c[ts._flip_idx(L)], np.asarray(js._flip_blocks(jnp.asarray(c), L)))


def test_rotation_blocks_match_jax_in_float64():
    L = 12
    mats = np.asarray(jq.to_matrix(jnp.asarray(_quats(3, 1).astype(np.float64))))
    got, want = ts.rotation_blocks_numpy(mats, L), js.rotation_blocks_numpy(mats, L)
    assert len(got) == len(want) == L + 1
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert _rel(g, w) <= 1e-12 * max(np.abs(w).max(), 1.0)


@pytest.mark.parametrize("L, target", [(6, 512), (24, 512), (24, 64), (88, 512)])
def test_wigner_tables_equal_jax(L, target):
    got, want = ts.wigner_tables(L, target), js.wigner_tables(L, target)
    assert got.L == want.L and got.group_bounds == want.group_bounds == ts._pack_group_bounds(L, target)
    assert len(got.t_groups) == len(want.t_groups)
    for g, w in zip(got.t_groups, want.t_groups):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)
    # The device form on the wide layout against JAX's padded stacks
    # (t_stack, the one-hot |m| expansion onehot_pad, the signed flip
    # p_signed[g, flip(w), w] = sigma(w)): the port holds the same |m|, sign
    # and (l, -m) partner of each column as index tables, with a zero tail.
    _, onehot_pad, p_signed = want.host_arrays()
    dev = got.device_arrays("cpu")
    assert dev is got.device_arrays("cpu")
    _, ms = ts._lm_of_columns(L)
    ncoef = ms.size
    assert dev.K == ts._width(L) and dev.K > ncoef and dev.K % 8 == 0
    assert not dev.m_cos[ncoef:].any() and not dev.m_sin[ncoef:].any()
    np.testing.assert_array_equal(dev.flip[ncoef:].numpy(), np.arange(ncoef, dev.K))
    sigma = np.zeros(ncoef, np.float32)
    for g, (start, size) in enumerate(want.group_bounds):
        cols = slice(start, start + size)
        assert (onehot_pad[:, g, :size].sum(0) == 1).all()
        np.testing.assert_array_equal(dev.m_cos[cols].numpy(), onehot_pad[:, g, :size].argmax(0))
        p = p_signed[g, :size, :size]
        assert ((p != 0).sum(0) <= 1).all() and not p_signed[g, size:].any()
        partner = np.where(p.any(0), np.abs(p).argmax(0), np.arange(size))
        np.testing.assert_array_equal(dev.flip[cols].numpy(), start + partner)
        sigma[cols] = p[partner, np.arange(size)]
    np.testing.assert_array_equal(sigma * dev.m_cos[:ncoef].numpy(), dev.m_sin[:ncoef].numpy())
    # sigma sin(|m| t) is sin(-m t) to the bit, so the Z stage's full-width
    # angles give JAX's one-hot expansion of its (n, L+1) tables.
    t = torch.as_tensor(np.random.default_rng(1).uniform(-np.pi, np.pi, 64).astype(np.float32))
    ang = t[:, None] * torch.arange(L + 1, dtype=torch.float32)
    onehot = torch.as_tensor(np.concatenate([onehot_pad[:, g, :z] for g, (_, z) in enumerate(want.group_bounds)], 1))
    np.testing.assert_array_equal(torch.sin(t[:, None] * dev.m_sin[:ncoef]).numpy(),
                                  (torch.sin(ang) @ onehot).numpy() * sigma)
    np.testing.assert_array_equal(torch.cos(t[:, None] * dev.m_cos[:ncoef]).numpy(), (torch.cos(ang) @ onehot).numpy())
    c = ts._widen(torch.arange(1.0, ncoef + 1)[None], dev.K)
    G, W = dev.t_stack.shape[:2]
    real = np.zeros(G * W, bool)
    for g, (start, size) in enumerate(want.group_bounds):
        real[g * W : g * W + size] = True
        np.testing.assert_array_equal(dev.stack_idx[g * W : g * W + size].numpy(), np.arange(start, start + size))
    assert (dev.stack_idx[~real] < dev.K).all() and len(set(dev.stack_idx[~real].tolist())) == min(dev.K, (~real).sum())
    np.testing.assert_array_equal(dev.unstack_idx[:ncoef].numpy(), np.flatnonzero(real))
    assert not real[dev.unstack_idx[ncoef:].numpy()].any()
    # Through the stack and back; the tail reads padding slots, which T's
    # zero rows keep at 0.
    stack = (c[:, dev.stack_idx].reshape(1, G, W) * torch.as_tensor(real.reshape(1, G, W))).reshape(1, -1)
    np.testing.assert_array_equal(stack[:, dev.unstack_idx].numpy(), c.numpy())
    for g, ((start, size), blk) in enumerate(zip(want.group_bounds, want.t_groups)):
        np.testing.assert_array_equal(dev.t_stack[g, :size, :size].numpy(), blk)
        assert not dev.t_stack[g, size:].any() and not dev.t_stack[g, :, size:].any()


# ------------------------------- analysis ------------------------------- #


@pytest.mark.parametrize("L, n_theta", [(12, None), (20, 48)])
def test_sh_analysis_lambert_matches_jax(master, L, n_theta):
    want = js.sh_analysis_lambert(master, L, n_theta)
    got = ts.sh_analysis_lambert(master, L, n_theta, device="cpu")
    assert got.dtype == torch.float64 and got.shape == ((L + 1) ** 2,)
    assert _rel(got.numpy(), want) <= 1e-5 * np.linalg.norm(want)
    # A tensor master stays on its device.
    got_t = ts.sh_analysis_lambert(torch.as_tensor(master), L, n_theta)
    np.testing.assert_array_equal(got_t.numpy(), got.numpy())


# ------------------------------- rotations ------------------------------- #


@pytest.mark.parametrize("which", ["random", "gimbal"])
def test_rotations_match_jax(which):
    L = 16
    c = np.random.default_rng(2).normal(size=((L + 1) ** 2,)).astype(np.float32)
    q = _quats(12, 3) if which == "random" else _gimbal_quats()
    scale = np.linalg.norm(c)
    rec_j = np.asarray(js.rotate_coefficients(jnp.asarray(q), jnp.asarray(c), L))
    rec_t = ts.rotate_coefficients(torch.as_tensor(q), torch.as_tensor(c), L)
    assert _rel(rec_t.numpy(), rec_j) <= 1e-5 * scale
    zyz_j = np.asarray(js.rotate_coefficients_zyz(jnp.asarray(q), jnp.asarray(c), L))
    for precision in ("highest", "default"):
        zyz_t = ts.rotate_coefficients_zyz(torch.as_tensor(q), torch.as_tensor(c), L, precision)
        assert torch.isfinite(zyz_t).all()
        assert _rel(zyz_t.numpy(), zyz_j) <= 1e-5 * scale
        # The zyz form against the recursion it replaces.
        assert _rel(zyz_t.numpy(), rec_t.numpy()) <= 1e-5 * scale
    with pytest.raises(KeyError):
        ts.rotate_coefficients_zyz(torch.as_tensor(q), torch.as_tensor(c), L, "fast")


def test_preselected_variant_matches_the_general_form():
    # The refinement's pipeline: the variant fixed per point (|cos beta| <=
    # 0.65 direct, else the Rx(90) offset) gives the general form's result.
    L = 12
    c = torch.as_tensor(np.random.default_rng(4).normal(size=((L + 1) ** 2,)).astype(np.float32))
    q = torch.as_tensor(np.concatenate([_quats(10, 5), _gimbal_quats()]))
    use_id = torch.abs(tq.to_matrix(q)[..., 2, 2]) <= 0.65
    assert bool(use_id.any()) and bool((~use_id).any())
    tables = ts.wigner_tables(L).device_arrays("cpu")
    got = ts._rotate_zyz_preselected(q, use_id, c, tables, "highest")
    assert got.shape == (q.shape[0], tables.K) and not got[:, c.numel():].any()
    got = got[:, : c.numel()]
    want = ts.rotate_coefficients_zyz(q, c, L)
    assert _rel(got.numpy(), want.numpy()) <= 1e-5 * float(torch.linalg.vector_norm(c))


def test_jvp_finite_and_correct_at_gimbal():
    # The JAX test of the same name: tangents through the delta-rotation
    # chain stay finite and match central differences when the rotation sits
    # at beta = 0 (a refinement's start), and match JAX's tangents.
    L = 6
    c = np.random.default_rng(11).normal(size=((L + 1) ** 2,)).astype(np.float32)
    q0 = np.stack([[1.0, 0.0, 0.0, 0.0],
                   np.asarray(jq.from_axis_angle(jnp.asarray([0.0, 0.0, 1.0]), 0.9))]).astype(np.float32)

    def f_t(delta):
        dq = torch.cat([torch.ones(delta.shape[:-1] + (1,), dtype=delta.dtype), delta / 2.0], dim=-1)
        dq = dq / torch.linalg.vector_norm(dq, dim=-1, keepdim=True)
        return ts.rotate_coefficients_zyz(tq.multiply(torch.as_tensor(q0), dq), torch.as_tensor(c), L)

    def f_j(delta):
        dq = jnp.concatenate([jnp.ones(delta.shape[:-1] + (1,), delta.dtype), delta / 2.0], axis=-1)
        dq = dq / jnp.linalg.norm(dq, axis=-1, keepdims=True)
        return js.rotate_coefficients_zyz(jq.multiply(jnp.asarray(q0), dq), jnp.asarray(c), L)

    d0 = torch.zeros((2, 3))
    scale = np.abs(c).max()
    for j in range(3):
        tan = torch.zeros((2, 3))
        tan[:, j] = 1.0
        _, jv = torch.func.jvp(f_t, (d0,), (tan,))
        assert torch.isfinite(jv).all()
        eps = 1e-3
        fd = (f_t(d0 + eps * tan) - f_t(d0 - eps * tan)) / (2 * eps)
        np.testing.assert_allclose(jv.numpy(), fd.numpy(), atol=5e-2 * scale)
        _, jv_j = jax.jvp(f_j, (jnp.zeros((2, 3), jnp.float32),), (jnp.asarray(tan.numpy()),))
        assert _rel(jv.numpy(), np.asarray(jv_j)) <= 1e-4 * scale


# ------------------------------- projector ------------------------------- #


@pytest.fixture(scope="module")
def projectors(master):
    L = 20
    jp = JMP(data=master).spherical_projector(L=L)
    tp = interop.spherical_projector_from_state(np.asarray(jp.coeffs), L, device="cpu")
    dc = np.asarray(j_dc(JDetector(shape=(16, 16), pc=PC, sample_tilt=70)))
    return jp, tp, dc


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_project_matches_jax(projectors, precision):
    jp, tp, dc = projectors
    q = np.concatenate([_quats(7, 6), _gimbal_quats()[:2]])
    jb = jp.synthesis_basis(dc)
    tb = tp.synthesis_basis(dc)
    assert tb.dtype == torch.float32 and tb.shape == (dc.shape[0], (tp.L + 1) ** 2)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    want = np.asarray(jp.project(jnp.asarray(q), jb, mm_precision=precision))
    got = tp.project(torch.as_tensor(q), tb, mm_precision=precision).numpy()
    err = np.linalg.norm(got - want, axis=1) / np.linalg.norm(want, axis=1)
    assert err.max() <= 1e-4, err


def test_project_samples_as_the_bilinear_projector(master):
    # Rotating the coefficients by conjugate(q) and synthesizing equals
    # synthesizing at rotate_vector(q, d), the bilinear projector's sampling.
    L = 12
    tp = ts.SphericalProjector.from_master(master, L=L, device="cpu")
    d = torch.as_tensor(_dirs(64, 13))
    q = torch.as_tensor(_quats(4, 14))
    got = tp.project(q, tp.synthesis_basis(d))
    rotated = tq.rotate_vector(q[:, None, :].double(), d[None])
    for i in range(4):
        direct = ts.sh_basis(rotated[i], L) @ tp.coeffs.double()
        assert _rel(got[i].numpy(), direct.numpy()) <= 2e-3 * float(direct.abs().max())


def test_synthesis_basis_is_cached_by_content(projectors):
    _, tp, dc = projectors
    b = tp.synthesis_basis(dc)
    assert tp.synthesis_basis(dc.copy()) is b
    assert tp.synthesis_basis(torch.as_tensor(dc)) is b
    assert tp.synthesis_basis(dc[::2]) is not b


def test_spherical_projector_cache_and_its_refusal(master):
    jmp = JMP(data=master)
    tmp = interop.master_pattern_from_state(master, point_group="m-3m", device="cpu")
    p = tmp.spherical_projector(L=8)
    assert tmp.spherical_projector(L=8) is p and jmp.spherical_projector(L=8) is jmp.spherical_projector(L=8)
    assert tmp.spherical_projector(L=10) is not p and tmp.spherical_projector(energy=20.0, L=8) is not p
    assert p.L == 8 and p.coeffs.dtype == torch.float32 and p.coeffs.device.type == "cpu"
    np.testing.assert_allclose(p.coeffs.numpy(), np.asarray(jmp.spherical_projector(L=8).coeffs),
                               atol=1e-5 * float(np.linalg.norm(p.coeffs.numpy())))
    # Only a square-Lambert master has an expansion, in both packages.
    with pytest.raises(ValueError, match="square-Lambert"):
        dataclasses.replace(tmp, projection="stereographic").spherical_projector(L=8)
    with pytest.raises(ValueError, match="square-Lambert"):
        dataclasses.replace(jmp, projection="stereographic").spherical_projector(L=8)


def test_spherical_projector_from_state(projectors):
    jp, tp, _ = projectors
    assert tp.L == jp.L and tp.coeffs.dtype == torch.float32
    np.testing.assert_array_equal(tp.coeffs.numpy(), np.asarray(jp.coeffs))
    with pytest.raises(ValueError, match="coeffs must be"):
        interop.spherical_projector_from_state(np.zeros(10), 4, device="cpu")


@pytest.mark.parametrize("flag", [False, True])
def test_default_precision_leaves_the_tf32_flag_as_it_was(projectors, flag):
    # "default" is TF32 only inside the call.
    _, tp, dc = projectors
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = flag
        tp.project(torch.as_tensor(_quats(2, 7)), tp.synthesis_basis(dc), mm_precision="default")
        ts.rotate_coefficients_zyz(torch.as_tensor(_quats(2, 8)), tp.coeffs, tp.L, "default")
        assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
