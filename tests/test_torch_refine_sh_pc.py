"""Refinement through the spherical-harmonic projector in the PC and joint
modes, the port against the JAX package on the CPU: each method from a PC
off by (0.01, -0.01, 0.01), PC mode with a signal mask and from per-point
PCs, and the PC-linearized synthesis basis.

State: ``tests/test_torch_refine_sh.py``'s (a 49 x 49 master, a 20 x 20
detector, a 3 x 3 scan, band limit 20, one expansion for both packages).

Tolerances, those of the bilinear tests: PCs within 1e-4 in PC mode and
5e-4 in joint mode, rotations within 0.05 degrees, scores within 1e-4; the
PC-linearized basis to 1e-6 of its largest value (float32 differences of
float64 bases that agree to 1e-15).
"""

import dataclasses

import numpy as np
import pytest
import torch

from kikuchipy_tpu.indexing import refinement as jr
from kikuchipy_tpu_torch.indexing import refinement as tr
from kikuchipy_tpu_torch.projection import spherical as sp
from tests.test_torch_refine_sh import (
    L,
    PC,
    SHAPE,
    angles,
    assert_same_result,
    assert_similar_iterations,
    both,
    sh_state,
)

PC_TOL, JOINT_PC_TOL = 1e-4, 5e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def state():
    return sh_state()


@pytest.mark.parametrize("method", ["lm", "nm", "gradient"])
def test_pc_matches_jax(state, method):
    # From the true orientations, as PC calibration runs.
    jres, tres = both(state, "refine_projection_center", off=True, start="xt", method=method)
    assert_same_result(jres, tres, pc_tol=PC_TOL)
    if method == "lm":  # the others' counts add the polish's iterations
        assert_similar_iterations(jres, tres, method)
    assert tres.detector.pc.shape == (3, 3, 3)
    # The polish lands on the true PC.
    assert np.abs(tres.detector.pc.reshape(-1, 3).mean(0) - PC).max() < 2e-3


@pytest.mark.parametrize("method", ["lm", "nm", "gradient"])
def test_joint_matches_jax(state, method):
    jres, tres = both(state, "refine_orientation_projection_center", off=True, method=method)
    assert_same_result(jres, tres, pc_tol=JOINT_PC_TOL)
    assert angles(state["truth"], tres.xmap.best_rotations).max() < 1.0


def test_pc_with_a_signal_mask_and_per_point_pcs(state):
    mask = np.zeros(SHAPE, bool)
    mask[:3] = True
    mask[:, -2:] = True
    jres, tres = both(state, "refine_projection_center", off=True, start="xt", method="lm", signal_mask=mask)
    assert_same_result(jres, tres, pc_tol=PC_TOL)
    # Per-point PCs: the linearization centre is their average, and each
    # point starts from its own.
    pcs = np.add(PC, np.random.default_rng(8).uniform(-0.01, 0.01, (9, 3))).reshape(3, 3, 3)
    j, t = state["j"], state["t"]
    jdet = dataclasses.replace(j["det_off"], pc=pcs)
    tdet = dataclasses.replace(t["det_off"], pc=pcs)
    kw = dict(projector="spherical", sh_L=L, method="lm", max_iters=30)
    jres = j["s"].refine_projection_center(xmap=j["xt"], detector=jdet, master_pattern=j["mp"], **kw)
    tres = t["s"].refine_projection_center(xmap=t["xt"], detector=tdet, master_pattern=t["mp"], **kw)
    assert_same_result(jres, tres, pc_tol=PC_TOL)


def test_pc_bases_match_jax_and_are_cached(state):
    j, t = state["j"], state["t"]
    mask_idx = tr._mask_bool_to_idx(np.eye(*SHAPE, dtype=bool), SHAPE[0] * SHAPE[1])
    for idx in (None, mask_idx):
        jproj, jb, jpc = jr._sh_pc_bases(j["mp"], None, j["det_off"], idx, L)
        tproj, tb, tpc = tr._sh_pc_bases(t["mp"], None, t["det_off"], idx, L)
        assert tb.dtype == torch.float32 and tuple(tb.shape) == jb.shape
        np.testing.assert_array_equal(tpc, jpc)
        assert np.abs(tb.numpy() - np.asarray(jb)).max() <= 1e-6 * np.abs(np.asarray(jb)).max()
        assert tr._sh_pc_bases(t["mp"], None, t["det_off"], idx, L)[1] is tb
    # A tilt is part of the key.
    tilted = dataclasses.replace(t["det_off"], tilt=1.0)
    assert tr._sh_pc_bases(t["mp"], None, tilted, None, L)[1] is not tr._sh_pc_bases(
        t["mp"], None, t["det_off"], None, L)[1]


def test_sh_residuals_and_objectives_match_jax(state):
    # At a point off the start, each SH residual and objective against JAX's
    # on the same coefficients, PC bases and tables; the residual is the
    # objective's unit form (0.5 ||r||^2 = 1 - NCC), and the PC solves'
    # precomputed product gives the JAX form's values.
    import jax.numpy as jnp

    from kikuchipy_tpu.projection import spherical as js

    j, t = state["j"], state["t"]
    _, jb, _ = jr._sh_pc_bases(j["mp"], None, j["det_off"], None, L)
    proj, bcat, _ = tr._sh_pc_bases(t["mp"], None, t["det_off"], None, L)
    exp, sq = tr._prepare_experimental(t["s"].data.reshape(9, *SHAPE), None)
    exp_u = tr.unit_rows(exp)
    dpix = exp.shape[1]
    q0 = torch.as_tensor(np.asarray(t["x"].best_rotations), dtype=torch.float32)
    use_id = tr._sh_variant(q0)
    x = torch.as_tensor(np.random.default_rng(4).normal(scale=[0.01] * 3 + [2e-3] * 3, size=(9, 6)),
                        dtype=torch.float32)
    tables = sp.wigner_tables(L).device_arrays("cpu")
    jt = js.wigner_tables(L)
    jj = dict(q0=jnp.asarray(q0.numpy()), use_id=jnp.asarray(use_id.numpy()), coeffs=jnp.asarray(proj.coeffs.numpy()),
              exp=jnp.asarray(exp.numpy()), sq=jnp.asarray(sq.numpy()), exp_u=jnp.asarray(exp_u.numpy()),
              x=jnp.asarray(x.numpy()))
    stacks = jt.device_arrays()
    jbasis = jb[:dpix]
    cases = [
        (tr._residual_orientation_delta_sh(x[:, :3], q0, use_id, exp_u, proj.coeffs, tables, bcat[:dpix], "highest"),
         jr._residual_orientation_delta_sh(jj["x"][:, :3], jj["q0"], jj["use_id"], jj["exp_u"], jj["coeffs"], *stacks,
                                           jbasis, L, jt.group_bounds, "highest")),
        (tr._objective_orientation_delta_sh(x[:, :3], q0, use_id, exp, sq, proj.coeffs, tables, bcat[:dpix], "highest"),
         jr._objective_orientation_delta_sh(jj["x"][:, :3], jj["q0"], jj["use_id"], jj["exp"], jj["sq"], jj["coeffs"],
                                            *stacks, jbasis, L, jt.group_bounds, "highest")),
        # The joint residual is the orientation residual at a frozen PC shift.
        (tr._residual_orientation_at_pc_sh(x[:, :3], q0, use_id, x[:, 3:], exp_u, proj.coeffs, tables, bcat, "highest",
                                           dpix),
         jr._residual_joint_delta_sh(jj["x"], jj["q0"], jj["use_id"], jj["exp_u"], jj["coeffs"], *stacks, jb, L,
                                     jt.group_bounds, "highest", dpix)),
        (tr._residual_orientation_at_pc_sh(x[:, :3], q0, use_id, x[:, 3:], exp_u, proj.coeffs, tables, bcat, "highest",
                                           dpix),
         jr._residual_orientation_at_pc_sh(jj["x"][:, :3], jj["q0"], jj["use_id"], jj["x"][:, 3:], jj["exp_u"],
                                           jj["coeffs"], *stacks, jb, L, jt.group_bounds, "highest", dpix)),
        (tr._objective_joint_delta_sh(x, q0, use_id, exp, sq, proj.coeffs, tables, bcat, "highest", dpix),
         jr._objective_joint_delta_sh(jj["x"], jj["q0"], jj["use_id"], jj["exp"], jj["sq"], jj["coeffs"], *stacks, jb,
                                      L, jt.group_bounds, "highest", dpix)),
    ]
    for got, want in cases:
        assert tuple(got.shape) == np.asarray(want).shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    # PC mode from the product sim4 = c0 @ bcat.T made once a solve, against
    # JAX's residual and objective, which make it an evaluation.
    c0 = sp.rotate_coefficients_zyz(tr.quat.conjugate(q0), proj.coeffs, L)
    sim4 = tr._synth(c0, bcat, "highest")
    r = tr._residual_pc_sim4(x[:, 3:], sim4, exp_u, dpix)
    f = tr._objective_pc_sim4(x[:, 3:], sim4, exp, sq, dpix)
    jc0 = js.rotate_coefficients_zyz(jnp.asarray(tr.quat.conjugate(q0).numpy()), jj["coeffs"], L)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr._residual_pc_delta_sh(jj["x"][:, 3:], jc0, jj["exp_u"], jb, dpix,
                                                                             "highest")), atol=2e-5)
    np.testing.assert_allclose(f.numpy(), np.asarray(jr._objective_pc_delta_sh(jj["x"][:, 3:], jc0, jj["exp"], jj["sq"], jb,
                                                                              dpix, "highest")), atol=2e-5)
    np.testing.assert_allclose(0.5 * (r**2).sum(1).numpy(), f.numpy(), atol=1e-6)
