"""The port's geometry and master-pattern projection against the JAX
package: quaternions, the Lambert projection, detector direction
cosines, interpolation weights and projected patterns, within 1e-5 (f32
transcendental functions differ in the last bits between frameworks)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kikuchipy_tpu.geometry import lambert as jl
from kikuchipy_tpu.geometry import quaternion as jq
from kikuchipy_tpu.geometry.detector import EBSDDetector as JDetector
from kikuchipy_tpu.projection import master_pattern as jmp
from kikuchipy_tpu_torch import interop
from kikuchipy_tpu_torch.geometry import lambert as tl
from kikuchipy_tpu_torch.geometry import quaternion as tq
from kikuchipy_tpu_torch.projection import master_pattern as tmp

ATOL = 1e-5


def _unit_quats(n, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _unit_vectors(n, seed=1):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    v = v / np.linalg.norm(v, axis=1, keepdims=True)
    # poles, equator, square edges and corners
    special = np.array(
        [[0, 0, 1], [0, 0, -1], [1, 0, 0], [0, 1, 0], [1, 1, 0], [-1, 1, 0],
         [1, 1, 1], [0, 1, 1e-3]],
        dtype=np.float32,
    )
    special /= np.linalg.norm(special, axis=1, keepdims=True)
    return np.concatenate([v, special])


def _t(x):
    return torch.from_numpy(np.array(x))


def test_quaternion_functions():
    q1, q2 = _unit_quats(64, 0), _unit_quats(64, 1)
    v = _unit_vectors(64)[:64]
    np.testing.assert_allclose(
        tq.rotate_vector(_t(q1), _t(v)).numpy(), np.asarray(jq.rotate_vector(jnp.asarray(q1), jnp.asarray(v))), atol=ATOL
    )
    np.testing.assert_allclose(
        tq.multiply(_t(q1), _t(q2)).numpy(), np.asarray(jq.multiply(jnp.asarray(q1), jnp.asarray(q2))), atol=ATOL
    )
    np.testing.assert_allclose(tq.conjugate(_t(q1)).numpy(), np.asarray(jq.conjugate(jnp.asarray(q1))), atol=0)
    eul = np.random.default_rng(3).uniform(0, [2 * np.pi, np.pi, 2 * np.pi], size=(64, 3)).astype(np.float32)
    eul[0] = [0.3, 0.0, 0.0]  # gimbal lock
    q = tq.from_euler(_t(eul))
    np.testing.assert_allclose(q.numpy(), np.asarray(jq.from_euler(jnp.asarray(eul))), atol=ATOL)
    np.testing.assert_allclose(
        tq.to_euler(q).numpy(), np.asarray(jq.to_euler(jnp.asarray(q.numpy()))), atol=1e-4
    )


def test_lambert_round_trip_and_parity():
    v = _unit_vectors(256)
    xy = tl.vector_to_lambert(_t(v))
    np.testing.assert_allclose(xy.numpy(), np.asarray(jl.vector_to_lambert(jnp.asarray(v))), atol=ATOL)
    grid = np.stack(np.meshgrid(np.linspace(-1, 1, 21), np.linspace(-1, 1, 21)), -1).reshape(-1, 2)
    grid = grid.astype(np.float32)
    back = tl.lambert_to_vector(_t(grid))
    np.testing.assert_allclose(back.numpy(), np.asarray(jl.lambert_to_vector(jnp.asarray(grid))), atol=ATOL)
    # vector -> lambert -> vector on the upper hemisphere
    up = v[v[:, 2] > 0.05]
    rt = tl.lambert_to_vector(tl.vector_to_lambert(_t(up)) / tl.SQRT_PI_HALF)
    np.testing.assert_allclose(rt.numpy(), up, atol=1e-5)


def _detectors():
    single = JDetector(shape=(12, 16), pc=(0.42, 0.28, 0.5), sample_tilt=70, tilt=5)
    multi = JDetector(
        shape=(8, 8), pc=np.array([[0.4, 0.3, 0.5], [0.5, 0.5, 0.6], [0.45, 0.2, 0.55]]),
        sample_tilt=70, px_size=2.0, binning=2,
    )
    tsl = JDetector(shape=(10, 10), pc=(0.5, 0.7, 0.6), convention="tsl")
    return [single, multi, tsl]


@pytest.mark.parametrize("idx", [0, 1, 2])
def test_direction_cosines_from_detector(idx):
    jd = _detectors()[idx]
    td = interop.detector_from_state(jd.shape, jd.pc, jd.sample_tilt, jd.tilt, jd.px_size, jd.binning)
    np.testing.assert_array_equal(td.pc, jd.pc)
    np.testing.assert_allclose(td.gnomonic_bounds, jd.gnomonic_bounds, rtol=0, atol=0)
    ref = np.asarray(jmp.direction_cosines_from_detector(jd))
    got = tmp.direction_cosines_from_detector(td, device="cpu").numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("scale", [5.0, 7.0])
def test_lambert_interpolation_weights(scale):
    # scale 5 on an 11-pixel grid is the real case; scale 7 puts points
    # outside the Lambert square, where the clamp keeps the taps exact.
    v = _unit_vectors(300)
    ref = jmp.lambert_interpolation_weights(jnp.asarray(v), 11, 11, scale)
    got = tmp.lambert_interpolation_weights(_t(v), 11, 11, scale)
    for r, g in zip(ref[:4], got[:4]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_allclose(got[4].numpy(), np.asarray(ref[4]), atol=ATOL)
    if scale == 7.0:
        assert (got[0].numpy() > 10).any()
    np.testing.assert_allclose(got[4].sum(-1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("rescale", [False, True])
@pytest.mark.parametrize("multi_pc", [False, True])
def test_project_patterns(rescale, multi_pc):
    rng = np.random.default_rng(7)
    master = rng.random((2, 21, 21)).astype(np.float32)
    rot = _unit_quats(3, 5)
    jd = _detectors()[1 if multi_pc else 0]
    dc = jmp.direction_cosines_from_detector(jd)
    ref = jmp.project_patterns(jnp.asarray(rot), dc, jnp.asarray(master), 21, 21, 10.0, rescale=rescale)
    got = tmp.project_patterns(_t(rot), _t(np.asarray(dc)), _t(master), 21, 21, 10.0, rescale=rescale)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_get_patterns_matches_jax():
    from kikuchipy_tpu.signals.master_pattern import EBSDMasterPattern as JMP

    rng = np.random.default_rng(8)
    data = rng.random((2, 31, 31)).astype(np.float32)
    jd = _detectors()[0]
    rot = _unit_quats(5, 9).astype(np.float64)
    ref = JMP(data=data).get_patterns(rot, jd, dtype_out=np.uint8)
    tmp_mp = interop.master_pattern_from_state(data, device="cpu")
    td = interop.detector_from_state(jd.shape, jd.pc, jd.sample_tilt, jd.tilt)
    got = tmp_mp.get_patterns(rot, td, dtype_out=np.uint8, chunk_size=2)
    diff = np.abs(got.data.numpy().astype(int) - np.asarray(ref.data).astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.05
    np.testing.assert_array_equal(got.xmap.rotations, ref.xmap.rotations)


@pytest.mark.parametrize("convention", ["tsl", "oxford", "emsoft4", "emsoft5", "bruker"])
def test_detector_pc_conventions(convention):
    from kikuchipy_tpu_torch.geometry.detector import EBSDDetector as TDetector

    pc = np.array([[0.45, 0.62, 0.58], [10.0, -20.0, 15000.0]])[1 if "emsoft" in convention else 0]
    kw = dict(shape=(40, 50), pc=pc, px_size=70.0, binning=2, sample_tilt=69.5, tilt=3.0, convention=convention)
    jd, td = JDetector(**kw), TDetector(**kw)
    np.testing.assert_array_equal(td.pc, jd.pc)
    for conv in ("tsl", "oxford", "emsoft4", "emsoft5"):
        np.testing.assert_array_equal(td.pc_in_convention(conv), jd.pc_in_convention(conv))
    np.testing.assert_array_equal(td.sample_to_detector, jd.sample_to_detector)
    np.testing.assert_array_equal(td.pc_average, jd.pc_average)


def test_quaternion_remainder_matches_jax():
    # from_rodrigues, from_axis_angle, to_matrix, from_matrix and
    # angle_between on the same float64 inputs (JAX runs with x64 here).
    rng = np.random.default_rng(21)
    r = rng.normal(size=(64, 3))
    r[0] = 0.0  # the identity
    np.testing.assert_allclose(tq.from_rodrigues(_t(r)).numpy(), np.asarray(jq.from_rodrigues(jnp.asarray(r))),
                               atol=1e-6)
    axis = rng.normal(size=(64, 3))
    for angle in (0.7, rng.uniform(-np.pi, np.pi, size=64)):
        np.testing.assert_allclose(
            tq.from_axis_angle(_t(axis), angle).numpy(),
            np.asarray(jq.from_axis_angle(jnp.asarray(axis), jnp.asarray(angle))), atol=1e-6,
        )
    q = _unit_quats(64, 22).astype(np.float64)
    mats = np.asarray(jq.to_matrix(jnp.asarray(q)))
    np.testing.assert_allclose(tq.to_matrix(_t(q)).numpy(), mats, atol=1e-6)
    # every branch of the extraction: trace largest and each diagonal
    # entry largest (rotations by near pi about x, y and z)
    near_pi = np.asarray(jq.from_axis_angle(jnp.asarray(np.eye(3)), 3.0))
    mats = np.concatenate([mats, np.asarray(jq.to_matrix(jnp.asarray(near_pi)))])
    got = tq.from_matrix(_t(mats)).numpy()
    np.testing.assert_allclose(got, np.asarray(jq.from_matrix(jnp.asarray(mats))), atol=1e-6)
    np.testing.assert_allclose(np.abs(got[:64]), np.abs(q), atol=1e-6)
    q2 = _unit_quats(64, 23).astype(np.float64)
    np.testing.assert_allclose(
        tq.angle_between(_t(q), _t(q2)).numpy(), np.asarray(jq.angle_between(jnp.asarray(q), jnp.asarray(q2))),
        atol=1e-6,
    )


def test_project_single_pattern_matches_jax():
    rng = np.random.default_rng(24)
    master = rng.random((2, 21, 21)).astype(np.float32)
    rot = _unit_quats(1, 25)[0]
    dc = np.asarray(jmp.direction_cosines_from_detector(_detectors()[0]))
    ref = jmp.project_single_pattern(jnp.asarray(rot), jnp.asarray(dc), jnp.asarray(master), 21, 21, 10.0,
                                     rescale=True)
    got = tmp.project_single_pattern(_t(rot), _t(dc), _t(master), 21, 21, 10.0, rescale=True)
    assert got.shape == (dc.shape[0],)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("case", ["shared", "masked", "per_element", "one"])
def test_projection_ncc_plain_matches_jax(case):
    # The projection-NCC kernel's plain twin against the JAX objective's
    # arithmetic, _project_at then _ncc_centered: a P that is no multiple
    # of the kernel's 256-thread block, a masked detector, one set of
    # direction cosines per rotation, and B = 1.
    from kikuchipy_tpu.indexing import refinement as jr
    from kikuchipy_tpu_torch.ops import lambert_project as lp

    rng = np.random.default_rng(26)
    master = rng.random((2, 21, 21)).astype(np.float32)
    jd = _detectors()[1 if case == "per_element" else 0]
    dc = np.asarray(jmp.direction_cosines_from_detector(jd), dtype=np.float32)
    if case == "masked":
        dc = dc[::3]
    B = {"one": 1, "per_element": 3}.get(case, 5)
    rot = _unit_quats(B, 27)
    exp = rng.normal(size=(B, dc.shape[-2])).astype(np.float32)
    exp -= exp.mean(axis=1, keepdims=True)
    sq = (exp.astype(np.float64) ** 2).sum(1).astype(np.float32)
    sim = jr._project_at(jnp.asarray(rot), jnp.asarray(dc), jnp.asarray(master), 21, 21, 10.0)
    ref = 1.0 - np.asarray(jr._ncc_centered(jnp.asarray(exp), jnp.asarray(sq), sim))
    quad = tmp.quad_texture(_t(master))
    before = lp.lambert_project_ncc.launches
    got = lp.lambert_project_ncc(_t(rot), _t(dc), quad, 21, 21, 10.0, _t(exp), _t(sq))
    assert lp.lambert_project_ncc.launches == before  # the CPU runs the plain twin
    assert got.shape == (B,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-6)
    np.testing.assert_array_equal(got.numpy(), lp.lambert_project_ncc_plain(_t(rot), _t(dc), quad, 21, 21, 10.0,
                                                                           _t(exp), _t(sq)).numpy())


def test_projection_wrappers_check_their_operands():
    from kikuchipy_tpu_torch.ops import lambert_project as lp

    quad = torch.zeros((2 * 5 * 5, 4))
    rot, dc = torch.zeros((2, 4)), torch.zeros((7, 3))
    with pytest.raises(ValueError, match="rotations"):
        lp.lambert_project(torch.zeros((2, 3)), dc, quad, 5, 5, 2.0)
    with pytest.raises(ValueError, match="dc"):
        lp.lambert_project(rot, torch.zeros((3, 7, 3)), quad, 5, 5, 2.0)
    with pytest.raises(ValueError, match="quad"):
        lp.lambert_project(rot, dc, quad[:-1], 5, 5, 2.0)
    with pytest.raises(ValueError, match="exp"):
        lp.lambert_project_ncc(rot, dc, quad, 5, 5, 2.0, torch.zeros((2, 6)), torch.zeros(2))
    before = lp.lambert_project.launches
    lp.lambert_project(_t(_unit_quats(2, 28)), _t(_unit_vectors(7)[:7]), quad, 5, 5, 2.0)
    assert lp.lambert_project.launches == before


@pytest.mark.parametrize("multi_pc", [False, True])
def test_get_patterns_float32_matches_jax(multi_pc):
    # float32 output, one PC or one PC per rotation; the kernel path's
    # caller is the same on the card.
    from kikuchipy_tpu.signals.master_pattern import EBSDMasterPattern as JMP

    rng = np.random.default_rng(29)
    data = rng.random((2, 31, 31)).astype(np.float32)
    jd = _detectors()[1 if multi_pc else 0]
    rot = _unit_quats(jd.navigation_size if multi_pc else 5, 30).astype(np.float64)
    ref = JMP(data=data).get_patterns(rot, jd)
    td = interop.detector_from_state(jd.shape, jd.pc, jd.sample_tilt, jd.tilt, jd.px_size, jd.binning)
    got = interop.master_pattern_from_state(data, device="cpu").get_patterns(rot, td, chunk_size=2)
    assert got.data.dtype == torch.float32 and tuple(got.data.shape) == np.asarray(ref.data).shape
    # A random master: neighbouring texels differ by up to 1, so the last
    # bit of a Lambert coordinate moves a value by up to about 2e-5.
    np.testing.assert_allclose(got.data.numpy(), np.asarray(ref.data), atol=5e-5)


def test_projector_matches_jax():
    from kikuchipy_tpu.signals.master_pattern import EBSDMasterPattern as JMP

    rng = np.random.default_rng(31)
    data = rng.random((2, 31, 31)).astype(np.float32)
    jd = _detectors()[0]
    mask = np.zeros(jd.shape, dtype=bool)
    mask[::2] = True
    rot = _unit_quats(6, 32)
    td = interop.detector_from_state(jd.shape, jd.pc, jd.sample_tilt, jd.tilt)
    tmp_mp = interop.master_pattern_from_state(data, device="cpu")
    for signal_mask in (None, mask.ravel()):
        ref = JMP(data=data).projector(jd, signal_mask=signal_mask)(rot)
        got = tmp_mp.projector(td, signal_mask=signal_mask)(rot)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


# ---- kernel A's yardstick: the plain twin on float64 operands ---- #
#
# On the card kernel A (lambert_project) is held against
# lambert_project_plain run in float64, beside the float32 twin's own
# distance from it (chip_smoke.py Float64Yardstick, tests/test_torch_gpu.py).
# These hold the yardstick itself here: the float64 twin against the JAX
# project_patterns in float64, and the float32 twin's error where the
# criterion's limits assume it.


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("chip_smoke_inputs", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.fixture(scope="module")
def smoke_projection():
    """chip_smoke.py's 401 x 401 master, its quad texture, the 60 x 60
    detector's direction cosines (PC 0.42, 0.28, 0.5) and the module."""
    from kikuchipy_tpu_torch.geometry.detector import EBSDDetector

    smoke = _chip_smoke()
    master = smoke.master_pattern_data(smoke.MASTER_SIDE)
    det = EBSDDetector(shape=smoke.DETECTOR_SHAPE, pc=smoke.PC, sample_tilt=70)
    dc = tmp.direction_cosines_from_detector(det, device="cpu")
    return smoke, master, tmp.quad_texture(_t(master)), dc


@pytest.mark.parametrize("rescale", [False, True])
@pytest.mark.parametrize("multi_pc", [False, True])
def test_plain_twin_in_float64_matches_jax(rescale, multi_pc):
    from kikuchipy_tpu_torch.ops import lambert_project as lp

    rng = np.random.default_rng(33)
    master = rng.random((2, 21, 21))
    jd = _detectors()[1 if multi_pc else 0]
    dc = np.asarray(jmp.direction_cosines_from_detector(jd, dtype=jnp.float64))
    q = rng.normal(size=(jd.navigation_size if multi_pc else 8, 4))
    rot = q / np.linalg.norm(q, axis=1, keepdims=True)
    ref = np.asarray(jmp.project_patterns(jnp.asarray(rot), jnp.asarray(dc), jnp.asarray(master), 21, 21, 10.0,
                                          rescale=rescale, out_min=0.0, out_max=255.0))
    assert ref.dtype == np.float64
    got = lp.lambert_project_plain(_t(rot), _t(dc), tmp.quad_texture(_t(master)), 21, 21, 10.0, rescale=rescale,
                                   out_min=0.0, out_max=255.0)
    assert got.dtype == torch.float64 and got.shape == ref.shape
    value_range = 255.0 if rescale else float(master.max() - master.min())
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12 * value_range)


def test_float32_twin_is_within_the_criterions_case_limit_of_float64(smoke_projection):
    # 300 random rotations of chip_smoke.py's master and detector: the
    # float32 twin's largest error against float64 is under the limit that
    # the criterion puts on kernel A in each case (A_CASE_MAX of the range).
    from kikuchipy_tpu_torch.ops import lambert_project as lp

    smoke, master, quad, dc = smoke_projection
    geo = (smoke.MASTER_SIDE, smoke.MASTER_SIDE, (smoke.MASTER_SIDE - 1) / 2)
    rot = _t(_unit_quats(300, 34))
    p32, t32 = lp.lambert_project_plain(rot, dc, quad, *geo, taps=True)
    p64, t64 = lp.lambert_project_plain(rot.double(), dc.double(), quad.double(), *geo, taps=True)
    e_t = (p32.double() - p64).abs() / float(master.max() - master.min())
    assert 0 < float(e_t.max()) <= smoke.A_CASE_MAX
    assert float(e_t.square().mean().sqrt()) < 1e-6
    assert int((t32 != t64).sum()) < smoke.A_TAP_SHARE * t64.numel()


def test_float32_twin_puts_pixels_near_a_pole_on_it(smoke_projection):
    # Within about 3.5e-4 rad of a Lambert pole the float32 twin's |wz|
    # rounds to 1 and its pole rule puts the pixel on the pole: there its
    # error against float64 passes A_CASE_MAX. So the pooled max of the
    # criterion (E_k <= E_t) is loose near the poles, and the per-case limit
    # is what holds kernel A there.
    from kikuchipy_tpu_torch.geometry import quaternion as tq
    from kikuchipy_tpu_torch.ops import lambert_project as lp

    smoke, master, quad, dc = smoke_projection
    geo = (smoke.MASTER_SIDE, smoke.MASTER_SIDE, (smoke.MASTER_SIDE - 1) / 2)
    rot = _t(smoke.pole_rotations(dc.numpy(), 64, 35))
    rotated = tq.rotate_vector(rot.double()[:, None, :], dc.double()[None])
    angle = torch.arccos((rotated[..., 2].abs() / rotated.norm(dim=-1)).clamp(max=1.0)).amin(dim=1)
    assert float(angle.max()) <= 1e-3 * (1 + 1e-6) and float(angle.min()) < 1e-6
    p32 = lp.lambert_project_plain(rot, dc, quad, *geo)
    p64 = lp.lambert_project_plain(rot.double(), dc.double(), quad.double(), *geo)
    e_t = (p32.double() - p64).abs() / float(master.max() - master.min())
    assert float(e_t.max()) > smoke.A_CASE_MAX


def test_float64_yardstick_flags_a_projection_off_its_limits(smoke_projection):
    # chip_smoke.py's check of kernel A, with stand-ins for the kernel: the
    # float64 twin itself passes; the float32 twin on the pole rotations
    # fails its case limit; a projection that moves every value by 2e-5 of
    # the range fails the pooled RMS limit.
    from kikuchipy_tpu_torch.ops import lambert_project as lp

    smoke, master, quad, dc = smoke_projection
    geo = (smoke.MASTER_SIDE, smoke.MASTER_SIDE, (smoke.MASTER_SIDE - 1) / 2)
    value_range = float(master.max() - master.min())
    cases = {"random": _t(_unit_quats(40, 36)), "pole": _t(smoke.pole_rotations(dc.numpy(), 16, 37))}
    runs = {name: (lp.lambert_project_plain(rot, dc, quad, *geo, taps=True),
                   lp.lambert_project_plain(rot.double(), dc.double(), quad.double(), *geo, taps=True))
            for name, rot in cases.items()}

    def yardstick(kernel):
        yard = smoke.Float64Yardstick()
        for name, ((p32, t32), (p64, t64)) in runs.items():
            got, tap = kernel(p32, t32, p64, t64)
            yard.add(name, got, tap, p32, t32, p64, t64, value_range)
        return yard.failures()

    assert yardstick(lambda p32, t32, p64, t64: (p64.float(), t64)) == []
    bad = yardstick(lambda p32, t32, p64, t64: (p32, t32))
    assert len(bad) == 1 and bad[0].startswith("pole: max E_k")
    bad = yardstick(lambda p32, t32, p64, t64: (p64.float() + 2e-5 * value_range, t64))
    assert any("RMS" in line for line in bad)


@pytest.mark.parametrize("multi_pc", [False, True])
def test_get_patterns_signal_mask_as_jax(multi_pc):
    # JAX reshapes the projected rows to the detector, so a mask that drops a
    # pixel raises ValueError there; an all-True mask gives the patterns of
    # no mask. compute and show_progressbar are accepted and do nothing.
    import inspect

    from kikuchipy_tpu.signals.master_pattern import EBSDMasterPattern as JMP
    from kikuchipy_tpu_torch.signals.master_pattern import EBSDMasterPattern as TMP

    assert inspect.signature(TMP.get_patterns) == inspect.signature(JMP.get_patterns)
    rng = np.random.default_rng(33)
    data = rng.random((2, 31, 31)).astype(np.float32)
    jd = _detectors()[1 if multi_pc else 0]
    rot = _unit_quats(jd.navigation_size if multi_pc else 5, 34).astype(np.float64)
    td = interop.detector_from_state(jd.shape, jd.pc, jd.sample_tilt, jd.tilt, jd.px_size, jd.binning)
    tmp_mp = interop.master_pattern_from_state(data, device="cpu")
    mask = np.ones(jd.shape, bool)
    plain = tmp_mp.get_patterns(rot, td, chunk_size=2).data
    masked = tmp_mp.get_patterns(rot, td, chunk_size=2, signal_mask=mask, compute=False, show_progressbar=True).data
    assert torch.equal(masked, plain)
    mask[0, 1] = False
    with pytest.raises(ValueError, match="cannot reshape") as want:
        JMP(data=data).get_patterns(rot, jd, chunk_size=2, signal_mask=mask)
    with pytest.raises(ValueError, match="cannot reshape") as got:
        tmp_mp.get_patterns(rot, td, chunk_size=2, signal_mask=mask)
    assert str(got.value) == str(want.value)
