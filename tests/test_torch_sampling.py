"""The port's symmetry and orientation sampling against the JAX package on
the same inputs (float64; the port on the CPU through ``device="cpu"``).

Tolerances: the fundamental-zone masks, the kept rows and the spiral are
equal; reductions, quaternions and angles within 1e-12. The cubochoric
grid's arithmetic is JAX's NumPy order in PyTorch, whose float64 ``sin``,
``cos``, ``sqrt`` and ``**`` can differ from NumPy's by an ulp: the grid
is held within 1e-12, and every kept set equal (no row lies within an ulp
of the fundamental zone's 1e-12 slack on these grids).
"""

import numpy as np
import pytest
import torch

from kikuchipy_tpu.crystallography import sampling as js
from kikuchipy_tpu.crystallography import symmetry as jsym
from kikuchipy_tpu_torch.crystallography import sampling as ts
from kikuchipy_tpu_torch.crystallography import symmetry as tsym

CPU = "cpu"
POINT_GROUPS = ["m-3m", "6/mmm", "432", "mmm", "1"]


@pytest.mark.parametrize("pg", ["m-3m", "6/mmm", "4/mmm", "-1", "m-3"])
def test_point_groups_match(pg):
    np.testing.assert_array_equal(tsym.get_point_group(pg).rotations, jsym.get_point_group(pg).rotations)


@pytest.mark.parametrize("res, pg", [(8.0, "m-3m"), (12.0, "6/mmm"), (20.0, "mmm")])
def test_sample_fundamental_zone_matches(res, pg):
    ref = np.asarray(js.sample_fundamental_zone(res, pg))
    got = ts.sample_fundamental_zone(res, pg, device=CPU)
    assert isinstance(got, np.ndarray) and got.dtype == np.float64
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_super_fibonacci_matches():
    np.testing.assert_array_equal(ts.super_fibonacci(999), js.super_fibonacci(999))


@pytest.mark.parametrize("n", [ts._SPIRAL_CHUNK + 17, 3 * ts._SPIRAL_CHUNK])
def test_super_fibonacci_in_chunks_is_one_pass_bit_for_bit(n):
    # The spiral is computed in row chunks on several threads: every row
    # equals JAX's single pass.
    np.testing.assert_array_equal(ts.super_fibonacci(n), js.super_fibonacci(n))
    np.testing.assert_array_equal(ts.super_fibonacci(n, dtype=np.float32), js.super_fibonacci(n, dtype=np.float32))


def test_reduce_and_disorientation_match():
    q = ts.super_fibonacci(500)
    red = ts.reduce_to_fundamental_zone(q, "m-3m", device=CPU)
    np.testing.assert_allclose(red, np.asarray(js.reduce_to_fundamental_zone(q, "m-3m")), atol=1e-12)
    assert ts.in_fundamental_zone(red, "m-3m", device=CPU).all()
    q2 = ts.super_fibonacci(500 * 3)[::3]
    np.testing.assert_allclose(
        ts.disorientation_angle(q, q2, "m-3m", device=CPU),
        np.asarray(js.disorientation_angle(q, q2, "m-3m")),
        atol=1e-9,
    )
    # symmetric equivalents are 0 apart
    np.testing.assert_allclose(ts.disorientation_angle(q, red, "m-3m", device=CPU), 0.0, atol=1e-6)


# ------------------- the repaired functions, on a device ------------------- #


@pytest.mark.parametrize("pg", POINT_GROUPS)
@pytest.mark.parametrize("res", [10.0, 6.0])
def test_sample_fundamental_zone_keeps_jax_rows(res, pg):
    ref = np.asarray(js.sample_fundamental_zone(res, pg))
    got = ts.sample_fundamental_zone(res, pg, batch=4096, device=CPU)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("pg", POINT_GROUPS)
def test_fundamental_zone_functions_match_jax(pg):
    q = ts.super_fibonacci(3001)
    np.testing.assert_array_equal(ts.in_fundamental_zone(q, pg, device=CPU), np.asarray(js.in_fundamental_zone(q, pg)))
    red = ts.reduce_to_fundamental_zone(q, pg, device=CPU)
    np.testing.assert_allclose(red, np.asarray(js.reduce_to_fundamental_zone(q, pg)), rtol=0, atol=1e-12)
    q2 = np.roll(q, 7, axis=0)
    np.testing.assert_allclose(ts.disorientation_angle(q, q2, pg, device=CPU),
                               np.asarray(js.disorientation_angle(q, q2, pg)), rtol=0, atol=1e-12)
    # Leading axes of disorientation_angle broadcast as in JAX.
    a, b = q[:60].reshape(3, 20, 4), q2[:60].reshape(3, 20, 4)
    got = ts.disorientation_angle(a, b, pg, device=CPU)
    assert got.shape == (3, 20)
    np.testing.assert_allclose(got, np.asarray(js.disorientation_angle(a, b, pg)), rtol=0, atol=1e-12)


def test_functions_take_tensors_and_return_numpy():
    q = ts.super_fibonacci(64)
    t = torch.as_tensor(q)
    for got, want in [(ts.in_fundamental_zone(t, "m-3m", device=CPU), ts.in_fundamental_zone(q, "m-3m", device=CPU)),
                      (ts.reduce_to_fundamental_zone(t, "m-3m", device=CPU),
                       ts.reduce_to_fundamental_zone(q, "m-3m", device=CPU)),
                      (ts.disorientation_angle(t, t, "m-3m", device=CPU),
                       ts.disorientation_angle(q, q, "m-3m", device=CPU))]:
        assert isinstance(got, np.ndarray)
        np.testing.assert_array_equal(got, want)


def test_fz_mask_batches_do_not_change_the_mask():
    q = torch.as_tensor(ts.super_fibonacci(5000))
    sym = torch.as_tensor(tsym.get_point_group("m-3m").rotations)
    whole = ts._fz_mask(q, sym, batch=1 << 19)
    for batch in (1, 7, 1000, 4999):
        assert torch.equal(ts._fz_mask(q, sym, batch=batch), whole)


# ------------------------------ cubochoric ------------------------------ #


def test_cubochoric_constants_are_jax():
    for name in ("_AP", "_A_LAM", "_BETA", "_SC", "_R1", "_PREK", "_PRED"):
        assert getattr(ts, name) == getattr(js, name), name


@pytest.mark.parametrize("steps", [4, 8, 12])
def test_cubochoric_grid_matches_jax(steps):
    ref = js.cubochoric_sampling(steps)
    got = ts.cubochoric_sampling(steps, device=CPU)
    assert got.shape == ref.shape == ((2 * steps + 1) ** 3, 4)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    for pg in ("m-3m", "6/mmm"):
        keep_ref = np.asarray(js.in_fundamental_zone(ref, pg))
        keep = ts.in_fundamental_zone(got, pg, device=CPU)
        np.testing.assert_array_equal(keep, keep_ref)


def test_cu2ho_and_ho2qu_match_jax():
    rng = np.random.default_rng(5)
    cu = rng.uniform(-js._AP / 2, js._AP / 2, size=(2000, 3))
    cu[:4] = [[0, 0, 0], [0, 0, js._AP / 2], [js._AP / 2, 0, 0], [0.1, 0.1, 0.1]]
    ho = ts.cu2ho(cu, device=CPU)
    np.testing.assert_allclose(ho, js.cu2ho(cu), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ts.cu2ho(cu[5], device=CPU), js.cu2ho(cu[5]), rtol=0, atol=1e-12)
    for n_bisect in (60, 20):
        np.testing.assert_allclose(ts.ho2qu(ho, n_bisect, device=CPU), js.ho2qu(js.cu2ho(cu), n_bisect),
                                   rtol=0, atol=1e-12)
    np.testing.assert_array_equal(ts.ho2qu([0.0, 0.0, 0.0], device=CPU), [[1.0, 0.0, 0.0, 0.0]])


@pytest.mark.parametrize("pg", ["m-3m", "6/mmm"])
@pytest.mark.parametrize("res", [10.0, 6.0])
def test_get_sample_fundamental_keeps_jax_rows(res, pg):
    ref = js.get_sample_fundamental(res, pg)
    got = ts.get_sample_fundamental(res, pg, device=CPU)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)
    # Row for row: the same grid points are kept.
    grid = ts.cubochoric_sampling(resolution=res, device=CPU)
    keep = ts.in_fundamental_zone(grid, pg, device=CPU)
    np.testing.assert_array_equal(keep, np.asarray(js.in_fundamental_zone(js.cubochoric_sampling(resolution=res), pg)))


def test_get_sample_fundamental_spiral_method_and_errors():
    np.testing.assert_array_equal(ts.get_sample_fundamental(12.0, "m-3m", method="super_fibonacci", device=CPU),
                                  js.get_sample_fundamental(12.0, "m-3m", method="super_fibonacci"))
    with pytest.raises(ValueError, match="method must be"):
        js.get_sample_fundamental(10.0, method="grid")
    with pytest.raises(ValueError, match="method must be"):
        ts.get_sample_fundamental(10.0, method="grid", device=CPU)
    with pytest.raises(ValueError, match="semi_edge_steps or resolution"):
        js.cubochoric_sampling()
    with pytest.raises(ValueError, match="semi_edge_steps or resolution"):
        ts.cubochoric_sampling(device=CPU)


@pytest.mark.parametrize("res, semi_fz, semi_cubo", [(2.0, 68, 66), (6.0, 23, 22), (10.0, 14, 14), (1.0, 138, 132)])
def test_the_two_resolution_formulae_are_jax_and_differ(res, semi_fz, semi_cubo):
    # sample_fundamental_zone: ceil(131.97049 / (res - 0.03732));
    # cubochoric_sampling: ceil(131.97049 / res - 0.03732). Neither is "fixed".
    assert int(np.ceil(131.97049 / (res - 0.03732))) == semi_fz
    assert int(np.ceil(131.97049 / res - 0.03732)) == semi_cubo
    # The cubochoric grid's size follows its formula in both packages.
    if res >= 6.0:
        assert ts.cubochoric_sampling(resolution=res, device=CPU).shape[0] == (2 * semi_cubo + 1) ** 3
        assert js.cubochoric_sampling(resolution=res).shape[0] == (2 * semi_cubo + 1) ** 3
    # The spiral draws (2 N + 1)^3 points by the other one: count them
    # through a point group with one rotation, which keeps every point.
    if res >= 10.0:
        assert ts.sample_fundamental_zone(res, "1", device=CPU).shape[0] == (2 * semi_fz + 1) ** 3
