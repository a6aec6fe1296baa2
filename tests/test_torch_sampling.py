"""The port's symmetry and fundamental-zone sampling (host NumPy, f64)
against the JAX package: same counts and quaternions."""

import numpy as np
import pytest

from kikuchipy_tpu.crystallography import sampling as js
from kikuchipy_tpu.crystallography import symmetry as jsym
from kikuchipy_tpu_torch.crystallography import sampling as ts
from kikuchipy_tpu_torch.crystallography import symmetry as tsym


@pytest.mark.parametrize("pg", ["m-3m", "6/mmm", "4/mmm", "-1", "m-3"])
def test_point_groups_match(pg):
    np.testing.assert_array_equal(tsym.get_point_group(pg).rotations, jsym.get_point_group(pg).rotations)


@pytest.mark.parametrize("res, pg", [(8.0, "m-3m"), (12.0, "6/mmm"), (20.0, "mmm")])
def test_sample_fundamental_zone_matches(res, pg):
    ref = np.asarray(js.sample_fundamental_zone(res, pg))
    got = ts.sample_fundamental_zone(res, pg)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_super_fibonacci_matches():
    np.testing.assert_array_equal(ts.super_fibonacci(999), js.super_fibonacci(999))


def test_reduce_and_disorientation_match():
    q = ts.super_fibonacci(500)
    red = ts.reduce_to_fundamental_zone(q, "m-3m")
    np.testing.assert_allclose(red, np.asarray(js.reduce_to_fundamental_zone(q, "m-3m")), atol=1e-12)
    assert ts.in_fundamental_zone(red, "m-3m").all()
    q2 = ts.super_fibonacci(500 * 3)[::3]
    np.testing.assert_allclose(
        ts.disorientation_angle(q, q2, "m-3m"),
        np.asarray(js.disorientation_angle(q, q2, "m-3m")),
        atol=1e-9,
    )
    # symmetric equivalents are 0 apart
    np.testing.assert_allclose(ts.disorientation_angle(q, red, "m-3m"), 0.0, atol=1e-6)
