"""The Nelder-Mead kernel's shape, as ``ops/refine_nm.py`` ``nelder_mead_plan``
chooses it from the pixel count and the mode: the tap cache of a point's
first pixels of ``CACHE_SHAPE[mode]`` (blocks an SM, and the shared memory
they may take beside their rows and patterns); the row and pattern alone
where the mode has no cache or it has no room; the two-pass branch past
``RESIDENT_SMEM_BYTES``. Plain Python: no card needed."""

import pytest

from kikuchipy_tpu_torch.ops import refine_nm as rn

MODES = ("orientation", "pc", "joint")


def _pad4(n):
    return -(-n // 4) * 4


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("P", [3600, 2520, 1000])  # the main path's 60 x 60, a signal mask keeping 70%, P = 1000
def test_plan_caches_the_first_pixels_the_blocks_leave_room_for(P, mode):
    plan = rn.nelder_mead_plan(P, mode)
    if rn.CACHE_SHAPE[mode] is None:
        assert plan == rn.NelderMeadPlan("resident", 256, 4, 8 * _pad4(P), 0)
        return
    blocks, sm_bytes = rn.CACHE_SHAPE[mode]
    room = sm_bytes // blocks - rn.BLOCK_OVERHEAD_SMEM_BYTES - 8 * _pad4(P)
    assert plan.route == "cache" and plan.threads == rn.THREADS == 256
    assert plan.cached_pixels == min(P, room // 20 // 4 * 4) >= 256
    assert plan.smem_bytes == 8 * _pad4(P) + 20 * _pad4(plan.cached_pixels)
    # Where every pixel fits, more blocks may.
    assert plan.blocks_per_sm == blocks if plan.cached_pixels < P else plan.blocks_per_sm >= blocks
    assert rn.resident(P)


def test_plan_at_the_main_path():
    # Orientation mode caches what four blocks leave within 196 KB: L1 keeps
    # the direction cosines; the PC modes cache nothing.
    assert rn.nelder_mead_plan(60 * 60) == rn.nelder_mead_plan(60 * 60, "orientation")
    assert rn.nelder_mead_plan(60 * 60) == rn.NelderMeadPlan("cache", 256, 4, 48_640, 992)
    assert rn.nelder_mead_plan(60 * 60, "pc") == rn.nelder_mead_plan(60 * 60, "joint")
    assert rn.nelder_mead_plan(60 * 60, "pc") == rn.NelderMeadPlan("resident", 256, 4, 28_800, 0)
    assert rn.nelder_mead_plan(1000).cached_pixels == 1000  # every pixel cached
    # Two blocks an SM hold every pixel of the main path's 60 x 60 in the cache.
    assert rn.cache_plan(3600, 2) == rn.NelderMeadPlan("cache", 256, 2, 100_800, 3600)
    assert rn.cache_plan(3600, None) == rn.NelderMeadPlan("resident", 256, 4, 28_800, 0)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape, route", [((96, 96), "resident"), ((120, 120), "resident"),
                                          ((128, 128), "two-pass"), ((240, 240), "two-pass")])
def test_plan_past_the_cache_and_past_the_budget(shape, route, mode):
    P = shape[0] * shape[1]
    plan = rn.nelder_mead_plan(P, mode)
    assert plan.route == route and plan.cached_pixels == 0
    assert plan.smem_bytes == (8 * _pad4(P) if route == "resident" else 0)
    assert rn.resident(P) == (route == "resident")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("P", [1, 3, 4, 5, 255, 256, 515, 1000, 2520, 3600, 3601, 4112, 6400, 9000, 14464, 14465,
                               57600])
def test_plan_shared_memory_fits_the_budget_it_states(P, mode):
    plan = rn.nelder_mead_plan(P, mode)
    assert plan.blocks_per_sm >= 1
    assert plan.blocks_per_sm * (plan.smem_bytes + rn.BLOCK_OVERHEAD_SMEM_BYTES) <= rn.SM_SMEM_BYTES
    assert plan.blocks_per_sm <= rn.REGISTER_BLOCKS
    assert 0 <= plan.cached_pixels <= P
    assert (plan.cached_pixels > 0) == (plan.route == "cache")
    assert plan.cached_pixels in (0, P) or plan.cached_pixels % 4 == 0
    if plan.route != "two-pass":
        assert 8 * _pad4(P) <= rn.RESIDENT_SMEM_BYTES
        assert plan.smem_bytes == 8 * _pad4(P) + 20 * _pad4(plan.cached_pixels)
    else:
        assert 8 * _pad4(P) > rn.RESIDENT_SMEM_BYTES and plan.smem_bytes == 0
