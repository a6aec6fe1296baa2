"""Kernel F's shape, as ``ops/refine_population.py`` ``population_plan``
chooses it from the pixel count, the population and the mode: how many of a
point's members a block evaluates at once (its group, whose lanes share
each tap load) and the route (the row and the group's patterns in shared
memory, or the two-pass route past ``RESIDENT_SMEM_BYTES``). The shared
memory a block takes is the source's own formula
(``csrc/refine_population.cu`` ``population_smem_bytes``) and fits a
Hopper block's 227 KB. Plain Python: no card needed."""

import pytest

from kikuchipy_tpu_torch.ops import refine_nm as rn
from kikuchipy_tpu_torch.ops import refine_population as rp
from kikuchipy_tpu_torch.ops._build import sources

MODES = ("orientation", "pc", "joint")
# The main path's 60 x 60, P = 1000 (the joint tests' detector) and 128 x
# 128, whose row and pattern pass RESIDENT_SMEM_BYTES.
PIXELS = {"main": 3600, "p1000": 1000, "over_budget": 128 * 128}
# A DA step, the PC modes' DE populations, orientation mode's, SHGO's 64
# samples and the start (a partial last group).
POPULATIONS = (1, 16, 24, 65)
HOPPER_BLOCK_SMEM = 227 * 1024


def _pad4(n):
    return -(-n // 4) * 4


# csrc/refine_population.cu population_smem_bytes, as the source states it
# (test_register_blocks_and_groups_are_the_sources holds the text).
SOURCE_SMEM = ("inline size_t population_smem_bytes(int route, int G, int P) {\n"
               "    if (route == kTwoPass) return 0;\n"
               "    return 4 * (size_t)(G + 1) * padded(P);\n"
               "}")


def _source_smem(route: str, G: int, P: int) -> int:
    """``SOURCE_SMEM`` evaluated here."""
    return 0 if route == "two-pass" else 4 * (G + 1) * _pad4(P)


def _expected_group(P: int, M: int, mode: str) -> int:
    G = min(rp.GROUP[mode], 1 << (M - 1).bit_length())
    if 8 * _pad4(P) > rn.RESIDENT_SMEM_BYTES:
        return G
    while G > 1 and 4 * (G + 1) * _pad4(P) > rp.BLOCK_SMEM_LIMIT:
        G //= 2
    return G


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", list(PIXELS))
@pytest.mark.parametrize("M", POPULATIONS)
def test_plan_group_route_and_shared_memory(mode, case, M):
    P = PIXELS[case]
    plan = rp.population_plan(P, M, mode)
    route = "two-pass" if case == "over_budget" else "resident"
    assert plan.route == route and plan.threads == 256
    assert plan.group == _expected_group(P, M, mode) and plan.group in rp.GROUPS
    # One member a block where there is one (a DA step keeps the Nelder-Mead
    # kernel's evaluation); never a group larger than the population needs.
    assert plan.group == 1 if M == 1 else 1 < plan.group <= 1 << (M - 1).bit_length()
    assert plan.smem_bytes == rp.population_smem_bytes(route, plan.group, P) == _source_smem(route, plan.group, P)
    assert plan.smem_bytes <= (rp.BLOCK_SMEM_LIMIT if route == "resident" else 0)
    assert plan.smem_bytes + 1024 <= HOPPER_BLOCK_SMEM  # 1 KB for the kernel's own arrays
    assert plan.blocks_per_sm == min(rp.REGISTER_BLOCKS[plan.group],
                                     rn.SM_SMEM_BYTES // (plan.smem_bytes + rn.BLOCK_OVERHEAD_SMEM_BYTES)) >= 1
    if M == 65:  # SHGO's candidates: the last group is partial and masked
        assert M % plan.group != 0 and -(-M // plan.group) * plan.group - M == plan.group - 1


def test_plan_at_the_main_path():
    # A DE generation at 60 x 60: orientation mode eight members a block
    # (129.6 KB, one block an SM), the PC modes four (72 KB, three blocks);
    # a DA step one member a block, as before groups (28.8 KB, four
    # blocks); SHGO's 65 candidates in 9 and 17 groups, the last of one.
    assert rp.GROUP == {"orientation": 8, "pc": 4, "joint": 4}
    assert rp.population_plan(3600, 24) == rp.population_plan(3600, 24, "orientation")
    assert rp.population_plan(3600, 24) == rp.PopulationPlan("resident", 8, 256, 1, 129_600)
    for mode in ("pc", "joint"):
        assert rp.population_plan(3600, 16, mode) == rp.PopulationPlan("resident", 4, 256, 3, 72_000)
        assert rp.population_plan(3600, 65, mode).group == 4
    for mode in ("orientation", "pc", "joint"):
        assert rp.population_plan(3600, 1, mode) == rp.PopulationPlan("resident", 1, 256, 4, 28_800)
    # Past a block's 227 KB the group halves: orientation mode at 96 x 96.
    assert rp.population_plan(96 * 96, 24) == rp.PopulationPlan("resident", 4, 256, 1, 184_320)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("case", list(PIXELS))
@pytest.mark.parametrize("group", [1, 2, 4, 8])
def test_forced_group_is_kept_where_it_fits_a_block(mode, case, group):
    P = PIXELS[case]
    plan = rp.population_plan(P, 24, mode, group=group)
    if case == "over_budget":
        assert plan == rp.PopulationPlan("two-pass", group, 256, rp.REGISTER_BLOCKS[group], 0)
        return
    fits = 4 * (group + 1) * _pad4(P) <= rp.BLOCK_SMEM_LIMIT
    assert plan.route == "resident" and (plan.group == group) == fits
    assert plan.smem_bytes == _source_smem("resident", plan.group, P) <= HOPPER_BLOCK_SMEM - 1024
    assert plan.blocks_per_sm >= 1


def test_register_blocks_and_groups_are_the_sources():
    text = sources()["refine_population"].read_text()
    b = rp.REGISTER_BLOCKS
    assert b[1] == b[2] and f"return kG <= 2 ? {b[2]} : kG == 4 ? {b[4]} : {b[8]};" in text
    assert f"constexpr int kMaxGroup = {max(rp.GROUPS)};" in text
    assert SOURCE_SMEM in text
    assert rp.BLOCK_SMEM_LIMIT == HOPPER_BLOCK_SMEM - 1024
    for case in ("case 1:", "case 2:", "case 4:", "case 8:"):
        assert case in text


@pytest.mark.parametrize("args, what", [((3600, 0, "orientation"), "positive"), ((0, 4, "pc"), "positive"),
                                        ((3600, 4, "dual"), "mode"), ((3600, 4, "joint", 3), "group")])
def test_plan_refuses_what_it_cannot_take(args, what):
    with pytest.raises(ValueError, match=what):
        rp.population_plan(*args)
