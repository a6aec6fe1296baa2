"""The CUDA kernels against their plain versions on the card. Marked
``gpu``: without a CUDA device each test skips. On a machine with a card
(no JAX needed) run

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

The cases include the shapes that are ragged against the wgmma kernels'
128-row x 256-candidate block (n of 8, 72 and 136, m a multiple of 32
only, row bytes no multiple of 128), k of 1 to 512, groups of 1 to 512,
fewer candidates than k, and duplicate dictionary rows on both sides of a
selection slice and each kernel's chunk, with one pattern in both
consumer warpgroups.

The int8 kernel must equal its plain version bit for bit. The f32 and
bf16 kernels sum in f32 in their own order, so they must agree with their
float64-sum plain versions modulo near-ties
(:func:`kikuchipy_tpu_torch.ops.ncc_topk.near_tie_disagreements`) with
``TOL`` = 1e-5 on unit-norm rows. The bf16 kernel's products are exact in
f32 and only the order of its f32 sum differs. The f32 kernel multiplies
in TF32, three products on operands split into a high and a low part
(``split_tf32``): each product of two parts is exact in f32, the dropped
low x low term and the rounding of the low parts are below 2**-21 of each
product, and the rest is the order of the f32 sum. So the f32 cases also
hold rows that differ only below TF32's 10 mantissa bits apart.
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from kikuchipy_tpu_torch.ops import ncc_topk as nt

pytestmark = pytest.mark.gpu

TOL = 1e-5
PLANTED = (3, 5, 40)
# Dictionary rows on both sides of a 32-candidate slice and of the bf16 and
# f32 (160) and int8 (256) kernels' chunks.
STRADDLE = (31, 32, 127, 128, 159, 160, 255, 256)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _int8_operands(n, m, d, seed, device):
    rng = np.random.default_rng(seed)
    e = torch.from_numpy(rng.integers(-127, 128, (n, d), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (m, d), dtype=np.int8))
    sc = torch.from_numpy((rng.random(m) * 0.01 + 1e-3).astype(np.float32))
    for j in (5, 40, m - 1) + STRADDLE:  # planted ties
        if j < m:
            w[j], sc[j] = w[3], sc[3]
    if n > 64:
        e[64] = e[63].clone()  # one pattern in both consumer warpgroups
    return e.to(device), w.to(device), sc.to(device)


def _unit_operands(n, m, d, seed, device):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(m, d)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    w[list(PLANTED[1:])] = w[PLANTED[0]]
    if m >= 512:
        w[64:128:8] = e[:8]  # clear best matches for the first rows
    return torch.from_numpy(e).to(device), torch.from_numpy(w).to(device)


@pytest.mark.parametrize(
    "n, m, d, k, tile_n, tile_m, group, extraction",
    [
        (64, 256, 128, 5, 8, 32, 1, "stream"),
        (64, 256, 128, 5, 8, 32, 8, "stream"),
        (100, 640, 3600, 40, 4, 128, 1, "stream"),
        (72, 96, 48, 70, 8, 32, 4, "stream"),
        (300, 2048, 3600, 128, 4, 512, 1, "stream"),
        # the repairs: k above 128, groups that straddle chunks, short lists
        (64, 1024, 200, 130, 8, 512, 4, "stream"),
        (64, 1024, 200, 512, 8, 512, 1, "stream"),
        (64, 192, 100, 70, 8, 96, 3, "stream"),
        (64, 1024, 100, 5, 8, 512, 256, "stream"),
        (64, 1024, 100, 3, 8, 512, 512, "stream"),
        (128, 256, 64, 20, 128, 128, 16, "stream"),
        # the other extractions
        (64, 256, 128, 7, 8, 64, 8, "fori"),
        (64, 256, 128, 7, 8, 64, 1, "none"),
        # ragged against the 128 x 256 block
        (8, 288, 200, 1, 8, 32, 1, "stream"),
        (72, 288, 200, 40, 8, 32, 1, "stream"),
        (136, 544, 100, 130, 8, 32, 1, "stream"),
        (136, 544, 72, 512, 8, 32, 1, "stream"),
        (72, 96, 72, 130, 8, 32, 1, "stream"),
        (72, 288, 100, 40, 8, 96, 3, "stream"),
        (136, 544, 100, 40, 8, 32, 16, "stream"),
        (8, 1024, 72, 5, 8, 512, 256, "stream"),
        (136, 1024, 72, 3, 8, 512, 512, "stream"),
        (136, 544, 72, 40, 8, 32, 1, "none"),
        # more row tiles than SMs: persistent blocks take a second tile
        (17280, 512, 64, 9, 8, 512, 1, "stream"),
    ],
)
def test_int8_kernel_matches_plain_bit_for_bit(cuda, n, m, d, k, tile_n, tile_m, group, extraction):
    e, w, sc = _int8_operands(n, m, d, n + m + group, cuda)
    before = nt.ncc_match_topk_int8.launches
    s1, i1 = nt.ncc_match_topk_int8(e, w, sc, k, tile_n, tile_m, group, extraction)
    torch.cuda.synchronize()
    assert nt.ncc_match_topk_int8.launches == before + 1
    s2, i2 = nt.ncc_match_topk_int8_plain(e, w, sc, k, tile_m, group, extraction)
    assert torch.equal(s1, s2) and torch.equal(i1, i2)
    if n > 64:
        assert torch.equal(s1[63], s1[64]) and torch.equal(i1[63], i1[64])


def test_int8_short_candidate_lists_end_in_float32_min(cuda):
    e, w, sc = _int8_operands(128, 256, 64, 3, cuda)
    s, i = nt.ncc_match_topk_int8(e, w, sc, 20, 128, 128, 16)
    assert (s[:, 16:] == nt.EMPTY_SCORE).all() and (i[:, 16:] == 0).all()


FLOAT_KERNELS = [
    (nt.ncc_match_topk_f32, {}, torch.float32),
    (nt.ncc_match_topk_f32_blocked, {"tile_d": 128}, torch.float32),
    (nt.ncc_match_topk_bf16, {"extraction": "fori"}, torch.bfloat16),
    (nt.ncc_match_topk_bf16, {"extraction": "stream"}, torch.bfloat16),
]


@pytest.mark.parametrize("wrapper, kw, rounding", FLOAT_KERNELS)
@pytest.mark.parametrize(
    "n, m, d, k",
    [(64, 512, 100, 5), (200, 2048, 3600, 40), (64, 1024, 301, 130),
     # ragged against the wgmma block; k of 1 and 512; lists in shared memory (k <= 76) and in the output rows
     (8, 1024, 100, 1), (72, 1536, 301, 40), (136, 1536, 72, 77), (136, 1024, 200, 512)],
)
def test_float_kernels_match_plain_modulo_near_ties(cuda, wrapper, kw, rounding, n, m, d, k):
    e, w = _unit_operands(n, m, d, n + d, cuda)
    before = wrapper.launches
    s, i = wrapper(e, w, k, 4, 512, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    if rounding == torch.bfloat16:
        ref_s, ref_i = nt.ncc_match_topk_bf16_plain(e, w, k + 1, 512)
    else:
        ref_s, ref_i = nt.ncc_match_topk_f32_plain(e, w, k + 1)
    assert nt.near_tie_disagreements(s, i, ref_s, ref_i, e, w, TOL, PLANTED, rounding) == []
    assert (i[:8, 0] == torch.arange(64, 128, 8, device=cuda)).all()


@pytest.mark.parametrize("wrapper, kw, rounding", FLOAT_KERNELS)
def test_float_kernels_ragged_chunks_and_straddling_ties(cuda, wrapper, kw, rounding):
    # m a multiple of tile_m = 32 only, duplicates across every boundary,
    # one pattern in both consumer warpgroups.
    n, m, d, k = 136, 544, 72, 40
    e, w = _unit_operands(n, m, d, 7, cuda)
    planted = PLANTED + STRADDLE
    w[list(planted[1:])] = w[planted[0]].clone()
    e[64] = e[63].clone()
    s, i = wrapper(e, w, k, 8, 32, **kw)
    torch.cuda.synchronize()
    if rounding == torch.bfloat16:
        ref_s, ref_i = nt.ncc_match_topk_bf16_plain(e, w, k + 1, 32)
    else:
        ref_s, ref_i = nt.ncc_match_topk_f32_plain(e, w, k + 1)
    assert nt.near_tie_disagreements(s, i, ref_s, ref_i, e, w, TOL, planted, rounding) == []
    assert torch.equal(s[63], s[64]) and torch.equal(i[63], i[64])


@pytest.mark.parametrize("wrapper, kw, rounding", FLOAT_KERNELS)
def test_float_kernels_short_candidate_lists_end_in_float32_min(cuda, wrapper, kw, rounding):
    e, w = _unit_operands(72, 96, 72, 5, cuda)
    s, i = wrapper(e, w, 130, 8, 32, **kw)
    ref_s, _ = (nt.ncc_match_topk_bf16_plain(e, w, 96, 32) if rounding == torch.bfloat16
                else nt.ncc_match_topk_f32_plain(e, w, 96))
    assert (s[:, :96] - ref_s).abs().max().item() <= TOL
    assert (s[:, 96:] == nt.EMPTY_SCORE).all() and (i[:, 96:] == 0).all()


F32_KERNELS = [(nt.ncc_match_topk_f32, {}), (nt.ncc_match_topk_f32_blocked, {"tile_d": 128})]


@pytest.mark.parametrize("wrapper, kw", F32_KERNELS)
def test_f32_kernels_tell_rows_apart_that_differ_below_tf32(cuda, wrapper, kw):
    # A positive pattern v and its copy cut to TF32 differ only in the low
    # plane of the split, by about 2**-11 of the score: as patterns, and as
    # dictionary rows on either side of a chunk boundary. Equal rows still
    # tie exactly, in column order.
    e, w = _unit_operands(72, 544, 200, 9, cuda)
    v = e[0].abs() / e[0].norm()
    cut = (v.view(torch.int32) & -0x2000).view(torch.float32)
    e[0], e[1] = v, cut
    w[[10, 159]], w[[11, 160]] = v, cut
    s, i = wrapper(e, w, 4, 8, 32, **kw)
    ref_s, ref_i = nt.ncc_match_topk_f32_plain(e, w, 5)
    assert nt.near_tie_disagreements(s, i, ref_s, ref_i, e, w, TOL, PLANTED) == []
    for r in (0, 1):
        assert i[r].tolist() == [10, 159, 11, 160]
        assert s[r, 0] == s[r, 1] > s[r, 2] == s[r, 3] and s[r, 1] - s[r, 2] > 1e-4


@pytest.mark.parametrize("wrapper, kw", F32_KERNELS)
def test_f32_kernels_take_more_row_tiles_than_sms(cuda, wrapper, kw):
    # 135 row tiles: persistent clusters take a second pair.
    e, w = _unit_operands(17280, 512, 64, 11, cuda)
    s, i = wrapper(e, w, 9, 8, 512, **kw)
    ref_s, ref_i = nt.ncc_match_topk_f32_plain(e, w, 10)
    assert nt.near_tie_disagreements(s, i, ref_s, ref_i, e, w, TOL, PLANTED) == []


@pytest.mark.parametrize("n, d", [(300, 301), (5, 3600), (3, 1), (2, 32), (70000, 33)])
def test_f32_split_pass_on_the_card_is_the_cpu_split_bit_for_bit(cuda, n, d):
    x = torch.from_numpy(np.random.default_rng(n + d).normal(size=(n, d)).astype(np.float32))
    big = float(np.finfo(np.float32).max)
    special = torch.tensor([0.0, -0.0, 1e-45, -1e-42, 1e-39, big, -big, big * (1 - 2.0**-12)])
    x[0, : min(d, 8)] = special[: min(d, 8)]
    for got, ref in zip(nt.split_tf32(x.to(cuda)), nt.split_tf32(x)):
        assert torch.equal(got.cpu().view(torch.int32), ref.view(torch.int32))
    before = nt.tf32_rows.launches
    got = nt.tf32_rows(x.to(cuda))
    assert nt.tf32_rows.launches == before + 1
    assert torch.equal(got.cpu().view(torch.int32), nt.tf32_rows(x).view(torch.int32))
    assert torch.equal(got.view(torch.int32), nt.tf32_rows_plain(x.to(cuda)).view(torch.int32))
    assert torch.isfinite(got).all()
    assert torch.equal(nt.tf32_rows(x.to(cuda), 128).cpu().view(torch.int32), nt.tf32_rows(x, 128).view(torch.int32))
    with pytest.raises(TypeError):
        nt.tf32_rows(x.to(cuda).double())


def test_bf16_none_keeps_the_last_tile_max(cuda):
    e, w = _unit_operands(64, 1024, 300, 1, cuda)
    s, i = nt.ncc_match_topk_bf16(e, w, 5, 8, 512, "none")
    ref, _ = nt.ncc_match_topk_bf16_plain(e, w, 5, 512, "none")
    assert (s[:, 0] - ref[:, 0]).abs().max().item() <= TOL
    assert torch.equal(s[:, 1:], ref[:, 1:]) and (i == 0).all()


def test_kernels_reject_what_they_cannot_take(cuda):
    e = torch.zeros((8, 32), dtype=torch.int8, device=cuda)
    w = torch.zeros((32, 32), dtype=torch.int8, device=cuda)
    sc = torch.ones(32, device=cuda)
    with pytest.raises(TypeError):
        nt.ncc_match_topk_int8(e.float(), w, sc, 4, 8, 32)
    with pytest.raises(ValueError, match="1..512"):
        nt.ncc_match_topk_int8(e, w, sc, 513, 8, 32)
    with pytest.raises(TypeError):
        nt.ncc_match_topk_f32(e.double(), w.double(), 4, 8, 32)
    with pytest.raises(ValueError, match="one device"):
        nt.ncc_match_topk_bf16(e.float(), w.float().cpu(), 4, 8, 32)


INT8_REFUSED = [
    # n, m, d, k, tile_m, group, mode, misalign
    (8, 32, 24, 4, 32, 1, 0, 0),    # row bytes no multiple of 16
    (8, 32, 32, 0, 32, 1, 0, 0),    # k below 1
    (8, 32, 32, 513, 32, 1, 0, 0),  # k above MAX_K
    (8, 32, 32, 4, 32, 5, 0, 0),    # group does not divide tile_m
    (8, 48, 32, 4, 32, 1, 0, 0),    # m no multiple of tile_m
    (8, 32, 32, 4, 32, 1, 2, 0),    # unknown mode
    (0, 32, 32, 4, 32, 1, 0, 0),    # no rows
    (8, 32, 32, 4, 32, 1, 0, 8),    # operand not 16-byte aligned
]


@pytest.mark.parametrize("n, m, d, k, tile_m, group, mode, misalign", INT8_REFUSED)
def test_int8_launcher_refuses_what_it_does_not_take(cuda, n, m, d, k, tile_m, group, mode, misalign):
    e = torch.zeros(8 * 32 + 16, dtype=torch.int8, device=cuda)[misalign:]
    w = torch.zeros(48 * 32, dtype=torch.int8, device=cuda)
    sc = torch.ones(48, device=cuda)
    out_s, out_i = nt._outputs(8, 512, cuda)
    before = nt.ncc_match_topk_int8.launches
    with pytest.raises(RuntimeError, match="cudaError_t"):
        nt._launch("ncc_topk_int8", [e, w, sc, out_s, out_i], [n, m, d, k, tile_m, group, mode], cuda)
    assert nt.ncc_match_topk_int8.launches == before
    torch.cuda.synchronize()  # nothing was launched, nothing faults


@pytest.mark.parametrize(
    "n, m, d, k, tile_m, mode, misalign",
    [(8, 32, 12, 4, 32, 0, 0), (8, 32, 16, 0, 32, 0, 0), (8, 32, 16, 513, 32, 0, 0), (8, 48, 16, 4, 32, 0, 0),
     (8, 32, 16, 4, 32, 3, 0), (8, 32, 0, 4, 32, 0, 0), (8, 32, 16, 4, 32, 0, 1)],
)
def test_bf16_launcher_refuses_what_it_does_not_take(cuda, n, m, d, k, tile_m, mode, misalign):
    e = torch.zeros(8 * 16 + 8, dtype=torch.bfloat16, device=cuda)[misalign:]
    w = torch.zeros(48 * 16, dtype=torch.bfloat16, device=cuda)
    out_s, out_i = nt._outputs(8, 512, cuda)
    with pytest.raises(RuntimeError, match="cudaError_t"):
        nt._launch("ncc_topk_bf16", [e, w, out_s, out_i], [n, m, d, k, tile_m, mode], cuda)
    torch.cuda.synchronize()


@pytest.mark.parametrize(
    "n, m, d, k, tile_m, mode, misalign",
    # d here is values per plane: a multiple of 32
    [(8, 32, 16, 4, 32, 0, 0), (8, 32, 32, 0, 32, 0, 0), (8, 32, 32, 513, 32, 0, 0), (8, 48, 32, 4, 32, 0, 0),
     (8, 32, 32, 4, 32, 3, 0), (8, 32, 0, 4, 32, 0, 0), (8, 32, 32, 4, 32, 0, 1), (0, 32, 32, 4, 32, 0, 0)],
)
def test_f32_launcher_refuses_what_it_does_not_take(cuda, n, m, d, k, tile_m, mode, misalign):
    e = torch.zeros(8 * 64 + 4, dtype=torch.float32, device=cuda)[misalign:]
    w = torch.zeros(48 * 64, dtype=torch.float32, device=cuda)
    out_s, out_i = nt._outputs(8, 512, cuda)
    before = nt.ncc_match_topk_f32.launches
    with pytest.raises(RuntimeError, match="cudaError_t"):
        nt._launch("ncc_topk_f32", [e, w, out_s, out_i], [n, m, d, k, tile_m, mode], cuda)
    assert nt.ncc_match_topk_f32.launches == before
    torch.cuda.synchronize()


def test_f32_product_alone_keeps_the_last_tile_max(cuda):
    # Mode 1 of the launcher, which no entry point uses: the timing scripts
    # run the product without the selection through it.
    e, w = _unit_operands(136, 544, 72, 2, cuda)
    planes_e, planes_w = nt.tf32_rows(e), nt.tf32_rows(w)
    out_s, out_i = nt._outputs(136, 3, cuda)
    nt._launch("ncc_topk_f32", [planes_e, planes_w, out_s, out_i], [136, 544, planes_e.shape[1] // 2, 3, 32, 1], cuda)
    ref = (e.double() @ w[-32:].double().T).amax(dim=1).float()
    assert (out_s[:, 0] - ref).abs().max().item() <= TOL
    assert (out_s[:, 1:] == nt.EMPTY_SCORE).all() and (out_i == 0).all()


@pytest.mark.parametrize("kernel", ["ncc_topk_int8", "ncc_topk_bf16", "ncc_topk_f32"])
def test_shared_memory_of_a_block_is_what_python_computes(cuda, kernel):
    from kikuchipy_tpu_torch.ops._build import library

    assert getattr(library(kernel), f"{kernel}_smem_bytes")() == nt.wgmma_smem_bytes(kernel, 40) <= nt.MAX_BLOCK_SMEM


# --------------------- the projection kernels (csrc/lambert_project.cu) --------------------- #
#
# Kernel A (lambert_project) against the plain twin run on float64 operands,
# beside the float32 twin's distance from it (chip_smoke.py
# Float64Yardstick): in each case the largest error within 1e-4 of the
# range (the master's, 255 when rescaled), and over the pixels of all cases
# together no larger than the float32 twin's, an RMS within 1.5 x its, and
# no more pixels on another tap than 1.5 x its (and under 1e-4 of them).
# Kernel B (lambert_project_ncc) computes the same pixel as kernel A
# (lambert_common.cuh lambert_pixel) and is held as kernel A is: its 1 - NCC
# no further from the plain twin run in float64 than the float32 twin's, in
# each case of 2,048 patterns and over the five cases together (max, and RMS
# within 1.5 x), and in each case within 2e-6 of the float32 twin
# (chip_smoke.py ncc_yardstick, ncc_pooled_failures).

NCC_CASES = ["shared", "masked", "per_point", "ragged", "one"]


def _smoke():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location("chip_smoke_inputs", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _projection_state(device, side=101, shape=(60, 60), pc=(0.42, 0.28, 0.5)):
    from kikuchipy_tpu_torch.geometry.detector import EBSDDetector
    from kikuchipy_tpu_torch.projection.master_pattern import direction_cosines_from_detector, quad_texture

    master = _smoke().master_pattern_data(side)
    det = EBSDDetector(shape=shape, pc=pc, sample_tilt=70)
    quad = quad_texture(torch.as_tensor(master, device=device))
    dc = direction_cosines_from_detector(det, device=device)
    om = torch.as_tensor(np.ascontiguousarray(det.sample_to_detector.T), dtype=torch.float32, device=device)
    return master, quad, dc, om, det


def _quats(n, seed, device):
    q = np.random.default_rng(seed).normal(size=(n, 4)).astype(np.float32)
    return torch.from_numpy(q / np.linalg.norm(q, axis=1, keepdims=True)).to(device)


def _per_point_dc(n, om, seed, device):
    from kikuchipy_tpu_torch.indexing.refinement import _dc_for_pc

    pcs = np.array([0.42, 0.28, 0.5]) + (np.random.default_rng(seed).random((n, 3)) - 0.5) * 0.04
    return _dc_for_pc(torch.as_tensor(pcs, dtype=torch.float32, device=device), 60, 60, om, None).contiguous()


A_CASES = ["shared", "rescale", "per_point", "ragged", "one", "pole"]


def _kernel_a_case(device, case, yard):
    """Kernel A on one case, added to ``yard`` beside both twins; checks
    the launch count and that a second launch gives the same values."""
    from kikuchipy_tpu_torch.ops import lambert_project as lp

    master, quad, dc, om, _ = _projection_state(device)
    B = {"one": 1, "pole": 64}.get(case, 3000)
    rot = _quats(B, 40, device)
    kw = dict(rescale=True, out_min=0.0, out_max=255.0) if case == "rescale" else {}
    if case == "per_point":
        dc = _per_point_dc(B, om, 41, device)
    elif case == "ragged":
        dc = dc[::7].contiguous()  # P = 515: no multiple of the warp or of an item's 512 pixels
    elif case == "pole":
        # each rotation turns one pixel to within 1e-3 rad of a Lambert pole
        rot = torch.as_tensor(_smoke().pole_rotations(dc.cpu().numpy(), B, 47), device=device)
    before = lp.lambert_project.launches
    got, tap = lp.lambert_project(rot, dc, quad, 101, 101, 50.0, taps=True, **kw)
    torch.cuda.synchronize()
    assert lp.lambert_project.launches == before + 1
    assert torch.equal(lp.lambert_project(rot, dc, quad, 101, 101, 50.0, **kw), got)
    p32, t32 = lp.lambert_project_plain(rot, dc, quad, 101, 101, 50.0, taps=True, **kw)
    p64, t64 = lp.lambert_project_plain(rot.double(), dc.double(), quad.double(), 101, 101, 50.0, taps=True, **kw)
    yard.add(case, got, tap, p32, t32, p64, t64, 255.0 if case == "rescale" else float(master.max() - master.min()))


@pytest.mark.parametrize("case", A_CASES)
def test_lambert_project_matches_plain(cuda, case):
    smoke = _smoke()
    yard = smoke.Float64Yardstick()
    _kernel_a_case(cuda, case, yard)
    c = yard.cases[case]
    print(f"{case}: {yard.summary(c)}")
    assert c["finite"]
    assert c["max_k"] <= smoke.A_CASE_MAX


def test_lambert_project_is_no_further_from_float64_than_the_float32_twin(cuda):
    smoke = _smoke()
    yard = smoke.Float64Yardstick()
    for case in A_CASES:
        _kernel_a_case(cuda, case, yard)
    print(f"pooled: {yard.summary(yard.pooled())}")
    assert yard.failures() == []


def _kernel_b_case(device, case):
    """Kernel B's yardstick on one case (chip_smoke.py ncc_yardstick); checks
    the launch count."""
    from kikuchipy_tpu_torch.indexing.refinement import _prepare_experimental
    from kikuchipy_tpu_torch.ops import lambert_project as lp

    _, quad, dc, om, _ = _projection_state(device)
    B = {"one": 1}.get(case, 2048)
    rot = _quats(B, 42, device)
    # Experimental rows: patterns projected near the rotations, plus noise.
    sim = lp.lambert_project(_quats(B, 42, device) + 0.01 * _quats(B, 43, device), dc, quad, 101, 101, 50.0)
    rows = sim + 0.05 * torch.randn(sim.shape, generator=torch.Generator(device=device).manual_seed(44), device=device)
    idx = None
    if case == "masked":
        idx = torch.nonzero(torch.rand(dc.shape[0], generator=torch.Generator().manual_seed(45)) > 0.3)[:, 0].to(device)
        dc = dc[idx].contiguous()
    elif case == "ragged":
        idx = torch.arange(0, dc.shape[0], 7, device=device)
        dc = dc[idx].contiguous()
    elif case == "per_point":
        dc = _per_point_dc(B, om, 46, device)
    exp, sq = _prepare_experimental(rows, idx)
    before = lp.lambert_project_ncc.launches
    got = lp.lambert_project_ncc(rot, dc, quad, 101, 101, 50.0, exp, sq)
    torch.cuda.synchronize()
    assert lp.lambert_project_ncc.launches == before + 1
    ref = lp.lambert_project_ncc_plain(rot, dc, quad, 101, 101, 50.0, exp, sq)
    ref64 = lp.lambert_project_ncc_plain(rot.double(), dc.double(), quad.double(), 101, 101, 50.0, exp.double(),
                                         sq.double())
    assert got.shape == (B,) and torch.isfinite(got).all()
    return _smoke().ncc_yardstick(got, ref, ref64)


@pytest.mark.parametrize("case", NCC_CASES)
def test_lambert_project_ncc_matches_plain(cuda, case):
    smoke = _smoke()
    y = _kernel_b_case(cuda, case)
    print(f"{case}: {smoke.ncc_yardstick_text(y)}")
    assert smoke.ncc_yardstick_failures(case, y) == []


def test_lambert_project_ncc_is_no_further_from_float64_than_the_float32_twin(cuda):
    smoke = _smoke()
    yards = {case: _kernel_b_case(cuda, case) for case in NCC_CASES}
    print(f"pooled: {smoke.ncc_yardstick_text(smoke.ncc_pooled(yards))}")
    assert smoke.ncc_pooled_failures(yards) == []


def test_refinement_on_the_card_goes_through_the_ncc_kernel(cuda):
    # A 64-point scan projected by kernel A at known orientations, refined
    # from 1 degree off on the card and on the CPU: the card's run is one
    # launch of the Nelder-Mead kernel (kernel A and kernel B never), and
    # both land on the truth.
    from kikuchipy_tpu_torch import EBSD, EBSDMasterPattern
    from kikuchipy_tpu_torch.crystallography.crystal_map import CrystalMap
    from kikuchipy_tpu_torch.crystallography.sampling import disorientation_angle, super_fibonacci
    from kikuchipy_tpu_torch.geometry import quaternion as tq
    from kikuchipy_tpu_torch.ops import lambert_project as lp
    from kikuchipy_tpu_torch.ops import refine_nm as rn

    master, _, _, _, det = _projection_state(cuda)
    truth = super_fibonacci(64 * 7)[::7][:64]
    axes = torch.as_tensor(np.random.default_rng(47).normal(size=(64, 3)))
    start = tq.multiply(tq.from_axis_angle(axes, np.deg2rad(1.0)), torch.as_tensor(truth)).numpy()
    results = {}
    for dev in ("cpu", cuda):
        on_card = str(dev) != "cpu"
        mp = EBSDMasterPattern(master, device=dev)
        before = lp.lambert_project.launches
        sim = mp.get_patterns(truth, det).data
        assert lp.lambert_project.launches == before + on_card
        signal = EBSD(sim, detector=det, device=dev)
        counts = (lp.lambert_project.launches, lp.lambert_project_ncc.launches, rn.nelder_mead_orientation.launches)
        res = signal.refine_orientation(xmap=CrystalMap(rotations=start), master_pattern=mp, max_iters=80)
        assert lp.lambert_project.launches == counts[0]
        assert lp.lambert_project_ncc.launches == counts[1]
        assert rn.nelder_mead_orientation.launches == counts[2] + on_card
        results[str(dev)] = res.xmap
    ang = np.degrees(disorientation_angle(results["cpu"].best_rotations, results["cuda"].best_rotations, "m-3m"))
    assert ang.max() < 0.05
    assert np.degrees(disorientation_angle(truth, results["cuda"].best_rotations, "m-3m")).max() < 0.2
    np.testing.assert_allclose(results["cuda"].prop["scores"], results["cpu"].prop["scores"], atol=1e-4)


# The Nelder-Mead kernel (csrc/refine_nm.cu) against the host loop on kernel
# B on the same card and inputs: it rounds every step as the loop does, so
# the two must take the same path: the same iterations and points and values
# bit for bit (n_evals differs: the kernel skips the loop's dropped second
# candidate of an accepted reflection).


# Detectors of the Nelder-Mead cases off the main path's 60 x 60, and the
# route nelder_mead_plan takes for each: P = 16,384 and 57,600 past
# RESIDENT_SMEM_BYTES (the two-pass branch), P = 9,216 leaving the tap cache
# no room (the row and pattern alone). At 60 x 60 the cache holds the first
# pixels only; at P = 1000 all of them.
NM_SHAPES = {"over_budget": (128, 128), "wide": (240, 240), "resident": (96, 96)}
NM_ROUTES = {"over_budget": "two-pass", "wide": "two-pass", "resident": "resident", "full_cache": "cache",
             "cache": "cache"}
# Shapes the plan does not take at 60 x 60, forced for a case: every pixel
# cached (two blocks an SM), and the PC modes' cache (which CACHE_SHAPE
# leaves off).
NM_FORCED = {"full_cache": (2, 228 * 1024), "cache": (4, 196 * 1024)}


def _nm_route(monkeypatch, case: str, mode: str, P: int) -> str:
    """The route the kernel takes for ``case``: a forced shape put in the
    plan's place, else the plan's own."""
    from kikuchipy_tpu_torch.ops import refine_nm as rn

    if case in NM_FORCED:
        shape = rn.cache_plan(P, *NM_FORCED[case])
        monkeypatch.setattr(rn, "nelder_mead_plan", lambda P, mode="orientation": shape)
    return rn.nelder_mead_plan(P, mode).route
# Initial simplex edges that keep nearly every pixel on its tap (tiny) or
# move nearly every one (large): the tap cache hit and missed.
NM_STEPS = {"tiny_step": (np.deg2rad(0.02), 0.0005), "large_step": (np.deg2rad(8.0), 0.05)}


def _straddle_rotations(dc, n: int, seed: int) -> torch.Tensor:
    """Unit quaternions ``(n, 4)`` that turn the detector's mean direction
    onto the equator (rotated z = 0) at random azimuths: each pattern's
    pixels straddle the two hemispheres."""
    rng = np.random.default_rng(seed)
    v = dc.double().mean(0).cpu().numpy()
    v /= np.linalg.norm(v)
    phi = rng.uniform(0.0, 2 * np.pi, n)
    target = np.stack([np.cos(phi), np.sin(phi), np.zeros(n)], axis=1)
    axis = np.cross(v, target)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    half = 0.5 * np.arccos(np.clip(target @ v, -1.0, 1.0))
    q = np.concatenate([np.cos(half)[:, None], np.sin(half)[:, None] * axis], axis=1)
    return torch.as_tensor(q, dtype=torch.float32, device=dc.device)


def _nm_inputs(device, case: str, n: int = 64):
    from kikuchipy_tpu_torch.crystallography.sampling import super_fibonacci
    from kikuchipy_tpu_torch.geometry import quaternion as tq
    from kikuchipy_tpu_torch.geometry.detector import EBSDDetector
    from kikuchipy_tpu_torch.indexing.refinement import _prepare_experimental
    from kikuchipy_tpu_torch.ops import lambert_project as lp
    from kikuchipy_tpu_torch.projection.master_pattern import direction_cosines_from_detector

    n = {"one": 1, "over_budget": 8, "wide": 4}.get(case, n)
    shape = NM_SHAPES.get(case, (60, 60))
    _, quad, _, om, _ = _projection_state(device)
    det = EBSDDetector(shape=shape, pc=(0.42, 0.28, 0.5), sample_tilt=70)
    dc = direction_cosines_from_detector(det, device=device)
    truth = torch.as_tensor(super_fibonacci(n * 7)[::7][:n], dtype=torch.float32, device=device)
    if case == "straddle":
        truth = _straddle_rotations(dc, n, 55)
    rows = lp.lambert_project(truth, dc, quad, 101, 101, 50.0)
    rows = rows + 0.02 * torch.randn(rows.shape, generator=torch.Generator(device=device).manual_seed(50),
                                     device=device)
    axes = torch.as_tensor(np.random.default_rng(51).normal(size=(n, 3)))
    start = tq.multiply(tq.from_axis_angle(axes, np.deg2rad(1.5)), truth.double().cpu())
    euler0 = tq.to_euler(start).to(torch.float32).to(device)
    idx = None
    if case == "masked":
        idx = torch.nonzero(torch.rand(dc.shape[0], generator=torch.Generator().manual_seed(52)) > 0.3)[:, 0]
        idx = idx.to(device)
        dc = dc[idx].contiguous()
    elif case == "p1000":
        idx = torch.arange(1000, device=device)
        dc = dc[idx].contiguous()
    elif case == "per_point":
        dc = _per_point_dc(n, om, 53, device)
    exp, sq = _prepare_experimental(rows, idx)
    kw = dict(initial_step=NM_STEPS.get(case, (np.deg2rad(1.0),))[0], max_iters=150, fatol=1e-4, xatol=1e-4)
    if case == "trust_region":
        tr = torch.tensor(np.deg2rad([0.5, 0.5, 0.5]), dtype=torch.float32, device=device)
        kw.update(lower_bounds=euler0 - tr, upper_bounds=euler0 + tr)
    return (euler0, exp, sq, dc, quad, 101, 101, 50.0), kw


NM_CASES = ["shared", "trust_region", "masked", "per_point", "over_budget", "one", "tiny_step", "large_step",
            "straddle", "p1000", "resident", "wide", "full_cache"]


@pytest.mark.parametrize("case", NM_CASES)
def test_nelder_mead_kernel_takes_the_host_loops_path(cuda, monkeypatch, case):
    from kikuchipy_tpu_torch.ops import lambert_project as lp
    from kikuchipy_tpu_torch.ops import refine_nm as rn

    args, kw = _nm_inputs(cuda, case)
    want = NM_ROUTES.get(case, "cache" if rn.CACHE_SHAPE["orientation"] else "resident")
    assert _nm_route(monkeypatch, case, "orientation", args[3].shape[-2]) == want
    before = (rn.nelder_mead_orientation.launches, lp.lambert_project_ncc.launches)
    got = rn.nelder_mead_orientation(*args, **kw)
    torch.cuda.synchronize()
    assert rn.nelder_mead_orientation.launches == before[0] + 1 and lp.lambert_project_ncc.launches == before[1]
    ref = rn.nelder_mead_orientation_plain(*args, **kw)
    n = args[0].shape[0]
    assert got.x.shape == (n, 3) and got.fun.shape == got.n_iter.shape == got.converged.shape == (n,)
    assert torch.isfinite(got.fun).all()
    # From a simplex edge of 0.02 or 8 degrees a point may run out of iterations.
    assert got.converged.all() or case in NM_STEPS
    print(f"{case}: n_iter equal {float((got.n_iter == ref.n_iter).float().mean()):.4f}, max |dfun| "
          f"{float((got.fun - ref.fun).abs().max()):.3e}, max |dx| {float((got.x - ref.x).abs().max()):.3e}, "
          f"evaluations {int(got.n_evals.sum())} vs {int(ref.n_evals.sum())}")
    assert torch.equal(got.n_iter, ref.n_iter) and torch.equal(got.converged, ref.converged)
    assert torch.equal(got.fun, ref.fun) and torch.equal(got.x, ref.x)
    assert (got.n_evals <= ref.n_evals).all() and (got.n_evals >= 4 + got.n_iter).all()
    if "lower_bounds" in kw:
        assert (got.x >= kw["lower_bounds"]).all() and (got.x <= kw["upper_bounds"]).all()


def test_refine_orientation_pseudo_symmetry_on_the_card(cuda):
    # Each variant is one launch; the winning variant and orientations agree
    # with the CPU (plain host loop) to the port's refinement tolerance.
    from kikuchipy_tpu_torch import EBSD, EBSDMasterPattern
    from kikuchipy_tpu_torch.crystallography.crystal_map import CrystalMap
    from kikuchipy_tpu_torch.crystallography.sampling import disorientation_angle, super_fibonacci
    from kikuchipy_tpu_torch.geometry import quaternion as tq
    from kikuchipy_tpu_torch.ops import refine_nm as rn

    master, _, _, _, det = _projection_state(cuda)
    truth = super_fibonacci(16 * 7)[::7][:16]
    op = tq.from_axis_angle(torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64), np.deg2rad(45.0)).numpy()
    axes = torch.as_tensor(np.random.default_rng(54).normal(size=(16, 3)))
    start = tq.multiply(tq.from_axis_angle(axes, np.deg2rad(1.0)), torch.as_tensor(truth))
    moved = np.arange(16) % 2 == 1
    start[moved] = tq.multiply(tq.conjugate(torch.as_tensor(op)), start[moved])
    results = {}
    for dev in ("cpu", cuda):
        mp = EBSDMasterPattern(master, device=dev)
        signal = EBSD(mp.get_patterns(truth, det).data, detector=det, device=dev)
        before = rn.nelder_mead_orientation.launches
        res = signal.refine_orientation(xmap=CrystalMap(rotations=start.numpy()), master_pattern=mp,
                                        pseudo_symmetry_ops=op[None], max_iters=80)
        assert rn.nelder_mead_orientation.launches == before + 2 * (str(dev) != "cpu")
        results[str(dev)] = res.xmap
    np.testing.assert_array_equal(results["cuda"].prop["pseudo_symmetry_index"], moved.astype(int))
    np.testing.assert_array_equal(results["cpu"].prop["pseudo_symmetry_index"], moved.astype(int))
    ang = np.degrees(disorientation_angle(results["cpu"].best_rotations, results["cuda"].best_rotations, "m-3m"))
    assert ang.max() < 0.05
    np.testing.assert_allclose(results["cuda"].prop["scores"], results["cpu"].prop["scores"], atol=1e-4)


def test_nelder_mead_kernel_refuses_what_it_cannot_take(cuda):
    from kikuchipy_tpu_torch.ops import refine_nm as rn

    args, kw = _nm_inputs(cuda, "shared", n=4)
    with pytest.raises(TypeError):
        rn.nelder_mead_orientation(args[0].double(), *args[1:], **kw)
    with pytest.raises(ValueError, match="one device"):
        rn.nelder_mead_orientation(args[0], args[1].cpu(), *args[2:], **kw)
    # The launcher itself refuses an empty batch and a negative max_iters.
    fn = rn._function()
    out = torch.empty(16, device=cuda)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [out.data_ptr()] * 14
    assert fn(*ptrs, 0, 3600, 0, 101, 101, 50.0, 10, 1e-4, 1e-4, 1, 0, stream) != 0
    assert fn(*ptrs, 1, 3600, 0, 101, 101, 50.0, -1, 1e-4, 1e-4, 1, 0, stream) != 0
    # ... a route outside the three (ops/refine_nm.py _ROUTE), a cache route
    # without cached pixels or with more than P, and cached pixels on another route.
    assert fn(*ptrs, 1, 3600, 0, 101, 101, 50.0, 10, 1e-4, 1e-4, 3, 0, stream) != 0
    assert fn(*ptrs, 1, 3600, 0, 101, 101, 50.0, 10, 1e-4, 1e-4, 2, 0, stream) != 0
    assert fn(*ptrs, 1, 3600, 0, 101, 101, 50.0, 10, 1e-4, 1e-4, 2, 3601, stream) != 0
    assert fn(*ptrs, 1, 3600, 0, 101, 101, 50.0, 10, 1e-4, 1e-4, 1, 8, stream) != 0


def test_projection_kernels_refuse_what_they_cannot_take(cuda):
    from kikuchipy_tpu_torch.ops import lambert_project as lp

    _, quad, dc, _, _ = _projection_state(cuda)
    rot = _quats(4, 48, cuda)
    with pytest.raises(TypeError):
        lp.lambert_project(rot.double(), dc, quad, 101, 101, 50.0)
    with pytest.raises(ValueError, match="one device"):
        lp.lambert_project(rot, dc.cpu(), quad, 101, 101, 50.0)
    buf = torch.empty(quad.numel() + 1, device=cuda)
    shifted = buf[1:].view(-1, 4)  # the right shape, 4 bytes off a float4
    shifted.copy_(quad)
    with pytest.raises(ValueError, match="aligned"):
        lp.lambert_project(rot, dc, shifted, 101, 101, 50.0)
    # The launchers themselves refuse an empty batch.
    out = torch.empty((1, dc.shape[0]), device=cuda)
    fn = lp._function("lambert_project")
    stream = torch.cuda.current_stream().cuda_stream
    assert fn(rot.data_ptr(), dc.data_ptr(), quad.data_ptr(), out.data_ptr(), 0, 0, dc.shape[0], 0, 101, 101, 50.0,
              0, 0.0, 1.0, stream) != 0
    fn = lp._function("lambert_project_ncc")
    assert fn(rot.data_ptr(), dc.data_ptr(), quad.data_ptr(), out.data_ptr(), out.data_ptr(), out.data_ptr(), 1, 0, 0,
              101, 101, 50.0, stream) != 0


# The PC and joint modes of the Nelder-Mead kernel against their host loops
# on kernel B (nelder_mead_batched over pc_objective / joint_objective, the
# direction cosines of every candidate PC built in PyTorch): the kernel
# computes each pixel's direction cosine from the candidate PC in the plain
# version's stated order, so the two must take the same path bit for bit.


def test_torch_mean_over_the_vertices_adds_in_the_kernels_order(cuda):
    # The centroid of the host loop is torch.mean over the best d vertices;
    # the kernel adds them as PyTorch's reduction does for so few values.
    g = torch.Generator(device="cpu").manual_seed(60)
    for n in (1, 48, 2048, 16384):
        for d in (3, 6):
            verts = torch.randn((n, d + 1, d), generator=g).to(cuda)
            got = torch.mean(verts[:, :-1, :], dim=1)
            v = [verts[:, i, :] for i in range(d)]
            if d == 3:
                s = (v[0] + v[1]) + v[2]
            else:
                s = (((v[0] + v[4]) + (v[1] + v[5])) + v[2]) + v[3]
            want = s * float(np.float32(1) / np.float32(d))
            assert torch.equal(got, want), (n, d)


def test_pc_direction_cosines_on_the_card_follow_their_stated_order(cuda):
    # Every operation correctly rounded in the stated order (float32 numpy,
    # square root included: PyTorch's on the card is IEEE).
    from kikuchipy_tpu_torch.ops import refine_nm as rn

    f = np.float32
    for nrows, ncols in ((60, 60), (24, 40)):
        det_om = _projection_state("cpu", shape=(nrows, ncols))[3].numpy()
        rng = np.random.default_rng(61)
        pcs = (np.array([0.42, 0.28, 0.5]) + rng.normal(scale=0.02, size=(33, 3))).astype(f)
        take = np.sort(rng.choice(nrows * ncols, size=nrows * ncols // 2, replace=False))
        got = rn.pc_direction_cosines(torch.as_tensor(pcs, device=cuda), nrows, ncols, torch.as_tensor(det_om, device=cuda),
                                      torch.as_tensor(take, device=cuda)).cpu().numpy()
        aspect = f(ncols / nrows)
        pcx, pcy, pcz = pcs[:, 0:1], pcs[:, 1:2], pcs[:, 2:3]
        gb0, gb1 = (pcx * -aspect) / pcz, ((f(1) - pcx) * aspect) / pcz
        gb2, gb3 = -(f(1) - pcy) / pcz, pcy / pcz
        xs, ys = (gb1 - gb0) * (f(1) / f(ncols)), (gb3 - gb2) * (f(1) / f(nrows))
        col, row = (take % ncols).astype(f)[None], (take // ncols).astype(f)[None]
        x = ((gb0 + col * xs) + xs * f(0.5)) * pcz
        y = ((gb3 - row * ys) - ys * f(0.5)) * pcz
        z = np.broadcast_to(pcz, x.shape)
        r = [(x * det_om[k, 0] + y * det_om[k, 1]) + z * det_om[k, 2] for k in range(3)]
        norm = np.sqrt((r[0] * r[0] + r[1] * r[1]) + r[2] * r[2])
        np.testing.assert_array_equal(got, np.stack([r[k] / norm for k in range(3)], axis=-1))


def _pc_inputs(device, mode: str, case: str, n: int = 64):
    """(wrapper, plain, x0, arguments, keywords) of the PC or joint mode on
    patterns projected at known orientations and the detector's PC, started
    from the PC off by (0.01, -0.01, 0.01) (joint: and 1.5 degrees off)."""
    from kikuchipy_tpu_torch.crystallography.sampling import super_fibonacci
    from kikuchipy_tpu_torch.geometry import quaternion as tq
    from kikuchipy_tpu_torch.geometry.detector import EBSDDetector
    from kikuchipy_tpu_torch.indexing.refinement import _prepare_experimental
    from kikuchipy_tpu_torch.ops import lambert_project as lp
    from kikuchipy_tpu_torch.ops import refine_nm as rn
    from kikuchipy_tpu_torch.projection.master_pattern import direction_cosines_from_detector

    n = {"one": 1, "over_budget": 8, "wide": 4}.get(case, n)
    shape = NM_SHAPES.get(case, (60, 60))
    pc = (0.42, 0.28, 0.5)
    _, quad, _, _, _ = _projection_state(device)
    det = EBSDDetector(shape=shape, pc=pc, sample_tilt=70)
    om = torch.as_tensor(np.ascontiguousarray(det.sample_to_detector.T), dtype=torch.float32, device=device)
    dc = direction_cosines_from_detector(det, device=device)
    truth = torch.as_tensor(super_fibonacci(n * 7)[::7][:n], dtype=torch.float32, device=device)
    if case == "straddle":
        truth = _straddle_rotations(dc, n, 65)
    rows = lp.lambert_project(truth, dc, quad, 101, 101, 50.0)
    rows = rows + 0.02 * torch.randn(rows.shape, generator=torch.Generator(device=device).manual_seed(62),
                                     device=device)
    take = None
    if case == "masked":
        take = torch.nonzero(torch.rand(rows.shape[1], generator=torch.Generator().manual_seed(63)) > 0.3)[:, 0]
        take = take.to(device)
    elif case == "p1000":
        take = torch.arange(1000, device=device)
    exp, sq = _prepare_experimental(rows, take)
    pc0 = torch.as_tensor(np.tile(np.asarray(pc) + [0.01, -0.01, 0.01], (n, 1)), dtype=torch.float32, device=device)
    geo = (101, 101, 50.0, shape[0], shape[1])
    step_deg, step_pc = NM_STEPS.get(case, (np.deg2rad(1.0), 0.01))
    if mode == "pc":
        x0, args = pc0, (exp, sq, truth, quad, om, take, *geo)
        kw = dict(initial_step=step_pc, max_iters=150, fatol=1e-4, xatol=1e-5)
        half = torch.full((3,), 0.006, device=device)
        fns = (rn.nelder_mead_projection_center, rn.nelder_mead_projection_center_plain)
    else:
        axes = torch.as_tensor(np.random.default_rng(64).normal(size=(n, 3)))
        start = tq.multiply(tq.from_axis_angle(axes, np.deg2rad(1.5)), truth.double().cpu())
        euler0 = tq.to_euler(start).to(torch.float32).to(device)
        x0, args = torch.cat([euler0, pc0], dim=1), (exp, sq, quad, om, take, *geo)
        kw = dict(initial_step=torch.tensor([step_deg] * 3 + [step_pc] * 3, dtype=torch.float32, device=device),
                  max_iters=200, fatol=1e-4, xatol=1e-5)
        half = torch.tensor([np.deg2rad(1.0)] * 3 + [0.006] * 3, dtype=torch.float32, device=device)
        fns = (rn.nelder_mead_orientation_projection_center, rn.nelder_mead_orientation_projection_center_plain)
    if case == "trust_region":
        kw.update(lower_bounds=x0 - half, upper_bounds=x0 + half)
    return fns[0], fns[1], x0, args, kw


@pytest.mark.parametrize("mode", ["pc", "joint"])
@pytest.mark.parametrize("case", ["shared", "trust_region", "masked", "p1000", "over_budget", "one", "tiny_step",
                                  "large_step", "straddle", "resident", "wide", "cache"])
def test_nelder_mead_pc_kernels_take_the_host_loops_path(cuda, monkeypatch, mode, case):
    from kikuchipy_tpu_torch.ops import lambert_project as lp
    from kikuchipy_tpu_torch.ops import refine_nm as rn

    wrapper, plain, x0, args, kw = _pc_inputs(cuda, mode, case)
    want = NM_ROUTES.get(case, "cache" if rn.CACHE_SHAPE[mode] else "resident")
    assert _nm_route(monkeypatch, case, mode, args[0].shape[1]) == want
    before = (wrapper.launches, lp.lambert_project_ncc.launches)
    got = wrapper(x0, *args, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == before[0] + 1 and lp.lambert_project_ncc.launches == before[1]
    ref = plain(x0, *args, **kw)
    n, d = x0.shape
    assert got.x.shape == (n, d) and got.fun.shape == got.n_iter.shape == got.converged.shape == (n,)
    assert torch.isfinite(got.fun).all()
    print(f"{mode} {case}: n_iter equal {float((got.n_iter == ref.n_iter).float().mean()):.4f}, max |dfun| "
          f"{float((got.fun - ref.fun).abs().max()):.3e}, max |dx| {float((got.x - ref.x).abs().max()):.3e}, "
          f"evaluations {int(got.n_evals.sum())} vs {int(ref.n_evals.sum())}")
    assert torch.equal(got.n_iter, ref.n_iter) and torch.equal(got.converged, ref.converged)
    assert torch.equal(got.fun, ref.fun) and torch.equal(got.x, ref.x)
    assert (got.n_evals <= ref.n_evals).all() and (got.n_evals >= d + 1 + got.n_iter).all()
    if "lower_bounds" in kw:
        assert (got.x >= kw["lower_bounds"]).all() and (got.x <= kw["upper_bounds"]).all()


@pytest.mark.parametrize("mode", ["orientation", "pc", "joint"])
def test_nelder_mead_kernel_agrees_with_the_loop_over_the_float32_twin(cuda, mode):
    # The kernel's pixel (lambert_pixel) is not the plain twin's float32
    # rounding: its points against the host loop over the float32 plain twin
    # on 64 points, both scored by the float64 twin (chip_smoke.py
    # float64_check: the mean float64 1 - NCC no higher by more than 1e-6,
    # in orientation mode 99% within 0.05 degrees).
    smoke = _smoke()
    if mode == "orientation":
        args, kw = _nm_inputs(cuda, "shared")
        from kikuchipy_tpu_torch.ops import refine_nm as rn

        x0, (exp, sq, dc, quad), q0, om = args[0], args[1:5], None, None
        wrap = lambda x: rn.nelder_mead_orientation(x, *args[1:], **kw)  # noqa: E731
        shape = (60, 60)
    else:
        wrapper, _, x0, args, kw = _pc_inputs(cuda, mode, "shared")
        exp, sq = args[0], args[1]
        q0 = args[2] if mode == "pc" else None
        quad, om = args[3 if mode == "pc" else 2], args[4 if mode == "pc" else 3]
        dc, shape = None, (60, 60)
        wrap = lambda x: wrapper(x, *args, **kw)  # noqa: E731
    ok, msg, got, ref = smoke.float64_check(mode, wrap, x0, kw, exp, sq, dc, q0, quad, om, None, (101, 101, 50.0),
                                            shape)
    print(f"{mode}: {msg}")
    assert torch.isfinite(got.fun).all() and ok


def test_pc_refinement_on_the_card_is_one_launch_a_mode(cuda):
    # refine_projection_center and refine_orientation_projection_center on a
    # 64-point scan: one launch of the Nelder-Mead kernel a mode and none of
    # kernel B, with a signal mask and a navigation mask too; the PC comes
    # back to the truth as on the CPU (the host loop).
    from kikuchipy_tpu_torch import EBSD, EBSDMasterPattern
    from kikuchipy_tpu_torch.crystallography.crystal_map import CrystalMap
    from kikuchipy_tpu_torch.crystallography.sampling import super_fibonacci
    from kikuchipy_tpu_torch.ops import lambert_project as lp
    from kikuchipy_tpu_torch.ops import refine_nm as rn

    master, _, _, _, det = _projection_state(cuda)
    truth = super_fibonacci(64 * 7)[::7][:64]
    bad = dataclasses.replace(det, pc=np.asarray(det.pc).reshape(3) + [0.01, -0.01, 0.01])
    sig_mask = np.zeros(det.shape, dtype=bool)
    sig_mask[:4] = True
    nav_mask = np.zeros(64, dtype=bool)
    nav_mask[[3, 17]] = True
    results = {}
    for dev in ("cpu", cuda):
        on_card = str(dev) != "cpu"
        mp = EBSDMasterPattern(master, device=dev)
        signal = EBSD(mp.get_patterns(truth, det).data, detector=det, device=dev)
        for name, wrapper in (("refine_projection_center", rn.nelder_mead_projection_center),
                              ("refine_orientation_projection_center", rn.nelder_mead_orientation_projection_center)):
            for kw in ({}, dict(signal_mask=sig_mask, navigation_mask=nav_mask)):
                counts = (wrapper.launches, lp.lambert_project_ncc.launches)
                res = getattr(signal, name)(xmap=CrystalMap(rotations=truth), detector=bad, master_pattern=mp, **kw)
                assert wrapper.launches == counts[0] + on_card and lp.lambert_project_ncc.launches == counts[1]
                pcs = res.detector.pc.reshape(-1, 3)
                keep = ~nav_mask if kw else np.ones(64, dtype=bool)
                assert np.abs(pcs[keep].mean(0) - np.asarray(det.pc).reshape(3)).max() < 2e-3
                if kw:
                    assert np.isnan(res.xmap.prop["scores"][nav_mask]).all()
                results[(str(dev), name, bool(kw))] = res
    for key in [k for k in results if k[0] == "cpu"]:
        cpu, card = results[key], results[("cuda",) + key[1:]]
        scores_cpu, scores_card = cpu.xmap.prop["scores"], card.xmap.prop["scores"]
        live = np.isfinite(scores_cpu)
        np.testing.assert_allclose(scores_card[live], scores_cpu[live], atol=1e-4)
        if key[1] == "refine_projection_center":
            np.testing.assert_allclose(card.detector.pc, cpu.detector.pc, atol=1e-4)


def test_nelder_mead_pc_kernel_refuses_what_it_cannot_take(cuda):
    from kikuchipy_tpu_torch.ops import refine_nm as rn

    wrapper, _, x0, args, kw = _pc_inputs(cuda, "pc", "shared", n=4)
    with pytest.raises(TypeError):
        wrapper(x0.double(), *args, **kw)
    with pytest.raises(ValueError, match="one device"):
        wrapper(x0, args[0].cpu(), *args[1:], **kw)
    with pytest.raises(ValueError, match="one device"):
        wrapper(x0, *args[:5], torch.arange(10), *args[6:], **kw)
    # The launcher itself refuses an unknown mode, an empty batch, a negative
    # max_iters, and a PC mode without rotations or pixel table.
    fn = rn._function("refine_nm_pc")
    out = torch.empty(64, device=cuda)
    p = out.data_ptr()
    stream = torch.cuda.current_stream().cuda_stream
    om = (ctypes.c_float * 9)(*([0.0] * 9))

    def call(mode=1, q0=p, pix=p, n=1, max_iters=10):
        return fn(mode, p, p, 0, 0, p, p, q0, pix, om, p, p, p, p, p, p, p, n, 3600, 101, 101, 50.0, 1.0, -1.0,
                  1.0 / 60, 1.0 / 60, max_iters, 1e-4, 1e-5, 1, 0, stream)

    assert call(mode=0) != 0 and call(mode=3) != 0
    assert call(n=0) != 0 and call(max_iters=-1) != 0
    assert call(q0=0) != 0 and call(pix=0) != 0 and call(mode=2, pix=0) != 0


# Kernel C (csrc/refine_lm.cu, the tangent kernel) against its plain version
# (torch.func.jvp over the plain residual, then the einsums) on the same card
# and inputs. Its pixel is kernel A's (lambert_common.cuh lambert_pixel_grad:
# the projected values are lambert_project's bit for bit, in the PC modes on
# pc_direction_cosines' rows), not the float32 plain twin's rounding, so its
# yardstick is the plain version run on float64 operands: in every mode and
# case the kernel's J^T r and J^T J are no further from it than twice the
# float32 plain version's, or LM_REL of their norms. Against the float32
# plain version f = 0.5 ||r||^2 agrees to 2e-6, and J^T r and J^T J to
# LM_REL of their norms in every case but those of LM_F32_REL_EXEMPT, where
# the float32 plain version is the one off the float64 one (its J^T r 2.2e-4
# to 4.6e-4, its J^T J to 1.3e-3; the kernel's within 1.6e-4 and 2.4e-4):
# each prints both (PERF.md names them). At the Lambert poles ("pole": a
# pixel of each point within 1e-3 rad of one, two on it) the float32 twin's
# 1 - |wz| cancels and puts pixels within about 3.5e-4 rad on the pole, where
# its tangent is 0; the kernel decides on rho^2 == 0 and its tangent there is
# bounded.
LM_REL = 1e-4
LM_F32_REL_EXEMPT = frozenset([("orientation", "per_point"), ("orientation", "pole"), ("orientation", "tie"),
                               ("pc", "shared"), ("pc", "masked"), ("pc", "over_budget"), ("joint", "shared"),
                               ("joint", "masked"), ("joint", "p1000")])


def _lm_inputs(device, mode: str, case: str, n: int = 64):
    """(wrapper, plain, x, arguments, q) of kernel C in ``mode`` on patterns
    projected at known orientations, the trial points near them; ``q`` the
    rotations the projection uses (for the bit-for-bit check of the
    values)."""
    from kikuchipy_tpu_torch.crystallography.sampling import super_fibonacci
    from kikuchipy_tpu_torch.geometry import quaternion as tq
    from kikuchipy_tpu_torch.geometry.detector import EBSDDetector
    from kikuchipy_tpu_torch.indexing.refinement import _prepare_experimental
    from kikuchipy_tpu_torch.ops import lambert_project as lp
    from kikuchipy_tpu_torch.ops import refine_lm as rl
    from kikuchipy_tpu_torch.projection.master_pattern import direction_cosines_from_detector

    n = {"one": 1, "over_budget": 8}.get(case, n)
    shape = (128, 128) if case == "over_budget" else (60, 60)  # P = 16,384: past RESIDENT_SMEM_BYTES
    pc = (0.42, 0.28, 0.5)
    _, quad, _, _, _ = _projection_state(device)
    det = EBSDDetector(shape=shape, pc=pc, sample_tilt=70)
    om = torch.as_tensor(np.ascontiguousarray(det.sample_to_detector.T), dtype=torch.float32, device=device)
    dc = direction_cosines_from_detector(det, device=device)
    truth = torch.as_tensor(super_fibonacci(n * 7)[::7][:n], dtype=torch.float32, device=device)
    if case == "pole":
        # each rotation turns one pixel to within 1e-3 rad of a Lambert pole
        # (the first two exactly onto it), with delta = 0
        truth = torch.as_tensor(_smoke().pole_rotations(dc.cpu().numpy(), n, 65), device=device)
    elif case == "tie":
        # The identity and pixels with y or x exactly 0: the Lambert
        # coordinate on the grid's centre line, the fractional offset exactly
        # 0, the clip's tie on every pixel (half the tangent, JAX's rule).
        truth = torch.tensor([[1.0, 0.0, 0.0, 0.0]], device=device).expand(n, 4).contiguous()
        g = np.random.default_rng(66)
        v = g.normal(size=(600, 3))
        v[:, 2] = np.abs(v[:, 2]) + 0.3
        v[:300, 1] = 0.0
        v[300:, 0] = 0.0
        dc = torch.as_tensor((v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32), device=device)
    at = truth
    if case in ("pole", "tie"):  # evaluated at delta = 0: rows half a degree off, or g would be noise
        axes = torch.as_tensor(np.random.default_rng(72).normal(size=(n, 3)))
        at = tq.multiply(tq.from_axis_angle(axes, np.deg2rad(0.5)), truth.double().cpu()).float().to(device)
    rows = lp.lambert_project(at, dc, quad, 101, 101, 50.0)
    rows = rows + 0.02 * torch.randn(rows.shape, generator=torch.Generator(device=device).manual_seed(67),
                                     device=device)
    take = None
    if case == "masked":
        take = torch.nonzero(torch.rand(rows.shape[1], generator=torch.Generator().manual_seed(68)) > 0.3)[:, 0]
        take = take.to(device)
    elif case == "p1000":
        take = torch.arange(1000, device=device)
    exp, _ = _prepare_experimental(rows, take)
    exp_unit = rl.unit_rows(exp)
    rng = np.random.default_rng(69)
    zero = case in ("pole", "tie")
    delta = torch.as_tensor(0 if zero else rng.normal(scale=0.01, size=(n, 3)), dtype=torch.float32,
                            device=device).expand(n, 3).contiguous()
    geo = (101, 101, 50.0)
    if mode == "orientation":
        if case == "per_point":
            dc = _per_point_dc(n, om, 70, device)
        elif take is not None:
            dc = dc[take].contiguous()
        q = rl._rotation(truth, delta)
        return rl.tangent_orientation, rl.tangent_orientation_plain, delta, (truth, exp_unit, dc, quad, *geo), q
    pc0 = torch.as_tensor(np.tile(np.asarray(pc) + [0.01, -0.01, 0.01], (n, 1)), dtype=torch.float32, device=device)
    dpc = torch.as_tensor(rng.normal(scale=0.004, size=(n, 3)), dtype=torch.float32, device=device)
    if mode == "pc":
        return (rl.tangent_projection_center, rl.tangent_projection_center_plain, dpc,
                (pc0, exp_unit, truth, quad, om, take, *geo, *shape), truth)
    x = torch.cat([delta, dpc], dim=1)
    return (rl.tangent_orientation_projection_center, rl.tangent_orientation_projection_center_plain, x,
            (truth, pc0, exp_unit, quad, om, take, *geo, *shape), rl._rotation(truth, delta))


def _lm_errors(got, ref):
    f, g, h = got
    rf, rg, rh = ref
    return (float((f - rf).abs().max()),
            float((torch.linalg.vector_norm(g - rg, dim=1) / torch.linalg.vector_norm(rg, dim=1)).max()),
            float((torch.linalg.matrix_norm(h - rh) / torch.linalg.matrix_norm(rh)).max()))


LM_CASES = [("orientation", c) for c in ("shared", "masked", "per_point", "p1000", "pole", "tie", "over_budget",
                                         "one")] + [(m, c) for m in ("pc", "joint")
                                                    for c in ("shared", "masked", "p1000", "over_budget", "one")]


@pytest.mark.parametrize("mode, case", LM_CASES, ids=[f"{m}-{c}" for m, c in LM_CASES])
def test_tangent_kernel_matches_plain(cuda, mode, case):
    from kikuchipy_tpu_torch.ops import lambert_project as lp
    from kikuchipy_tpu_torch.ops import refine_lm as rl
    from kikuchipy_tpu_torch.ops.refine_nm import pc_direction_cosines

    wrapper, plain, x, args, q = _lm_inputs(cuda, mode, case)
    n, d = x.shape
    exp_unit, quad = args[2 if mode == "joint" else 1], args[3]
    P = exp_unit.shape[1]
    assert rl.resident(P, d) == (case != "over_budget")
    sim = torch.empty((n, P), device=cuda)
    before = wrapper.launches
    got = wrapper(x, *args, sim=sim)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    ref = plain(x, *args)
    assert [tuple(t.shape) for t in got] == [(n,), (n, d), (n, d, d)]
    assert all(torch.isfinite(t).all() for t in got)
    # The values are kernel A's bit for bit.
    if mode == "orientation":
        dc = args[2]
    else:
        pc0, om, take = args[0 if mode == "pc" else 1], args[4], args[5]
        dc = pc_direction_cosines(pc0 + (x if mode == "pc" else x[:, 3:]), args[-2], args[-1], om, take)
    assert torch.equal(sim, lp.lambert_project(q, dc.contiguous(), quad, 101, 101, 50.0))
    f_err, g_err, h_err = _lm_errors(got, ref)
    ref64 = plain(x.double(), *(a.double() if torch.is_tensor(a) and a.is_floating_point() else a for a in args))
    fk, gk, hk = _lm_errors(got, ref64)
    ft, gt, ht = _lm_errors(ref, ref64)
    print(f"{mode} {case}: against the float32 plain version max |df| {f_err:.3e}, max |dg| / |g| {g_err:.3e}, max "
          f"|dJtJ| / |JtJ| {h_err:.3e}; against float64: kernel {fk:.3e}, {gk:.3e}, {hk:.3e}, the float32 plain "
          f"version {ft:.3e}, {gt:.3e}, {ht:.3e}")
    assert f_err <= 2e-6
    assert fk <= max(2e-6, 2 * ft) and gk <= max(LM_REL, 2 * gt) and hk <= max(LM_REL, 2 * ht)
    if (mode, case) not in LM_F32_REL_EXEMPT:
        assert g_err <= LM_REL and h_err <= LM_REL
    assert torch.allclose(got[2], got[2].transpose(1, 2))


def test_lm_and_gradient_refinement_on_the_card_go_through_kernel_c(cuda):
    # The three modes with method "lm" and "gradient" on a 64-point scan:
    # on the card each "lm" call is one launch of the LM loop kernel (kernel
    # C never), each "gradient" evaluation a launch of kernel C (no
    # Nelder-Mead kernel, no kernel A or B), and the results are the CPU's
    # (the plain versions) within the rounding of their sums.
    from kikuchipy_tpu_torch import EBSD, EBSDMasterPattern
    from kikuchipy_tpu_torch.crystallography.crystal_map import CrystalMap
    from kikuchipy_tpu_torch.crystallography.sampling import super_fibonacci
    from kikuchipy_tpu_torch.geometry import quaternion as tq
    from kikuchipy_tpu_torch.ops import lambert_project as lp
    from kikuchipy_tpu_torch.ops import refine_lm as rl
    from kikuchipy_tpu_torch.ops import refine_nm as rn

    master, _, _, _, det = _projection_state(cuda)
    truth = super_fibonacci(64 * 7)[::7][:64]
    axes = torch.as_tensor(np.random.default_rng(71).normal(size=(64, 3)))
    start = tq.multiply(tq.from_axis_angle(axes, np.deg2rad(1.5)), torch.as_tensor(truth)).numpy()
    bad = dataclasses.replace(det, pc=np.asarray(det.pc).reshape(3) + [0.01, -0.01, 0.01])
    calls = [("refine_orientation", rl.tangent_orientation, rl.levenberg_marquardt_orientation,
              dict(xmap=CrystalMap(rotations=start))),
             ("refine_projection_center", rl.tangent_projection_center, rl.levenberg_marquardt_projection_center,
              dict(xmap=CrystalMap(rotations=truth), detector=bad)),
             ("refine_orientation_projection_center", rl.tangent_orientation_projection_center,
              rl.levenberg_marquardt_orientation_projection_center, dict(xmap=CrystalMap(rotations=start), detector=bad))]
    others = (rn.nelder_mead_orientation, rn.nelder_mead_projection_center,
              rn.nelder_mead_orientation_projection_center, lp.lambert_project, lp.lambert_project_ncc)
    results = {}
    for dev in ("cpu", cuda):
        on_card = str(dev) != "cpu"
        mp = EBSDMasterPattern(master, device=dev)
        signal = EBSD(mp.get_patterns(truth, det).data, detector=det, device=dev)
        for name, tangent, loop, kw in calls:
            for method in ("lm", "gradient"):
                counts = (tangent.launches, loop.launches, [f.launches for f in others])
                res = getattr(signal, name)(master_pattern=mp, method=method, max_iters=40, **kw)
                if method == "lm":
                    assert tangent.launches == counts[0] and loop.launches == counts[1] + on_card
                else:
                    assert (tangent.launches > counts[0]) == on_card and loop.launches == counts[1]
                assert [f.launches for f in others] == counts[2]
                results[(str(dev), name, method)] = res
    for key in [k for k in results if k[0] == "cpu"]:
        cpu, card = results[key], results[("cuda",) + key[1:]]
        print(key[1:], "max |score diff|", np.abs(card.xmap.prop["scores"] - cpu.xmap.prop["scores"]).max())
        np.testing.assert_allclose(card.xmap.prop["scores"], cpu.xmap.prop["scores"], atol=1e-4)
        if key[1] != "refine_orientation":
            pcs = card.detector.pc.reshape(-1, 3)
            assert np.abs(pcs.mean(0) - np.asarray(det.pc).reshape(3)).max() < 2e-3
            np.testing.assert_allclose(pcs.mean(0), cpu.detector.pc.reshape(-1, 3).mean(0), atol=1e-4)


def test_tangent_kernel_refuses_what_it_cannot_take(cuda):
    from kikuchipy_tpu_torch.ops import refine_lm as rl

    wrapper, _, x, args, _ = _lm_inputs(cuda, "pc", "shared", n=4)
    with pytest.raises(TypeError):
        wrapper(x.double(), *args)
    with pytest.raises(ValueError, match="one device"):
        wrapper(x, args[0].cpu(), *args[1:])
    # The launcher itself refuses an unknown mode, an empty batch, and a
    # mode without its operands.
    fn = rl._function()
    out = torch.empty(64, device=cuda)
    p = out.data_ptr()
    stream = torch.cuda.current_stream().cuda_stream
    om = (ctypes.c_float * 9)(*([0.0] * 9))

    def call(mode=1, q0=p, pc=p, dc=p, pix=p, n=1, P=3600):
        return fn(mode, p, q0, p, pc, dc, 0, pix, om, p, p, p, p, p, 0, n, P, 101, 101, 50.0, 1.0, -1.0, 1.0 / 60,
                  1.0 / 60, 1, stream)

    assert call(mode=3) != 0 and call(mode=-1) != 0
    assert call(n=0) != 0 and call(P=0) != 0
    assert call(mode=0, q0=0) != 0 and call(mode=0, dc=0) != 0
    assert call(mode=1, pix=0) != 0 and call(mode=2, pc=0) != 0


# The Levenberg-Marquardt loop kernel (csrc/refine_lm.cu refine_lm_loop_kernel,
# one launch for every point) against the host loop on kernel C (the
# batched levenberg_marquardt_batched over the tangent wrapper) on the same
# card and inputs. Each evaluation is kernel C's arithmetic, and the trial
# point's rotation and PC and the d x d solve round as the host loop's
# PyTorch operations and torch.linalg.solve_ex do on the card (each held bit
# for bit below), so the two take the same path (each case prints the share
# bit for bit). The criterion is chip_smoke.py's: on at least 99% of the
# points 0.5 ||r||^2 within 1e-5, rotations within 0.05 degrees and PCs
# within 1e-4, on at least 90% the same iterations (NM_FUN_TOL, NM_AGREE,
# NM_DEG, LM_PC_TOL, LM_ITER_AGREE), all values finite.
LM_LOOP_CASES = ([(m, "map") for m in ("orientation", "pc", "joint")] + [("orientation", "per_point")]
                 + [(m, c) for m in ("orientation", "pc", "joint") for c in ("over_budget", "max_iters_1", "flat")])


def _lm_loop_inputs(device, mode: str, case: str):
    """(kernel wrapper, host loop, x0, arguments, keywords) of the LM loop
    kernel in ``mode``: patterns projected at known orientations with noise,
    starts 1.5 degrees off (orientation, joint), the PC off by (0.01, -0.01,
    0.01) (PC, joint), refine_*'s settings. "flat": a constant master
    pattern, so every value is NaN and each point stalls after six
    rejections at its start."""
    from kikuchipy_tpu_torch.crystallography.sampling import super_fibonacci
    from kikuchipy_tpu_torch.geometry import quaternion as tq
    from kikuchipy_tpu_torch.geometry.detector import EBSDDetector
    from kikuchipy_tpu_torch.indexing.refinement import _prepare_experimental
    from kikuchipy_tpu_torch.ops import lambert_project as lp
    from kikuchipy_tpu_torch.ops import refine_lm as rl
    from kikuchipy_tpu_torch.projection.master_pattern import direction_cosines_from_detector

    n = {"map": 2048, "per_point": 512, "over_budget": 64, "max_iters_1": 512, "flat": 64}[case]
    shape = (128, 128) if case == "over_budget" else (60, 60)
    pc = (0.42, 0.28, 0.5)
    _, quad, _, _, _ = _projection_state(device)
    det = EBSDDetector(shape=shape, pc=pc, sample_tilt=70)
    om = torch.as_tensor(np.ascontiguousarray(det.sample_to_detector.T), dtype=torch.float32, device=device)
    dc = direction_cosines_from_detector(det, device=device)
    if case == "per_point":
        dc = _per_point_dc(n, om, 73, device)
    truth = torch.as_tensor(super_fibonacci(n * 7)[::7][:n], dtype=torch.float32, device=device)
    rows = lp.lambert_project(truth, dc, quad, 101, 101, 50.0)
    rows = rows + 0.02 * torch.randn(rows.shape, generator=torch.Generator(device=device).manual_seed(74),
                                     device=device)
    if case == "flat":
        quad = torch.full_like(quad, 0.5)
    exp, _ = _prepare_experimental(rows, None)
    unit = rl.unit_rows(exp)
    axes = torch.as_tensor(np.random.default_rng(75).normal(size=(n, 3)))
    start = tq.multiply(tq.from_axis_angle(axes, np.deg2rad(1.5)), truth.double().cpu()).float().to(device)
    pc0 = torch.as_tensor(np.tile(np.asarray(pc) + [0.01, -0.01, 0.01], (n, 1)), dtype=torch.float32, device=device)
    geo = (101, 101, 50.0)
    rot, pcn = np.deg2rad(3.0), 0.05
    kw = dict(max_iters=1 if case == "max_iters_1" else 30, ftol=1e-6)
    if mode == "orientation":
        return (rl.levenberg_marquardt_orientation, rl.levenberg_marquardt_orientation_plain,
                torch.zeros((n, 3), device=device), (start, unit, dc, quad, *geo), dict(kw, blocks=((3, rot),)))
    if mode == "pc":
        return (rl.levenberg_marquardt_projection_center, rl.levenberg_marquardt_projection_center_plain,
                torch.zeros((n, 3), device=device), (pc0, unit, truth, quad, om, None, *geo, *shape),
                dict(kw, blocks=((3, pcn),)))
    return (rl.levenberg_marquardt_orientation_projection_center,
            rl.levenberg_marquardt_orientation_projection_center_plain, torch.zeros((n, 6), device=device),
            (start, pc0, unit, quad, om, None, *geo, *shape), dict(kw, blocks=((3, rot), (3, pcn))))


def _lm_loop_agreement(mode, got, ref, q0):
    """The shares of points that agree (fun, iterations, rotation, PC)."""
    from kikuchipy_tpu_torch.ops import refine_lm as rl

    shares = {"fun": float(((got.fun - ref.fun).abs() <= 1e-5).float().mean()),
              "n_iter": float((got.n_iter == ref.n_iter).float().mean())}
    if mode != "pc":
        a = rl._rotation(q0, got.x[:, :3].contiguous()).double()
        b = rl._rotation(q0, ref.x[:, :3].contiguous()).double()
        a, b = a / a.norm(dim=1, keepdim=True), b / b.norm(dim=1, keepdim=True)
        dot = (a * b).sum(1).abs().clamp(max=1.0)
        shares["rotation"] = float((torch.rad2deg(2 * torch.acos(dot)) <= 0.05).float().mean())
    if mode != "orientation":
        shares["pc"] = float(((got.x[:, -3:] - ref.x[:, -3:]).abs().amax(1) <= 1e-4).float().mean())
    return shares


@pytest.mark.parametrize("mode, case", LM_LOOP_CASES, ids=[f"{m}-{c}" for m, c in LM_LOOP_CASES])
def test_lm_loop_kernel_agrees_with_the_host_loop_on_kernel_c(cuda, mode, case):
    from kikuchipy_tpu_torch.ops import refine_lm as rl

    wrapper, plain, x0, args, kw = _lm_loop_inputs(cuda, mode, case)
    n, d = x0.shape
    P = args[2 if mode == "joint" else 1].shape[1]
    assert rl.resident(P, d) == (case != "over_budget")
    # The row beside the pattern in the d = 3 modes; joint mode and the
    # 128 x 128 detector without it.
    assert rl.loop_residency(P, d) == (0 if case == "over_budget" else 2 if d == 3 else 1)
    tangent = {"orientation": rl.tangent_orientation, "pc": rl.tangent_projection_center,
               "joint": rl.tangent_orientation_projection_center}[mode]
    before = (wrapper.launches, tangent.launches)
    got = wrapper(x0, *args, **kw)
    torch.cuda.synchronize()
    assert (wrapper.launches, tangent.launches) == (before[0] + 1, before[1])
    ref = plain(x0, *args, **kw)
    assert [tuple(t.shape) for t in got] == [(n, d), (n,), (n,), (n,), (n,)]
    assert torch.equal(got.n_evals, got.n_iter + 1)
    assert int(got.n_iter.max()) <= kw["max_iters"]
    if case == "flat":
        # Every value NaN: each point rejects six steps and stalls at its start.
        assert bool(torch.isnan(got.fun).all()) and bool(torch.isnan(ref.fun).all())
        assert bool((got.n_iter == 6).all()) and bool(got.converged.all()) and bool((got.x == 0).all())
        assert torch.equal(ref.n_iter, got.n_iter) and torch.equal(ref.converged, got.converged)
        return
    shares = _lm_loop_agreement(mode, got, ref, args[0])
    same = float(((got.x == ref.x).all(1) & (got.fun == ref.fun)).float().mean())
    print(f"{mode} {case} (n={n}): {shares}, bit for bit {same:.4f}, iterations mean "
          f"{float(got.n_iter.float().mean()):.2f} (host {float(ref.n_iter.float().mean()):.2f}), max |dfun| "
          f"{float((got.fun - ref.fun).abs().max()):.2e}")
    assert bool(torch.isfinite(got.fun).all())
    assert shares["n_iter"] >= 0.9 and all(v >= 0.99 for k, v in shares.items() if k != "n_iter")


@pytest.mark.parametrize("mode", ["orientation", "pc", "joint"])
def test_lm_loop_trial_point_rounds_as_pytorch(cuda, mode):
    # The kernel's rotation and PC at a trial point are the wrapper's
    # PyTorch operations on the card bit for bit (exp_map's sum of squares
    # over a last axis of 3 added as (h0^2 + h2^2) + h1^2).
    from kikuchipy_tpu_torch.ops import refine_lm as rl

    n = 8192
    rng = np.random.default_rng(76)
    q0 = rng.normal(size=(n, 4))
    q0 = torch.as_tensor(q0 / np.linalg.norm(q0, axis=1, keepdims=True), dtype=torch.float32, device=cuda)
    pc0 = torch.as_tensor(np.asarray([0.42, 0.28, 0.5]) + rng.normal(scale=0.01, size=(n, 3)), dtype=torch.float32,
                          device=cuda)
    d = 6 if mode == "joint" else 3
    x = torch.as_tensor(rng.normal(size=(n, d)) * np.repeat([1e-3, 1e-2, 0.05, 0.5], n // 4)[:, None],
                        dtype=torch.float32, device=cuda)
    q, pc = rl.trial_point(mode, q0, pc0, x)
    if mode != "pc":
        assert torch.equal(q, rl._rotation(q0, x[:, :3].contiguous()))
    if mode != "orientation":
        assert torch.equal(pc, pc0 + x[:, -3:])


def test_lm_loop_launcher_refuses_what_it_cannot_take(cuda):
    from kikuchipy_tpu_torch.ops import refine_lm as rl

    wrapper, _, x0, args, kw = _lm_loop_inputs(cuda, "joint", "flat")
    with pytest.raises(TypeError):
        wrapper(x0.double(), *args, **kw)
    with pytest.raises(ValueError, match="one device"):
        wrapper(x0, args[0].cpu(), *args[1:], **kw)
    with pytest.raises(ValueError, match="blocks"):
        wrapper(x0, *args, max_iters=3, blocks=((6, 0.1),))
    fn = rl._function("refine_lm_loop")
    out = torch.zeros(64, device=cuda)
    p = out.data_ptr()
    stream = torch.cuda.current_stream().cuda_stream
    om = (ctypes.c_float * 9)(*([0.0] * 9))
    norms = (ctypes.c_float * 2)(0.1, 0.1)

    def call(mode=2, pc0=p, dc=p, pix=p, n=1, P=3600, max_iters=3, n_blocks=2, x=p):
        return fn(mode, p, p, pc0, dc, 0, pix, om, p, p, x, p, p, p, p, p, n, P, 101, 101, 50.0, 1.0, -1.0,
                  1.0 / 60, 1.0 / 60, max_iters, 1e-6, 1e-3, n_blocks, norms, 1, stream)

    assert call(mode=3) != 0 and call(mode=-1) != 0 and call(n=0) != 0 and call(P=0) != 0
    assert call(max_iters=-1) != 0 and call(n_blocks=3) != 0 and call(mode=0, n_blocks=2) != 0
    assert call(mode=0, dc=0) != 0 and call(mode=1, pc0=0) != 0 and call(pix=0) != 0 and call(x=0) != 0


@pytest.mark.parametrize("mode", ["orientation", "pc", "joint"])
def test_lm_loop_kernel_in_refine_calls_with_a_navigation_mask_and_per_point_pcs(cuda, mode, monkeypatch):
    # refine_*(method="lm") on an 8 x 8 scan with a navigation mask (and, in
    # orientation mode, one PC a point): one launch of the loop kernel a
    # call, against the same call with the mode's LM wrapper swapped for its
    # host loop on kernel C, by the criterion above; masked points keep their
    # start.
    from kikuchipy_tpu_torch import EBSD, EBSDMasterPattern
    from kikuchipy_tpu_torch.crystallography.crystal_map import CrystalMap
    from kikuchipy_tpu_torch.crystallography.sampling import super_fibonacci
    from kikuchipy_tpu_torch.geometry import quaternion as tq
    from kikuchipy_tpu_torch.indexing import refinement as tr
    from kikuchipy_tpu_torch.ops import refine_lm as rl

    master, _, _, _, det = _projection_state(cuda)
    n = 64
    truth = super_fibonacci(n * 7)[::7][:n]
    axes = torch.as_tensor(np.random.default_rng(77).normal(size=(n, 3)))
    start = tq.multiply(tq.from_axis_angle(axes, np.deg2rad(1.5)), torch.as_tensor(truth)).numpy()
    pcs = np.asarray(det.pc).reshape(3) + (np.random.default_rng(78).random((n, 3)) - 0.5) * 0.02
    det_pp = dataclasses.replace(det, pc=pcs.reshape(8, 8, 3))
    mp = EBSDMasterPattern(master, device=cuda)
    sim_det = det_pp if mode == "orientation" else det
    signal = EBSD(mp.get_patterns(truth, det).data.reshape(8, 8, 60, 60), detector=sim_det, device=cuda)
    nav_mask = np.zeros((8, 8), dtype=bool)
    nav_mask[::3, 1::2] = True
    name, wrapper, plain, kw = {
        "orientation": ("refine_orientation", rl.levenberg_marquardt_orientation,
                        rl.levenberg_marquardt_orientation_plain, dict(xmap=CrystalMap(rotations=start, shape=(8, 8)),
                                                                       detector=det_pp)),
        "pc": ("refine_projection_center", rl.levenberg_marquardt_projection_center,
               rl.levenberg_marquardt_projection_center_plain,
               dict(xmap=CrystalMap(rotations=truth, shape=(8, 8)),
                    detector=dataclasses.replace(det, pc=np.asarray(det.pc).reshape(3) + [0.01, -0.01, 0.01]))),
        "joint": ("refine_orientation_projection_center", rl.levenberg_marquardt_orientation_projection_center,
                  rl.levenberg_marquardt_orientation_projection_center_plain,
                  dict(xmap=CrystalMap(rotations=start, shape=(8, 8)),
                       detector=dataclasses.replace(det, pc=np.asarray(det.pc).reshape(3) + [0.01, -0.01, 0.01]))),
    }[mode]
    before = wrapper.launches
    got = getattr(signal, name)(master_pattern=mp, method="lm", navigation_mask=nav_mask, **kw)
    assert wrapper.launches == before + 1
    lm_attr = {"orientation": "levenberg_marquardt_orientation", "pc": "levenberg_marquardt_projection_center",
               "joint": "levenberg_marquardt_orientation_projection_center"}[mode]
    monkeypatch.setattr(tr, lm_attr, plain)
    ref = getattr(signal, name)(master_pattern=mp, method="lm", navigation_mask=nav_mask, **kw)
    assert wrapper.launches == before + 1
    keep = ~nav_mask.ravel()
    s_got, s_ref = got.xmap.prop["scores"], ref.xmap.prop["scores"]
    assert np.isnan(s_got[~keep]).all() and np.isfinite(s_got[keep]).all()
    assert (np.abs(s_got[keep] - s_ref[keep]) <= 1e-5).mean() >= 0.99
    assert (got.xmap.prop["num_evals"][keep] == ref.xmap.prop["num_evals"][keep]).mean() >= 0.9
    np.testing.assert_array_equal(got.xmap.best_rotations[~keep], kw["xmap"].best_rotations[~keep])
    a, b = got.xmap.best_rotations[keep].astype(np.float64), ref.xmap.best_rotations[keep].astype(np.float64)
    a, b = a / np.linalg.norm(a, axis=1, keepdims=True), b / np.linalg.norm(b, axis=1, keepdims=True)
    ang = np.degrees(2 * np.arccos(np.clip(np.abs((a * b).sum(1)), 0, 1)))
    assert (ang <= 0.05).mean() >= 0.99
    if mode != "orientation":
        dp = np.abs(got.detector.pc.reshape(-1, 3)[keep] - ref.detector.pc.reshape(-1, 3)[keep]).max(1)
        assert (dp <= 1e-4).mean() >= 0.99


@pytest.mark.parametrize("mode", ["orientation", "pc", "joint"])
def test_loop_residency_keeps_the_row_where_the_card_keeps_the_blocks(cuda, mode):
    # loop_residency (ops/refine_lm.py) keeps the point's experimental row
    # beside its pattern and tangents only where that leaves as many blocks
    # of the loop kernel an SM: its model of the SM's shared memory against
    # the card's own count (cudaOccupancyMaxActiveBlocksPerMultiprocessor,
    # registers included) at the main path's 60 x 60 pixels.
    from kikuchipy_tpu_torch.ops import refine_lm as rl

    d = 6 if mode == "joint" else 3
    blocks = {plan: rl.kernel_attributes("loop", mode, plan, 3600)["blocks_per_sm"] for plan in (0, 1, 2)}
    print(mode, blocks, {plan: rl.kernel_attributes("tangent", mode, plan, 3600) for plan in (0, 1)})
    assert min(blocks.values()) >= 1
    assert (blocks[2] == blocks[1]) == (rl.loop_residency(3600, d) == 2)


@pytest.mark.parametrize("d", [3, 6])
def test_lm_loop_solve_is_solve_ex_bit_for_bit(cuda, d):
    # The loop kernel's d x d solve (LAPACK's elimination order, each update
    # one FMA) against torch.linalg.solve_ex on damped Gauss-Newton systems of
    # the loop's kind, at damping 1e-9, 1e-3 and 1: bit for bit.
    from kikuchipy_tpu_torch.ops import refine_lm as rl

    rng = np.random.default_rng(79 + d)
    n = 4096
    jac = rng.normal(size=(n, 60, d)) * rng.random((n, 1, d)) * 10
    jtj = torch.as_tensor(np.einsum("nmp,nmq->npq", jac, jac), dtype=torch.float32, device=cuda)
    b = torch.as_tensor(rng.normal(size=(n, d)), dtype=torch.float32, device=cuda)
    diag = torch.clamp_min(torch.diagonal(jtj, dim1=1, dim2=2), 1e-12)
    for lam in (1e-9, 1e-3, 1.0):
        a = jtj + torch.full((n,), lam, device=cuda)[:, None, None] * (diag[:, :, None] * torch.eye(d, device=cuda))
        assert torch.equal(rl.solve(a, b), torch.linalg.solve_ex(a, b[..., None])[0][..., 0])


# ------------------- kernels D and E: preprocessing ------------------- #
# Kernel D (csrc/background.cu) in its static mode equals its plain version
# bit for bit; its dynamic mode sums the two operator products in its own
# FMA order against cuBLAS's, so integer outputs may differ by one gray
# level, on under 1% of the pixels. Kernel E (csrc/clahe.cu) blends four
# tables where the plain version's einsum sums over every tile: one gray
# level, on under 1% of the pixels.


def _preprocess_patterns(n, shape, seed, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    yy, xx = np.indices(shape)
    base = 90 + 0.5 * yy + 60 * np.cos(xx / 6.0) * np.sin(yy / 8.0)
    data = np.clip(base[None] + rng.normal(scale=14, size=(n,) + shape), 1, 255)
    return data.astype(dtype)


def _static_background(shape):
    yy, xx = np.indices(shape)
    return (60 + 40 * np.exp(-((xx - shape[1] / 2) ** 2 + (yy - shape[0] / 2.4) ** 2) / 1100)).astype(np.float32)


def _gray_share(got, ref):
    diff = (got.to(torch.float64) - ref.to(torch.float64)).abs()
    return float(diff.max()), float((diff > 0).to(torch.float64).mean())


def _static_case(n, shape, in_dtype, content):
    """Patterns and background of a static-mode case: ``"seeded"``; ``"flat"``
    (a constant background, every other pattern constant: a range of 0, so
    NaN before the cast); ``"nonfinite"`` (zeros in the background, and NaN
    and +-inf pixels in float input or zero pixels on the background's
    zeros in integer input: inf and NaN where it is divided)."""
    data = _preprocess_patterns(n, shape, 5, in_dtype)
    bg = _static_background(shape)
    if content == "flat":
        bg = np.full(shape, 37.0, np.float32)
        data[::2] = 91
    elif content == "nonfinite":
        bg[::7, ::5] = 0.0
        if np.issubdtype(in_dtype, np.floating):
            data[::3, 0, 0] = np.nan
            data[1::3, -1, -1] = np.inf
            data[2::3, 0, -1] = -np.inf
        else:
            data[::2, ::7, ::5] = 0
    return data, bg


# The static mode's kernels (ops/background.py static_path): the warp kernel
# at 60 x 60 (225 vectors, about 7 a lane), 40 x 40 (100 vectors, 4 a lane's
# size), 80 x 80 (400 vectors, 16 a lane's size), 1 x 16 and 16 x 1 (one
# vector), with n of 1 and 13 (not a multiple of the block's 8 warps); the
# block kernel at 57 x 61 (patterns off 16-byte boundaries), 480 x 480 (past
# the registers; the image in scratch) and every other storage pair.
STATIC_SHAPES = [((60, 60), 300), ((60, 60), 13), ((60, 60), 1), ((40, 40), 300), ((80, 80), 40), ((57, 61), 300),
                 ((1, 16), 300), ((16, 1), 300), ((480, 480), 20)]


@pytest.mark.parametrize("shape, n", STATIC_SHAPES)
@pytest.mark.parametrize("operation, scale_bg", [("subtract", False), ("divide", False), ("subtract", True)])
@pytest.mark.parametrize("in_dtype, dtype_out", [(np.uint8, np.uint8), (np.uint8, np.float32),
                                                 (np.float32, np.uint16), (np.uint16, np.int16)])
@pytest.mark.parametrize("content", ["seeded", "flat", "nonfinite"])
def test_background_kernel_static_is_its_plain_version_bit_for_bit(cuda, shape, n, operation, scale_bg, in_dtype,
                                                                   dtype_out, content):
    from kikuchipy_tpu_torch.ops import background as bgk
    from kikuchipy_tpu_torch.utils.dtypes import get_dtype_range

    data, bg = _static_case(n, shape, in_dtype, content)
    p = torch.as_tensor(data, device=cuda)
    bg = torch.as_tensor(bg, device=cuda)
    omin, omax = get_dtype_range(dtype_out)
    want, _ = bgk.static_path(*shape, p.dtype, dtype_out, omin, omax, aligned=p.data_ptr() % 16 == 0)
    assert want == ("warp" if in_dtype == dtype_out == np.uint8 and shape in ((60, 60), (40, 40), (80, 80), (1, 16), (16, 1))
                    else "block")
    before = dict(bgk.remove_background.mode_launches)
    launches = bgk.remove_background.launches
    got = bgk.remove_background(p, operation, omin, omax, dtype_out, static_bg=bg, scale_bg=scale_bg)
    torch.cuda.synchronize()
    assert bgk.remove_background.launches == launches + 1
    assert bgk.remove_background.mode_launches[f"static-{want}"] == before[f"static-{want}"] + 1
    ref = bgk.remove_background_plain(p, operation, omin, omax, dtype_out, static_bg=bg, scale_bg=scale_bg)
    assert _same_bits(got, ref)


def _same_bits(got, ref) -> bool:
    """Equal bit for bit, float NaNs (whose payload IEEE leaves open) at the
    same places."""
    if got.dtype != ref.dtype or got.shape != ref.shape:
        return False
    if not got.dtype.is_floating_point:
        return torch.equal(got, ref)
    nan = torch.isnan(ref)
    as_int = {torch.float32: torch.int32, torch.float64: torch.int64}[got.dtype]
    return torch.equal(torch.isnan(got), nan) and torch.equal(got.view(as_int)[~nan], ref.view(as_int)[~nan])


def test_background_kernel_static_misaligned_and_wide_ranges_take_the_block_kernel(cuda):
    # A view that starts off a 16-byte boundary, and an output range past
    # int32's, go to the block kernel; a narrower range stays on the warp
    # kernel. All bit for bit.
    from kikuchipy_tpu_torch.ops import background as bgk

    data = torch.as_tensor(_preprocess_patterns(13, (60, 60), 11), device=cuda)
    buf = torch.empty(data.numel() + 1, dtype=torch.uint8, device=cuda)
    buf[1:].copy_(data.reshape(-1))
    bg = torch.as_tensor(_static_background((60, 60)), device=cuda)
    for p, (omin, omax), want in ((buf[1:].view(13, 60, 60), (0, 255), "block"), (data, (-3e9, 3e9), "block"),
                                  (data, (10, 200), "warp")):
        before = bgk.remove_background.mode_launches[f"static-{want}"]
        got = bgk.remove_background(p, "subtract", omin, omax, np.uint8, static_bg=bg)
        torch.cuda.synchronize()
        assert bgk.remove_background.mode_launches[f"static-{want}"] == before + 1
        assert torch.equal(got, bgk.remove_background_plain(p, "subtract", omin, omax, np.uint8, static_bg=bg))


# SHA-256 (first 16 hex digits) of kernel D's dynamic mode and kernel E on
# _fixed_scan(), as the kernels computed them before the static warp kernel
# came (commit 5959fde, NVIDIA H100 80GB HBM3): they stay the same.
FIXED_SCAN_HASHES = {"dynamic": "f2a049f9828ed357", "clahe": "496ff2d0337d6c2f"}


def _fixed_scan_hashes(device) -> dict:
    import hashlib

    from kikuchipy_tpu_torch.ops import ahe
    from kikuchipy_tpu_torch.ops import background as bgk
    from kikuchipy_tpu_torch.ops import pattern as tops

    p = torch.as_tensor(_preprocess_patterns(512, (60, 60), 21), device=device)
    plan = tops.dynamic_background_separable_plan((60, 60), 60 / 8)
    row, col = torch.as_tensor(plan.row_op, device=device), torch.as_tensor(plan.col_op, device=device)
    dyn = bgk.remove_background(p, "subtract", 0, 255, np.uint8, row_op=row, col_op=col)
    out = {"dynamic": dyn, "clahe": ahe.clahe(dyn, 15, 15, 128, 0.0, np.uint8)}
    return {k: hashlib.sha256(v.cpu().numpy().tobytes()).hexdigest()[:16] for k, v in out.items()}


def test_background_dynamic_and_clahe_outputs_are_unchanged(cuda):
    assert _fixed_scan_hashes(cuda) == FIXED_SCAN_HASHES


@pytest.mark.parametrize("shape", [(60, 60), (57, 61), (120, 120)])
@pytest.mark.parametrize("operation", ["subtract", "divide"])
@pytest.mark.parametrize("dtype_out", [np.uint8, np.float32])
def test_background_kernel_dynamic_matches_plain(cuda, shape, operation, dtype_out):
    from kikuchipy_tpu_torch.ops import background as bgk
    from kikuchipy_tpu_torch.ops import pattern as tops
    from kikuchipy_tpu_torch.utils.dtypes import get_dtype_range

    p = torch.as_tensor(_preprocess_patterns(256, shape, 6), device=cuda)
    plan = tops.dynamic_background_separable_plan(shape, shape[1] / 8)
    row, col = torch.as_tensor(plan.row_op, device=cuda), torch.as_tensor(plan.col_op, device=cuda)
    omin, omax = get_dtype_range(dtype_out)
    got = bgk.remove_background(p, operation, omin, omax, dtype_out, row_op=row, col_op=col)
    ref = bgk.remove_background_plain(p, operation, omin, omax, dtype_out, row_op=row, col_op=col)
    torch.cuda.synchronize()
    if dtype_out == np.uint8:
        worst, share = _gray_share(got, ref)
        assert worst <= 1 and share < 0.01, (worst, share)
    else:
        assert float((got - ref).abs().max()) <= 1e-5


def test_background_kernel_scratch_path_past_the_shared_memory_budget(cuda):
    # 180 x 180 in the dynamic mode passes the budget: the images go to a
    # scratch buffer and the operators are read from device memory.
    from kikuchipy_tpu_torch.ops import background as bgk
    from kikuchipy_tpu_torch.ops import pattern as tops

    shape = (180, 180)
    assert bgk.smem_bytes(*shape, True) > bgk.SMEM_BUDGET
    p = torch.as_tensor(_preprocess_patterns(40, shape, 7), device=cuda)
    plan = tops.dynamic_background_separable_plan(shape, shape[1] / 8)
    row, col = torch.as_tensor(plan.row_op, device=cuda), torch.as_tensor(plan.col_op, device=cuda)
    got = bgk.remove_background(p, "subtract", 0, 255, np.uint8, row_op=row, col_op=col)
    ref = bgk.remove_background_plain(p, "subtract", 0, 255, np.uint8, row_op=row, col_op=col)
    worst, share = _gray_share(got, ref)
    assert worst <= 1 and share < 0.01, (worst, share)


# The dynamic mode's kernels (ops/background.py dynamic_path): the pair
# kernel at 60 x 60 (8 pairs a block) with n of 300, 13 and 1 (not a
# multiple of the pairs), at 64 x 64 (7 pairs), 40 x 40 and 1 x 16; the block
# kernel at 57 x 61, 180 x 180 (the scratch path), float32 out, uint16 in and
# a view off 16-byte boundaries.
DYNAMIC_PATH_CASES = {
    "60x60 n=300": ((60, 60), 300, np.uint8, np.uint8, 0, "pair"),
    "60x60 n=13": ((60, 60), 13, np.uint8, np.uint8, 0, "pair"),
    "60x60 n=1": ((60, 60), 1, np.uint8, np.uint8, 0, "pair"),
    "64x64": ((64, 64), 40, np.uint8, np.uint8, 0, "pair"),
    "40x40": ((40, 40), 40, np.uint8, np.uint8, 0, "pair"),
    "1x16": ((1, 16), 40, np.uint8, np.uint8, 0, "pair"),
    "57x61": ((57, 61), 40, np.uint8, np.uint8, 0, "block"),
    "180x180": ((180, 180), 20, np.uint8, np.uint8, 0, "block"),
    "float32 out": ((60, 60), 40, np.uint8, np.float32, 0, "block"),
    "uint16 in": ((60, 60), 40, np.uint16, np.uint8, 0, "block"),
    "misaligned": ((60, 60), 13, np.uint8, np.uint8, 1, "block"),
}


@pytest.mark.parametrize("name", list(DYNAMIC_PATH_CASES))
@pytest.mark.parametrize("operation", ["subtract", "divide"])
def test_background_dynamic_takes_the_kernel_dynamic_path_chose(cuda, name, operation):
    # Each case's launch is counted on the path dynamic_path chose, within
    # one gray level of the plain version on under 1% of the pixels (float32
    # within 1e-5 of the range); the pair kernel's bytes are the block
    # kernel's.
    from kikuchipy_tpu_torch.ops import background as bgk
    from kikuchipy_tpu_torch.ops import pattern as tops
    from kikuchipy_tpu_torch.utils.dtypes import get_dtype_range

    shape, n, dtype_in, dtype_out, offset, want = DYNAMIC_PATH_CASES[name]
    data = _preprocess_patterns(n, shape, 13)
    if dtype_in == np.uint16:
        data = data.astype(np.uint16) * 257
    p = torch.as_tensor(data, device=cuda)
    if offset:
        buf = torch.empty(p.numel() + offset, dtype=p.dtype, device=cuda)
        buf[offset:].copy_(p.reshape(-1))
        p = buf[offset:].view(p.shape)
    plan = tops.dynamic_background_separable_plan(shape, shape[1] / 8)
    row, col = torch.as_tensor(plan.row_op, device=cuda), torch.as_tensor(plan.col_op, device=cuda)
    omin, omax = get_dtype_range(dtype_out)
    chosen, _ = bgk.dynamic_path(*shape, p.dtype, dtype_out, omin, omax, aligned=p.data_ptr() % 16 == 0)
    assert chosen == want
    before = dict(bgk.remove_background.mode_launches)
    got = bgk.remove_background(p, operation, omin, omax, dtype_out, row_op=row, col_op=col)
    torch.cuda.synchronize()
    after = bgk.remove_background.mode_launches
    assert after[f"dynamic-{want}"] == before[f"dynamic-{want}"] + 1
    assert after["dynamic"] == before["dynamic"] + 1 and sum(after.values()) == sum(before.values()) + 2
    ref = bgk.remove_background_plain(p, operation, omin, omax, dtype_out, row_op=row, col_op=col)
    if got.dtype.is_floating_point:
        assert float((got - ref).abs().max()) <= 1e-5 * (omax - omin)
    else:
        worst, share = _gray_share(got, ref)
        assert worst <= 1 and share < 0.01, (worst, share)
    if want == "pair":
        with _smoke().forced_block(bgk, "dynamic_path"):
            block = bgk.remove_background(p, operation, omin, omax, dtype_out, row_op=row, col_op=col)
        assert torch.equal(got, block)


# The CLAHE kernels (ops/ahe.py clahe_path): the pair kernel at the
# defaults of 60 x 60 (with n of 300, 13 and 1), clipping, 64 x 64, 40 x 40
# and rows wider than 64 pixels (8 x 500, 12 x 340, 4 x 1020); the block
# kernel at 7 x 7 tiles, 480 x 480 (its scratch path), uint16
# in, float32 out, 64 bins, 57 x 61 and a view off 16-byte boundaries.
CLAHE_PATH_CASES = {
    "60x60 n=300": ((60, 60), 300, np.uint8, {}, 0, "pair"),
    "60x60 n=13": ((60, 60), 13, np.uint8, {}, 0, "pair"),
    "60x60 n=1": ((60, 60), 1, np.uint8, {}, 0, "pair"),
    "clip_0.02": ((60, 60), 100, np.uint8, {"clip_limit": 0.02}, 0, "pair"),
    "64x64 clip_0.5": ((64, 64), 40, np.uint8, {"clip_limit": 0.5}, 0, "pair"),
    "40x40": ((40, 40), 40, np.uint8, {}, 0, "pair"),
    # Rows of more than 16 words: each word's row by pair_row's product.
    "8x500": ((8, 500), 37, np.uint8, {}, 0, "pair"),
    "12x340 clip_0.02": ((12, 340), 21, np.uint8, {"clip_limit": 0.02}, 0, "pair"),
    "4x1020": ((4, 1020), 19, np.uint8, {}, 0, "pair"),
    "7x7 tiles": ((60, 60), 40, np.uint8, {"kernel_size": (7, 7)}, 0, "block"),
    "480x480": ((480, 480), 4, np.uint8, {}, 0, "block"),
    "uint16 in": ((60, 60), 40, np.uint16, {}, 0, "block"),
    "float32 out": ((60, 60), 40, np.uint8, {"dtype_out": np.float32}, 0, "block"),
    "64 bins": ((60, 60), 40, np.uint8, {"nbins": 64}, 0, "block"),
    "57x61": ((57, 61), 40, np.uint8, {}, 0, "block"),
    "misaligned": ((60, 60), 13, np.uint8, {}, 1, "block"),
}


@pytest.mark.parametrize("name", list(CLAHE_PATH_CASES))
def test_clahe_takes_the_kernel_clahe_path_chose(cuda, name):
    from kikuchipy_tpu_torch.ops import ahe

    shape, n, dtype_in, kw, offset, want = CLAHE_PATH_CASES[name]
    data = _preprocess_patterns(n, shape, 14)
    if dtype_in == np.uint16:
        data = data.astype(np.uint16) * 257
    p = torch.as_tensor(data, device=cuda)
    if offset:
        buf = torch.empty(p.numel() + offset, dtype=p.dtype, device=cuda)
        buf[offset:].copy_(p.reshape(-1))
        p = buf[offset:].view(p.shape)
    sy, sx = shape
    ky, kx = kw.get("kernel_size", (sy // 4, sx // 4))
    nbins, dtype_out = kw.get("nbins", 128), kw.get("dtype_out", dtype_in)
    chosen, _ = ahe.clahe_path(sy, sx, ky, kx, nbins, p.dtype, dtype_out, aligned=p.data_ptr() % 16 == 0)
    assert chosen == want
    before = dict(ahe.clahe.mode_launches)
    got = ahe.adaptive_histogram_equalization(p, device=cuda, **kw)
    torch.cuda.synchronize()
    assert ahe.clahe.mode_launches[want] == before[want] + 1
    assert sum(ahe.clahe.mode_launches.values()) == sum(before.values()) + 1
    ref = ahe.clahe_plain(p, ky, kx, nbins, kw.get("clip_limit", 0.0), dtype_out, chunk=8)
    assert got.dtype == ref.dtype
    if got.dtype.is_floating_point:
        assert float((got - ref).abs().max()) <= 1e-5
    else:
        worst, share = _gray_share(got, ref)
        assert worst <= 1 and share < 0.01, (worst, share)
    if want == "pair":
        with _smoke().forced_block(ahe, "clahe_path"):
            block = ahe.adaptive_histogram_equalization(p, device=cuda, **kw)
        assert torch.equal(got, block)


CLAHE_GPU_CASES = {
    "defaults": (np.uint8, (60, 60), {}),
    "clip_0.02": (np.uint8, (60, 60), {"clip_limit": 0.02}),
    "reflect_pad_7x7": (np.uint8, (60, 60), {"kernel_size": (7, 7)}),
    "uint16": (np.uint16, (60, 60), {}),
    "float32_in": (np.float32, (57, 61), {"clip_limit": 0.05}),
    "float_out_bins_64": (np.uint8, (57, 61), {"nbins": 64, "dtype_out": np.float32}),
}


@pytest.mark.parametrize("name", list(CLAHE_GPU_CASES))
def test_clahe_kernel_matches_plain(cuda, name):
    from kikuchipy_tpu_torch.ops import ahe

    dtype, shape, kw = CLAHE_GPU_CASES[name]
    data = _preprocess_patterns(200, shape, 8)
    if dtype == np.uint16:
        data = data.astype(np.uint16) * 257
    p = torch.as_tensor(data.astype(dtype), device=cuda)
    before = ahe.clahe.launches
    got = ahe.adaptive_histogram_equalization(p, device=cuda, **kw)
    torch.cuda.synchronize()
    assert ahe.clahe.launches == before + 1
    sy, sx = shape
    ky, kx = kw.get("kernel_size", (sy // 4, sx // 4))
    ref = ahe.clahe_plain(p, ky, kx, kw.get("nbins", 128), kw.get("clip_limit", 0.0),
                          kw.get("dtype_out", dtype), chunk=64)
    assert got.dtype == ref.dtype
    if got.dtype.is_floating_point:
        assert float((got - ref).abs().max()) <= 1e-5
    else:
        worst, share = _gray_share(got, ref)
        assert worst <= 1 and share < 0.01, (worst, share)


def test_clahe_kernel_scratch_path_at_large_patterns(cuda):
    # 480 x 480 at the defaults: the blended values pass the budget and go to
    # a scratch buffer in device memory; only the tables stay resident.
    from kikuchipy_tpu_torch.ops import ahe

    assert ahe.clahe_smem_bytes(480, 480, 120, 120, 128) > ahe.SMEM_BUDGET
    small = torch.as_tensor(_preprocess_patterns(24, (60, 60), 10), device=cuda)
    p = small.repeat_interleave(8, dim=-2).repeat_interleave(8, dim=-1).contiguous()
    before = ahe.clahe.launches
    got = ahe.adaptive_histogram_equalization(p, device=cuda)
    torch.cuda.synchronize()
    assert ahe.clahe.launches == before + 1
    ref = ahe.clahe_plain(p, 120, 120, 128, 0.0, np.uint8, chunk=4)
    worst, share = _gray_share(got, ref)
    assert worst <= 1 and share < 0.01, (worst, share)


def test_clahe_kernel_refuses_past_its_shared_memory_budget(cuda):
    from kikuchipy_tpu_torch.ops import ahe

    p = torch.zeros((2, 240, 240), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        ahe.adaptive_histogram_equalization(p, kernel_size=(4, 4), nbins=256, device=cuda)


def test_preprocessing_on_the_card_never_reaches_the_plain_versions(cuda, monkeypatch):
    # Each removal is one launch of kernel D, CLAHE one of kernel E, and a
    # CUDA tensor never takes a plain version.
    from kikuchipy_tpu_torch import EBSD
    from kikuchipy_tpu_torch.ops import ahe
    from kikuchipy_tpu_torch.ops import background as bgk

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    monkeypatch.setattr(bgk, "remove_background_plain", refuse)
    monkeypatch.setattr(ahe, "clahe_plain", refuse)
    data = _preprocess_patterns(64, (60, 60), 9).reshape(8, 8, 60, 60)
    s = EBSD(data, static_background=_static_background((60, 60)), device=cuda)
    d0, e0 = bgk.remove_background.launches, ahe.clahe.launches
    s = s.remove_static_background()
    assert bgk.remove_background.launches == d0 + 1
    s = s.remove_dynamic_background()
    assert bgk.remove_background.launches == d0 + 2
    s = s.adaptive_histogram_equalization()
    assert ahe.clahe.launches == e0 + 1
    out = s.normalize_intensity(dtype_out=np.float32).data
    torch.cuda.synchronize()
    assert out.shape == (8, 8, 60, 60) and bool(torch.isfinite(out).all())


# ----------------------- the spherical-harmonic tier ----------------------- #
#
# No kernel of its own: the zyz rotation and the synthesis are PyTorch
# operations and library products. On the card they are held against the
# same rotation and synthesis in float64 on the CPU, at the JAX default band
# limit; "default" runs the products in TF32 only inside the call.

SH_TOL = {"highest": 1e-4, "default": 5e-3}


def _sh_quats(n, seed):
    q = np.random.default_rng(seed).normal(size=(n, 4))
    q = q / np.linalg.norm(q, axis=1, keepdims=True)
    # pure z-rotations and beta = pi: the zyz extraction's gimbal lock
    z = np.array([[np.cos(0.35), 0.0, 0.0, np.sin(0.35)], [0.0, np.cos(0.2), np.sin(0.2), 0.0]])
    return np.concatenate([q, z]).astype(np.float32)


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_spherical_project_at_l88_matches_a_float64_synthesis(cuda, precision):
    from kikuchipy_tpu_torch.geometry.quaternion import conjugate
    from kikuchipy_tpu_torch.projection import spherical as sp

    master, _, dc, _, _ = _projection_state(cuda, side=401)
    proj = sp.SphericalProjector.from_master(master, L=88, device=cuda)
    basis = proj.synthesis_basis(dc)
    q = torch.as_tensor(_sh_quats(62, 3))
    coeffs64 = proj.coeffs.double().cpu()
    ref = sp.rotate_coefficients_zyz(conjugate(q.double()), coeffs64, 88) @ sp.sh_basis(dc.cpu(), 88).T
    old = torch.backends.cuda.matmul.allow_tf32
    got = proj.project(q.to(cuda), basis, mm_precision=precision).double().cpu()
    assert torch.backends.cuda.matmul.allow_tf32 == old
    err = torch.linalg.vector_norm(got - ref, dim=1) / torch.linalg.vector_norm(ref, dim=1)
    assert bool(torch.isfinite(got).all()) and float(err.max()) <= SH_TOL[precision], float(err.max())


def test_spherical_refinement_leaves_the_tf32_flag_as_it_was(cuda):
    from kikuchipy_tpu_torch import EBSD, EBSDDetector
    from kikuchipy_tpu_torch.crystallography.crystal_map import CrystalMap
    from kikuchipy_tpu_torch.signals.master_pattern import EBSDMasterPattern

    mp = EBSDMasterPattern(_smoke().master_pattern_data(65), device=cuda)
    det = EBSDDetector(shape=(24, 24), pc=(0.42, 0.28, 0.5), sample_tilt=70)
    q = _sh_quats(8, 4).astype(np.float64)
    s = EBSD(mp.get_patterns(q, det).data, detector=det, device=cuda)
    xmap = CrystalMap(rotations=q, shape=(10,))
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        for flag in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = flag
            for fn in ("refine_orientation", "refine_projection_center", "refine_orientation_projection_center"):
                res = getattr(s, fn)(xmap=xmap, master_pattern=mp, projector="spherical", sh_L=24, method="lm",
                                     sh_precision="default", max_iters=4)
                assert np.isfinite(res.xmap.prop["scores"]).all()
                assert torch.backends.cuda.matmul.allow_tf32 is flag
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


# Kernel F (csrc/refine_population.cu), the population objective of the global
# solvers: it evaluates with the Nelder-Mead kernel's own code
# (csrc/refine_objective.cuh), so on the card its values are the objectives'
# of ops/refine_nm.py (kernel B over PyTorch's direction cosines) bit for bit,
# and within POP_TOL of its plain version (the objectives in PyTorch
# operations): kernel B's criterion, as kernel F's values are kernel B's
# objective, a float32 sum over the pixels in another order than PyTorch's;
# chip_smoke.py's [population-check] holds the same.
POP_TOL = 2e-6


# Spreads of a point's members about its start, (kind, degrees, PC units):
# chip_smoke.py POP_SPREADS (a converging population, the timed generation,
# a DE call's first population in the trust region).
POP_SPREADS = {"sigma_0.1": ("normal", 0.1, 0.001), "sigma_0.5": ("normal", 0.5, 0.005),
               "uniform_3": ("uniform", 3.0, 0.02)}


def _population_inputs(device, mode: str, case: str, M: int, spread: str = "sigma_0.5"):
    """(wrapper, objective, plain, x (n, M, d), arguments) on the Nelder-Mead
    tests' inputs, the candidates spread about the starts."""
    from kikuchipy_tpu_torch.ops import refine_nm as rn
    from kikuchipy_tpu_torch.ops import refine_population as rp

    gen = torch.Generator(device=device).manual_seed(70)
    if mode == "orientation":
        args, _ = _nm_inputs(device, case)
        x0, args = args[0], args[1:]
        fns = (rp.population_orientation, rn.orientation_objective, rp.population_orientation_plain)
    else:
        _, _, x0, args, _ = _pc_inputs(device, mode, case)
        if mode == "pc":
            fns = (rp.population_projection_center, rn.pc_objective, rp.population_projection_center_plain)
        else:
            fns = (rp.population_orientation_projection_center, rn.joint_objective,
                   rp.population_orientation_projection_center_plain)
    kind, deg, pc = POP_SPREADS[spread]
    scale = {"orientation": [np.deg2rad(deg)] * 3, "pc": [pc] * 3, "joint": [np.deg2rad(deg)] * 3 + [pc] * 3}[mode]
    scale = torch.tensor(scale, dtype=torch.float32, device=device)
    n, d = x0.shape
    if kind == "normal":
        noise = torch.randn((n, M, d), generator=gen, device=device) * scale
    else:
        noise = (torch.rand((n, M, d), generator=gen, device=device) * 2.0 - 1.0) * scale
    x = (x0[:, None, :] + noise).contiguous()
    x[:, 0] = x0  # the start is a member
    return (*fns, x, args)


@pytest.mark.parametrize("mode, case", [("orientation", "shared"), ("orientation", "masked"),
                                        ("orientation", "per_point"), ("orientation", "over_budget"),
                                        ("orientation", "one"), ("pc", "shared"), ("pc", "masked"),
                                        ("pc", "over_budget"), ("joint", "shared"), ("joint", "p1000"),
                                        ("joint", "one")])
@pytest.mark.parametrize("M", [1, 24])
def test_population_kernel_is_the_nelder_mead_objective_bit_for_bit(cuda, mode, case, M):
    from kikuchipy_tpu_torch.ops import lambert_project as lp

    wrapper, objective, plain, x, args = _population_inputs(cuda, mode, case, M)
    before = (wrapper.launches, lp.lambert_project_ncc.launches)
    got = wrapper(x, *args)
    torch.cuda.synchronize()
    assert wrapper.launches == before[0] + 1 and lp.lambert_project_ncc.launches == before[1]
    n = x.shape[0]
    assert got.shape == (n, M) and got.dtype == torch.float32 and torch.isfinite(got).all()
    want = torch.stack([objective(x[:, m].contiguous(), *args) for m in range(M)], dim=1)
    ref = plain(x, *args)
    print(f"{mode} {case} M={M}: equal to the objective on {float((got == want).float().mean()):.4f}, max |diff| "
          f"{float((got - want).abs().max()):.3e}; against the plain version {float((got - ref).abs().max()):.3e}")
    assert torch.equal(got, want)
    assert float((got - ref).abs().max()) <= POP_TOL


def test_population_kernel_refuses_what_it_cannot_take(cuda):
    from kikuchipy_tpu_torch.ops import refine_population as rp

    wrapper, _, _, x, args = _population_inputs(cuda, "orientation", "shared", 2)
    with pytest.raises(ValueError, match="must be a"):
        wrapper(x[:, :0], *args)
    with pytest.raises(TypeError, match="float32"):
        wrapper(x.double(), *args)
    with pytest.raises(ValueError, match="one device"):
        wrapper(x, args[0].cpu(), *args[1:])
    # The launcher's own checks: no candidates, or no direction cosines.
    out = torch.empty((x.shape[0], 2), device=cuda)
    fn = rp._function()
    err = fn(0, x.data_ptr(), args[0].data_ptr(), args[1].data_ptr(), args[2].data_ptr(), 0, None, None, None,
             args[3].data_ptr(), out.data_ptr(), x.shape[0], 0, args[0].shape[1], 101, 101, 50.0, 0.0, 0.0, 0.0,
             0.0, 1, 1, None, None, torch.cuda.current_stream().cuda_stream)
    assert err != 0
    err = fn(0, x.data_ptr(), args[0].data_ptr(), args[1].data_ptr(), None, 0, None, None, None, args[3].data_ptr(),
             out.data_ptr(), x.shape[0], 2, args[0].shape[1], 101, 101, 50.0, 0.0, 0.0, 0.0, 0.0, 1, 1, None, None,
             torch.cuda.current_stream().cuda_stream)
    assert err != 0
    # ... a group that is not 1, 2, 4 or 8, and a live mask without its queue.
    for group, live, queue in ((3, None, None), (16, None, None), (4, x.data_ptr(), None)):
        err = fn(0, x.data_ptr(), args[0].data_ptr(), args[1].data_ptr(), args[2].data_ptr(), 0, None, None, None,
                 args[3].data_ptr(), out.data_ptr(), x.shape[0], 2, args[0].shape[1], 101, 101, 50.0, 0.0, 0.0, 0.0,
                 0.0, 1, group, live, queue, torch.cuda.current_stream().cuda_stream)
        assert err != 0
    with pytest.raises(ValueError, match="live must be"):
        wrapper(x, *args, live=torch.ones(x.shape[0] + 1, dtype=torch.bool, device=cuda))
    with pytest.raises(ValueError, match="one device"):
        wrapper(x, *args, live=torch.ones(x.shape[0], dtype=torch.bool))


def _forced_plan(monkeypatch, group):
    """Kernel F's plan with its group forced to ``group`` (None: the plan's)."""
    from kikuchipy_tpu_torch.ops import refine_population as rp

    if group is not None:
        plan = rp.population_plan
        monkeypatch.setattr(rp, "population_plan", lambda P, M, mode="orientation": plan(P, M, mode, group))


def _hold_population(wrapper, objective, plain, x, args, live=None, label=""):
    """Kernel F against the objectives member by member (bit for bit, +inf
    where ``live`` is false) and its plain version (POP_TOL)."""
    from kikuchipy_tpu_torch.ops import lambert_project as lp

    before = (wrapper.launches, lp.lambert_project_ncc.launches)
    got = wrapper(x, *args, live=live)
    torch.cuda.synchronize()
    assert wrapper.launches == before[0] + 1 and lp.lambert_project_ncc.launches == before[1]
    n, M = x.shape[:2]
    want = torch.stack([objective(x[:, m].contiguous(), *args) for m in range(M)], dim=1)
    ref = plain(x, *args)
    dead = torch.zeros(n, dtype=torch.bool, device=x.device) if live is None else ~live
    print(f"{label}: equal to the objective on {float((got[~dead] == want[~dead]).float().mean()):.4f}; against the "
          f"plain version {float((got - ref)[~dead].abs().max()) if bool((~dead).any()) else 0.0:.3e}")
    assert got.shape == (n, M) and got.dtype == torch.float32
    assert torch.equal(got[~dead], want[~dead]) and torch.isfinite(got[~dead]).all()
    assert bool((got[dead] == torch.inf).all())
    if bool((~dead).any()):
        assert float((got - ref)[~dead].abs().max()) <= POP_TOL
    assert torch.equal(got, plain(x, *args, live=live).where(dead[:, None], got))


@pytest.mark.parametrize("mode, case", [("orientation", "shared"), ("orientation", "per_point"),
                                        ("orientation", "over_budget"), ("pc", "masked"), ("pc", "over_budget"),
                                        ("joint", "shared"), ("joint", "p1000")])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("M", [24, 65])
def test_population_kernel_every_group_is_the_nelder_mead_objective(cuda, monkeypatch, mode, case, group, M):
    # Every group the plan can choose, forced, on the resident and two-pass
    # routes; M = 65 (SHGO's) ends in a partial group.
    from kikuchipy_tpu_torch.ops import refine_population as rp

    wrapper, objective, plain, x, args = _population_inputs(cuda, mode, case, M)
    _forced_plan(monkeypatch, group)
    plan = rp.population_plan(args[0].shape[1], M, mode)
    assert plan.group == group and plan.route == ("two-pass" if case == "over_budget" else "resident")
    _hold_population(wrapper, objective, plain, x, args, label=f"{mode} {case} G={group} M={M}")


@pytest.mark.parametrize("mode", ["orientation", "pc", "joint"])
@pytest.mark.parametrize("spread", list(POP_SPREADS))
@pytest.mark.parametrize("group", [None, 1, 8])
def test_population_kernel_at_every_spread(cuda, monkeypatch, mode, spread, group):
    wrapper, objective, plain, x, args = _population_inputs(cuda, mode, "shared", 24, spread)
    _forced_plan(monkeypatch, group)
    _hold_population(wrapper, objective, plain, x, args, label=f"{mode} {spread} G={group}")


@pytest.mark.parametrize("mode", ["orientation", "pc", "joint"])
@pytest.mark.parametrize("mask", ["none", "alternate", "all_false", "one"])
@pytest.mark.parametrize("group", [None, 1, 8])
def test_population_kernel_live_masks(cuda, monkeypatch, mode, mask, group):
    # Points that are not live get +inf and nothing of them is read; the
    # live points' values are the unmasked launch's; the queue is left zero
    # for the next launch, whatever the mask.
    from kikuchipy_tpu_torch.ops import refine_population as rp

    wrapper, objective, plain, x, args = _population_inputs(cuda, mode, "shared", 16)
    _forced_plan(monkeypatch, group)
    n = x.shape[0]
    live = {"none": None, "alternate": torch.arange(n, device=cuda) % 2 == 1,
            "all_false": torch.zeros(n, dtype=torch.bool, device=cuda),
            "one": torch.arange(n, device=cuda) == n - 1}[mask]
    _hold_population(wrapper, objective, plain, x, args, live, label=f"{mode} live {mask} G={group}")
    for _ in range(2):  # twice: the queue set back to zero
        got = wrapper(x, *args, live=live)
        assert torch.equal(got, wrapper(x, *args, live=live))
    if live is not None:
        assert torch.equal(rp._queue(x.device), torch.zeros(2, dtype=torch.int32, device=cuda))
        full = wrapper(x, *args)
        assert torch.equal(got[live], full[live]) and bool((got[~live] == torch.inf).all())


@pytest.mark.parametrize("mode", ["orientation", "pc", "joint"])
def test_de_with_the_live_mask_is_de_without_it_on_the_card(cuda, mode):
    # Differential evolution on kernel F with each generation's live mask
    # and with an evaluation that ignores it: the same run, bit for bit.
    from kikuchipy_tpu_torch.utils import optimize as topt

    wrapper, _, _, x, args = _population_inputs(cuda, mode, "shared", 1)
    x0 = x[:, 0]
    half = {"orientation": [np.deg2rad(3.0)] * 3, "pc": [0.02] * 3, "joint": [np.deg2rad(3.0)] * 3 + [0.02] * 3}[mode]
    half = torch.tensor(half, dtype=torch.float32, device=cuda)
    M = {"orientation": 24, "pc": 16, "joint": 16}[mode]
    shares = []

    def masked(x, live=None):
        if live is not None:
            shares.append(float(live.float().mean()))
        return wrapper(x, *args, live=live)

    runs = [topt._differential_evolution(fn, x0 - half, x0 + half, x0, M, 60, 0.02, 0.8, 0.9, 1)
            for fn in (masked, lambda x, live=None: wrapper(x, *args))]
    print(f"{mode}: live share by generation {[round(v, 3) for v in shares]}")
    for field in ("x", "fun", "n_iter", "converged"):
        assert torch.equal(getattr(runs[0], field), getattr(runs[1], field)), field
    assert any(0.0 < v < 1.0 for v in shares)


@pytest.mark.parametrize("fn", ["refine_orientation", "refine_projection_center",
                                "refine_orientation_projection_center"])
def test_global_refinement_on_the_card_goes_through_kernel_f_and_the_nelder_mead_kernel(cuda, fn):
    # A 64-point scan projected by kernel A at known orientations, refined
    # from 1 degree off (and the PC off by (0.01, -0.01, 0.01)) with each
    # global method: populations and candidate sets are launches of kernel
    # F, local minimizations launches of the Nelder-Mead kernel, kernel B
    # never runs. SHGO draws nothing and matches the CPU's run; the others
    # draw from another generator on each device, and are held to the truth
    # in orientation mode.
    from kikuchipy_tpu_torch import EBSD, EBSDMasterPattern
    from kikuchipy_tpu_torch.crystallography.crystal_map import CrystalMap
    from kikuchipy_tpu_torch.crystallography.sampling import disorientation_angle, super_fibonacci
    from kikuchipy_tpu_torch.geometry import quaternion as tq
    from kikuchipy_tpu_torch.ops import lambert_project as lp
    from kikuchipy_tpu_torch.ops import refine_nm as rn
    from kikuchipy_tpu_torch.ops import refine_population as rp

    master, _, _, _, det = _projection_state(cuda)
    truth = super_fibonacci(64 * 7)[::7][:64]
    axes = torch.as_tensor(np.random.default_rng(48).normal(size=(64, 3)))
    start = tq.multiply(tq.from_axis_angle(axes, np.deg2rad(1.0)), torch.as_tensor(truth)).numpy()
    bad = dataclasses.replace(det, pc=np.asarray([0.42, 0.28, 0.5]) + [0.01, -0.01, 0.01])
    mode = {"refine_orientation": "orientation", "refine_projection_center": "pc"}.get(fn, "joint")
    wrapper = {"orientation": rp.population_orientation, "pc": rp.population_projection_center,
               "joint": rp.population_orientation_projection_center}[mode]
    nm = {"orientation": rn.nelder_mead_orientation, "pc": rn.nelder_mead_projection_center,
          "joint": rn.nelder_mead_orientation_projection_center}[mode]
    trust = {"orientation": [2.0] * 3, "pc": [0.02] * 3, "joint": [2.0] * 3 + [0.02] * 3}[mode]
    kw = dict(xmap=CrystalMap(rotations=truth if mode == "pc" else start), master_pattern=None, trust_region=trust,
              max_iters=20)
    if mode != "orientation":
        kw["detector"] = bad
    results = {}
    for dev in ("cpu", cuda):
        mp = EBSDMasterPattern(master, device=dev)
        signal = EBSD(mp.get_patterns(truth, det).data, detector=det, device=dev)
        for method in ("de", "da", "bh", "shgo") if dev != "cpu" else ("shgo",):
            before = (wrapper.launches, nm.launches, lp.lambert_project_ncc.launches)
            res = getattr(signal, fn)(method=method, **dict(kw, master_pattern=mp))
            after = (wrapper.launches, nm.launches, lp.lambert_project_ncc.launches)
            on_card = str(dev) != "cpu"
            assert after[2] == before[2]
            assert (after[0] > before[0]) == (on_card and method != "bh") and (after[1] > before[1]) == on_card
            results[(str(dev), method)] = res
            assert np.isfinite(res.xmap.prop["scores"]).all()
    ang = np.degrees(disorientation_angle(results[("cpu", "shgo")].xmap.best_rotations,
                                          results[("cuda", "shgo")].xmap.best_rotations, "m-3m"))
    ds = np.abs(results[("cpu", "shgo")].xmap.prop["scores"] - results[("cuda", "shgo")].xmap.prop["scores"])
    print(f"{fn} shgo: card against CPU max angle {ang.max():.4f} deg, max |dscore| {ds.max():.2e}")
    assert ang.max() < 0.05 and ds.max() < 1e-4
    for method in ("de", "da", "bh", "shgo"):
        if mode == "orientation":
            to_truth = np.degrees(disorientation_angle(truth, results[("cuda", method)].xmap.best_rotations, "m-3m"))
            assert to_truth.max() < 0.8, (method, to_truth.max())


# ------------------- kernel G: neighbour averaging ------------------- #

NEIGHBOUR_WINDOWS = {
    "circular": dict(window="circular", window_shape=(3, 3)),
    "rectangular_2x3": dict(window="rectangular", window_shape=(2, 3)),
    "gaussian_std2": dict(window="gaussian", window_shape=(3, 3), std=2),
    "1d_on_2d": dict(window=None, window_shape=(3,)),
    "ndarray": dict(window=np.array([[0.5, 1.0, 0.0], [1.0, 2.0, 1.0], [0.0, 0.25, 3.0]])),
}
NEIGHBOUR_DTYPES = (np.uint8, np.uint16, np.float32)


def _neighbour_scan(nav, sig, dtype, seed):
    rng = np.random.default_rng(seed)
    shape = tuple(nav) + tuple(sig)
    if dtype == np.float32:
        data = rng.normal(size=shape).astype(np.float32)
        if data.size > 8:
            data.reshape(-1)[[1, 5]] = [np.inf, np.nan]
    else:
        data = rng.integers(0, np.iinfo(dtype).max, size=shape, endpoint=True).astype(dtype)
    if nav[0] * nav[1] > 2:
        data[0, 0] = data.reshape(-1)[0]  # a flat pattern: its range is 0
    return data


@pytest.mark.parametrize("nav", [(1, 1), (1, 7), (7, 1), (3, 3), (128, 128)])
@pytest.mark.parametrize("sig", [(60, 60), (1, 16)])
@pytest.mark.parametrize("dtype_in", NEIGHBOUR_DTYPES)
@pytest.mark.parametrize("dtype_out", NEIGHBOUR_DTYPES)
def test_neighbours_kernel_is_its_plain_version_bit_for_bit(cuda, nav, sig, dtype_in, dtype_out):
    from kikuchipy_tpu_torch.ops import neighbours as ng

    p = torch.as_tensor(_neighbour_scan(nav, sig, dtype_in, seed=nav[0] * 7 + sig[1]), device=cuda)
    for name, kw in NEIGHBOUR_WINDOWS.items():
        kw = dict(kw)
        w = ng._resolve_window(kw.pop("window"), kw.pop("window_shape", (3, 3)), **kw)
        offsets, weights = ng.window_taps(w)
        before = ng.average_neighbours.launches
        got = ng.average_neighbours(p, offsets, weights, dtype_out)
        torch.cuda.synchronize()
        assert ng.average_neighbours.launches == before + 1, name
        ref = ng.average_neighbours_plain(p, offsets, weights, dtype_out)
        assert _same_bits(got, ref), name


def test_neighbours_entry_point_launches_once_and_identity_windows_launch_none(cuda):
    from kikuchipy_tpu_torch.ops import neighbours as ng

    p = torch.as_tensor(_neighbour_scan((4, 5), (60, 60), np.uint8, 3), device=cuda)
    before = ng.average_neighbours.launches
    got = ng.average_neighbour_patterns(p, window="gaussian", std=2)
    assert ng.average_neighbours.launches == before + 1
    ref = ng.average_neighbours_plain(p, *ng.window_taps(ng._resolve_window("gaussian", (3, 3), std=2)), np.uint8)
    assert torch.equal(got, ref)
    for w in (np.ones((1, 1)), np.ones(1)):
        assert ng.average_neighbour_patterns(p, window=w) is p
    assert ng.average_neighbours.launches == before + 1


def test_neighbours_kernel_refuses_what_it_cannot_hold(cuda):
    # Only a storage type it has no conversion for: windows past 128 taps go
    # through the device table and patterns past the shared-memory budget
    # through the device-memory scratch, both bit for bit.
    from kikuchipy_tpu_torch.ops import neighbours as ng

    p = torch.zeros((2, 2, 8, 8), dtype=torch.uint8, device=cuda)
    before = ng.average_neighbours.launches
    with pytest.raises(TypeError, match="kernel G"):
        ng.average_neighbour_patterns(p.to(torch.int64))
    assert ng.average_neighbours.launches == before
    for data, window in ((_neighbour_scan((2, 2), (8, 8), np.uint8, 4), np.ones((12, 12))),
                         (_neighbour_scan((2, 2), (250, 250), np.uint8, 6), None),
                         (_neighbour_scan((2, 3), (240, 240), np.uint8, 5), None)):
        data = torch.as_tensor(data, device=cuda)
        got = ng.average_neighbour_patterns(data, window=window)
        w = ng._resolve_window(window, (3, 3))
        assert torch.equal(got, ng.average_neighbours_plain(data, *ng.window_taps(w), np.uint8))
    assert ng.average_neighbours.launches == before + 3


@pytest.mark.parametrize("nav", [(1, 1), (3, 5), (16, 16)])
@pytest.mark.parametrize("dtype_in, dtype_out", [(np.uint8, np.uint8), (np.uint16, np.float32),
                                                 (np.float32, np.uint8)])
def test_neighbours_kernel_takes_patterns_past_the_shared_memory_budget(cuda, nav, dtype_in, dtype_out):
    # 480 x 480 float32 averages (921,600 bytes) live in the device-memory
    # scratch; with a 13 x 13 window its taps come from the device table too.
    from kikuchipy_tpu_torch.ops import neighbours as ng
    from kikuchipy_tpu_torch.ops.pattern_io import SMEM_BUDGET

    assert 4 * 480 * 480 > SMEM_BUDGET
    p = torch.as_tensor(_neighbour_scan(nav, (480, 480), dtype_in, seed=nav[1]), device=cuda)
    for window, shape, kw in (("circular", (3, 3), {}), ("gaussian", (13, 13), {"std": 3})):
        offsets, weights = ng.window_taps(ng._resolve_window(window, shape, **kw))
        before = ng.average_neighbours.launches
        got = ng.average_neighbours(p, offsets, weights, dtype_out)
        torch.cuda.synchronize()
        assert ng.average_neighbours.launches == before + 1
        assert _same_bits(got, ng.average_neighbours_plain(p, offsets, weights, dtype_out)), (window, shape)


@pytest.mark.parametrize("window, shape, kw", [("rectangular", (13, 13), {}), ("gaussian", (13, 13), {"std": 2}),
                                               ("circular", (15, 15), {}), ("rectangular", (1, 129), {})])
@pytest.mark.parametrize("nav", [(1, 1), (7, 9), (128, 128)])
def test_neighbours_kernel_takes_windows_past_128_taps(cuda, window, shape, kw, nav):
    from kikuchipy_tpu_torch.ops import neighbours as ng

    offsets, weights = ng.window_taps(ng._resolve_window(window, shape, **kw))
    assert len(weights) > ng.MAX_TAPS
    for dtype in NEIGHBOUR_DTYPES:
        p = torch.as_tensor(_neighbour_scan(nav, (60, 60), dtype, seed=len(weights)), device=cuda)
        before = ng.average_neighbours.launches
        got = ng.average_neighbours(p, offsets, weights, dtype)
        torch.cuda.synchronize()
        assert ng.average_neighbours.launches == before + 1
        assert _same_bits(got, ng.average_neighbours_plain(p, offsets, weights, dtype)), (window, shape, dtype)


# Kernel G's instantiations (csrc/neighbours.cu): the integer route (uint8,
# weights of 1), the float64 route at 5, 9 and any tap count, on
# the vector kernel, and the general kernel where a pattern is no whole number
# of 16-byte vectors or the data is not aligned to them; negative weights too.
NEIGHBOUR_ROUTE_WINDOWS = {
    "circular, 5 taps of 1": np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], dtype=float),
    "rectangular 3x3, 9 taps of 1": np.ones((3, 3)),
    "5 taps, 2 and 3": np.array([[0, 2, 0], [3, 1, 2], [0, 1, 0]], dtype=float),
    "5 taps, fractions": np.array([[0, 0.25, 0], [1.5, 1.0, 0.75], [0, 0.5, 0]]),
    "5 taps, negative": np.array([[0, -1.0, 0], [2.0, 3.0, -0.5], [0, 1.25, 0]]),
    "9 taps, negative": np.array([[-0.5, 1, 2], [1, 4, -1.25], [0.5, 1, -0.75]]),
    "9 taps, gaussian": "gaussian",
    "6 taps (any count)": np.array([[1, 2, 0], [1, 1, 1], [0, 0, 1]], dtype=float),
    "3 taps, negative (any count)": np.array([[0, 0, 0], [-1.0, 2.5, 0.5], [0, 0, 0]]),
}


def _route_window(w):
    from kikuchipy_tpu_torch.ops import neighbours as ng

    return ng._resolve_window("gaussian", (3, 3), std=1.5) if isinstance(w, str) else w


@pytest.mark.parametrize("nav", [(1, 9), (9, 1), (6, 7)])
@pytest.mark.parametrize("sig", [(60, 60), (16, 16), (5, 6), (7, 9)])
@pytest.mark.parametrize("dtype_in", NEIGHBOUR_DTYPES)
@pytest.mark.parametrize("dtype_out", NEIGHBOUR_DTYPES)
def test_neighbours_routes_and_instantiations_are_the_plain_version_bit_for_bit(cuda, nav, sig, dtype_in, dtype_out):
    # Every instantiation the plan picks, and the general kernel where a
    # pattern (5 x 6, 7 x 9) is no whole number of 16-byte vectors of the
    # input type; each call on the route neighbours_plan names.
    from kikuchipy_tpu_torch.ops import neighbours as ng

    p = torch.as_tensor(_neighbour_scan(nav, sig, dtype_in, seed=nav[0] + 3 * sig[0]), device=cuda)
    for name, w in NEIGHBOUR_ROUTE_WINDOWS.items():
        offsets, weights = ng.window_taps(_route_window(w))
        plan = ng.neighbours_plan(p.dtype, torch_dtype_of(dtype_out), sig[0] * sig[1], weights, 16, 16)
        size = np.dtype(dtype_in).itemsize
        assert (plan.route == "vector") == ((sig[0] * sig[1] * size) % 16 == 0), (name, plan)
        before = dict(ng.average_neighbours.mode_launches)
        got = ng.average_neighbours(p, offsets, weights, dtype_out)
        torch.cuda.synchronize()
        assert ng.average_neighbours.mode_launches[plan.route] == before[plan.route] + 1, (name, plan)
        assert _same_bits(got, ng.average_neighbours_plain(p, offsets, weights, dtype_out)), (name, plan)


def torch_dtype_of(dtype):
    return {np.uint8: torch.uint8, np.uint16: torch.uint16, np.float32: torch.float32}[dtype]


@pytest.mark.parametrize("dtype, offset", [(np.uint8, 1), (np.uint8, 8), (np.uint16, 2), (np.uint16, 6),
                                           (np.float32, 4), (np.float32, 8)])
def test_neighbours_misaligned_input_takes_the_general_kernel_bit_for_bit(cuda, dtype, offset):
    # A contiguous scan whose data starts ``offset`` bytes past a 16-byte
    # boundary (a storage offset): the vector kernel's loads need 16.
    from kikuchipy_tpu_torch.ops import neighbours as ng

    size = np.dtype(dtype).itemsize
    shape = (5, 4, 60, 60)
    data = _neighbour_scan(shape[:2], shape[2:], dtype, seed=offset)
    flat = torch.zeros(data.size + 16, dtype=torch_dtype_of(dtype), device=cuda)
    p = flat[offset // size:offset // size + data.size].view(shape)
    p.copy_(torch.as_tensor(data, device=cuda))
    assert p.is_contiguous() and p.data_ptr() % 16 == offset
    for name, w in NEIGHBOUR_ROUTE_WINDOWS.items():
        offsets, weights = ng.window_taps(_route_window(w))
        before = dict(ng.average_neighbours.mode_launches)
        got = ng.average_neighbours(p, offsets, weights, dtype)
        torch.cuda.synchronize()
        assert ng.average_neighbours.mode_launches["general"] == before["general"] + 1, name
        assert _same_bits(got, ng.average_neighbours_plain(p, offsets, weights, dtype)), name


def test_neighbours_main_path_takes_the_integer_route(cuda):
    # The main path's shape on the vector kernel's integer route (24 x 31 =
    # 744 points), the Gaussian's float64 route, and the float64 route's
    # bits with the circular window scaled (weights of 0.5: another route,
    # the same function up to the scale, which the quotient removes).
    from kikuchipy_tpu_torch.ops import neighbours as ng

    p = torch.as_tensor(_neighbour_scan((24, 31), (60, 60), np.uint8, seed=5), device=cuda)
    offsets, weights = ng.window_taps(ng._resolve_window("circular", (3, 3)))
    ref = ng.average_neighbours_plain(p, offsets, weights, np.uint8)
    gauss = ng.window_taps(ng._resolve_window("gaussian", (3, 3), std=2))
    plan = ng.neighbours_plan(p.dtype, torch.uint8, 3600, weights, 16, 16)
    assert (plan.route, plan.integer, plan.taps, plan.warps) == ("vector", True, 5, 8)
    assert torch.equal(ng.average_neighbours(p, offsets, weights, np.uint8), ref)
    assert torch.equal(ng.average_neighbours(p, *gauss, np.uint8), ng.average_neighbours_plain(p, *gauss, np.uint8))
    half = [0.5 * w for w in weights]
    assert not ng.neighbours_plan(p.dtype, torch.uint8, 3600, half, 16, 16).integer
    assert torch.equal(ng.average_neighbours(p, offsets, half, np.uint8),
                       ng.average_neighbours_plain(p, offsets, half, np.uint8))


# ------------------------- kernel H (Hough voting) ------------------------- #

# Kernel H is held against its plain version by
# ``ops/hough_vote.vote_disagreements`` (the smoke's [hough-check] criterion).


def _hough_inputs(n, n_bands, n_poles, seed, outliers=0.3):
    """Band normals of ``n`` patterns: each a rotation of some of the poles
    with noise of about half a degree, a share of them replaced by random
    directions; the poles are nickel's at ``min_dspacing`` 1 (25) or random
    unit vectors, with a LUT of their interplanar angles (for many poles, of
    pairs among a subset, so the plain version's intermediates stay small)."""
    from kikuchipy_tpu_torch.crystallography.crystal_map import Phase
    from kikuchipy_tpu_torch.indexing.hough import _poles_and_lut

    rng = np.random.default_rng(seed)
    if n_poles == 25:
        ni = Phase("ni", space_group=225, lattice=(3.5236,) * 3 + (90.0,) * 3,
                   atoms=[("ni", 0, 0, 0), ("ni", 0.5, 0.5, 0), ("ni", 0.5, 0, 0.5), ("ni", 0, 0.5, 0.5)])
        g, lut_angles, lut_pairs = _poles_and_lut(ni, None, 1.0, 20.0)
        assert len(g) == 25
    elif n_poles == 1:
        g = np.array([[0.0, 0.0, 1.0]])
        lut_pairs, lut_angles = np.array([[0, 0]]), np.array([0.0])
    else:
        g = rng.normal(size=(n_poles, 3))
        g /= np.linalg.norm(g, axis=1, keepdims=True)
        sub = list(range(40)) + list(rng.choice(np.arange(40, n_poles), 40, replace=False))
        lut_pairs = np.array([(a, b) for i, a in enumerate(sub) for b in sub[i + 1:]])
        lut_angles = np.arccos(np.clip(np.abs(np.sum(g[lut_pairs[:, 0]] * g[lut_pairs[:, 1]], axis=1)), 0, 1))
    normals = np.empty((n, n_bands, 3))
    for i in range(n):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        a, b, c, d = q
        R = np.array([[a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
                      [2 * (b * c + a * d), a * a - b * b + c * c - d * d, 2 * (c * d - a * b)],
                      [2 * (b * d - a * c), 2 * (c * d + a * b), a * a - b * b - c * c + d * d]])
        pick = rng.choice(len(g), n_bands, replace=len(g) < n_bands)
        v = g[pick] @ R + rng.normal(scale=0.008, size=(n_bands, 3))
        swap = rng.random(n_bands) < outliers
        v[swap] = rng.normal(size=(int(swap.sum()), 3))
        normals[i] = v / np.linalg.norm(v, axis=1, keepdims=True)
    return normals, g, lut_angles, lut_pairs


def _hough_tensors(device, normals, g, lut_angles, lut_pairs, n_bands):
    from kikuchipy_tpu_torch.indexing.hough import _pair_index

    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)  # noqa: E731
    i32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.int32, device=device)  # noqa: E731
    return f32(normals), f32(g), f32(lut_angles), i32(lut_pairs), i32(_pair_index(n_bands))


def _hough_agree(got, ref, args, tol, n_pairs_max=8, chunk=1024):
    from kikuchipy_tpu_torch.ops.hough_vote import vote_disagreements

    bad, stats = vote_disagreements(got, ref, *args, tol, n_pairs_max=n_pairs_max, chunk=chunk)
    assert bad == [], bad
    return stats


@pytest.mark.parametrize("n", [1, 33, 1025])
@pytest.mark.parametrize("n_poles", [1, 25, 3000])
def test_hough_vote_kernel_matches_its_plain_version(cuda, n, n_poles):
    from kikuchipy_tpu_torch.ops import hough_vote as hv

    tol = float(np.deg2rad(2.0))
    for n_bands in (3, 6, 9, 12):
        for n_pairs_max in (1, 8):
            args = _hough_tensors(cuda, *_hough_inputs(n, n_bands, n_poles, seed=n + n_bands), n_bands=n_bands)
            before = hv.vote_orientations.launches
            got = hv.vote_orientations(*args, tol, n_pairs_max=n_pairs_max)
            torch.cuda.synchronize()
            assert hv.vote_orientations.launches == before + 1
            assert hv._queue(cuda).tolist() == [0, 0]  # the launch left its queue zero for the next
            chunk = 16 if n_poles == 3000 else 256
            ref = hv.vote_orientations_plain(*args, tol, n_pairs_max=n_pairs_max, chunk=chunk)
            _hough_agree(got, ref, args, tol, n_pairs_max, chunk)


def test_hough_vote_kernel_without_a_valid_candidate(cuda):
    # Parallel bands (every pair at or below 0.05 rad) and a tolerance no LUT
    # entry meets: every score is -1, and candidate 0 (pair 0, slot 0: the
    # first LUT entry by the fill rule) wins with err inf and no inlier.
    from kikuchipy_tpu_torch.ops import hough_vote as hv

    normals, g, lut_angles, lut_pairs = _hough_inputs(40, 9, 25, seed=3, outliers=0.0)
    normals[:20] = normals[:20, :1] + 1e-3 * np.random.default_rng(4).normal(size=(20, 9, 3))
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    args = _hough_tensors(cuda, normals, g, lut_angles, lut_pairs, 9)
    for tol in (float(np.deg2rad(2.0)), 1e-9):
        got = hv.vote_orientations(*args, tol)
        ref = hv.vote_orientations_plain(*args, tol)
        assert _hough_agree(got, ref, args, tol)["none_valid"] >= 20
        assert torch.isinf(got[1][:20]).all() and (got[2][:20] == 0).all()


@pytest.mark.parametrize("groups", [1, 2, 4, 8])
@pytest.mark.parametrize("n_poles", [25, 300, 1500])
def test_hough_vote_block_shapes_match_the_plain_version(cuda, monkeypatch, groups, n_poles):
    # Every block shape: 1 to 8 patterns of a warp a block where the poles
    # sit in one shared tile (25, 300), a pattern of TILE_WARPS warps where
    # they stream in tiles (1,500); pattern counts that leave groups without
    # a pattern; band counts with a scoring loop of their own (9) and
    # without (2, 13).
    from kikuchipy_tpu_torch.ops import hough_vote as hv

    monkeypatch.setattr(hv, "PATTERNS_PER_BLOCK", groups)
    tol = float(np.deg2rad(2.0))
    want = (1, hv.TILE_WARPS) if hv.pole_route(n_poles) == "tiles" else (groups, 1)
    for n, n_bands in ((1, 9), (7, 13), (45, 9), (20, 2)):
        args = _hough_tensors(cuda, *_hough_inputs(n, n_bands, n_poles, seed=n + n_poles), n_bands=n_bands)
        k = min(8, args[2].shape[0])
        assert hv.block_shape(n_bands, n_poles, args[4].shape[0], k) == want
        before = hv.vote_orientations.launches
        got = hv.vote_orientations(*args, tol)
        torch.cuda.synchronize()
        assert hv.vote_orientations.launches == before + 1
        _hough_agree(got, hv.vote_orientations_plain(*args, tol, chunk=64), args, tol, chunk=64)


def _symmetric_hough_inputs(n, seed):
    """Poles closed under the half turn S = diag(-1, -1, 1) (6 random unit
    vectors and their images: S g is the negation of two coordinates, exact
    in float32), the LUT of all their pairs, and normals of rotated poles
    with 0.01 of noise. A candidate from LUT entry (a, b) and one from (S a,
    S b) score alike bit for bit in both versions (the products of one are
    the other's negated), so every pattern's best has a twin of another
    index, a rotation apart."""
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(6, 3))
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    g = np.concatenate([g, g * [-1.0, -1.0, 1.0]]).astype(np.float32).astype(np.float64)
    pairs = np.array([(a, b) for a in range(len(g)) for b in range(a + 1, len(g))])
    lut_angles = np.arccos(np.clip(np.abs(np.sum(g[pairs[:, 0]] * g[pairs[:, 1]], axis=1)), 0, 1))
    normals = np.empty((n, 9, 3))
    for i in range(n):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        a, b, c, d = q
        R = np.array([[a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
                      [2 * (b * c + a * d), a * a - b * b + c * c - d * d, 2 * (c * d - a * b)],
                      [2 * (b * d - a * c), 2 * (c * d + a * b), a * a - b * b - c * c + d * d]])
        v = g[rng.choice(len(g), 9, replace=False)] @ R + rng.normal(scale=0.01, size=(9, 3))
        normals[i] = v / np.linalg.norm(v, axis=1, keepdims=True)
    return normals, g, lut_angles, pairs


# A planted tie is held where the third best score is below the two by more
# than this (scores of the kernel and the plain version differ by under 1e-5
# at these inputs' 0.014 rad misfits: vote_disagreements' err limit / 10).
PLANTED_GAP = 5e-5


@pytest.mark.parametrize("patterns, copies", [(4, 1), (1, 1), (4, 93)])
def test_hough_vote_planted_equal_scores_take_the_lowest_index(cuda, monkeypatch, patterns, copies):
    # Where the plain version's two best scores are equal bit for bit (a
    # planted twin) and the third is clearly below, the kernel's R is the
    # plain version's: the lower flattened index of the two, as jnp.argmax.
    # 93 copies of the 12 poles (1,116: the same maxima, so the same scores)
    # take the tile route, a pattern's candidates over TILE_WARPS warps.
    from kikuchipy_tpu_torch.ops import hough_vote as hv

    monkeypatch.setattr(hv, "PATTERNS_PER_BLOCK", patterns)
    tol = float(np.deg2rad(2.0))
    normals, g, lut_angles, lut_pairs = _symmetric_hough_inputs(128, seed=9)
    args = _hough_tensors(cuda, normals, np.tile(g, (copies, 1)), lut_angles, lut_pairs, n_bands=9)
    assert hv.pole_route(args[1].shape[0]) == ("tiles" if copies > 1 else "shared")
    got = hv.vote_orientations(*args, tol)
    ref = hv.vote_orientations_plain(*args, tol, chunk=32)
    _hough_agree(got, ref, args, tol, chunk=32)
    R_all, _, _, scores = hv.candidate_scores(*args, tol)
    top = torch.topk(scores, 3, dim=1).values
    planted = (top[:, 0] == top[:, 1]) & (top[:, 1] - top[:, 2] > PLANTED_GAP)
    assert int(planted.sum()) >= 16, int(planted.sum())
    twin = torch.argsort(-scores, dim=1, stable=True)[:, :2]
    assert bool((twin[planted, 0] < twin[planted, 1]).all())
    R_twin = torch.take_along_dim(R_all, twin[:, 1, None, None, None], dim=1)[:, 0]
    diff = (got[0] - ref[0]).abs().amax(dim=(1, 2))
    assert float(diff[planted].max()) <= hv.R_TOL
    # The twin is another rotation: the kernel did not take it.
    assert float((got[0] - R_twin).abs().amax(dim=(1, 2))[planted].min()) > 0.1


def test_hough_vote_kernel_refuses_what_it_cannot_take(cuda):
    from kikuchipy_tpu_torch.ops import hough_vote as hv

    args = list(_hough_tensors(cuda, *_hough_inputs(4, 9, 3000, seed=1), n_bands=9))
    assert hv.smem_bytes(9, 3000, 15, args[2].shape[0]) > hv.SMEM_BUDGET
    # The source's layout: for each pattern float4 normals, frames, angles,
    # five P x K tables, two float4 units a slot and 2 x warps + 2 reduction
    # and queue words, each rounded up to 16 bytes; then the pole tile
    # (float4, at most 1,024).
    one = 144 + 544 + 64 + 5 * 480 + 32 * 120 + 16
    assert hv.smem_bytes(9, 25, 15, 8) == one + 16 * 25
    assert hv.smem_bytes(9, 25, 15, 8, 4) == 4 * one + 16 * 25
    assert hv.smem_bytes(9, 3000, 15, 8) == one - 16 + 16 * -(-(2 * hv.TILE_WARPS + 2) * 4 // 16) + 16 * 1024
    before = hv.vote_orientations.launches
    with pytest.raises(TypeError, match="kernel H"):
        hv.vote_orientations(args[0].double(), *args[1:], 0.03)
    with pytest.raises(ValueError, match="one device"):
        hv.vote_orientations(args[0], args[1].cpu(), *args[2:], 0.03)
    with pytest.raises(ValueError, match="shared memory"):
        hv.vote_orientations(*args, 0.03, n_pairs_max=10**6)
    assert hv.vote_orientations.launches == before


# ------------------- reading files and lazy scans on the card ------------------- #


def _nordif_file(tmp_path, shape=(12, 10, 60, 60), seed=0):
    data = np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)
    path = tmp_path / "Pattern.dat"
    data.tofile(path)
    return path, data


def test_load_places_the_patterns_on_the_card(cuda, tmp_path):
    import warnings

    import kikuchipy_tpu_torch as kt

    path, data = _nordif_file(tmp_path)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # no Setting.txt, no background
        s = kt.load(path, scan_size=(10, 12), pattern_size=(60, 60))
        lazy = kt.load(path, scan_size=(10, 12), pattern_size=(60, 60), lazy=True)
    assert s.data.device.type == "cuda" and s.device.type == "cuda" and lazy.device.type == "cuda"
    assert np.array_equal(s.data.cpu().numpy(), data)
    out = lazy.compute()
    assert out.data.device.type == "cuda" and torch.equal(out.data, s.data)


@pytest.mark.parametrize("shape", [(7, 60, 60), (3000, 40, 33), (1, 5, 5)])
def test_to_device_and_the_chunk_stager_copy_bytes(cuda, shape):
    from kikuchipy_tpu_torch.utils.staging import ChunkStager, to_device

    data = np.random.default_rng(1).integers(0, 65536, shape).astype(np.uint16)
    assert np.array_equal(to_device(data, cuda).cpu().numpy(), data)
    stager = ChunkStager(5, shape[1:], np.uint16, cuda)
    for start in range(0, shape[0], 5):
        got = stager.put(data[start:start + 5])
        assert np.array_equal(got.cpu().numpy(), data[start:start + 5])
        stager.release()


@pytest.mark.parametrize("chunk_size", [100, 1024, 5000])
def test_lazy_chain_equals_the_eager_chain_on_the_card(cuda, tmp_path, chunk_size):
    import warnings

    import kikuchipy_tpu_torch as kt

    path, data = _nordif_file(tmp_path, shape=(40, 64, 60, 60))
    bg = np.random.default_rng(2).integers(20, 200, (60, 60), dtype=np.uint8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        eager = kt.load(path, scan_size=(64, 40), pattern_size=(60, 60))
        lazy = kt.load(path, scan_size=(64, 40), pattern_size=(60, 60), lazy=True)
    eager = dataclasses.replace(eager, static_background=bg)
    lazy = dataclasses.replace(lazy, static_background=bg, chunk_size=chunk_size)
    want = eager.remove_static_background().remove_dynamic_background()
    got = lazy.remove_static_background().remove_dynamic_background().compute()
    assert torch.equal(got.data, want.data)
    # With halo rows through kernel G.
    want = eager.remove_static_background().average_neighbour_patterns()
    got = lazy.remove_static_background().average_neighbour_patterns().compute()
    assert torch.equal(got.data, want.data)
    # A lazy view of a scan already on the card slices it.
    got = eager.as_lazy(chunk_size).remove_static_background().remove_dynamic_background().compute()
    assert torch.equal(got.data, eager.remove_static_background().remove_dynamic_background().data)


# ------------- kinematical simulation, PCA, virtual BSE imaging ------------- #


def _ni_reflectors(dmin):
    from kikuchipy_tpu_torch.crystallography.reciprocal import Lattice, ReciprocalLatticeVectors

    ref = ReciprocalLatticeVectors.from_min_dspacing(Lattice(3.5236, 3.5236, 3.5236, 90, 90, 90), dmin)
    ref.calculate_structure_factor([("ni", 0, 0, 0), ("ni", 0.5, 0.5, 0), ("ni", 0.5, 0, 0.5), ("ni", 0, 0.5, 0.5)])
    ref.calculate_theta(20.0)
    return ref.allowed()


@pytest.mark.parametrize("half_size", [250, 500])
def test_band_accumulation_on_the_card_keeps_the_band_edge_rule(cuda, half_size):
    # The card's master pattern and its CPU twin against the float64
    # recomputation on the same float32 inputs: equal within float32's
    # summation bound outside the pixels within 1e-6 rad of a band edge
    # (under 0.5% of them), and within twice that of each other. The grid's
    # rows and columns through the pole lie on band centers, a share of about
    # 1 / size each: at 201 pixels a side they pass 0.5%.
    from kikuchipy_tpu_torch.simulation import KikuchiPatternSimulator
    from kikuchipy_tpu_torch.simulation import kikuchi_pattern_simulator as tsim

    ref = _ni_reflectors(0.5)
    sim = KikuchiPatternSimulator(ref)
    card = sim.calculate_master_pattern(half_size=half_size, hemisphere="both", device=cuda).data
    size = 2 * half_size + 1
    rows = np.arange(0, size, 1 if half_size <= 250 else 37)
    cpu = KikuchiPatternSimulator(ref).calculate_master_pattern(half_size=half_size, hemisphere="both",
                                                               device="cpu").data if half_size <= 250 else None
    rule = _smoke().band_rule_rows(card, ref, rows)
    assert rule["bad"] == 0 and rule["uncertain"] < 0.005 * rule["pixels"], rule
    if cpu is not None:
        arr = np.linspace(-1, 1, size)
        X, Y = np.meshgrid(arr, arr)
        for h, pole in enumerate((-1, 1)):
            xyz = tsim._inverse_stereographic(X.ravel(), Y.ravel(), pole).astype(np.float32)
            want, uncertain = tsim._accumulate_bands_float64(
                xyz, ref.unit.astype(np.float32), ref.theta.astype(np.float32),
                np.abs(ref.structure_factor).astype(np.float32))
            tol = 2 * tsim._band_tolerance(want, ref.size)
            diff = np.abs(card[h].ravel().astype(np.float64) - cpu[h].ravel())
            assert (diff <= tol)[~uncertain].all()


def test_band_accumulation_blocks_do_not_change_a_pixel_on_the_card(cuda, monkeypatch):
    from kikuchipy_tpu_torch.simulation import kikuchi_pattern_simulator as tsim

    ref = _ni_reflectors(0.5)
    xyz = torch.randn(300_001, 3, generator=torch.Generator().manual_seed(5))
    xyz = (xyz / xyz.norm(dim=1, keepdim=True)).to(cuda)
    args = [torch.as_tensor(a.astype(np.float32), device=cuda)
            for a in (ref.unit, ref.theta, np.abs(ref.structure_factor))]
    whole = tsim._accumulate_bands(xyz, *args)
    monkeypatch.setattr(tsim, "_BLOCK_ELEMENTS", 4096 * ref.size)
    assert torch.equal(tsim._accumulate_bands(xyz, *args), whole)


def test_kernel_a_on_the_kinematical_master_keeps_its_yardstick(cuda):
    # A master of 1001 x 1001 a hemisphere (quad texture 2,004,002 x 4):
    # kernel A no further from the float64 twin than the float32 twin is, and
    # within 1e-4 of the range everywhere (kernel A's criterion).
    from kikuchipy_tpu_torch.geometry.detector import EBSDDetector
    from kikuchipy_tpu_torch.ops import lambert_project as lp
    from kikuchipy_tpu_torch.projection.master_pattern import direction_cosines_from_detector, quad_texture
    from kikuchipy_tpu_torch.simulation import KikuchiPatternSimulator

    smoke = _smoke()
    lam = KikuchiPatternSimulator(_ni_reflectors(0.5)).calculate_master_pattern(
        half_size=500, hemisphere="both", device=cuda).as_lambert()
    master = lam._hemispheres_at_energy()
    assert master.shape == (2, 1001, 1001)
    quad = quad_texture(torch.as_tensor(master, device=cuda))
    dc = direction_cosines_from_detector(EBSDDetector(shape=(60, 60), pc=(0.42, 0.28, 0.5), sample_tilt=70),
                                         device=cuda)
    yard = smoke.Float64Yardstick()
    for seed, rot in ((48, _quats(3000, 48, cuda)),
                      (49, torch.as_tensor(smoke.pole_rotations(dc.cpu().numpy(), 64, 49), device=cuda))):
        before = lp.lambert_project.launches
        got, tap = lp.lambert_project(rot, dc, quad, 1001, 1001, 500.0, taps=True)
        assert lp.lambert_project.launches == before + 1
        p32, t32 = lp.lambert_project_plain(rot, dc, quad, 1001, 1001, 500.0, taps=True)
        p64, t64 = lp.lambert_project_plain(rot.double(), dc.double(), quad.double(), 1001, 1001, 500.0, taps=True)
        yard.add(f"kinematical {seed}", got, tap, p32, t32, p64, t64, float(master.max() - master.min()))
    print({name: yard.summary(c) for name, c in yard.cases.items()})
    assert yard.failures() == []


def _planted(nav=(40, 50), seed=0):
    rng = np.random.default_rng(seed)
    n, d = int(np.prod(nav)), 900
    u, _ = np.linalg.qr(rng.normal(size=(n, 5)))
    v, _ = np.linalg.qr(rng.normal(size=(d, 5)))
    x = (u * [400.0, 240.0, 140.0, 80.0, 50.0]) @ v.T + 0.1 * rng.normal(size=(n, d)) + 20
    return np.round((x - x.min()) / (x.max() - x.min()) * 255).astype(np.uint8).reshape(nav + (30, 30))


@pytest.mark.parametrize("nav", [(40, 50), (10, 12)])  # more patterns than pixels, and fewer
@pytest.mark.parametrize("driver", ["gesvd", "gesvda"])
def test_pca_on_the_card_matches_the_cpu_up_to_sign(cuda, monkeypatch, driver, nav):
    # The driver kept (gesvda) and the accurate alternative; gesvdj is left
    # out: its factors are orthonormal only to about 1e-3 (chip_smoke.py
    # [decomposition] times and checks all three on every run).
    from kikuchipy_tpu_torch.ops import decomposition as dec

    monkeypatch.setattr(dec, "SVD_DRIVER", driver)
    x = _planted(nav)
    n = int(np.prod(nav))
    got = dec.pca(x, 5, return_variance=True, device=cuda)
    want = dec.pca(x, 5, return_variance=True, device="cpu")
    # The model of every component is the data.
    np.testing.assert_allclose(dec.pca_reconstruct(x, None, np.float32, device=cuda), x, atol=1e-4 * 255)
    for a, b in zip(got[:2], want[:2]):
        a, b = (a.T, b.T) if a.shape[0] == n else (a, b)
        signs = np.sign(np.sum(a * b, axis=1, keepdims=True))
        assert (np.abs(signs * a - b) <= 1e-4 * np.abs(b).max(axis=1, keepdims=True)).all()
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6)
    for a, b in zip(got[3:], want[3:]):
        np.testing.assert_allclose(a, b, rtol=1e-4)
    for components in (3, [0, 2, 4]):
        a = dec.pca_reconstruct(x, components, dtype_out=np.uint8, device=cuda)
        b = dec.pca_reconstruct(x, components, dtype_out=np.uint8, device="cpu")
        diff = np.abs(a.astype(int) - b.astype(int))
        assert diff.max() <= 1 and (diff > 0).mean() <= 0.01


@pytest.mark.parametrize("grid", [(5, 5), (4, 7)])
def test_vbse_sums_on_the_card_are_the_cpus_bit_for_bit(cuda, grid):
    import kikuchipy_tpu_torch as kt
    from kikuchipy_tpu_torch.imaging import VirtualBSEImager

    data = np.random.default_rng(6).integers(0, 256, (33, 47, 60, 60), dtype=np.uint8)
    card, cpu = VirtualBSEImager(kt.EBSD(data, device=cuda)), VirtualBSEImager(kt.EBSD(data, device="cpu"))
    card.grid_shape = cpu.grid_shape = grid
    assert card.get_images_from_grid().tobytes() == cpu.get_images_from_grid().tobytes()
    assert card.get_virtual_bse_intensity((5, 50, 3, 41)).tobytes() == cpu.get_virtual_bse_intensity(
        (5, 50, 3, 41)).tobytes()
    assert card.get_rgb_image((0, 0), (1, 1), (2, 2)).tobytes() == cpu.get_rgb_image((0, 0), (1, 1), (2, 2)).tobytes()


# ------------- scale-out: virtual shards of the card, streamed chunks ------------- #


def _module(name, path):
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(name, Path(__file__).resolve().parents[1] / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _top1_where_clear(got, ref_s, ref_i, atol, cols=None):
    # A shard's IEEE product may move a score's last bits: top-1 is held
    # where the reference's top-1/top-2 gap exceeds TOL, the first `cols`
    # scores (all by default) within atol (both lists are sorted).
    clear = (ref_s[:, 0] - ref_s[:, 1]) > TOL
    assert clear.mean() > 0.9
    assert (got[1][:, 0] == ref_i[:, 0])[clear].all()
    np.testing.assert_allclose(got[0][:, :cols], ref_s[:, :cols], rtol=0, atol=atol)


def _di_problem(n=200, m=1001, d=900, seed=0):
    rng = np.random.default_rng(seed)
    exp = rng.normal(size=(n, d)).astype(np.float32)
    dic = rng.normal(size=(m, d)).astype(np.float32)
    dic[::7][: n // 2] = exp[: n // 2] + 0.3 * dic[::7][: n // 2]
    return exp, dic


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (1, 4), (4, 1)])
@pytest.mark.parametrize("precision, approx", [("highest", False), ("int8", False), ("f16", True)])
def test_sharded_di_on_virtual_shards_of_the_card(cuda, shape, precision, approx):
    from kikuchipy_tpu_torch.indexing.di import dictionary_index, prepare_dictionary
    from kikuchipy_tpu_torch.parallel import make_mesh, sharded_dictionary_index

    exp, dic = _di_problem()
    prep = prepare_dictionary(dic, quantize=True, device=cuda)
    kw = dict(keep_n=10, precision=precision, approx_topk=approx)
    got = sharded_dictionary_index(exp, prep, mesh=make_mesh(*shape, devices=[cuda] * (shape[0] * shape[1])), **kw)
    # With dict shards the group compression sees other groups: the exact
    # selection's top-1 is the reference there.
    grouped = approx and shape[1] > 1
    ref = dictionary_index(exp, prep, device=cuda, **dict(kw, approx_topk=approx and not grouped))
    _top1_where_clear(got, ref.scores, ref.simulation_indices, 5e-4 if precision == "f16" else 1e-5,
                      cols=1 if grouped else None)
    assert (got[1] < dic.shape[0]).all()


def test_fused_on_virtual_shards_of_the_card(cuda):
    import kikuchipy_tpu_torch as kt
    from kikuchipy_tpu_torch.crystallography.sampling import super_fibonacci
    from kikuchipy_tpu_torch.indexing.di import dictionary_index
    from kikuchipy_tpu_torch.ops import lambert_project as lp
    from kikuchipy_tpu_torch.parallel import make_mesh, sharded_fused_dictionary_index
    from kikuchipy_tpu_torch.projection.master_pattern import direction_cosines_from_detector

    master = _module("chip_smoke_inputs", "chip_smoke.py").master_pattern_data(side=101)
    mp = kt.EBSDMasterPattern(master, device=cuda)
    det = kt.EBSDDetector(shape=(30, 30), pc=(0.42, 0.28, 0.5), sample_tilt=70)
    rot = super_fibonacci(1000).astype(np.float32)
    sim = mp.get_patterns(rot[::10], det).data.cpu().numpy()
    exp = sim + np.random.default_rng(1).normal(scale=0.05 * sim.std(), size=sim.shape).astype(np.float32)
    dc = direction_cosines_from_detector(det, device=cuda)
    before = lp.lambert_project.launches
    got = sharded_fused_dictionary_index(exp, rot, master, dc, 101, 101, 50.0, keep_n=5,
                                         mesh=make_mesh(2, 2, devices=[cuda] * 4))
    assert lp.lambert_project.launches - before == 4
    ref = dictionary_index(exp, project_fn=mp.projector(det), rotations=rot, keep_n=5, precision="highest",
                           device=cuda)
    _top1_where_clear(got, ref.scores, ref.simulation_indices, 1e-5)
    assert (got[1][:, 0] == np.arange(0, 1000, 10)).all()


@pytest.mark.parametrize("mode", ["orientation", "pc", "joint"])
def test_sharded_refinement_on_the_card_is_the_single_device_call(cuda, mode):
    # The kernel refines each point alone; the rows' preparation (PyTorch's
    # row means and squared norms) rounds as the whole map's only where the
    # reduction splits a row the same way, which depends on the number of
    # rows: at 9 points in shards of 3, two scores moved by an ulp. At 4,096
    # rows a shard, as in chip_smoke.py, the rows are the same bytes.
    from kikuchipy_tpu_torch.crystallography.crystal_map import CrystalMap
    from kikuchipy_tpu_torch.indexing.refinement import _prepare_experimental
    from kikuchipy_tpu_torch.ops import refine_nm as rn
    from kikuchipy_tpu_torch.parallel import make_mesh, refine as pr
    from kikuchipy_tpu_torch.signals.ebsd import EBSD

    n = 4 * 4096
    mp, det, scan, start = _module("torch_multihost_worker", "tests/_torch_multihost_worker.py").refinement_problem(
        n=n, device=cuda)
    if mode != "orientation":
        det = dataclasses.replace(det, pc=np.asarray(det.pc).reshape(-1, 3)[0] + [0.004, -0.004, 0.004])
    sig = EBSD(data=scan.reshape(128, 128, 32, 32), detector=det, device=cuda)
    whole = _prepare_experimental(sig.data.reshape(n, -1), None)
    shard = _prepare_experimental(sig.data.reshape(n, -1)[: n // 4], None)
    assert all(torch.equal(a[: n // 4], b) for a, b in zip(whole, shard))
    name, sharded, wrapper = {
        "orientation": ("refine_orientation", pr.sharded_refine_orientation, rn.nelder_mead_orientation),
        "pc": ("refine_projection_center", pr.sharded_refine_projection_center, rn.nelder_mead_projection_center),
        "joint": ("refine_orientation_projection_center", pr.sharded_refine_orientation_projection_center,
                  rn.nelder_mead_orientation_projection_center)}[mode]
    kw = dict(xmap=CrystalMap(rotations=start, shape=(128, 128)), detector=det, master_pattern=mp, max_iters=60)
    want = getattr(sig, name)(**kw)
    before = wrapper.launches
    got = sharded(sig, mesh=make_mesh(4, 1, devices=[cuda] * 4), **kw)
    assert wrapper.launches - before == 4
    np.testing.assert_array_equal(got.xmap.rotations, want.xmap.rotations)
    np.testing.assert_array_equal(got.xmap.prop["scores"], want.xmap.prop["scores"])
    np.testing.assert_array_equal(np.asarray(got.detector.pc), np.asarray(want.detector.pc))


@pytest.mark.parametrize("precision", ["int8", "highest"])
def test_index_chunks_on_the_card_equals_eager_di(cuda, tmp_path, precision):
    from kikuchipy_tpu_torch.indexing.di import dictionary_index
    from kikuchipy_tpu_torch.io.streaming import _index_chunks
    from kikuchipy_tpu_torch.ops.pattern import remove_static_background

    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, (3000, 30, 30), dtype=np.uint8)
    dic = rng.normal(size=(700, 30, 30)).astype(np.float32)
    dic[::5][:100] = data[:100]
    path = tmp_path / "scan.u8"
    data.tofile(path)
    mm = np.memmap(path, dtype=np.uint8, mode="r", shape=data.shape)
    kw = dict(keep_n=5, precision=precision, device=cuda)

    def chunks():
        return ((s, mm[s:s + 512]) for s in range(0, 3000, 512))

    eager = dictionary_index(data, dic, **kw)
    got = _index_chunks(chunks(), dic, chunk_size=512, **kw)
    _top1_where_clear((got.scores, got.simulation_indices), eager.scores, eager.simulation_indices, 1e-6)
    if precision == "int8":  # exact sums select the same candidates
        np.testing.assert_array_equal(got.simulation_indices, eager.simulation_indices)
    bg = rng.integers(1, 100, (30, 30), dtype=np.uint8)
    on_card = _index_chunks(chunks(), dic, chunk_size=512, preprocess_on_device=True,
                            preprocess_fn=lambda c: remove_static_background(c, bg, device=cuda), **kw)
    on_host = _index_chunks(chunks(), dic, chunk_size=512,
                            preprocess_fn=lambda c: remove_static_background(c, bg, device="cpu").numpy(), **kw)
    np.testing.assert_array_equal(on_card.simulation_indices, on_host.simulation_indices)
    np.testing.assert_array_equal(on_card.scores, on_host.scores)


def test_native_loader_builds_on_the_cards_machine(cuda):
    from kikuchipy_tpu_torch import native
    from kikuchipy_tpu_torch.ops.pattern import remove_static_background

    assert native.available(), native.BUILD_LOG
    rng = np.random.default_rng(4)
    pats = rng.integers(0, 256, (500, 60, 60), dtype=np.uint8)
    bg = rng.integers(1, 256, (60, 60)).astype(np.float32)
    card = remove_static_background(pats, bg, dtype_out=np.float32, out_range=(-1.0, 1.0), device=cuda).cpu().numpy()
    np.testing.assert_allclose(native.preprocess_u8(pats, bg), card, rtol=0, atol=2e-6)
