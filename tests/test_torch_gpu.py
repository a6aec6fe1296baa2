"""The CUDA kernels against their plain versions on the card. Marked
``gpu``: without a CUDA device each test skips. On a machine with a card
(no JAX needed) run

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

The int8 kernel must equal its plain version bit for bit. The f32 and
bf16 kernels sum in f32 in their own order, so they must agree with their
float64-sum plain versions modulo near-ties
(:func:`kikuchipy_tpu_torch.ops.ncc_topk.near_tie_disagreements`) with
``TOL`` = 1e-5 on unit-norm rows: the products are exact in f32 and only
the order of the f32 sum differs.
"""

import numpy as np
import pytest
import torch

from kikuchipy_tpu_torch.ops import ncc_topk as nt

pytestmark = pytest.mark.gpu

TOL = 1e-5
PLANTED = (3, 5, 40)


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
    for j in (5, 40, m - 1):  # planted ties
        w[j], sc[j] = w[3], sc[3]
    return e.to(device), w.to(device), sc.to(device)


def _unit_operands(n, m, d, seed, device):
    rng = np.random.default_rng(seed)
    e = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=(m, d)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    w[list(PLANTED[1:])] = w[PLANTED[0]]
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
@pytest.mark.parametrize("n, m, d, k", [(64, 512, 100, 5), (200, 2048, 3600, 40), (64, 1024, 301, 130)])
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
