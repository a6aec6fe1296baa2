"""The CUDA kernel against its plain version on the card. Marked ``gpu``:
without a CUDA device each test skips. On a machine with a card (no JAX
needed) run

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from kikuchipy_tpu_torch.ops.ncc_topk import ncc_match_topk_int8, ncc_match_topk_int8_plain

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize(
    "n, m, d, k, tile_n, tile_m, group",
    [
        (64, 256, 128, 5, 8, 32, 1),
        (64, 256, 128, 5, 8, 32, 8),
        (100, 640, 3600, 40, 4, 128, 1),
        (72, 96, 48, 70, 8, 32, 4),
        (300, 2048, 3600, 128, 4, 512, 1),
    ],
)
def test_kernel_matches_plain_bit_for_bit(cuda, n, m, d, k, tile_n, tile_m, group):
    rng = np.random.default_rng(n + m)
    e = torch.from_numpy(rng.integers(-127, 128, (n, d), dtype=np.int8)).to(cuda)
    w = torch.from_numpy(rng.integers(-127, 128, (m, d), dtype=np.int8))
    sc = torch.from_numpy((rng.random(m) * 0.01 + 1e-3).astype(np.float32))
    for j in (5, 40, m - 1):  # planted ties
        w[j], sc[j] = w[3], sc[3]
    w, sc = w.to(cuda), sc.to(cuda)
    before = ncc_match_topk_int8.launches
    s1, i1 = ncc_match_topk_int8(e, w, sc, k, tile_n, tile_m, group)
    torch.cuda.synchronize()
    assert ncc_match_topk_int8.launches == before + 1
    s2, i2 = ncc_match_topk_int8_plain(e, w, sc, k, tile_m, group)
    assert torch.equal(s1, s2) and torch.equal(i1, i2)


def test_kernel_rejects_what_it_cannot_take(cuda):
    e = torch.zeros((8, 32), dtype=torch.int8, device=cuda)
    w = torch.zeros((32, 32), dtype=torch.int8, device=cuda)
    sc = torch.ones(32, device=cuda)
    with pytest.raises(TypeError):
        ncc_match_topk_int8(e.float(), w, sc, 4, 8, 32)
    with pytest.raises(ValueError, match="k="):
        ncc_match_topk_int8(e, w, sc, 200, 8, 32)
