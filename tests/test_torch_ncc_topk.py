"""The port's fused int8 NCC + top-k (plain version on the CPU) against
the JAX package's ncc_match_topk_pallas_v5 in interpret mode: same int8
inputs, exact equality of scores and indices (the int32 sum is exact and
the f32 conversion and one multiply are deterministic)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kikuchipy_tpu.indexing.di import _quantize_rows_int8 as quantize_jax
from kikuchipy_tpu.ops.pallas_di import ncc_match_topk_pallas_v5
from kikuchipy_tpu_torch.indexing.di import _quantize_rows_int8 as quantize_torch
from kikuchipy_tpu_torch.ops.ncc_topk import ncc_match_topk_int8, ncc_match_topk_int8_plain


def _operands(n, m, d, seed, ties=True):
    rng = np.random.default_rng(seed)
    eq = rng.integers(-127, 128, size=(n, d), dtype=np.int8)
    dq = rng.integers(-127, 128, size=(m, d), dtype=np.int8)
    ds = (rng.random(m) * 0.01 + 1e-3).astype(np.float32)
    if ties:
        # Duplicated dictionary rows tie exactly; an all-zero pattern
        # ties every column at 0.
        for j in (5, 40 % m, m - 1):
            dq[j], ds[j] = dq[3], ds[3]
        eq[1] = 0
    return eq, dq, ds


def _jax(eq, dq, ds, k, tile_n, tile_m, group):
    s, i = ncc_match_topk_pallas_v5(
        jnp.asarray(eq), jnp.asarray(dq), jnp.asarray(ds), k,
        tile_n=tile_n, tile_m=tile_m, interpret=True, group=group,
    )
    return np.asarray(s), np.asarray(i)


@pytest.mark.parametrize(
    "n, m, d, k, tile_n, tile_m, group",
    [
        (16, 128, 100, 5, 8, 32, 1),
        (16, 128, 100, 5, 8, 32, 4),
        (16, 128, 100, 5, 8, 32, 8),
        # several row tiles and dictionary tiles, d not a multiple of 128
        (24, 256, 200, 7, 8, 64, 1),
        (24, 256, 200, 7, 8, 64, 8),
        # k wider than a dictionary tile
        (32, 96, 128, 40, 16, 32, 1),
    ],
)
def test_plain_matches_jax_v5_exactly(n, m, d, k, tile_n, tile_m, group):
    eq, dq, ds = _operands(n, m, d, seed=n + m + group)
    ref_s, ref_i = _jax(eq, dq, ds, k, tile_n, tile_m, group)
    s, i = ncc_match_topk_int8_plain(
        torch.from_numpy(eq), torch.from_numpy(dq), torch.from_numpy(ds), k, tile_m, group
    )
    np.testing.assert_array_equal(i.numpy(), ref_i)
    np.testing.assert_array_equal(s.numpy(), ref_s)


def test_wrapper_on_cpu_is_the_plain_version():
    eq, dq, ds = _operands(16, 128, 100, seed=1)
    args = (torch.from_numpy(eq), torch.from_numpy(dq), torch.from_numpy(ds))
    s1, i1 = ncc_match_topk_int8(*args, k=5, tile_n=8, tile_m=32, group=8)
    s2, i2 = ncc_match_topk_int8_plain(*args, k=5, tile_m=32, group=8)
    assert torch.equal(s1, s2) and torch.equal(i1, i2)
    assert s1.dtype == torch.float32 and i1.dtype == torch.int32


@pytest.mark.parametrize(
    "n, m, tile_n, tile_m, group, match",
    [
        (15, 128, 8, 32, 1, "multiples"),
        (16, 100, 8, 32, 1, "multiples"),
        (16, 128, 8, 32, 7, "group"),
    ],
)
def test_tiling_errors_match_jax(n, m, tile_n, tile_m, group, match):
    eq, dq, ds = _operands(n, m, 64, seed=2, ties=False)
    with pytest.raises(ValueError, match=match):
        _jax(eq, dq, ds, 5, tile_n, tile_m, group)
    with pytest.raises(ValueError, match=match):
        ncc_match_topk_int8(
            torch.from_numpy(eq), torch.from_numpy(dq), torch.from_numpy(ds),
            5, tile_n, tile_m, group,
        )


def test_quantize_rows_int8_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(12, 50)).astype(np.float32)
    x[3] = 0.0  # zero row: scale 1
    # max 127 -> scale 1.0, so these sit exactly on .5: half to even.
    x[5, :4] = [127.0, 2.5, -3.5, 0.5]
    q_ref, s_ref = quantize_jax(jnp.asarray(x))
    q, s = quantize_torch(torch.from_numpy(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    assert q[5, :4].tolist() == [127, 2, -4, 0]
