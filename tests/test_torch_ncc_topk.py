"""The port's fused NCC + top-k wrappers (their plain versions, on the
CPU) against the JAX package's four Pallas kernels in interpret mode.

- int8 (v5): the same int8 inputs give equal scores and indices exactly
  (the int32 sum is exact; the f32 conversion and one multiply are
  deterministic).
- f32 (v1, v3) and bf16 (v4): integer-valued operands make every sum
  exact in any order, so scores and indices are equal exactly, planted
  ties included. On unit-norm random rows indices are equal and scores
  agree within 1e-5 of the row's largest |score|: the plain version sums
  in float64, XLA in float32 in its own order.
- f32 on the card is three TF32 products on split operands: the split
  (``split_tf32``), its row layout (``tf32_rows``) and a float64 model of
  the three products are held against the float64 sum and JAX's v1 and v3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kikuchipy_tpu.indexing.di import _quantize_rows_int8 as quantize_jax
from kikuchipy_tpu.ops.pallas_di import (
    ncc_match_topk_pallas,
    ncc_match_topk_pallas_v3,
    ncc_match_topk_pallas_v4,
    ncc_match_topk_pallas_v5,
)
from kikuchipy_tpu_torch.indexing.di import _quantize_rows_int8 as quantize_torch
from kikuchipy_tpu_torch.ops import ncc_topk as nt
from kikuchipy_tpu_torch.ops.ncc_topk import (
    ncc_match_topk_bf16,
    ncc_match_topk_f32,
    ncc_match_topk_f32_blocked,
    ncc_match_topk_int8,
    ncc_match_topk_int8_plain,
)

F32_MIN = np.finfo(np.float32).min
RTOL_ROW = 1e-5


# Dictionary rows that straddle the wgmma kernels' boundaries: a 32-candidate
# selection slice, the bf16 and f32 kernels' 160-candidate chunk and the
# int8 kernel's 256-candidate chunk (and 128, a power of two between them).
STRADDLE = (31, 32, 127, 128, 159, 160, 255, 256)


def _operands(n, m, d, seed, ties=True, straddle=False):
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
    if straddle:
        # The best match of row 0, planted on both sides of each boundary.
        for j in STRADDLE:
            if j < m:
                dq[j], ds[j] = eq[0], 0.02
    return eq, dq, ds


def _float_operands(n, m, d, seed, exact):
    """Integer-valued float32 rows (every sum exact, many exact ties), or
    unit-norm random rows. Planted duplicate dictionary rows either way."""
    rng = np.random.default_rng(seed)
    if exact:
        e = rng.integers(-8, 9, size=(n, d)).astype(np.float32)
        w = rng.integers(-8, 9, size=(m, d)).astype(np.float32)
    else:
        e = rng.normal(size=(n, d)).astype(np.float32)
        w = rng.normal(size=(m, d)).astype(np.float32)
        e /= np.linalg.norm(e, axis=1, keepdims=True)
        w /= np.linalg.norm(w, axis=1, keepdims=True)
    for j in (5, 40 % m, m - 1):
        w[j] = w[3]
    return e, w


def _jax_v5(eq, dq, ds, k, tile_n, tile_m, group, extraction="stream"):
    s, i = ncc_match_topk_pallas_v5(
        jnp.asarray(eq), jnp.asarray(dq), jnp.asarray(ds), k,
        tile_n=tile_n, tile_m=tile_m, interpret=True, group=group, extraction=extraction,
    )
    return np.asarray(s), np.asarray(i)


def _int8_port(eq, dq, ds, k, tile_n, tile_m, group, extraction="stream"):
    s, i = ncc_match_topk_int8(
        torch.from_numpy(eq), torch.from_numpy(dq), torch.from_numpy(ds), k,
        tile_n, tile_m, group, extraction,
    )
    return s.numpy(), i.numpy()


def _assert_exact(got, ref):
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_array_equal(got[0], ref[0])


# ------------------------------ int8 (v5) ------------------------------ #


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
    ref = _jax_v5(eq, dq, ds, k, tile_n, tile_m, group)
    got = ncc_match_topk_int8_plain(
        torch.from_numpy(eq), torch.from_numpy(dq), torch.from_numpy(ds), k, tile_m, group
    )
    _assert_exact((got[0].numpy(), got[1].numpy()), ref)


@pytest.mark.parametrize("extraction", ["fori", "none"])
@pytest.mark.parametrize("group", [1, 8])
def test_v5_fori_and_none_match_jax_exactly(extraction, group):
    # "fori" ignores group on the TPU; "none" keeps the last tile's row max.
    eq, dq, ds = _operands(24, 256, 200, seed=11 + group)
    ref = _jax_v5(eq, dq, ds, 7, 8, 64, group, extraction)
    _assert_exact(_int8_port(eq, dq, ds, 7, 8, 64, group, extraction), ref)


def test_fewer_candidates_than_k_leave_float32_min_slots():
    # 256 columns in groups of 16: 16 candidates for k = 20. The TPU's
    # running top-k starts at float32-min with index 0, and so must ours.
    eq, dq, ds = _operands(128, 256, 64, seed=3)
    ref = _jax_v5(eq, dq, ds, 20, 128, 128, 16)
    got = _int8_port(eq, dq, ds, 20, 128, 128, 16)
    _assert_exact(got, ref)
    assert (got[0][:, 16:] == F32_MIN).all() and (got[1][:, 16:] == 0).all()


def test_k_up_to_512_matches_jax_and_beyond_raises():
    eq, dq, ds = _operands(16, 640, 64, seed=4)
    for k in (130, 512):
        _assert_exact(_int8_port(eq, dq, ds, k, 8, 128, 1), _jax_v5(eq, dq, ds, k, 8, 128, 1))
    # keep_n = 65 through pallas-int8 carries k = 130 candidates.
    _assert_exact(_int8_port(eq, dq, ds, 130, 8, 128, 4), _jax_v5(eq, dq, ds, 130, 8, 128, 4))
    with pytest.raises(ValueError, match="1..512"):
        _int8_port(eq, dq, ds, 513, 8, 128, 1)
    assert nt.MAX_K == 512


@pytest.mark.parametrize(
    "m, k, tile_m, group",
    [
        (192, 70, 96, 3),    # groups that do not divide a 128-candidate chunk
        (1024, 5, 512, 256),  # groups wider than a chunk
        (1024, 3, 512, 512),
    ],
)
def test_group_not_dividing_the_chunk_matches_jax(m, k, tile_m, group):
    eq, dq, ds = _operands(16, m, 64, seed=m + group)
    _assert_exact(_int8_port(eq, dq, ds, k, 8, tile_m, group), _jax_v5(eq, dq, ds, k, 8, tile_m, group))


@pytest.mark.parametrize(
    "n, m, d, k, tile_m, group",
    [
        # n no multiple of the 128-row block or of a 64-row warpgroup, m a
        # multiple of tile_m = 32 but not of the 256-candidate chunk, row
        # bytes no multiple of 128
        (8, 288, 200, 1, 32, 1),
        (72, 288, 200, 40, 32, 1),
        (136, 544, 100, 130, 32, 1),
        (8, 544, 72, 512, 32, 1),
        (8, 96, 72, 130, 32, 1),      # fewer candidates than k
        (72, 288, 100, 40, 96, 3),
        (72, 544, 100, 40, 32, 16),   # 34 candidates for k = 40
        (8, 1024, 72, 5, 512, 256),
        (8, 1024, 72, 3, 512, 512),
    ],
)
def test_ragged_shapes_and_straddling_ties_match_jax_v5(n, m, d, k, tile_m, group):
    eq, dq, ds = _operands(n, m, d, seed=n + m + k + group, straddle=True)
    ref = _jax_v5(eq, dq, ds, k, 8, tile_m, group)
    got = _int8_port(eq, dq, ds, k, 8, tile_m, group)
    _assert_exact(got, ref)
    if group == 1 and k >= 6 and m > 256:
        assert got[1][0, :6].tolist() == list(STRADDLE[:6])  # equal scores in column order


def test_fori_fill_index_past_a_short_dictionary_diverges_from_jax():
    # k > m over two tiles: JAX's k-round extraction re-picks its first
    # (already extracted, now float32-min) slot and fills the empty slots
    # with that slot's index; the port fills index 0, as "stream" does.
    eq, dq, ds = _operands(8, 64, 64, seed=0, ties=False)
    ref = _jax_v5(eq, dq, ds, 80, 8, 32, 1, "fori")
    got = _int8_port(eq, dq, ds, 80, 8, 32, 1, "fori")
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1][:, :64], ref[1][:, :64])
    assert (got[1][:, 64:] == 0).all() and (ref[1][:, 64:] != 0).any()
    stream = _jax_v5(eq, dq, ds, 80, 8, 32, 1, "stream")
    _assert_exact(got, stream)


# --------------------------- f32 (v1, v3), bf16 (v4) --------------------------- #


def _jax_float(kernel, e, w, k, tile_n, tile_m, **kw):
    fn = {"v1": ncc_match_topk_pallas, "v3": ncc_match_topk_pallas_v3, "v4": ncc_match_topk_pallas_v4}[kernel]
    s, i = fn(jnp.asarray(e), jnp.asarray(w), k, tile_n=tile_n, tile_m=tile_m, interpret=True, **kw)
    return np.asarray(s), np.asarray(i)


def _port_float(kernel, e, w, k, tile_n, tile_m, **kw):
    fn = {"v1": ncc_match_topk_f32, "v3": ncc_match_topk_f32_blocked, "v4": ncc_match_topk_bf16}[kernel]
    s, i = fn(torch.from_numpy(e), torch.from_numpy(w), k, tile_n, tile_m, **kw)
    return s.numpy(), i.numpy()


FLOAT_CASES = [
    # kernel, extra kwargs
    ("v1", {}),
    ("v3", {"tile_d": 128}),
    ("v4", {"extraction": "fori"}),
    ("v4", {"extraction": "stream"}),
]


@pytest.mark.parametrize("kernel, kw", FLOAT_CASES)
@pytest.mark.parametrize(
    "n, m, d, k, tile_n, tile_m",
    [
        (16, 128, 100, 5, 8, 32),   # ragged d, 4 dictionary tiles
        (24, 192, 260, 7, 8, 64),   # several row tiles too
        (16, 96, 64, 40, 8, 32),    # k wider than a dictionary tile
        # ragged against the wgmma block: rows, chunk and row bytes
        (8, 288, 100, 1, 8, 32),
        (72, 288, 260, 40, 8, 32),
        (136, 544, 72, 130, 8, 32),
    ],
)
def test_float_kernels_match_jax_exactly_on_integer_rows(kernel, kw, n, m, d, k, tile_n, tile_m):
    e, w = _float_operands(n, m, d, seed=n + m + d, exact=True)
    _assert_exact(_port_float(kernel, e, w, k, tile_n, tile_m, **kw), _jax_float(kernel, e, w, k, tile_n, tile_m, **kw))


@pytest.mark.parametrize("kernel, kw", FLOAT_CASES)
def test_float_kernels_match_jax_on_unit_rows(kernel, kw):
    e, w = _float_operands(16, 256, 300, seed=21, exact=False)
    ref = _jax_float(kernel, e, w, 6, 8, 64, **kw)
    got = _port_float(kernel, e, w, 6, 8, 64, **kw)
    np.testing.assert_array_equal(got[1], ref[1])
    row_max = np.abs(ref[0]).max(axis=1, keepdims=True)
    assert (np.abs(got[0] - ref[0]) <= RTOL_ROW * row_max).all()


def test_planted_ties_keep_column_order():
    e, w = _float_operands(8, 64, 32, seed=2, exact=False)
    w[[10, 20, 30]] = e[0]  # three exact best matches of row 0
    for kernel, kw in FLOAT_CASES:
        s, i = _port_float(kernel, e, w, 4, 8, 32, **kw)
        assert i[0, :3].tolist() == [10, 20, 30] and s[0, 0] == s[0, 1] == s[0, 2]


def test_v4_none_keeps_the_last_tile_max():
    e, w = _float_operands(16, 128, 100, seed=5, exact=True)
    ref = _jax_float("v4", e, w, 5, 8, 32, extraction="none")
    got = _port_float("v4", e, w, 5, 8, 32, extraction="none")
    _assert_exact(got, ref)
    assert (got[0][:, 1:] == F32_MIN).all() and (got[1] == 0).all()


def test_bf16_rounds_operands_to_nearest_even():
    # 1 + 2**-8 lies halfway between two bf16 values: RNE gives 1.0;
    # 1 + 3 * 2**-8 rounds up to 1 + 2**-6.
    e = np.ones((8, 4), np.float32)
    w = np.zeros((32, 4), np.float32)
    w[0, 0] = 1 + 2**-8
    w[1, 0] = 1 + 3 * 2**-8
    ref = _jax_float("v4", e, w, 2, 8, 32)
    got = _port_float("v4", e, w, 2, 8, 32)
    _assert_exact(got, ref)
    assert got[0][0].tolist() == [1 + 2**-6, 1.0]


# ------------------- f32 as three TF32 products (the card's way) ------------------- #


def _low_bits(x):
    return x.view(torch.int32) & 0x1FFF


F32_MAX = float(np.finfo(np.float32).max)
F32_TINY = float(np.finfo(np.float32).tiny)


@pytest.mark.parametrize(
    "values",
    [
        np.random.default_rng(0).normal(size=4096),
        np.random.default_rng(1).normal(size=4096) * 1e-3,
        np.random.default_rng(2).normal(size=4096) * 1e30,
        [1.0, -1.0, 1 + 2.0**-11, 1 + 2.0**-10, 1 + 3 * 2.0**-12, -(1 + 2.0**-23), 2 - 2.0**-23, 0.1, 1 / 3],
        # The smallest values whose low part is still a normal number.
        [F32_TINY * 2.0**24, -F32_TINY * 2.0**24 * (1 + 2.0**-12), F32_TINY * 2.0**25 * (1 + 3 * 2.0**-13)],
    ],
    ids=["unit", "small", "large", "edges", "low-part-barely-normal"],
)
def test_split_tf32_planes_are_tf32_exact_and_sum_to_the_value(values):
    x = torch.tensor(np.asarray(values), dtype=torch.float32)
    hi, lo = nt.split_tf32(x)
    assert hi.dtype == lo.dtype == torch.float32 and hi.shape == lo.shape == x.shape
    assert not _low_bits(hi).any() and not _low_bits(lo).any()
    err = (hi.double() + lo.double() - x.double()).abs()
    assert (err <= 2.0**-21 * x.double().abs()).all()
    # hi is the nearest TF32 value: at most half a TF32 ulp (2**-11 relative) away.
    assert ((hi.double() - x.double()).abs() <= 2.0**-11 * x.double().abs()).all()


def test_split_tf32_keeps_zeros_denormals_and_the_largest_values_finite():
    x = torch.tensor([0.0, -0.0, 1e-45, -1e-42, 1e-39, F32_MAX, -F32_MAX, F32_MAX * (1 - 2.0**-12), F32_TINY,
                      F32_TINY * (1 + 2.0**-12)], dtype=torch.float32)
    hi, lo = nt.split_tf32(x)
    assert torch.isfinite(hi).all() and torch.isfinite(lo).all()
    assert not _low_bits(hi).any() and not _low_bits(lo).any()
    assert hi[0] == 0 and lo[0] == 0 and hi[1] == 0 and lo[1] == 0
    # The largest values round down to the largest TF32 value; the rest is the low part.
    assert hi[5] == float.fromhex("0x1.ffcp127") and hi[6] == -hi[5]
    assert (hi[5:].double() + lo[5:].double() - x[5:].double()).abs().max() <= 2.0**-21 * F32_MAX
    with pytest.raises(TypeError):
        nt.split_tf32(x.double())


def _tf32x3_scores(e, w):
    """A plain model of the f32 kernel's product: hi*hi + hi*lo + lo*hi on
    the planes of ``split_tf32``, each in float64, rounded once."""
    (eh, el), (wh, wl) = (tuple(p.double() for p in nt.split_tf32(x)) for x in (e, w))
    return (el @ wh.T + eh @ wl.T + eh @ wh.T).to(torch.float32)


def test_tf32x3_model_is_within_2e_6_of_the_float64_sum_at_d_3600():
    e, w = (torch.from_numpy(x) for x in _float_operands(32, 512, 3600, seed=13, exact=False))
    # Correlated rows too: a pattern against itself and its neighbours sums 3600 positive terms.
    w[64:96] = e + 0.01 * w[64:96]
    w[64:96] /= w[64:96].norm(dim=1, keepdim=True)
    ref = nt._f64_scores(e.double(), w.double())(0, 32)
    got = _tf32x3_scores(e, w)
    assert ref.abs().max() > 0.9
    assert (got - ref).abs().max().item() <= 2e-6
    # One TF32 product alone is not the f32 product, and fails the 1e-5
    # rule the kernel is held to: the low planes matter.
    hi_only = (nt.split_tf32(e)[0].double() @ nt.split_tf32(w)[0].double().T).to(torch.float32)
    assert (hi_only - ref).abs().max().item() > 1e-5


@pytest.mark.parametrize("kernel, kw", [("v1", {}), ("v3", {"tile_d": 128})])
def test_tf32x3_model_keeps_the_top_k_of_jax_modulo_near_ties(kernel, kw):
    k = 6
    e, w = _float_operands(16, 256, 3600, seed=17, exact=False)
    ref_s, ref_i = _jax_float(kernel, e, w, k + 1, 8, 64, **kw)
    e, w = torch.from_numpy(e), torch.from_numpy(w)
    s, i = nt._select(_tf32x3_scores(e, w), k, 64, 1, "fori")
    bad = nt.near_tie_disagreements(
        s, i, torch.tensor(ref_s), torch.tensor(ref_i), e, w, 1e-5, (3, 5, 40, 255))
    assert bad == []
    # The planted duplicates tie exactly in the model too, and keep column order.
    dup = _tf32x3_scores(e, w)[:, [3, 5, 40, 255]]
    assert (dup == dup[:, :1]).all()


@pytest.mark.parametrize("n, d", [(3, 3600), (5, 100), (2, 32), (4, 31), (1, 1), (2, 64)])
def test_tf32_rows_interleave_the_planes_by_128_byte_slices(n, d):
    x = torch.from_numpy(np.random.default_rng(d).normal(size=(n, d)).astype(np.float32))
    rows = nt.tf32_rows(x)
    blocks = -(-d // 32)
    # Pitch: two planes of d padded to whole 32-value slices.
    assert rows.shape == (n, 64 * blocks) and rows.is_contiguous() and rows.dtype == torch.float32
    assert rows.shape[1] * 4 == 2 * nt.row_pitch_bytes(32 * blocks, 4) and rows.data_ptr() % nt.ROW_ALIGN == 0
    hi, lo = nt.split_tf32(torch.nn.functional.pad(x, (0, 32 * blocks - d)))
    for b in range(blocks):
        assert torch.equal(rows[:, 64 * b : 64 * b + 32], hi[:, 32 * b : 32 * b + 32])
        assert torch.equal(rows[:, 64 * b + 32 : 64 * b + 64], lo[:, 32 * b : 32 * b + 32])
    assert (rows.reshape(n, blocks, 2, 32)[:, -1, :, d - 32 * (blocks - 1) :] == 0).all()
    with pytest.raises(ValueError, match="rows"):
        nt.tf32_rows(x[0])


def test_tf32_rows_pads_d_to_a_multiple_first():
    # v3 pads d to its tile_d: 70 -> 128 values, four blocks of zeros past 70.
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(3, 70)).astype(np.float32))
    rows = nt.tf32_rows(x, 128)
    assert rows.shape == (3, 256)
    assert torch.equal(rows, nt.tf32_rows(torch.nn.functional.pad(x, (0, 58))))
    assert torch.equal(rows[:, :192], nt.tf32_rows(x)) and (rows[:, 192:] == 0).all()
    with pytest.raises(ValueError, match="d_multiple"):
        nt.tf32_rows(x, 0)


def test_tf32_rows_splits_in_slabs(monkeypatch):
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(11, 70)).astype(np.float32))
    whole = nt.tf32_rows(x)
    monkeypatch.setattr(nt, "_SPLIT_SLAB", 4)
    assert torch.equal(nt.tf32_rows(x), whole)


# --------------------------- contract and wrappers --------------------------- #


@pytest.mark.parametrize(
    "wrapper, plain",
    [
        (lambda e, w: ncc_match_topk_f32(e, w, 5, 8, 32), lambda e, w: nt.ncc_match_topk_f32_plain(e, w, 5)),
        (
            lambda e, w: ncc_match_topk_f32_blocked(e, w, 5, 8, 32, 128),
            lambda e, w: nt.ncc_match_topk_f32_blocked_plain(e, w, 5),
        ),
        (
            lambda e, w: ncc_match_topk_bf16(e, w, 5, 8, 32, "stream"),
            lambda e, w: nt.ncc_match_topk_bf16_plain(e, w, 5, 32, "stream"),
        ),
    ],
)
def test_float_wrappers_on_cpu_are_the_plain_versions(wrapper, plain):
    e, w = _float_operands(16, 128, 100, seed=1, exact=False)
    e, w = torch.from_numpy(e), torch.from_numpy(w)
    s1, i1 = wrapper(e, w)
    s2, i2 = plain(e, w)
    assert torch.equal(s1, s2) and torch.equal(i1, i2)
    assert s1.dtype == torch.float32 and i1.dtype == torch.int32


def test_int8_wrapper_on_cpu_is_the_plain_version():
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
        _jax_v5(eq, dq, ds, 5, tile_n, tile_m, group)
    with pytest.raises(ValueError, match=match):
        _int8_port(eq, dq, ds, 5, tile_n, tile_m, group)


@pytest.mark.parametrize(
    "kernel, n, kw, match",
    [
        ("v1", 100, {}, "multiples"),
        ("v3", 128, {"tile_d": 100}, "multiple of 128"),
        ("v3", 128, {}, "multiple of 128"),  # v3's own default tile_d = 1200
        ("v3", 100, {"tile_d": 128}, "multiples"),
        ("v4", 100, {}, "multiples"),
    ],
)
def test_float_errors_match_jax(kernel, n, kw, match):
    e, w = _float_operands(n, 1024, 64, seed=0, exact=False)
    with pytest.raises(ValueError, match=match):
        _jax_float(kernel, e, w, 5, 128, 512, **kw)
    with pytest.raises(ValueError, match=match):
        _port_float(kernel, e, w, 5, 128, 512, **kw)


def test_unknown_extraction_raises():
    e, w = _float_operands(8, 32, 16, seed=0, exact=True)
    with pytest.raises(ValueError, match="extraction"):
        _port_float("v4", e, w, 2, 8, 32, extraction="sort")


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


# ----------------------- what the wrappers decide ----------------------- #


@pytest.mark.parametrize(
    "dtype, group, extraction, expected",
    [
        (torch.int8, 1, "stream", ("ncc_topk_int8", 1, 0, False)),
        (torch.int8, 16, "stream", ("ncc_topk_int8", 16, 0, True)),
        (torch.int8, 512, "stream", ("ncc_topk_int8", 512, 0, True)),
        (torch.int8, 16, "fori", ("ncc_topk_int8", 1, 0, False)),   # fori ignores group
        (torch.int8, 16, "none", ("ncc_topk_int8", 1, 1, False)),
        (torch.bfloat16, 1, "fori", ("ncc_topk_bf16", 1, 0, False)),
        (torch.bfloat16, 1, "stream", ("ncc_topk_bf16", 1, 0, False)),
        (torch.bfloat16, 1, "none", ("ncc_topk_bf16", 1, 1, False)),
        (torch.float32, 1, "fori", ("ncc_topk_f32", 1, 0, False)),   # v1 and v3: no extraction, no group
        (torch.float32, 1, "none", ("ncc_topk_f32", 1, 1, False)),   # the product alone, to be timed
    ],
)
def test_wgmma_plan(dtype, group, extraction, expected):
    plan = nt.wgmma_plan(dtype, group, extraction)
    assert (plan["kernel"], plan["group"], plan["mode"], plan["gather"]) == expected
    assert plan["variant"] == "wgmma"  # one design at every group: no second kernel to fall back to


def test_wgmma_plan_refuses_other_types_and_extractions():
    for dtype in (torch.float64, torch.float16, torch.uint8):
        with pytest.raises(TypeError):
            nt.wgmma_plan(dtype, 1, "stream")
    with pytest.raises(ValueError, match="extraction"):
        nt.wgmma_plan(torch.int8, 1, "sort")


@pytest.mark.parametrize(
    "d, itemsize, pitch",
    [(3600, 1, 3600), (3600, 2, 7200), (100, 1, 112), (301, 2, 608), (48, 1, 48), (1, 2, 16), (72, 1, 80)],
)
def test_row_pitch_is_the_next_multiple_of_16_bytes(d, itemsize, pitch):
    assert nt.row_pitch_bytes(d, itemsize) == pitch
    x = torch.ones((3, d), dtype={1: torch.int8, 2: torch.bfloat16}[itemsize])
    rows = nt._kernel_rows(x, "x")
    assert rows.shape[1] * itemsize == pitch and rows.is_contiguous() and rows.data_ptr() % 16 == 0
    assert (rows[:, d:] == 0).all() and torch.equal(rows[:, :d], x)


def test_row_pitch_refuses_what_has_none():
    with pytest.raises(ValueError, match="row pitch"):
        nt.row_pitch_bytes(0, 1)
    with pytest.raises(ValueError, match="row pitch"):
        nt.row_pitch_bytes(8, 3)


@pytest.mark.parametrize("kernel", ["ncc_topk_int8", "ncc_topk_bf16", "ncc_topk_f32"])
def test_shared_memory_fits_the_block_for_every_k(kernel):
    sizes = {nt.wgmma_smem_bytes(kernel, k) for k in range(1, nt.MAX_K + 1)}
    assert len(sizes) == 1 and sizes.pop() <= nt.MAX_BLOCK_SMEM == 232448
    with pytest.raises(ValueError, match="1..512"):
        nt.wgmma_smem_bytes(kernel, 513)
    lay = nt.wgmma_layout(kernel)
    tile = nt.WGMMA_TILE[kernel]
    slices = tile["stages"] * tile["planes"]  # 128-byte slices of every row in flight
    assert lay["ring"] == slices * (tile["bm"] + tile["bn"]) * 128 and slices >= 4
    assert lay["lists"] % 128 == 0 and lay["lists"] + lay["list_k"] * tile["bm"] * 8 + 1024 == lay["smem_bytes"]
    # One more slot per row would not fit.
    assert lay["smem_bytes"] + tile["bm"] * 8 > nt.MAX_BLOCK_SMEM


@pytest.mark.parametrize(
    "kernel, k, on_chip",
    [("ncc_topk_bf16", 40, True), ("ncc_topk_bf16", 76, True), ("ncc_topk_bf16", 77, False),
     ("ncc_topk_bf16", 512, False), ("ncc_topk_int8", 27, True), ("ncc_topk_int8", 40, False),
     ("ncc_topk_f32", 4, True), ("ncc_topk_f32", 5, False), ("ncc_topk_f32", 40, False)],
)
def test_where_the_lists_live(kernel, k, on_chip):
    # bf16's narrower chunk leaves room for the main path's k = 40 lists in
    # shared memory; int8's 192 KB ring and f32's 216 KB ring do not.
    assert nt.wgmma_lists_on_chip(kernel, k) is on_chip


def test_python_tile_is_the_headers():
    import re
    from pathlib import Path

    csrc = Path(nt.__file__).resolve().parents[1] / "csrc"
    header = (csrc / "ncc_wgmma.cuh").read_text()

    def constant(name, text=header):
        value = re.search(rf"constexpr int {name} = (\w+);", text).group(1)
        if not value.isdigit():  # a macro with a default in the same file
            value = re.search(rf"#define {value} (\d+)", text).group(1)
        return int(value)

    assert (constant("BK_BYTES"), constant("SUB"), constant("MAX_SMEM")) == (
        nt.WGMMA_BK_BYTES, nt.WGMMA_SLICE, nt.MAX_BLOCK_SMEM)
    for name, tile in nt.WGMMA_TILE.items():
        src = (csrc / f"{name}.cu").read_text()
        assert constant("WG_ROWS") * constant("NCONSUMERS") == tile["bm"]
        assert constant("NW", src) == tile["bn"], name
        assert constant("STAGES", src) == tile["stages"], name
        assert constant("PLANES", src if "int PLANES" in src else header) == tile["planes"], name
        assert constant("CLUSTER") == tile["cluster"], name


def test_l2_traffic_of_the_chosen_tiles():
    # The main-path shape: the bytes each tile moves from L2 to shared memory.
    n, m, d = 16384, 107008, 3600
    assert round(nt.wgmma_l2_bytes("ncc_topk_int8", n, m, d) / 1e9, 1) == 49.3
    assert round(nt.wgmma_l2_bytes("ncc_topk_bf16", n, m, 2 * d) / 1e9, 1) == 128.2
    # f32: two planes of d padded to whole 32-value slices, 28,928 bytes a row.
    f32_row = nt.tf32_rows(torch.zeros((1, d))).shape[1] * 4
    assert f32_row == 28928 and round(nt.wgmma_l2_bytes("ncc_topk_f32", n, m, f32_row) / 1e9, 1) == 515.1


@pytest.mark.parametrize(
    "address, pitch, ok",
    [(0x7F0000000000, 3600, True), (0x7F0000000010, 16, True), (0x7F0000000008, 3600, False),
     (0x7F0000000000, 3604, False)],
)
def test_alignment_check(address, pitch, ok):
    if ok:
        nt.check_alignment(address, pitch)
    else:
        with pytest.raises(ValueError, match="multiples of 16 bytes"):
            nt.check_alignment(address, pitch, "dict_q")


@pytest.mark.parametrize(
    "m, tile_m, group", [(128, 32, 4), (192, 96, 3), (1024, 512, 256), (1024, 512, 512), (64, 32, 1)]
)
def test_logical_order_makes_groups_consecutive(m, tile_m, group):
    # A kernel that folds `group` consecutive columns of the gathered
    # dictionary and maps positions back through the order computes the
    # interleaved group compression of the plain version.
    order = nt.logical_order(m, tile_m, group)
    assert sorted(order.tolist()) == list(range(m))
    sim = torch.from_numpy(np.random.default_rng(m + group).integers(-5, 6, (6, m)).astype(np.float32))
    ref_v, ref_i = nt._group_compress(sim, tile_m, group)
    runs = sim[:, order].reshape(6, m // group, group)
    best = runs.max(dim=2)
    first = (runs == best.values[..., None]).to(torch.int8).argmax(dim=2)  # lowest member on ties
    pos = torch.arange(m // group)[None, :] * group + first
    assert torch.equal(best.values, ref_v) and torch.equal(order[pos], ref_i)
    with pytest.raises(ValueError):
        nt.logical_order(m, tile_m, tile_m + 1)


def test_near_tie_rule_accepts_the_plain_version_and_flags_departures():
    e, w = (torch.from_numpy(x) for x in _float_operands(32, 512, 100, seed=8, exact=False))
    ref_s, ref_i = nt.ncc_match_topk_f32_plain(e, w, 6)
    s, i = ref_s[:, :5].clone(), ref_i[:, :5].clone()
    assert nt.near_tie_disagreements(s, i, ref_s, ref_i, e, w, 1e-5, (3, 5, 40)) == []
    i[0, [0, 1]] = i[0, [1, 0]]
    assert any("indices differ" in p for p in nt.near_tie_disagreements(s, i, ref_s, ref_i, e, w, 1e-5))
    s[0, 0] += 1e-3
    assert len(nt.near_tie_disagreements(s, i, ref_s, ref_i, e, w, 1e-5)) == 3
