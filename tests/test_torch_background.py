"""Kernel D on the CPU: the choice between its static mode's two kernels
and between its dynamic mode's two, the conversions the static warp kernel
relies on, the static removal through ``EBSD`` against JAX, and the device
copy of the background.

The card's own checks (each kernel bit for bit with the plain version) are
in ``tests/test_torch_gpu.py``; here the wrapper runs its plain version.
"""

import numpy as np
import pytest
import torch

from kikuchipy_tpu.signals.ebsd import EBSD as JEBSD
from kikuchipy_tpu_torch.ops import background as tbg
from kikuchipy_tpu_torch.signals.ebsd import EBSD as TEBSD
from kikuchipy_tpu_torch.utils import device as tdev

CPU = "cpu"


def _patterns(n, shape, seed, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    yy, xx = np.indices(shape)
    base = 90 + 0.5 * yy + 60 * np.cos(xx / 6.0) * np.sin(yy / 8.0)
    return np.clip(base[None] + rng.normal(scale=14, size=(n,) + shape), 1, 255).astype(dtype)


def _background(shape):
    yy, xx = np.indices(shape)
    return (60 + 40 * np.exp(-((xx - shape[1] / 2) ** 2 + (yy - shape[0] / 2.4) ** 2) / 1100)).astype(np.float32)


# ---------------------------- the path choice ---------------------------- #


@pytest.mark.parametrize(
    "shape, dtype_in, dtype_out, kw, want",
    [
        ((60, 60), np.uint8, np.uint8, {}, ("warp", 8)),  # the main path: 225 vectors, about 7 a lane
        ((64, 64), np.uint8, np.uint8, {}, ("warp", 8)),  # 256 vectors, 8 a lane
        ((40, 40), np.uint8, np.uint8, {}, ("warp", 4)),  # 100 vectors, about 3 a lane
        ((80, 80), np.uint8, np.uint8, {}, ("warp", 16)),
        ((1, 16), np.uint8, np.uint8, {}, ("warp", 2)),
        ((16, 1), np.uint8, np.uint8, {}, ("warp", 2)),
        ((32, 32), np.uint8, np.uint8, {"omin": 10, "omax": 200}, ("warp", 2)),
        ((57, 61), np.uint8, np.uint8, {}, ("block", 0)),  # 3,477 bytes: patterns start off 16-byte boundaries
        ((480, 480), np.uint8, np.uint8, {}, ("block", 0)),  # 14,400 vectors: past the registers
        ((96, 96), np.uint8, np.uint8, {}, ("block", 0)),  # 576 vectors, 18 a lane
        ((60, 60), np.uint8, np.float32, {}, ("block", 0)),
        ((60, 60), np.float32, np.uint16, {}, ("block", 0)),
        ((60, 60), np.uint16, np.int16, {}, ("block", 0)),
        ((60, 60), np.uint8, np.uint8, {"aligned": False}, ("block", 0)),
        ((60, 60), np.uint8, np.uint8, {"omin": -3e9, "omax": 3e9}, ("block", 0)),  # past int32's range
    ],
)
def test_static_path_choice(shape, dtype_in, dtype_out, kw, want):
    assert tbg.static_path(*shape, dtype_in, dtype_out, **kw) == want
    assert tbg.static_path(*shape, torch.from_numpy(np.zeros(1, dtype_in)).dtype, dtype_out, **kw) == want


def test_static_warp_kernel_sizes_cover_their_vectors():
    # Each size takes the patterns the one below cannot hold, up to 32 x 16
    # vectors of 16 bytes.
    assert tbg.WARP_VECTORS == (2, 4, 8, 16)
    for npix, vec in ((16, 2), (1024, 2), (1040, 4), (2048, 4), (2064, 8), (4096, 8), (4112, 16), (8192, 16)):
        assert tbg.static_path(1, npix, np.uint8, np.uint8) == ("warp", vec), npix
    assert tbg.static_path(1, 8208, np.uint8, np.uint8) == ("block", 0)


@pytest.mark.parametrize(
    "shape, dtype_in, dtype_out, kw, want",
    [
        ((60, 60), np.uint8, np.uint8, {}, ("pair", 8)),  # the main path
        ((64, 64), np.uint8, np.uint8, {}, ("pair", 7)),  # the largest: 7 pairs fit the budget
        ((40, 40), np.uint8, np.uint8, {}, ("pair", 8)),
        ((1, 16), np.uint8, np.uint8, {}, ("pair", 8)),
        ((60, 60), np.uint8, np.uint8, {"omin": 10, "omax": 200}, ("pair", 8)),
        ((57, 61), np.uint8, np.uint8, {}, ("block", 0)),  # ragged: no whole vectors, an odd width
        ((60, 62), np.uint8, np.uint8, {}, ("block", 0)),  # a width no multiple of 4
        ((16, 1), np.uint8, np.uint8, {}, ("block", 0)),
        ((64, 68), np.uint8, np.uint8, {}, ("block", 0)),  # past 64 x 64
        ((68, 64), np.uint8, np.uint8, {}, ("block", 0)),
        ((180, 180), np.uint8, np.uint8, {}, ("block", 0)),  # the block kernel's scratch path
        ((60, 60), np.uint8, np.float32, {}, ("block", 0)),
        ((60, 60), np.uint16, np.uint8, {}, ("block", 0)),
        ((60, 60), np.float32, np.uint16, {}, ("block", 0)),
        ((60, 60), np.uint8, np.uint8, {"aligned": False}, ("block", 0)),
        ((60, 60), np.uint8, np.uint8, {"omin": -3e9, "omax": 3e9}, ("block", 0)),  # past int32's range
    ],
)
def test_dynamic_path_choice(shape, dtype_in, dtype_out, kw, want):
    assert tbg.dynamic_path(*shape, dtype_in, dtype_out, **kw) == want
    assert tbg.dynamic_path(*shape, torch.from_numpy(np.zeros(1, dtype_in)).dtype, dtype_out, **kw) == want


@pytest.mark.parametrize("sy, sx", [(60, 60), (64, 64), (4, 4), (40, 40), (64, 4), (1, 16), (32, 60)])
def test_dynamic_pair_kernel_takes_as_many_pairs_as_fit(sy, sx):
    path, pairs = tbg.dynamic_path(sy, sx, np.uint8, np.uint8)
    assert path == "pair" and 1 <= pairs <= 8
    assert tbg.dynamic_smem_bytes(sy, sx, pairs) <= tbg.SMEM_BUDGET
    assert pairs == 8 or tbg.dynamic_smem_bytes(sy, sx, pairs + 1) > tbg.SMEM_BUDGET
    # Both transposed operators (64 floats a row), then each pair's row
    # product (68 floats a row), two pattern buffers and its min and max.
    assert tbg.dynamic_smem_bytes(sy, sx, 1) == 256 * (sy + sx) + 272 * sx + 2 * sy * sx + 16


def test_dynamic_pair_kernel_limits_are_the_sources():
    from pathlib import Path

    text = (Path(tbg.__file__).resolve().parents[1] / "csrc" / "background.cu").read_text()
    assert f"constexpr int kDynSide = {tbg.DYNAMIC_SIDE};" in text
    assert f"constexpr int kDynMaxPairs = {tbg._DYN_MAX_PAIRS};" in text
    assert f"constexpr int kDynTStride = {tbg._DYN_TSTRIDE};" in text
    assert "return 4 * sx * kDynTStride + 2 * sy * sx + 16;" in text
    assert "return 4 * kDynSide * (sy + sx) + pairs * dyn_pair_bytes(sy, sx);" in text


@pytest.mark.parametrize("operation", ["subtract", "divide"])
def test_dynamic_removal_on_the_cpu_is_the_plain_version_and_counts_no_launch(operation):
    from kikuchipy_tpu_torch.ops import pattern as tops

    p = torch.from_numpy(_patterns(5, (60, 60), 29))
    plan = tops.dynamic_background_separable_plan((60, 60), 60 / 8)
    row, col = torch.as_tensor(plan.row_op), torch.as_tensor(plan.col_op)
    launches, modes = tbg.remove_background.launches, dict(tbg.remove_background.mode_launches)
    got = tbg.remove_background(p, operation, 0, 255, np.uint8, row_op=row, col_op=col)
    assert torch.equal(got, tbg.remove_background_plain(p, operation, 0, 255, np.uint8, row_op=row, col_op=col))
    assert tbg.remove_background.launches == launches and tbg.remove_background.mode_launches == modes
    assert set(modes) == {"static", "dynamic", "static-warp", "static-block", "dynamic-pair", "dynamic-block"}


# ------------------- the static warp kernel's conversions ------------------- #


def _cvt_rzi_s32(v: torch.Tensor) -> torch.Tensor:
    """PTX ``cvt.rzi.s32.f32`` (``__float2int_rz``): truncation toward zero,
    saturated to int32's range, NaN to 0."""
    t = torch.trunc(v).nan_to_num(nan=0.0, posinf=2.0**31, neginf=-(2.0**31)).clamp(-(2.0**31), 2.0**31)
    return t.to(torch.int64).clamp(-(2**31), 2**31 - 1)


def test_byte_to_float_through_2_23_is_exact():
    # 0x4B000000 | b is the float 2^23 + b; less 2^23 it is float(b) exactly.
    b = np.arange(256, dtype=np.uint32)
    f = (np.uint32(0x4B000000) | b).view(np.float32) - np.float32(2.0**23)
    assert f.dtype == np.float32 and np.array_equal(f, b.astype(np.float32))


def test_uint8_cast_through_int32_is_pytorchs_over_the_rescale():
    # The rescale gives every pattern's outputs in [omin, omax] = [0, 255],
    # or NaN (a range of 0, inf or NaN). Over every float32 there and NaN,
    # the low byte of the kernel's truncation through int32 is PyTorch's
    # .to(torch.uint8) (through int64).
    top = int(np.array(255.0, np.float32).view(np.int32))
    step = 1 << 25
    for start in range(0, top + 1, step):
        bits = torch.arange(start, min(start + step, top + 1), dtype=torch.int32)
        v = bits.view(torch.float32)
        assert torch.equal((_cvt_rzi_s32(v) & 0xFF).to(torch.uint8), v.to(torch.uint8)), start
    special = torch.tensor([float("nan"), -0.0, 0.0, 255.0, np.nextafter(np.float32(255), np.float32(0))],
                           dtype=torch.float32)
    assert torch.equal((_cvt_rzi_s32(special) & 0xFF).to(torch.uint8), special.to(torch.uint8))
    assert int(_cvt_rzi_s32(torch.tensor([float("nan")]))[0]) == 0


def test_uint8_cast_through_int32_is_pytorchs_within_the_wide_ranges_it_takes():
    # Output ranges within +-2^30 take the warp kernel: its values lie
    # within +-2^31, where the two truncations agree to the byte.
    rng = np.random.default_rng(3)
    bound = np.float32(2.0**31)
    bits = rng.integers(0, 2**31, size=4_000_000, dtype=np.int64).astype(np.int32).view(np.float32)
    v = np.concatenate([bits[np.abs(bits) < bound], -bits[np.abs(bits) < bound],
                        np.nextafter(bound, np.float32(0)) * np.array([1, -1], np.float32),
                        np.float32([2.0**30, -(2.0**30), 0.5, -0.5, -1.0, 256.0, -256.0, 1e-45])])
    t = torch.from_numpy(v)
    assert torch.equal((_cvt_rzi_s32(t) & 0xFF).to(torch.uint8), t.to(torch.int64).to(torch.uint8))


# ------------------- the static removal against JAX ------------------- #


@pytest.mark.parametrize("shape, n", [((60, 60), 13), ((60, 60), 1), ((57, 61), 9), ((1, 16), 40), ((16, 1), 40),
                                      ((40, 40), 9)])
@pytest.mark.parametrize("operation, scale_bg", [("subtract", False), ("divide", False), ("subtract", True)])
def test_ebsd_static_removal_matches_jax(shape, n, operation, scale_bg):
    # uint8 out: within one gray level on under 1% of the pixels (float32
    # round-off at integer boundaries between XLA and PyTorch); the plain
    # version is what the card is held to bit for bit.
    data = _patterns(n, shape, 17)
    bg = _background(shape)
    got = TEBSD(data, static_background=bg, device=CPU).remove_static_background(operation, scale_bg=scale_bg)
    want = JEBSD(data=data, static_background=bg).remove_static_background(operation, scale_bg=scale_bg)
    got, want = got.data.numpy().astype(np.int64), np.asarray(want.data).astype(np.int64)
    assert got.shape == want.shape == data.shape
    diff = np.abs(got - want)
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01, (diff.max(), (diff > 0).mean())
    ref = tbg.remove_background_plain(torch.from_numpy(data), operation, 0, 255, np.uint8,
                                      static_bg=torch.from_numpy(bg), scale_bg=scale_bg)
    assert np.array_equal(got, ref.numpy())


def test_ebsd_static_removal_of_flat_patterns_matches_jax():
    # A pattern equal to its background plus a constant has a range of 0:
    # every output is NaN before the cast, and both cast it to 0.
    bg = np.full((60, 60), 37.0, np.float32)
    data = _patterns(8, (60, 60), 19)
    data[[0, 3]] = 91
    got = TEBSD(data, static_background=bg, device=CPU).remove_static_background().data.numpy()
    want = np.asarray(JEBSD(data=data, static_background=bg).remove_static_background().data)
    assert np.array_equal(got[[0, 3]], np.zeros((2, 60, 60), np.uint8))
    assert np.array_equal(got[[0, 3]], want[[0, 3]])
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01


# ------------------- the background's device copy ------------------- #


def test_constant_tensor_copies_once_and_follows_changes_in_place():
    bg = _background((60, 60))
    first = tdev.constant_tensor(bg, torch.device(CPU), torch.float32)
    assert tdev.constant_tensor(bg, torch.device(CPU), torch.float32) is first
    assert not np.shares_memory(first.numpy(), bg)
    bg[3, 4] += 1.0  # changed in place: copied again
    second = tdev.constant_tensor(bg, torch.device(CPU), torch.float32)
    assert second is not first and float(second[3, 4]) == float(bg[3, 4])
    assert float(first[3, 4]) == float(bg[3, 4]) - 1.0
    t = torch.from_numpy(bg)
    assert tdev.constant_tensor(t, torch.device(CPU)) is t  # a tensor is as_tensor's


def test_constant_tensor_keeps_a_bounded_number_of_copies():
    arrays = [np.full((4, 4), float(i), np.float32) for i in range(40)]
    for a in arrays:
        tdev.constant_tensor(a, torch.device(CPU), torch.float32)
    assert len(tdev._CONSTANTS) <= tdev._CONSTANTS_KEPT


def test_ebsd_static_removal_follows_its_background_changed_in_place():
    data = _patterns(6, (60, 60), 23)
    bg = _background((60, 60))
    s = TEBSD(data, static_background=bg, device=CPU)
    before = s.remove_static_background().data.clone()
    bg[:30] += 25.0
    after = s.remove_static_background().data
    want = JEBSD(data=data, static_background=bg).remove_static_background().data
    assert not torch.equal(before, after)
    diff = np.abs(after.numpy().astype(np.int64) - np.asarray(want).astype(np.int64))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01
